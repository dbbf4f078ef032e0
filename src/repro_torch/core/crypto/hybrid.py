"""Hybrid archival encryption: R-LWE KEM + ChaCha20 bulk layer.

Port of ``repro.core.crypto.hybrid``.  Every archived block is encrypted
under a fresh session key encapsulated with the lattice KEM; the bulk bytes
pay only a stream-cipher XOR.  Session keys rotate per block by
construction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.crypto import rlwe
from repro_torch.core.crypto.chacha import xor_stream
from repro_torch.kernels import resolve_device

__all__ = [
    "SealedBlock",
    "SessionMaterial",
    "encapsulate_session",
    "seal",
    "unseal",
    "bytes_to_u32",
    "u32_to_bytes",
]

NONCE_MAX = 2**31 - 1  # nonces are drawn in [0, NONCE_MAX), as in the reference


class SealedBlock(NamedTuple):
    kem_c1: torch.Tensor  # (1, n) int32
    kem_c2: torch.Tensor  # (1, n) int32
    nonce: torch.Tensor   # (3,) uint32
    body: torch.Tensor    # uint32 payload
    n_valid_u32: int      # logical length (callers may pad the payload)


def bytes_to_u32(data: bytes, *, device=None) -> torch.Tensor:
    """Little-endian pack, zero-padded to a multiple of 4 bytes."""
    pad = (-len(data)) % 4
    buf = np.frombuffer(data + b"\0" * pad, dtype="<u4").copy()
    return torch.from_numpy(buf).to(resolve_device(device))


def u32_to_bytes(words: torch.Tensor, n_bytes: int) -> bytes:
    """The first ``n_bytes`` bytes of u32 words, little-endian (host bytes)."""
    return words.cpu().numpy().astype("<u4").tobytes()[:n_bytes]


class SessionMaterial(NamedTuple):
    """One shard's bulk-encryption material: KEM ciphertext + symmetric key."""

    kem_c1: torch.Tensor   # (1, n) int32
    kem_c2: torch.Tensor   # (1, n) int32
    session: torch.Tensor  # (8,) uint32 ChaCha key (never stored)
    nonce: torch.Tensor    # (3,) uint32


def encapsulate_session(pub: rlwe.PublicKey, generator: torch.Generator,
                        params: rlwe.RLWEParams = rlwe.RLWEParams()) -> SessionMaterial:
    """Fresh session key + nonce under the lattice KEM, on pub's device."""
    ct, session = rlwe.kem_encapsulate(pub, generator, params)
    nonce = torch.randint(0, NONCE_MAX, (3,), generator=generator,
                          device=generator.device).to(torch.uint32)
    return SessionMaterial(ct.c1, ct.c2, session, nonce.to(pub.a.device))


def seal(pub: rlwe.PublicKey, payload_u32: torch.Tensor, generator: torch.Generator,
         params: rlwe.RLWEParams = rlwe.RLWEParams()) -> SealedBlock:
    """Encrypt a u32 payload under a fresh encapsulated session key."""
    sm = encapsulate_session(pub, generator, params)
    body = xor_stream(sm.session, sm.nonce, payload_u32)
    return SealedBlock(sm.kem_c1, sm.kem_c2, sm.nonce, body, int(payload_u32.numel()))


def unseal(s: torch.Tensor, block: SealedBlock,
           params: rlwe.RLWEParams = rlwe.RLWEParams()) -> torch.Tensor:
    session = rlwe.kem_decapsulate(s, rlwe.Ciphertext(block.kem_c1, block.kem_c2), params)
    return xor_stream(session, block.nonce, block.body)
