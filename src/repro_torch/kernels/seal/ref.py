"""Staged plain PyTorch version of the fused seal datapath (bit-exact target).

Port of ``repro.kernels.seal.ref``: each stage is a separate pass over the
whole stripe.  Words are carried as int64 masked to 32 bits (PyTorch on the
CPU has no ``+``, shifts or compares for ``torch.uint32``) and leave as
``torch.uint32``.  Runs on either device; on the card it is what
``chip_smoke.py`` holds the kernel against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.archival import raid
from repro_torch.core.crypto.chacha import chacha20_block, i64_to_u32, u32_to_i64

__all__ = ["seal_stripe_ref", "unseal_stripe_ref"]

_SHIFTS = (0, 8, 16, 24)


def _pack_rows(codes: torch.Tensor) -> torch.Tensor:
    """(S, R, 512) int8 -> (S, R, 128) u32 words as int64, little-endian."""
    S, R, C = codes.shape
    b = (codes.to(torch.int64) & 0xFF).reshape(S, R, C // 4, 4)
    sh = torch.tensor(_SHIFTS, device=codes.device)
    return (b << sh).sum(-1)


def _unpack_rows(words: torch.Tensor) -> torch.Tensor:
    """(S, R, 128) int64 words -> (S, R, 512) int8 (two's complement)."""
    S, R, L = words.shape
    sh = torch.tensor(_SHIFTS, device=words.device)
    v = (words[..., None] >> sh) & 0xFF
    signed = v - ((v & 0x80) << 1)
    return signed.reshape(S, R, 4 * L).to(torch.int8)


def _keystream_rows(keys: torch.Tensor, nonces: torch.Tensor, R: int) -> torch.Tensor:
    """Per-shard ChaCha20 keystream shaped (S, R, 128) int64, counter0 = 0."""
    counters = torch.arange(R * 8, dtype=torch.int64, device=keys.device)
    rows = [
        chacha20_block(keys[s], counters, nonces[s]).reshape(R, 128)
        for s in range(keys.shape[0])
    ]
    return u32_to_i64(torch.stack(rows))


def _mask_valid(words: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    S, R, L = words.shape
    widx = torch.arange(R * L, device=words.device).reshape(1, R, L)
    return torch.where(widx < n_valid.reshape(S, 1, 1).to(torch.int64), words, 0)


def _rows_u8(words: torch.Tensor) -> torch.Tensor:
    """(S, R, 128) int64 words -> (S, R*512) uint8, little-endian bytes."""
    sh = torch.tensor(_SHIFTS, device=words.device)
    return ((words[..., None] >> sh) & 0xFF).to(torch.uint8).reshape(words.shape[0], -1)


def _u8_rows_to_u32(rows: torch.Tensor, R: int) -> torch.Tensor:
    sh = torch.tensor(_SHIFTS, device=rows.device)
    words = (rows.to(torch.int64).reshape(-1, 4) << sh).sum(-1)
    return i64_to_u32(words.reshape(R, 128))


def _parity(words: torch.Tensor, q_coef: torch.Tensor, parity: str):
    if parity not in ("none", "raid5", "raid6"):
        raise ValueError(f"unknown parity mode {parity!r}")
    if parity == "none":
        return None, None
    data = _rows_u8(words)
    R = words.shape[1]
    p = _u8_rows_to_u32(raid.raid5_encode(data), R)
    if parity == "raid5":
        return p, None
    q = torch.zeros_like(data[0])
    coefs = q_coef.reshape(-1).to(torch.int64).tolist()
    for s in range(data.shape[0]):
        q = q ^ raid.gf_mul(coefs[s], data[s])
    return p, _u8_rows_to_u32(q, R)


def seal_stripe_ref(codes, keys, nonces, n_valid, q_coef, *, parity: str = "raid6"
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Staged seal: same operands and outputs as the kernel wrapper."""
    R = codes.shape[1]
    packed = _pack_rows(codes)
    ks = _keystream_rows(keys, nonces, R)
    sealed = _mask_valid(packed ^ ks, n_valid)
    p, q = _parity(sealed, q_coef, parity)
    return i64_to_u32(sealed), p, q


def unseal_stripe_ref(sealed, keys, nonces, n_valid, q_coef, *, parity: str = "raid6"
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Staged decode twin: same operands and outputs as the kernel wrapper."""
    R = sealed.shape[1]
    stored = u32_to_i64(sealed)
    ks = _keystream_rows(keys, nonces, R)
    codes = _unpack_rows(_mask_valid(stored ^ ks, n_valid))
    p, q = _parity(stored, q_coef, parity)
    return codes, p, q
