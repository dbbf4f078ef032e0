"""Ring-LWE public-key encryption / KEM (Salient Store section 4, Alg. 3).

Port of ``repro.core.crypto.rlwe``, with the same parameters (n = 256,
q = 12289, centered binomial psi_16 noise) and the same equations:

    keygen:   b_pk = a o s + e
    encrypt:  C1 = a o r + e1,   C2 = b_pk o r + e2 + encode(m)
    decrypt:  m  = decode(C2 - C1 o s)

Every ring product goes through ``kernels.polymul.polymul_fixed``: the
Hopper kernel for CUDA tensors, the plain version for CPU tensors.

Randomness comes from explicit ``torch.Generator``s in place of
``jax.random`` keys.  Samples are drawn on the generator's device and then
moved, so one seed gives the same keys on the CPU and on the card.
``encrypt_bits`` takes its noise ``(r, e1, e2)`` as an argument, so that a
caller (a test) can hand it noise drawn elsewhere.

A systems reproduction, not an audited cryptographic implementation.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.crypto.chacha import i64_to_u32
from repro_torch.kernels import resolve_device
from repro_torch.kernels.polymul.ops import polymul_fixed

__all__ = [
    "RLWEParams",
    "PublicKey",
    "Ciphertext",
    "keygen",
    "sample_encrypt_noise",
    "encrypt_bits",
    "decrypt_bits",
    "kem_encapsulate",
    "kem_decapsulate",
    "pack_bits_u32",
    "unpack_bits_u32",
]


class RLWEParams(NamedTuple):
    n: int = 256      # ring dimension (x^n + 1)
    q: int = 12289    # 13-bit modulus
    cbd_k: int = 16   # centered binomial psi_k, sigma = sqrt(k/2)


class PublicKey(NamedTuple):
    a: torch.Tensor  # (n,) int32 uniform public polynomial
    b: torch.Tensor  # (n,) int32 a o s + e


class Ciphertext(NamedTuple):
    c1: torch.Tensor  # (B, n) int32
    c2: torch.Tensor  # (B, n) int32


def _sample_uniform(gen: torch.Generator, shape, q: int) -> torch.Tensor:
    return torch.randint(0, q, shape, generator=gen, device=gen.device, dtype=torch.int32)


def _sample_cbd(gen: torch.Generator, shape, k: int, q: int) -> torch.Tensor:
    """Centered binomial psi_k in [0, q) (mod-q representation)."""
    bits = torch.randint(0, 2, tuple(shape) + (2 * k,), generator=gen,
                         device=gen.device, dtype=torch.int32)
    e = bits[..., :k].sum(-1) - bits[..., k:].sum(-1)  # in [-k, k]
    return torch.remainder(e, q).to(torch.int32)


def _mod(x: torch.Tensor, q: int) -> torch.Tensor:
    return torch.remainder(x, q).to(torch.int32)


def keygen(generator: torch.Generator, params: RLWEParams = RLWEParams(), *,
           device=None) -> Tuple[PublicKey, torch.Tensor]:
    """Returns (PublicKey, secret s), all on ``device``."""
    device = resolve_device(device)
    n, q, k = params
    a = _sample_uniform(generator, (n,), q).to(device)
    s = _sample_cbd(generator, (n,), k, q).to(device)
    e = _sample_cbd(generator, (n,), k, q).to(device)
    b = _mod(polymul_fixed(a, s[None, :], q)[0] + e, q)
    return PublicKey(a, b), s


def sample_encrypt_noise(generator: torch.Generator, batch: int, device: torch.device,
                         params: RLWEParams = RLWEParams()):
    """The noise ``(r, e1, e2)`` of ``encrypt_bits``, each (batch, n)."""
    n, q, k = params
    return tuple(_sample_cbd(generator, (batch, n), k, q).to(device) for _ in range(3))


def encrypt_bits(pub: PublicKey, m_bits: torch.Tensor, noise,
                 params: RLWEParams = RLWEParams()) -> Ciphertext:
    """Encrypt a batch of bit-vectors m_bits (B, n) in {0, 1} under the
    given noise ``(r, e1, e2)``."""
    n, q, k = params
    r, e1, e2 = noise
    half_q = q // 2
    c1 = _mod(polymul_fixed(pub.a, r, q) + e1, q)
    c2 = _mod(polymul_fixed(pub.b, r, q) + e2 + m_bits.to(torch.int32) * half_q, q)
    return Ciphertext(c1, c2)


def decrypt_bits(s: torch.Tensor, ct: Ciphertext,
                 params: RLWEParams = RLWEParams()) -> torch.Tensor:
    """Decrypt to (B, n) int32 bits."""
    n, q, k = params
    d = torch.remainder(ct.c2.to(torch.int64) - polymul_fixed(s, ct.c1, q), q)
    # bit = 1 iff d is closer to q/2 than to 0 (mod q)
    return ((d > q // 4) & (d < 3 * q // 4)).to(torch.int32)


def pack_bits_u32(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32*w) {0,1} -> (..., w) torch.uint32, little-endian bit order."""
    *lead, nb = bits.shape
    if nb % 32:
        raise ValueError(f"bit count {nb} is not a multiple of 32")
    b = bits.reshape(*lead, nb // 32, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device)
    return i64_to_u32((b * weights).sum(-1))


def unpack_bits_u32(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """(..., w) u32 words -> (..., nbits) int32 {0,1}."""
    shifts = torch.arange(32, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32)[..., :nbits].to(torch.int32)


def kem_encapsulate(pub: PublicKey, generator: torch.Generator,
                    params: RLWEParams = RLWEParams()):
    """Returns (Ciphertext, shared key (8,) torch.uint32 = 256 bits)."""
    n = params.n
    device = pub.a.device
    m = torch.randint(0, 2, (1, n), generator=generator, device=generator.device,
                      dtype=torch.int32).to(device)
    ct = encrypt_bits(pub, m, sample_encrypt_noise(generator, 1, device, params), params)
    return ct, pack_bits_u32(m[0])


def kem_decapsulate(s: torch.Tensor, ct: Ciphertext,
                    params: RLWEParams = RLWEParams()) -> torch.Tensor:
    return pack_bits_u32(decrypt_bits(s, ct, params)[0])
