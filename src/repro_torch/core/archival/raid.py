"""Erasure coding for the archive: RAID-5 (XOR) and RAID-6 (GF(256) RS).

Port of ``repro.core.archival.raid``: the same field (poly 0x11D, generator
2), the same log/antilog tables, on ``torch.uint8`` tensors of any device.
A "disk" is a storage shard; P and Q let a stripe survive one or two lost
shards.  Syndrome location stays host-side numpy, as in the reference: a
scrubber ships syndromes of a few KiB, not bodies.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "gf_mul",
    "gf_div",
    "gf_pow_gen",
    "raid5_encode",
    "raid5_reconstruct",
    "raid6_encode",
    "raid6_reconstruct",
    "raid6_syndrome_locate",
]


def _gf_tables():
    exp = np.zeros(512, np.int64)
    log = np.zeros(256, np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= 0x11D
    exp[255:510] = exp[:255]
    exp[510:] = exp[:2]
    return exp, log


_EXP_NP, _LOG_NP = _gf_tables()
_EXP = torch.from_numpy(_EXP_NP)
_LOG = torch.from_numpy(_LOG_NP)


def _as_u8(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x, np.uint8), device=device)


def _device_of(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def gf_mul(a, b) -> torch.Tensor:
    """Elementwise GF(256) multiply of uint8 values (tensors or ints, broadcastable)."""
    dev = _device_of(a, b)
    ai = _as_u8(a, dev).to(torch.int64)
    bi = _as_u8(b, dev).to(torch.int64)
    exp, log = _EXP.to(dev), _LOG.to(dev)
    prod = exp[log[ai] + log[bi]]
    return torch.where((ai == 0) | (bi == 0), 0, prod).to(torch.uint8)


def gf_div(a, b) -> torch.Tensor:
    """Elementwise GF(256) divide (b nonzero where a is nonzero)."""
    dev = _device_of(a, b)
    ai = _as_u8(a, dev).to(torch.int64)
    bi = _as_u8(b, dev).to(torch.int64)
    exp, log = _EXP.to(dev), _LOG.to(dev)
    quot = exp[log[ai] - log[bi] + 255]
    return torch.where(ai == 0, 0, quot).to(torch.uint8)


def gf_pow_gen(i: int) -> int:
    """g^i for the generator g = 2 (host-side scalar)."""
    return int(_EXP_NP[i % 255])


# ------------------------------------------------------------------ RAID-5
def raid5_encode(shards: torch.Tensor) -> torch.Tensor:
    """shards: (k, ...) uint8 -> parity (...,) uint8."""
    p = shards[0]
    for i in range(1, shards.shape[0]):
        p = p ^ shards[i]
    return p


def raid5_reconstruct(shards: Sequence[Optional[torch.Tensor]],
                      parity: torch.Tensor, missing: int) -> torch.Tensor:
    """Recover the single missing data shard."""
    acc = parity
    for i, s in enumerate(shards):
        if i != missing:
            if s is None:
                raise ValueError(f"shard {i} also missing; RAID-5 covers 1 erasure")
            acc = acc ^ s
    return acc


# ------------------------------------------------------------------ RAID-6
def raid6_encode(shards: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """shards: (k, ...) uint8 -> (P, Q) parities."""
    p = raid5_encode(shards)
    q = torch.zeros_like(shards[0])
    for i in range(shards.shape[0]):
        q = q ^ gf_mul(gf_pow_gen(i), shards[i])
    return p, q


def raid6_reconstruct(shards: List[Optional[torch.Tensor]],
                      p: Optional[torch.Tensor], q: Optional[torch.Tensor],
                      missing: Sequence[int]) -> List[torch.Tensor]:
    """Recover up to two missing data shards (``None`` in ``shards``).

    Lost parities are re-encoded afterwards by the caller.  Returns the
    complete data shard list.
    """
    shards = list(shards)
    missing = sorted(missing)
    if len(missing) == 0:
        return shards
    if len(missing) == 1:
        (i,) = missing
        if p is not None:
            shards[i] = raid5_reconstruct(shards, p, i)
        else:
            if q is None:
                raise ValueError("need P or Q for a single erasure")
            acc = q
            for m, s in enumerate(shards):
                if m != i:
                    acc = acc ^ gf_mul(gf_pow_gen(m), s)
            shards[i] = gf_div(acc, gf_pow_gen(i))
        return shards
    if len(missing) == 2:
        i, j = missing
        if p is None or q is None:
            raise ValueError("two erasures need both P and Q")
        pxor, qxor = p, q
        for m, s in enumerate(shards):
            if m not in (i, j):
                pxor = pxor ^ s
                qxor = qxor ^ gf_mul(gf_pow_gen(m), s)
        # pxor = d_i ^ d_j ;  qxor = g^i d_i ^ g^j d_j
        gi, gj = gf_pow_gen(i), gf_pow_gen(j)
        dj = gf_div(qxor ^ gf_mul(gi, pxor), gi ^ gj)
        shards[i], shards[j] = pxor ^ dj, dj
        return shards
    raise ValueError(f"RAID-6 covers at most 2 erasures, got {missing}")


# --------------------------------------------------------- scrub syndromes
def raid6_syndrome_locate(sp, sq, n_shards: int) -> Optional[int]:
    """Locate a single corrupt data shard from RAID-6 parity syndromes.

    ``sp = P_recomputed ^ P_stored`` and ``sq = Q_recomputed ^ Q_stored``
    (uint8, equal length).  One shard ``z`` carrying an XOR error ``e``
    gives ``sp = e`` and ``sq = g^z * e``, so every byte with ``sp != 0``
    agrees on ``z = log(sq) - log(sp) (mod 255)``.  Returns ``z`` when all
    agree on one ``z < n_shards``, else ``None`` (unlocatable corruption).
    """
    sp = np.asarray(sp, np.uint8)
    sq = np.asarray(sq, np.uint8)
    if sp.shape != sq.shape:
        return None
    nz = sp != 0
    if not nz.any() or (sq[nz] == 0).any() or (sq[~nz] != 0).any():
        return None
    z = (_LOG_NP[sq[nz].astype(np.int64)] - _LOG_NP[sp[nz].astype(np.int64)]) % 255
    z0 = int(z[0])
    if (z == z0).all() and z0 < n_shards:
        return z0
    return None
