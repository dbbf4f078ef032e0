"""Fused stripe seal/unseal kernel (``csrc/seal.cu``) and its ctypes wrappers.

Port of ``repro.kernels.seal.seal``.  ``seal_stripe_kernel`` (TPU kernel
``_seal_kernel``) and ``unseal_stripe_kernel`` (``_unseal_kernel``) launch
one CUDA kernel with a mode flag, as the reference's ``_stripe_call`` runs
both bodies.  A CPU tensor runs the staged plain version in ``ref.py``; a
CUDA tensor launches the kernel or raises.

Operands (S shards, R rows of 128 words):
  codes (S, R, 512) int8 | sealed (S, R, 128) uint32;
  keys (S, 8) uint32; nonces (S, 3) uint32; n_valid (S, 1) int32 valid
  words per shard; q_coef (S, 1) uint32 RAID-6 coefficient g^s per shard.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.seal import ref as _ref

__all__ = ["seal_stripe_kernel", "unseal_stripe_kernel", "R_TILE", "LANES",
           "ROW_BYTES", "parity_flags"]

R_TILE = 8                 # row granularity of stripe geometry (reference tile)
LANES = 128                # uint32 words per row
ROW_BYTES = 4 * LANES      # int8 payload bytes per row

Outputs = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def parity_flags(parity: str) -> Tuple[bool, bool]:
    if parity not in ("none", "raid5", "raid6"):
        raise ValueError(f"unknown parity mode {parity!r}")
    return parity != "none", parity == "raid6"


_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _launch(mode: int, inp, out, keys, nonces, n_valid, q_coef, parity: str) -> Outputs:
    S, R = inp.shape[0], inp.shape[1]
    dev = inp.device
    with_p, with_q = parity_flags(parity)
    _build.require(keys, "keys", torch.uint32, (S, 8), dev)
    _build.require(nonces, "nonces", torch.uint32, (S, 3), dev)
    _build.require(n_valid, "n_valid", torch.int32, (S, 1), dev)
    _build.require(q_coef, "q_coef", torch.uint32, (S, 1), dev)
    p = torch.empty((R, LANES), dtype=torch.uint32, device=dev) if with_p else None
    q = torch.empty((R, LANES), dtype=torch.uint32, device=dev) if with_q else None
    launch = _build.function("seal", "stripe_launch", _ARGTYPES)
    with torch.cuda.device(dev):  # the launch goes to the current device's context
        status = launch(
            mode, inp.data_ptr(), out.data_ptr(),
            p.data_ptr() if with_p else None, q.data_ptr() if with_q else None,
            keys.data_ptr(), nonces.data_ptr(), n_valid.data_ptr(), q_coef.data_ptr(),
            S, R, int(with_p), int(with_q), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(status, "stripe_launch")
    return out, p, q


def seal_stripe_kernel(codes, keys, nonces, n_valid, q_coef, *,
                       parity: str = "raid6") -> Outputs:
    """Seal one stripe in one launch -> (sealed (S, R, 128) uint32, P, Q)."""
    if codes.device.type == "cpu":
        return _ref.seal_stripe_ref(codes, keys, nonces, n_valid, q_coef, parity=parity)
    S, R, C = codes.shape
    _build.require(codes, "codes", torch.int8, (S, R, ROW_BYTES), codes.device)
    sealed = torch.empty((S, R, LANES), dtype=torch.uint32, device=codes.device)
    out = _launch(1, codes, sealed, keys, nonces, n_valid, q_coef, parity)
    _build.LAUNCHES["seal"] += 1
    return out


def unseal_stripe_kernel(sealed, keys, nonces, n_valid, q_coef, *,
                         parity: str = "raid6") -> Outputs:
    """Decode twin -> (codes (S, R, 512) int8, P, Q), with P/Q recomputed
    over the bodies as stored."""
    if sealed.device.type == "cpu":
        return _ref.unseal_stripe_ref(sealed, keys, nonces, n_valid, q_coef, parity=parity)
    S, R, C = sealed.shape
    _build.require(sealed, "sealed", torch.uint32, (S, R, LANES), sealed.device)
    codes = torch.empty((S, R, ROW_BYTES), dtype=torch.int8, device=sealed.device)
    out = _launch(0, sealed, codes, keys, nonces, n_valid, q_coef, parity)
    _build.LAUNCHES["unseal"] += 1
    return out
