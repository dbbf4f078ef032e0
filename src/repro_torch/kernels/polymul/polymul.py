"""Negacyclic matmul kernel (``csrc/polymul.cu``) and its ctypes wrapper.

Port of ``repro.kernels.polymul.polymul``: C = N(a) @ B mod q, the ring
multiply of the R-LWE KEM.  The TPU kernel took the n x n matrix N(a) and
split coefficients into 7-bit limbs for int8 MXU products; the Hopper
kernel takes ``a`` itself, forms N(a)'s entries on the fly and contracts
each column exactly in int64 (see the note atop the source).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.polymul import ref as _ref

__all__ = ["negacyclic_matmul", "MAX_N"]

MAX_N = 1024  # one thread per output coefficient
_MAX_Q = 1 << 14


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def negacyclic_matmul(a: torch.Tensor, vecs: torch.Tensor, q: int) -> torch.Tensor:
    """(a * vecs[i]) mod (x^n + 1, q) for every row i.

    a: (n,) int32 in [0, q); vecs: (B, n) int32 in [0, q) -> (B, n) int32
    in [0, q).  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel or raises.
    """
    if a.device.type == "cpu":
        return _ref.negacyclic_matmul_ref(a, vecs, q)
    B, n = vecs.shape
    if not 0 < n <= MAX_N or not 1 < q < _MAX_Q:
        raise ValueError(f"kernel needs 0 < n <= {MAX_N} and 1 < q < {_MAX_Q}, got n={n}, q={q}")
    _build.require(a, "a", torch.int32, (n,), a.device)
    _build.require(vecs, "vecs", torch.int32, (B, n), a.device)
    out = torch.empty((B, n), dtype=torch.int32, device=a.device)
    launch = _build.function("polymul", "negacyclic_launch", _ARGTYPES)
    with torch.cuda.device(a.device):  # the launch goes to the current device's context
        status = launch(a.data_ptr(), vecs.data_ptr(), out.data_ptr(), n, B, q,
                        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(status, "negacyclic_launch")
    _build.LAUNCHES["polymul"] += 1
    return out
