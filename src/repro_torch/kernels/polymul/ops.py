"""Public negacyclic polynomial products (port of ``repro.kernels.polymul.ops``).

* ``polymul_fixed(a, vecs, q)``: one polynomial against many, the R-LWE
  bulk dataflow.  A CUDA tensor goes to the hand-written kernel, a CPU
  tensor to the plain version.
* ``polymul(a, b, q)``: general batched product, plain PyTorch on either
  device, as the reference leaves it to XLA.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.polymul import ref as _ref
from repro_torch.kernels.polymul.polymul import negacyclic_matmul

__all__ = ["polymul_fixed", "polymul"]


def polymul_fixed(a: torch.Tensor, vecs: torch.Tensor, q: int) -> torch.Tensor:
    """(a * vecs[i]) mod (x^n + 1, q) for every row i.

    a: (n,) integers; vecs: (B, n) integers on a's device -> (B, n) int32
    in [0, q).  Both the kernel and the plain version reduce any int32 mod
    q, so only other dtypes are reduced (exactly, in int64) and cast here.
    """
    return negacyclic_matmul(_as_int32_mod(a, q), _as_int32_mod(vecs, q), q)


def _as_int32_mod(x: torch.Tensor, q: int) -> torch.Tensor:
    if x.dtype == torch.int32:
        return x.contiguous()
    return torch.remainder(x.to(torch.int64), q).to(torch.int32)


def polymul(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """General negacyclic product; a, b broadcastable (..., n) -> (..., n)."""
    return _ref.negacyclic_polymul_ref(a, b, q)
