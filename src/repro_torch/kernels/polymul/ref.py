"""Plain PyTorch negacyclic polynomial product in Z_q[x]/(x^n + 1).

Port of ``repro.kernels.polymul.ref``: the schoolbook product
``c_k = sum_{i+j=k} a_i b_j - sum_{i+j=k+n} a_i b_j (mod q)``, i.e. the
mat-vec ``c = N(a) @ b`` with ``N(a)[k, j] = a_{k-j}`` for ``k >= j`` and
``-a_{n+k-j}`` otherwise, entries in the centered representation.  The
contraction runs in int64, which is exact for any q < 2^27 at n <= 1024, so
it needs none of the reference's int32 chunking.  It multiplies and sums
elementwise rather than calling ``matmul``, which CUDA does not offer for
integers, so the same code runs on either device.
"""

from __future__ import annotations

import torch

__all__ = [
    "center",
    "negacyclic_matrix",
    "negacyclic_matmul_ref",
    "negacyclic_polymul_ref",
]


def center(x: torch.Tensor, q: int) -> torch.Tensor:
    """Map coefficients to the centered representation (-q/2, q/2], int64."""
    x = torch.remainder(x.to(torch.int64), q)
    return torch.where(x > q // 2, x - q, x)


def negacyclic_matrix(a: torch.Tensor, q: int) -> torch.Tensor:
    """N(a) with centered entries: a (..., n) -> (..., n, n) int64."""
    a = center(a, q)
    n = a.shape[-1]
    k = torch.arange(n, device=a.device)[:, None]
    j = torch.arange(n, device=a.device)[None, :]
    idx = torch.remainder(k - j, n)
    sign = torch.where(k >= j, 1, -1)
    return a[..., idx] * sign


def negacyclic_matmul_ref(a: torch.Tensor, vecs: torch.Tensor, q: int) -> torch.Tensor:
    """Fixed-a bulk product: a (n,), vecs (B, n) -> (B, n) int32 in [0, q)."""
    mat = negacyclic_matrix(a, q)                     # (n, n)
    prod = (center(vecs, q)[:, None, :] * mat).sum(-1)  # (B, n), exact in int64
    return torch.remainder(prod, q).to(torch.int32)


def negacyclic_polymul_ref(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """General negacyclic product a * b; a, b broadcastable (..., n)."""
    mat = negacyclic_matrix(a, q)                     # (..., n, n)
    prod = (mat * center(b, q).unsqueeze(-2)).sum(-1)
    return torch.remainder(prod, q).to(torch.int32)
