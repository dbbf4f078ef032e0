"""Public wrappers for the fused seal datapath: padding, dispatch, accounting.

Port of ``repro.kernels.seal.ops``.  ``seal_stripe`` / ``unseal_stripe``
take ragged per-shard payloads, pad them to the (R, 512)-int8 row grid and
call the stripe kernel wrapper, which runs the CUDA kernel for tensors on
the card and the staged plain version for tensors on the CPU.  Both give the
same sealed bodies, P/Q parity and zero-padded tails.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.archival.raid import gf_pow_gen
from repro_torch.kernels import as_payload_list, as_tensor, resolve_device
from repro_torch.kernels.seal.seal import (
    LANES,
    R_TILE,
    ROW_BYTES,
    parity_flags,
    seal_stripe_kernel,
    unseal_stripe_kernel,
)

__all__ = [
    "SealedStripe",
    "seal_stripe",
    "unseal_stripe",
    "pad_rows_for",
    "bucket_rows_for",
    "datapath_traffic",
]

# one entry per full-payload device-memory pass of the staged plain version
STAGED_PASSES = (
    "pack int8->u32 (read i8, write u32)",
    "ChaCha20 keystream (write u32)",
    "XOR-seal (read payload + keystream, write u32)",
    "valid-length mask (read + write u32)",
    "u32->u8 bytes for GF math (read + write)",
    "RAID P/Q accumulation over S shards (S reads per parity)",
)


class SealedStripe(NamedTuple):
    sealed: torch.Tensor           # (S, R, 128) uint32, zero-padded tails
    p: Optional[torch.Tensor]      # (R, 128) uint32 RAID-5 parity (or None)
    q: Optional[torch.Tensor]      # (R, 128) uint32 RAID-6 parity (or None)
    n_words: Tuple[int, ...]       # valid uint32 words per shard
    n_i8: Tuple[int, ...]          # valid int8 payload bytes per shard

    def body(self, s: int) -> torch.Tensor:
        """Exact-length flat uint32 sealed body of shard s."""
        return self.sealed[s].reshape(-1)[: self.n_words[s]]

    @property
    def pad_words(self) -> int:
        return self.sealed.shape[1] * LANES


def pad_rows_for(n_words: int) -> int:
    """Rows of 128 words covering n_words, rounded to the 8-row tile."""
    rows = max(1, -(-n_words // LANES))
    return -(-rows // R_TILE) * R_TILE


def bucket_rows_for(n_words: int) -> int:
    """Smallest power-of-two multiple of ``R_TILE`` rows covering n_words
    (the reference's jit-trace bucket; archives keep its geometry)."""
    tiles = -(-pad_rows_for(n_words) // R_TILE)
    return R_TILE * (1 << (tiles - 1).bit_length())


def _stack_padded(flats: Sequence[torch.Tensor], pad_rows: Optional[int] = None):
    if not flats:
        raise ValueError("stripe must contain at least one shard payload")
    n_i8 = tuple(int(f.shape[0]) for f in flats)
    n_words = tuple(-(-n // 4) for n in n_i8)
    R = pad_rows_for(max(n_words))
    if pad_rows is not None:
        if pad_rows < R or pad_rows % R_TILE:
            raise ValueError(
                f"pad_rows={pad_rows} must be a multiple of {R_TILE} "
                f"covering the largest shard ({R} rows)"
            )
        R = pad_rows
    codes = torch.zeros((len(flats), R * ROW_BYTES), dtype=torch.int8, device=flats[0].device)
    for s, f in enumerate(flats):
        codes[s, : f.shape[0]] = f
    return codes.reshape(len(flats), R, ROW_BYTES), n_words, n_i8


def _meta_arrays(keys, nonces, n_words, device: torch.device,
                 shard_ids: Optional[Sequence[int]] = None):
    """Per-shard kernel operands.  ``shard_ids`` carries each row's GLOBAL
    stripe-shard index so the RAID-6 Q coefficient g^s stays right when a
    subset read hands the kernel only some of a stripe's shards."""
    S = len(n_words)
    ids = range(S) if shard_ids is None else shard_ids
    keys = as_tensor(keys, torch.uint32, device).reshape(S, 8).contiguous()
    nonces = as_tensor(nonces, torch.uint32, device).reshape(S, 3).contiguous()
    n_valid = torch.tensor(n_words, dtype=torch.int32).reshape(S, 1).to(device)
    q_coef = torch.tensor([gf_pow_gen(int(s)) for s in ids],
                          dtype=torch.int64).to(torch.uint32).reshape(S, 1).to(device)
    return keys, nonces, n_valid, q_coef


def seal_stripe(payloads, keys, nonces, *, parity: str = "raid6",
                pad_rows: Optional[int] = None, device=None) -> SealedStripe:
    """Seal all S shards of a stripe (+ parity) in one fused pass.

    payloads: list of flat int8 arrays (ragged ok) or an (S, N) int8 array.
    keys: (S, 8) uint32 ChaCha session keys; nonces: (S, 3) uint32.
    pad_rows: optional row count (multiple of ``R_TILE`` covering the
    largest shard), e.g. a coalescer's pow2 bucket.
    """
    device = resolve_device(device)
    parity_flags(parity)
    flats = as_payload_list(payloads, device)
    codes, n_words, n_i8 = _stack_padded(flats, pad_rows)
    meta = _meta_arrays(keys, nonces, n_words, device)
    sealed, p, q = seal_stripe_kernel(codes, *meta, parity=parity)
    return SealedStripe(sealed, p, q, n_words, n_i8)


def unseal_stripe(stripe: SealedStripe, keys, nonces, *, parity: str = "raid6",
                  shard_ids: Optional[Sequence[int]] = None, device=None):
    """Fused decode: returns (payload list, P, Q) with parity recomputed
    from the stored bodies (compare with the seal-time parity to verify the
    stripe before trusting the decode).

    ``shard_ids``: global stripe-shard index per row, for SUBSET reads; a
    subset cannot recompute stripe-wide parity, so such reads run
    ``parity="none"``.
    """
    if not stripe.n_words:
        raise ValueError("stripe must contain at least one shard payload")
    device = resolve_device(device)
    parity_flags(parity)
    sealed = as_tensor(stripe.sealed, torch.uint32, device).contiguous()
    meta = _meta_arrays(keys, nonces, stripe.n_words, device, shard_ids)
    codes, p, q = unseal_stripe_kernel(sealed, *meta, parity=parity)
    flats = [codes[s].reshape(-1)[: stripe.n_i8[s]] for s in range(codes.shape[0])]
    return flats, p, q


def datapath_traffic(S: int, n_words: int, parity: str = "raid6") -> dict:
    """Structural device-memory bytes per stripe: staged passes vs fused.

    n_words: padded uint32 words per shard.  The fused kernel reads each
    payload byte once (int8) and writes it once (uint32), plus one write per
    parity strip; every staged pass re-reads and/or re-writes the stripe.
    """
    body_u8 = 4 * n_words
    stripe_u8 = S * body_u8
    n_par = {"none": 0, "raid5": 1, "raid6": 2}[parity]
    fused = stripe_u8 + stripe_u8 + n_par * body_u8
    staged = (
        2 * stripe_u8
        + stripe_u8
        + 3 * stripe_u8
        + 2 * stripe_u8
        + (2 * stripe_u8 if n_par else 0)
        + n_par * (stripe_u8 + body_u8)
    )
    return {
        "staged_bytes": staged,
        "fused_bytes": fused,
        "reduction": staged / fused,
        "staged_passes": len(STAGED_PASSES),
        "fused_launches": 1,
    }
