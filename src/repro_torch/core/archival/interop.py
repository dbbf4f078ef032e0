"""Carry archive state between the reference package and the port.

The state is what outlives a process: the KEM key pair (public ``(a, b)``,
secret ``s``) and the on-disk form of a stripe, which is

* the replicated records of ``stripe_manifests_to_json`` (KEM polys, nonce,
  manifest, body length per shard),
* the sealed bodies as little-endian u32 (``<u4``) arrays, ``None`` for a
  lost shard,
* the parity dict ``{"p": u8, "q"?: u8, "pad_to": words}``.

All of it is numpy and JSON here, the form both packages read and write,
so a stripe sealed by either package restores in the other.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.archival.pipeline import (
    ArchivedBlock,
    StripeArchive,
    stripe_manifests,
    stripe_manifests_from_json,
    stripe_manifests_to_json,
)
from repro_torch.core.crypto.hybrid import SealedBlock
from repro_torch.core.crypto.rlwe import PublicKey
from repro_torch.kernels import as_tensor, resolve_device

__all__ = [
    "keypair_from_numpy",
    "keypair_to_numpy",
    "stripe_from_state",
    "stripe_to_state",
]

StripeState = Tuple[List[Dict], List[Optional[np.ndarray]], Optional[Dict]]


def keypair_from_numpy(a, b, s, *, device=None) -> Tuple[PublicKey, torch.Tensor]:
    """Public key ``(a, b)`` and secret ``s`` (int arrays of length n)."""
    device = resolve_device(device)
    pub = PublicKey(as_tensor(a, torch.int32, device), as_tensor(b, torch.int32, device))
    return pub, as_tensor(s, torch.int32, device)


def keypair_to_numpy(pub: PublicKey, s: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """``(a, b, s)`` as int32 numpy arrays."""
    return tuple(t.cpu().numpy().astype(np.int32) for t in (pub.a, pub.b, s))


def stripe_to_state(stripe: StripeArchive) -> StripeState:
    """(records, bodies ``<u4``, parity u8) of a stripe with every shard present."""
    records = stripe_manifests_to_json(stripe_manifests(stripe))
    bodies = [b.sealed.body.cpu().numpy().astype("<u4") for b in stripe.blocks]
    parity = None
    if stripe.parity is not None:
        parity = {k: (int(v) if k == "pad_to" else v.cpu().numpy().astype(np.uint8))
                  for k, v in stripe.parity.items()}
    return records, bodies, parity


def stripe_from_state(records: List[Dict], bodies: List[Optional[np.ndarray]],
                      parity: Optional[Dict], *, device=None) -> StripeArchive:
    """The port's ``StripeArchive`` from the on-disk form, on ``device``.

    A ``None`` body is a lost shard (a ``None`` block), which a degraded
    read rebuilds from the parity and the records.
    """
    device = resolve_device(device)
    metas = stripe_manifests_from_json(records, device=device)
    blocks: List[Optional[ArchivedBlock]] = []
    for m, body in zip(metas, bodies):
        if body is None:
            blocks.append(None)
            continue
        words = as_tensor(np.asarray(body, "<u4").astype(np.uint32), torch.uint32, device)
        if words.shape[0] != m["n_words"]:
            raise ValueError(f"body of {words.shape[0]} words, record says {m['n_words']}")
        blocks.append(ArchivedBlock(
            SealedBlock(m["kem_c1"], m["kem_c2"], m["nonce"], words, m["n_words"]),
            m["manifest"]))
    par = None
    if parity is not None:
        par = {k: (int(v) if k == "pad_to" else as_tensor(np.asarray(v, np.uint8), torch.uint8,
                                                           device))
               for k, v in parity.items()}
    return StripeArchive(blocks, par)
