"""Archival pipeline at payload level: seal stripes, restore, degraded read,
zero-key parity scrub.

Port of the payload-level half of ``repro.core.archival.pipeline``, on the
chained write path, for every ``codec_name``: ``"rans"`` (the default),
``"none"``, ``"zlib"`` and ``"zstd"``:

* write: ``seal_payload_stripes`` (and its ``_dispatch`` / ``_finalize``
  halves) seals K stripes; per stripe, the entropy stage codes each shard
  (``"rans"``: one launch of the on-device rANS encoder for the stripe,
  ``kernels.entropy``; host codecs compress on the host), the R-LWE KEM
  encapsulates one ChaCha20 session key per shard (ring products on the
  polymul kernel), and ONE launch of the stripe kernel packs, seals and
  RAID-codes all S shards (``kernels.seal``).  This is the reference's
  chained path (``entropy_fn``/``seal_fn``), bit-identical to its one-launch
  fused write;
* read: ``restore_stripe_payloads`` unseals with the parity
  recompute-and-compare check (full reads), unseals only the named shards
  (subset reads, global shard ids keep the Q coefficient right), and
  rebuilds lost shards from P/Q first (degraded reads, ``recover_stripe``);
  then decodes by the recorded codec (rANS: one decode launch over the
  coded shards, by the recorded stream version);
* durability: ``recompute_stripe_parity`` drives the same unseal kernel with
  ZERO keys, since parity is defined over the sealed bodies, and returns the
  P/Q strips that a scrubber compares with the stored ones
  (``raid.raid6_syndrome_locate`` names the corrupt shard).

The one-launch fused entropy+seal write (the reference's default for
``"rans"``, kernel ``_entropy_seal_kernel``) is the next slice of the port.
Telemetry (``repro.obs`` spans and the byte ledger) is not ported yet.

Randomness: where the reference takes one ``jax.random`` key per stripe and
folds in the shard index, the port takes one ``torch.Generator`` per stripe
and draws each shard's session material from it in shard order.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.common import compress as host_entropy
from repro_torch.core.archival import raid
from repro_torch.core.crypto import rlwe
from repro_torch.core.crypto.hybrid import SealedBlock, encapsulate_session
from repro_torch.kernels import as_payload_list, as_tensor, resolve_device
from repro_torch.kernels.entropy import ops as entropy_ops
from repro_torch.kernels.seal import ops as seal_ops

__all__ = [
    "ArchiveConfig",
    "ArchivedBlock",
    "StripeArchive",
    "PendingStripeSeal",
    "entropy_encode_payloads",
    "entropy_decode_payloads",
    "seal_payload_stripe",
    "seal_payload_stripes",
    "seal_payload_stripes_dispatch",
    "seal_payload_stripes_finalize",
    "restore_stripe_payloads",
    "stripe_manifests",
    "stripe_manifests_to_json",
    "stripe_manifests_from_json",
    "stripe_parity",
    "recover_stripe",
    "recompute_stripe_parity",
]

class ArchiveConfig(NamedTuple):
    rlwe: rlwe.RLWEParams = rlwe.RLWEParams()
    parity: str = "raid6"  # "raid5" | "raid6" | "none"
    # entropy stage: "rans" (on-device) | "zstd"/"zlib" (host codec) | "none"
    codec_name: str = "rans"


class ArchivedBlock(NamedTuple):
    sealed: SealedBlock
    manifest: Dict  # host-side metadata; "n_i8" is the payload length


class StripeArchive(NamedTuple):
    """One parity stripe: S archived shards + their P/Q parity."""

    blocks: List[Optional[ArchivedBlock]]
    parity: Optional[Dict]  # {"p": u8, "q"?: u8, "pad_to": words} or None


class PendingStripeSeal(NamedTuple):
    """A dispatched stripe-seal batch.  The chained path's launches are
    already queued on the card's stream; finalize hands the archives over.
    (The fused write's in-flight kernel handle comes with the next slice.)"""

    archives: List[StripeArchive]


def _u32_rows_to_u8(rows: torch.Tensor) -> torch.Tensor:
    """(R, 128) uint32 parity strip -> flat uint8 (R*512,), little-endian."""
    return rows.contiguous().view(torch.uint8).reshape(-1)


def _stack_u32(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([x.view(torch.int32) for x in xs]).view(torch.uint32)


def _pub_on(pub: rlwe.PublicKey, device: torch.device) -> rlwe.PublicKey:
    return rlwe.PublicKey(as_tensor(pub.a, torch.int32, device),
                          as_tensor(pub.b, torch.int32, device))


# ------------------------------------------------------------ entropy stage
def _device_of(flats: Sequence) -> Optional[torch.device]:
    """The device of the first tensor payload (None: the caller's default)."""
    return next((f.device for f in flats if isinstance(f, torch.Tensor)), None)


def entropy_encode_payloads(flats: List[torch.Tensor], cfg: ArchiveConfig = ArchiveConfig()):
    """Entropy-code S shard payloads per ``cfg.codec_name``.

    Returns (compressed flats on the payloads' device, per-shard entropy
    metas for the manifests).  ``"rans"`` codes all shards in one launch on
    their device.  Host codecs pull each payload to the host: that is what a
    host codec is, and the traffic the on-device coder removes.  A shard the
    codec cannot shrink is stored raw and flagged ``"raw"``.
    """
    name = cfg.codec_name
    if name == "none":
        return list(flats), [
            {"codec": "none", "n_raw": int(f.shape[0]), "n_comp": int(f.shape[0])}
            for f in flats
        ]
    if name == "rans":
        return entropy_ops.encode_payloads(flats, device=_device_of(flats))
    if name in ("zstd", "zlib"):
        comps, metas = [], []
        for f in flats:
            raw = f.cpu().numpy().tobytes()
            blob = host_entropy.compress_as(name, raw)
            if len(blob) >= len(raw):
                comps.append(f)
                metas.append({"codec": name, "raw": True,
                              "n_raw": len(raw), "n_comp": len(raw)})
            else:
                comps.append(torch.from_numpy(
                    np.frombuffer(blob, np.int8).copy()).to(f.device))
                metas.append({"codec": name, "n_raw": len(raw), "n_comp": len(blob)})
        return comps, metas
    raise ValueError(f"unknown entropy codec {name!r}")


def entropy_decode_payloads(comps: List[torch.Tensor], metas: List[Dict]) -> List[torch.Tensor]:
    """Invert ``entropy_encode_payloads``, dispatching on the RECORDED codec
    (the manifest is ground truth, not the caller's current config)."""
    if not metas:
        return []
    names = {m["codec"] for m in metas}
    if len(names) != 1:
        raise ValueError(f"stripe mixes entropy codecs {sorted(names)}")
    name = names.pop()
    if name == "none":
        return list(comps)
    if name == "rans":
        return entropy_ops.decode_payloads(comps, metas, device=_device_of(comps))
    if name in ("zstd", "zlib"):
        out = []
        for c, m in zip(comps, metas):
            if m.get("raw"):  # raw-skip: the stored bytes ARE the payload
                out.append(c.reshape(-1))
                continue
            raw = host_entropy.decompress_as(
                name, c.cpu().numpy().tobytes(), max_output_size=m["n_raw"])
            out.append(torch.from_numpy(np.frombuffer(raw, np.int8).copy()).to(c.device))
        return out
    raise ValueError(f"unknown entropy codec {name!r}")


# ------------------------------------------------------------------- write
def _assemble_stripe(stripe: seal_ops.SealedStripe, mats, manifests: List[Dict]) -> StripeArchive:
    """Wrap a SealedStripe + its KEM material as a ``StripeArchive``."""
    blocks = [
        ArchivedBlock(
            SealedBlock(m.kem_c1, m.kem_c2, m.nonce, stripe.body(s), stripe.n_words[s]),
            manifests[s],
        )
        for s, m in enumerate(mats)
    ]
    parity = None
    if stripe.p is not None:
        parity = {"p": _u32_rows_to_u8(stripe.p), "pad_to": stripe.pad_words}
        if stripe.q is not None:
            parity["q"] = _u32_rows_to_u8(stripe.q)
    return StripeArchive(blocks, parity)


def seal_payload_stripe(pub: rlwe.PublicKey, flats, manifests: List[Dict],
                        generator: torch.Generator, cfg: ArchiveConfig = ArchiveConfig(),
                        *, pad_rows: Optional[int] = None, device=None) -> StripeArchive:
    """Entropy-code + seal pre-encoded payloads as one parity stripe.

    flats: S flat int8 payloads; manifests: S dicts, each with ``"n_i8"``.
    The entropy stage runs first (``"rans"``: one encode launch), then the
    per-shard KEM (ring products on the polymul kernel), then one
    stripe-kernel launch seals all shards.  ``pad_rows`` is the caller's row
    bucket for the RAW payloads; an entropy codec re-buckets it on the
    compressed sizes.
    """
    device = resolve_device(device)
    pub = _pub_on(pub, device)
    flats, emetas = entropy_encode_payloads(as_payload_list(flats, device), cfg)
    manifests = [dict(m, entropy=em) for m, em in zip(manifests, emetas)]
    if cfg.codec_name != "none" and pad_rows is not None:
        pad_rows = seal_ops.bucket_rows_for(max(-(-int(f.shape[0]) // 4) for f in flats))
    mats = [encapsulate_session(pub, generator, cfg.rlwe) for _ in flats]
    stripe = seal_ops.seal_stripe(
        flats,
        _stack_u32([m.session for m in mats]),
        _stack_u32([m.nonce for m in mats]),
        parity=cfg.parity,
        pad_rows=pad_rows,
        device=device,
    )
    return _assemble_stripe(stripe, mats, manifests)


def seal_payload_stripes_dispatch(pub: rlwe.PublicKey, stripes: List[List[torch.Tensor]],
                                  manifests: List[List[Dict]],
                                  generators: List[torch.Generator],
                                  cfg: ArchiveConfig = ArchiveConfig(), *,
                                  pad_rows=None, device=None) -> PendingStripeSeal:
    """Dispatch half of ``seal_payload_stripes``: KEM, staging and one seal
    launch per stripe, queued on the card's stream without a sync."""
    n = len(stripes)
    if not (n == len(manifests) == len(generators)):
        raise ValueError(f"{n} stripes vs {len(manifests)} manifests / "
                         f"{len(generators)} generators")
    pr_list = list(pad_rows) if isinstance(pad_rows, (list, tuple)) else [pad_rows] * n
    return PendingStripeSeal([
        seal_payload_stripe(pub, f, m, g, cfg, pad_rows=pr, device=device)
        for f, m, g, pr in zip(stripes, manifests, generators, pr_list)
    ])


def seal_payload_stripes_finalize(pending: PendingStripeSeal) -> List[StripeArchive]:
    """Finalize half: the assembled archives."""
    return pending.archives


def seal_payload_stripes(pub: rlwe.PublicKey, stripes: List[List[torch.Tensor]],
                         manifests: List[List[Dict]], generators: List[torch.Generator],
                         cfg: ArchiveConfig = ArchiveConfig(), *, pad_rows=None,
                         device=None) -> List[StripeArchive]:
    """Seal K stripes: ``pad_rows`` is None, an int, or one per stripe.
    Exactly ``finalize(dispatch(...))``."""
    return seal_payload_stripes_finalize(seal_payload_stripes_dispatch(
        pub, stripes, manifests, generators, cfg, pad_rows=pad_rows, device=device))


# -------------------------------------------------------------------- read
def _stack_bodies(bodies: Sequence[torch.Tensor], words: int, device) -> torch.Tensor:
    """Flat u32 bodies zero-padded to ``words`` each -> (S, words) uint32."""
    out = torch.zeros((len(bodies), words), dtype=torch.int32, device=device)
    for j, b in enumerate(bodies):
        out[j, : b.shape[0]] = as_tensor(b, torch.uint32, device).view(torch.int32)
    return out.view(torch.uint32)


def _stripe_rows(bodies: Sequence[torch.Tensor], words: int, device) -> torch.Tensor:
    """Bodies stacked in the kernel's (S, R, 128) geometry, ``words = R * 128``."""
    return _stack_bodies(bodies, words, device).reshape(len(bodies), -1, seal_ops.LANES)


def _parity_matches(got: torch.Tensor, want) -> bool:
    """Recomputed vs stored strip; zero tails of different lengths agree."""
    got_u8 = _u32_rows_to_u8(got)
    want_u8 = as_tensor(want, torch.uint8, got.device).reshape(-1)
    n = min(got_u8.numel(), want_u8.numel())
    return (torch.equal(got_u8[:n], want_u8[:n])
            and not bool(got_u8[n:].any()) and not bool(want_u8[n:].any()))


def restore_stripe_payloads(s, stripe: StripeArchive, cfg: ArchiveConfig = ArchiveConfig(), *,
                            shards: Optional[Sequence[int]] = None,
                            verify_parity: bool = True,
                            manifests: Optional[List[Dict]] = None,
                            device=None):
    """Unseal + entropy-decode a stripe down to its payloads.

    Returns (flat int8 payloads, the blocks they came from) in ``shards``
    order.  ``shards=None`` reads the whole stripe and checks the
    recomputed P/Q against the stored strips (``ValueError`` on mismatch).
    ``shards=[...]`` reads only those shards' bodies, with their global ids,
    and skips the parity check (a subset cannot recompute it).  Entries of
    ``stripe.blocks`` may be ``None`` (lost shards): wanted lost shards are
    rebuilt from parity first, which needs the replicated records
    (``stripe_manifests`` format) in ``manifests``.
    """
    if not stripe.blocks:
        raise ValueError("stripe must contain at least one shard payload")
    device = resolve_device(device)
    S = len(stripe.blocks)
    subset = shards is not None
    wanted = list(range(S)) if shards is None else [int(i) for i in shards]
    if not wanted:
        raise ValueError("shard subset must name at least one shard")
    if len(set(wanted)) != len(wanted):
        raise ValueError(f"duplicate shard ids in {wanted}")
    if any(i < 0 or i >= S for i in wanted):
        raise ValueError(f"shard ids {wanted} out of range for S={S}")
    blocks = list(stripe.blocks)
    missing = [i for i, b in enumerate(blocks) if b is None]
    if any(i in missing for i in wanted):
        if stripe.parity is None:
            raise ValueError(
                f"shards {sorted(set(missing) & set(wanted))} are missing "
                "and the stripe has no parity to rebuild from")
        if manifests is None:
            raise ValueError(
                "degraded read needs the replicated metadata records "
                "(stripe_manifests format) for the missing shards")
        body_lens = [
            int(manifests[i]["n_words"]) if blocks[i] is None
            else int(blocks[i].sealed.n_valid_u32)
            for i in range(S)
        ]
        blocks = recover_stripe(blocks, stripe.parity, missing, manifests, body_lens,
                                device=device)
    sub = [blocks[i] for i in wanted]
    s = as_tensor(s, torch.int32, device)
    sessions = [
        rlwe.kem_decapsulate(s, rlwe.Ciphertext(as_tensor(b.sealed.kem_c1, torch.int32, device),
                                                as_tensor(b.sealed.kem_c2, torch.int32, device)),
                             cfg.rlwe)
        for b in sub
    ]
    nonces = [as_tensor(b.sealed.nonce, torch.uint32, device) for b in sub]
    n_words = tuple(int(b.sealed.body.shape[0]) for b in sub)
    emetas = [b.manifest.get("entropy", {"codec": "none"}) for b in sub]
    # bytes inside the sealed body: the compressed stream when an entropy
    # stage ran, the raw payload otherwise
    n_i8 = tuple(int(em.get("n_comp", b.manifest["n_i8"])) for b, em in zip(sub, emetas))
    R = seal_ops.pad_rows_for(max(n_words))
    packed = seal_ops.SealedStripe(
        _stripe_rows([b.sealed.body for b in sub], R * seal_ops.LANES, device),
        None, None, n_words, n_i8)
    # recompute parity in the mode the stripe was sealed with (the stored
    # parity dict is ground truth); a subset read cannot, so it runs "none"
    if subset or stripe.parity is None:
        parity_mode = "none"
    else:
        parity_mode = "raid6" if "q" in stripe.parity else "raid5"
    flats, p2, q2 = seal_ops.unseal_stripe(
        packed, _stack_u32(sessions), _stack_u32(nonces),
        parity=parity_mode, shard_ids=tuple(wanted), device=device)
    if not subset and verify_parity and stripe.parity is not None:
        for name, got in (("p", p2), ("q", q2)):
            want = stripe.parity.get(name)
            if want is not None and got is not None and not _parity_matches(got, want):
                raise ValueError(f"stripe parity mismatch on {name.upper()}")
    payloads = entropy_decode_payloads(
        [flats[j][: n_i8[j]] for j in range(len(sub))],
        [dict(em, codec=em.get("codec", "none")) for em in emetas],
    )
    return [p[: b.manifest["n_i8"]] for p, b in zip(payloads, sub)], sub


# ---------------------------------------------------------- metadata tier
def stripe_manifests(stripe: StripeArchive) -> List[Dict]:
    """Replicated-metadata records in the format ``recover_stripe`` and the
    degraded-read path expect (``n_words`` sizes a lost shard's body)."""
    return [
        {
            "kem_c1": b.sealed.kem_c1,
            "kem_c2": b.sealed.kem_c2,
            "nonce": b.sealed.nonce,
            "manifest": b.manifest,
            "n_words": int(b.sealed.n_valid_u32),
        }
        for b in stripe.blocks
    ]


def stripe_manifests_to_json(manifests: List[Dict]) -> List[Dict]:
    """JSON-able form of ``stripe_manifests`` records (the reference's format)."""
    return [
        {
            "kem_c1": m["kem_c1"].cpu().numpy().tolist(),
            "kem_c2": m["kem_c2"].cpu().numpy().tolist(),
            "nonce": m["nonce"].cpu().numpy().tolist(),
            "manifest": m["manifest"],
            "n_words": int(m["n_words"]),
        }
        for m in manifests
    ]


def stripe_manifests_from_json(data: List[Dict], *, device=None) -> List[Dict]:
    """Invert ``stripe_manifests_to_json``, tensors on ``device``."""
    device = resolve_device(device)
    return [
        {
            "kem_c1": torch.tensor(m["kem_c1"], dtype=torch.int32, device=device),
            "kem_c2": torch.tensor(m["kem_c2"], dtype=torch.int32, device=device),
            "nonce": as_tensor(np.asarray(m["nonce"], np.uint32), torch.uint32, device),
            "manifest": m["manifest"],
            "n_words": int(m["n_words"]),
        }
        for m in data
    ]


# ------------------------------------------------------------- parity tier
def _bodies_u8(blocks: List[ArchivedBlock], pad_to: int, device) -> torch.Tensor:
    """Sealed bodies zero-padded to ``pad_to`` words -> (S, pad_to*4) uint8."""
    return _stack_bodies([b.sealed.body for b in blocks], pad_to, device).view(torch.uint8)


def stripe_parity(blocks: List[ArchivedBlock], mode: str = "raid6", *, device=None):
    """Parity over the sealed bodies of one stripe (S storage shards)."""
    if mode == "none":
        return None
    device = resolve_device(device)
    pad_to = max(int(b.sealed.body.shape[0]) for b in blocks)
    data = _bodies_u8(blocks, pad_to, device)
    if mode == "raid5":
        return {"p": raid.raid5_encode(data), "pad_to": pad_to}
    p, q = raid.raid6_encode(data)
    return {"p": p, "q": q, "pad_to": pad_to}


def recover_stripe(blocks: List[Optional[ArchivedBlock]], parity: Dict, missing: List[int],
                   manifests: List[Dict], body_lens: List[int], *, stripe_id: str = "",
                   device=None) -> List[ArchivedBlock]:
    """Rebuild missing shards' sealed bodies from parity.

    Parity protects the bodies; KEM polys and nonces are tiny and replicated
    in the manifest tier.  ``stripe_id`` names the stripe in errors.
    """
    device = resolve_device(device)
    pad_to = int(parity["pad_to"])
    mode = "raid6" if "q" in parity else "raid5"
    rows: List[Optional[torch.Tensor]] = [
        None if b is None else _bodies_u8([b], pad_to, device)[0] for b in blocks
    ]
    p = as_tensor(parity["p"], torch.uint8, device)
    if mode == "raid6":
        full = raid.raid6_reconstruct(rows, p, as_tensor(parity["q"], torch.uint8, device),
                                      missing)
    else:
        if len(missing) != 1:
            which = f"stripe {stripe_id!r}" if stripe_id else "stripe"
            raise ValueError(
                f"{which}: RAID-5 parity covers exactly 1 erasure but shards "
                f"{sorted(missing)} are missing — data is unrecoverable "
                "without a RAID-6 Q strip or a replica")
        full = list(rows)
        full[missing[0]] = raid.raid5_reconstruct(rows, p, missing[0])
    out: List[ArchivedBlock] = []
    for i, b in enumerate(blocks):
        if b is not None:
            out.append(b)
            continue
        words = full[i].contiguous().view(torch.uint32)[: body_lens[i]]
        meta = manifests[i]
        sealed = SealedBlock(meta["kem_c1"], meta["kem_c2"], meta["nonce"], words, body_lens[i])
        out.append(ArchivedBlock(sealed, meta["manifest"]))
    return out


def recompute_stripe_parity(stripe: StripeArchive, *, device=None) -> Dict[str, np.ndarray]:
    """Recompute a sealed stripe's P/Q WITHOUT any key material.

    Parity is defined over the sealed bodies, so the scrubber drives the
    unseal kernel with all-zero keys and nonces: its decode is garbage, but
    the P/Q fold runs on the stored bodies and is exact.  Bodies are stacked
    at the seal-time geometry (``parity["pad_to"]`` words) so the strips
    align byte for byte with the stored ones.  Returns ``{"p": u8, "q"?: u8}``
    as numpy (syndromes are small and leave the device).
    """
    parity = stripe.parity
    if parity is None:
        raise ValueError("stripe has no parity strips to recompute")
    if any(b is None for b in stripe.blocks):
        raise ValueError(
            "parity recompute needs every shard body present; rebuild "
            "missing shards first (recover_stripe)")
    device = resolve_device(device)
    S = len(stripe.blocks)
    pad_to = int(parity["pad_to"])
    n_words = tuple(int(b.sealed.body.shape[0]) for b in stripe.blocks)
    if max(n_words) > pad_to:
        raise ValueError(f"shard body of {max(n_words)} words exceeds the stripe's "
                         f"seal-time pad_to={pad_to}")
    packed = seal_ops.SealedStripe(
        _stripe_rows([b.sealed.body for b in stripe.blocks], pad_to, device),
        None, None, n_words, n_words)
    mode = "raid6" if "q" in parity else "raid5"
    _, p2, q2 = seal_ops.unseal_stripe(
        packed, torch.zeros((S, 8), dtype=torch.uint32, device=device),
        torch.zeros((S, 3), dtype=torch.uint32, device=device), parity=mode, device=device)
    out = {"p": _u32_rows_to_u8(p2).cpu().numpy()}
    if q2 is not None:
        out["q"] = _u32_rows_to_u8(q2).cpu().numpy()
    return out
