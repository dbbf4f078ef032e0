"""Public wrappers for the interleaved-rANS entropy stage: padding, dispatch,
stream packing and parsing.

Port of ``repro.kernels.entropy.ops``.  ``encode_payloads`` pads ragged
shard payloads to the coder's (T, 128) lane grid (T pow2-bucketed by
``rows_for``), runs one encode launch per stripe and packs each shard into a
self-contained byte stream:

    [freq table: 256 x u16][lane lengths: 128 x u32][lane states: 128 x u32]
    [16-bit words in decoder-read order (row-major across lanes)]

``n_comp`` counts the 1536-byte header.  A shard whose stream would not be
smaller than its raw bytes is stored raw and flagged so in its meta.
``decode_payloads`` dispatches on the recorded stream ``version`` (absent
means 0, the older lane-major word order) and decodes only the coded shards,
in one launch.  The pack and the parse are plain PyTorch around the kernels,
as the reference keeps them in jnp outside Pallas.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import as_payload_list, as_tensor, resolve_device
from repro_torch.kernels.entropy.rans import (
    rans_decode_kernel,
    rans_decode_v0_kernel,
    rans_encode_kernel,
)
from repro_torch.kernels.entropy.ref import N_LANES, STREAM_VERSION, T_TILE

__all__ = [
    "HEADER_BYTES",
    "MAX_ROWS",
    "rows_for",
    "stream_word_cap",
    "encode_payloads",
    "decode_payloads",
    "entropy_traffic",
]

# freq u16[256] + lane_lens u32[128] + states u32[128]
HEADER_BYTES = 2 * 256 + 4 * N_LANES + 4 * N_LANES
# 2^17 lane rows = 16 MiB per shard, the largest shard a stripe takes
MAX_ROWS = 1 << 17

# one entry per full-payload pass of the chained coder (the reference's
# staged passes; the fused write of the next slice does all in one launch)
STAGED_PASSES = (
    "histogram (read payload)",
    "table build: freqs (256-entry, table-only)",
    "interleaved encode (read payload, write words + mask)",
    "emission compaction (read words + mask, write stream)",
)


def rows_for(n_bytes: int) -> int:
    """Smallest pow2 multiple of ``T_TILE`` lane rows covering n_bytes."""
    rows = max(1, -(-n_bytes // N_LANES))
    tiles = -(-rows // T_TILE)
    return T_TILE * (1 << (tiles - 1).bit_length())


def stream_word_cap(T: int) -> int:
    """Most u16 stream words a T-row shard can store coded: a shard that
    emits more compresses to at least its raw size and is stored raw."""
    return max(1, (T * N_LANES - HEADER_BYTES) // 2)


def _stage_codes(flats: Sequence[torch.Tensor], T: int) -> torch.Tensor:
    """Ragged int8 payloads zero-padded to (S, T, 128)."""
    codes = torch.zeros((len(flats), T * N_LANES), dtype=torch.int8, device=flats[0].device)
    for s, f in enumerate(flats):
        codes[s, : f.shape[0]] = f
    return codes.reshape(len(flats), T, N_LANES)


def _compact(words: torch.Tensor, mask: torch.Tensor, total: int) -> torch.Tensor:
    """The emitted words of every shard, each shard's in row-major order
    (row ascending, lanes in order), shards back to back: (total,) int16.
    One flat scan and one scatter on the device: each emitted word goes to
    its rank over the whole stripe, the others to a spare slot past the end."""
    m = mask.reshape(-1)
    dest = torch.where(m.bool(), m.cumsum(0) - 1, total)
    out = torch.empty(total + 1, dtype=torch.int16, device=words.device)
    return out.scatter_(0, dest, words.reshape(-1))[:total]


def _headers(freq: torch.Tensor, lane_lens: torch.Tensor, states: torch.Tensor) -> torch.Tensor:
    """(S, 1536) int8 stream headers, little-endian: freq as u16, lane
    lengths and final states as u32."""
    return torch.cat([freq.to(torch.int16).view(torch.int8), lane_lens.view(torch.int8),
                      states.view(torch.int8)], dim=1)


def encode_payloads(payloads, *, device=None) -> Tuple[List[torch.Tensor], List[Dict]]:
    """rANS-encode S ragged shard payloads in one launch.

    payloads: list of flat int8 arrays (ragged ok) or an (S, N) int8 array.
    Returns (int8 streams of exact length, header included, on ``device``;
    raw shards pass their payload through) and per-shard metas
    ``{"codec", "version", ["raw",] "n_raw", "n_comp", "rows"}``: ``rows``
    is the lane-row count the whole stripe was coded at, which decode needs
    back.  One device-to-host copy per stripe fetches the word counts that
    the raw-skip rule and the metas need.
    """
    device = resolve_device(device)
    flats = as_payload_list(payloads, device)
    if not flats:
        raise ValueError("stripe must contain at least one shard payload")
    n_raw = [int(f.shape[0]) for f in flats]
    T = rows_for(max(n_raw))
    if T > MAX_ROWS:
        raise ValueError(
            f"payload of {max(n_raw)} bytes needs {T} lane rows (max "
            f"{MAX_ROWS}); split it across more stripe shards")
    n_valid = torch.tensor(n_raw, dtype=torch.int32).reshape(-1, 1).to(device)
    words, mask, freq, states = rans_encode_kernel(_stage_codes(flats, T), n_valid)
    lane_lens = mask.sum(1, dtype=torch.int32)
    n_words = lane_lens.sum(1).tolist()  # the one device-to-host copy
    comp_words = _compact(words, mask, sum(n_words)).view(torch.int8)
    headers = _headers(freq, lane_lens, states)
    comps, metas, off = [], [], 0
    for s, (nr, nw) in enumerate(zip(n_raw, n_words)):
        nc = HEADER_BYTES + 2 * nw
        if nc >= nr:
            # raw-skip: an incompressible shard, or one smaller than the
            # header, is stored as it is; decode dispatches on the flag
            comps.append(flats[s])
            metas.append({"codec": "rans", "version": STREAM_VERSION, "raw": True,
                          "n_raw": nr, "n_comp": nr, "rows": T})
        else:
            comps.append(torch.cat([headers[s], comp_words[2 * off: 2 * (off + nw)]]))
            metas.append({"codec": "rans", "version": STREAM_VERSION,
                          "n_raw": nr, "n_comp": nc, "rows": T})
        off += nw
    return comps, metas


def _stack_streams(flats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Coded streams zero-padded to one width (S, C) int8: the word area
    even and at least one word long (tails are never read)."""
    C = max(max(int(f.shape[0]) for f in flats), HEADER_BYTES + 2)
    C += (C - HEADER_BYTES) % 2
    comp = torch.zeros((len(flats), C), dtype=torch.int8, device=flats[0].device)
    for j, f in enumerate(flats):
        comp[j, : f.shape[0]] = f
    return comp


def _field(comp: torch.Tensor, start: int, stop: int, dtype: torch.dtype) -> torch.Tensor:
    """Bytes [start, stop) of every row of (S, C) int8 streams, as ``dtype``."""
    return comp[:, start:stop].clone(memory_format=torch.contiguous_format).view(dtype)


def _parse(comp: torch.Tensor):
    """(S, C) int8 padded streams -> (freq, lane_lens, states, word stream)."""
    freq = _field(comp, 0, 512, torch.int16).to(torch.int32) & 0xFFFF
    return (freq, _field(comp, 512, 1024, torch.int32),
            _field(comp, 1024, HEADER_BYTES, torch.int32),
            _field(comp, HEADER_BYTES, comp.shape[1], torch.int16))


def decode_payloads(comps: Sequence, metas: Sequence[Dict], *, device=None) -> List[torch.Tensor]:
    """Compressed streams + metas -> the exact original int8 payloads.

    Shards flagged ``raw`` pass through; the coded shards are decoded in one
    launch at the stripe's recorded ``rows``, by the decoder of their
    recorded ``version`` (absent = 0).
    """
    if len(comps) != len(metas):
        raise ValueError(f"{len(comps)} streams vs {len(metas)} metas")
    if not comps:
        raise ValueError("stripe must contain at least one shard payload")
    T = int(metas[0]["rows"])
    if any(int(m["rows"]) != T for m in metas):
        raise ValueError("all shards of a stripe share one padded row count")
    device = resolve_device(device)
    flats = [as_tensor(c, torch.int8, device).reshape(-1) for c in comps]
    out: List = [None] * len(flats)
    coded = []
    for i, (f, m) in enumerate(zip(flats, metas)):
        if int(f.shape[0]) != int(m["n_comp"]):
            raise ValueError(f"stream is {int(f.shape[0])} bytes, manifest says {m['n_comp']}")
        if m.get("raw"):
            if int(m["n_comp"]) != int(m["n_raw"]):
                raise ValueError(
                    f"raw-skip shard must store n_raw bytes, manifest says "
                    f"{m['n_comp']} vs {m['n_raw']}")
            out[i] = f
            continue
        if int(f.shape[0]) < HEADER_BYTES:
            raise ValueError("compressed stream shorter than its header")
        coded.append(i)
    if not coded:
        return out
    versions = {int(metas[i].get("version", 0)) for i in coded}
    if len(versions) != 1:
        raise ValueError(f"stripe mixes stream versions {sorted(versions)}")
    version = versions.pop()
    if T <= 0 or T % T_TILE:
        raise ValueError(f"rows {T} not a multiple of {T_TILE}")
    freq, lane_lens, states, stream = _parse(_stack_streams([flats[i] for i in coded]))
    n_valid = torch.tensor([int(metas[i]["n_raw"]) for i in coded],
                           dtype=torch.int32).reshape(-1, 1).to(device)
    if version == 0:
        codes = rans_decode_v0_kernel(stream, lane_lens, freq, states, n_valid, rows=T)
    else:
        codes = rans_decode_kernel(stream, freq, states, n_valid, rows=T)
    for j, i in enumerate(coded):
        out[i] = codes[j].reshape(-1)[: int(metas[i]["n_raw"])]
    return out


def entropy_traffic(n_raw: int, n_comp: int) -> dict:
    """Structural byte accounting of the on-device coder: the payload never
    crosses to the host, only O(1) manifest integers do."""
    return {
        "ratio": n_raw / n_comp if n_comp else float("nan"),
        "host_entropy_bytes": 0,
        "host_bytes_eliminated": n_raw,
        "staged_passes": len(STAGED_PASSES),
        "fused_launches": 1,
    }
