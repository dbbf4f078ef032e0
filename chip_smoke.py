#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA sources in ``src/repro_torch/csrc`` (one nvcc each, all
   started together) and prints the build seconds.
2. Holds every kernel against its plain PyTorch version on the card, bit for
   bit, at the shapes the archive gives it: seal (raid6, raid5, none), unseal
   (full, subset with global shard ids, zero keys), the KEM's ring multiply,
   and the rANS coder: encode on a full-size stripe (T = 8192 rows) and on
   edge shards (n_valid = 0, exactly full, one symbol, all 256 symbols,
   uniform bytes), v1 decode of the same streams, v0 decode of the golden
   fixture ``tests/data_rans_v0.json`` and of the full-size streams re-laid
   lane-major.  The plain versions and the kernels are timed back to back
   (CUDA events, inputs rotated past the 50 MB L2).  A small stripe sealed
   on the card, with codec ``none`` and with ``rans``, must equal the same
   stripe sealed on the CPU from the same seed.
3. Drives the archive through its entry points at an edge server's size:
   K = 64 RAID-6 stripes of S = 8 shards, each shard one GOP of int8 codes
   drawn as a quantised Laplacian, ragged between 256 KiB and 1 MiB (about
   331 MB), twice:
   - the rANS main path (``ArchiveConfig()``, codec ``rans``): seal (rANS
     encode, KEM, seal), full restore with the parity check (byte-exact
     against the inputs), a 2-shard subset read of every stripe, a degraded
     read with shards {1, 5} lost on 8 stripes, a zero-key scrub of every
     stripe with one injected bit flip that must be detected and located,
     and the restore of 4 stripes whose streams are version 0;
   - the PR-12 path with codec ``none`` (the same phases), then a smaller
     zlib phase.
   The launch counters are zeroed just before each path and read just
   after, and every kernel of the path must have run.
4. Times the seal, unseal and polymul kernels' own device time from the
   profiler's trace, and traces sealing and restoring 4 stripes with each
   codec: the device's busy and idle share and its top kernels.  Both run
   last, because the profiler slows every later launch on the host.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line; without a CUDA device it exits 2.
"""

from __future__ import annotations

import base64
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.archival import pipeline, raid  # noqa: E402
from repro_torch.core.crypto import rlwe  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.entropy import ops as entropy_ops  # noqa: E402
from repro_torch.kernels.entropy import ref as rans_ref  # noqa: E402
from repro_torch.kernels.entropy.rans import (  # noqa: E402
    rans_decode_kernel,
    rans_decode_v0_kernel,
    rans_encode_kernel,
)
from repro_torch.kernels.polymul import ref as poly_ref  # noqa: E402
from repro_torch.kernels.polymul.polymul import negacyclic_matmul  # noqa: E402
from repro_torch.kernels.seal import ops as seal_ops  # noqa: E402
from repro_torch.kernels.seal import ref as seal_ref  # noqa: E402
from repro_torch.kernels.seal.seal import seal_stripe_kernel, unseal_stripe_kernel  # noqa: E402

SEED = 0
S = 8                        # shards per RAID-6 stripe
K = 64                       # stripes in the seal batch
SHARD_MIN, SHARD_MAX = 256 << 10, 1 << 20
DEGRADED_STRIPES, LOST = 8, (1, 5)
V0_STRIPES = 4               # rANS stripes restored from version-0 streams
ZLIB_K, ZLIB_MAX = 4, 256 << 10
LAPLACE_SCALE = 6.0

# H100 SXM roofs: HBM3 rate from NVIDIA's data sheet; INT32 issue rate is
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost (half the FP32 lanes behind the
# data sheet's 67 TFLOP/s FP32).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SM_CLOCK_HZ = 1.98e9

# rANS int32 operations per valid symbol.  The u32 divide of the encode step
# is counted as the 15 instructions nvcc compiles it to (cuobjdump -sass of
# the built library: I2F, MUFU.RCP, F2I, 3 IMAD.HI/IMAD, 2 corrections);
# the rest is counted from the algorithm.  Encode: byte extract + shared
# atomic for the histogram, table lookup, renorm test (shift, compare) and
# shift (2), divide (15), x + q * (M - f) + cum (3).  v1 decode: slot mask,
# table lookup, f/symbol extract (2), x >> 12, multiply-add, renorm compare,
# ballot + popc + lane mask (3), warp-total adds (4), word fetch, shift-or
# (2), signed byte (2).  v0 decode: the same without the ballot and warp
# totals, plus the pointer's clamp and increment (3).
RANS_OPS_PER_SYMBOL = {"rans_encode": 25, "rans_decode": 19, "rans_decode_v0": 15}
# per-shard table builds: freq table and encode table (encode), decode table
# over 4096 slots with its running max (decodes)
RANS_OPS_PER_SHARD = {"rans_encode": 256 * 24, "rans_decode": 4096 * 5 + 256 * 6,
                      "rans_decode_v0": 4096 * 5 + 256 * 6}
# dependent latency of one step on a lane's state, in SM cycles (the serial
# floor: T such steps one after another, S * 128 threads in the launch),
# estimated from the chain in the SASS: encode compare, select and the
# divide's state-dependent half (~10 instructions at ~4.5 cycles); v1 decode
# the table lookup, the multiply-add, ballot, barrier, the warp totals and
# the ring read (~150 cycles); v0 the lookup, multiply-add and a load that
# mostly hits L1 (~120 cycles)
RANS_STEP_CYCLES = {"rans_encode": 45, "rans_decode": 150, "rans_decode_v0": 120}

CUDA_EVENT = torch.autograd.DeviceType.CUDA  # profiler entries that are device kernels

SOURCES = {
    "seal": ("src/repro_torch/csrc/seal.cu", "src/repro/kernels/seal/seal.py:140"),
    "unseal": ("src/repro_torch/csrc/seal.cu", "src/repro/kernels/seal/seal.py:173"),
    "polymul": ("src/repro_torch/csrc/polymul.cu", "src/repro/kernels/polymul/polymul.py:45"),
    "rans_encode": ("src/repro_torch/csrc/rans.cu", "src/repro/kernels/entropy/rans.py:533"),
    "rans_decode": ("src/repro_torch/csrc/rans.cu", "src/repro/kernels/entropy/rans.py:548"),
    "rans_decode_v0": ("src/repro_torch/csrc/rans.cu", "src/repro/kernels/entropy/rans.py:598"),
}
GOLDEN_V0 = ROOT / "tests" / "data_rans_v0.json"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32) if a.dtype == torch.uint32 else a,
        b.view(torch.int32) if b.dtype == torch.uint32 else b)


def rows_of(t: torch.Tensor, ids) -> torch.Tensor:
    """t[ids] along dim 0 (CUDA has no indexing kernel for uint32)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32)[list(ids)].contiguous().view(torch.uint32)
    return t[list(ids)].contiguous()


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        if a is None:
            continue
        diff = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
        err = max(err, float(diff))
    return err


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: str) -> float:
    """Per-launch device time of the CUDA kernel whose name contains
    ``kernel``, from the profiler's CUPTI trace: the kernel's own time,
    without the host's launch overhead between launches."""
    fn(0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == CUDA_EVENT and kernel in e.key]
    count = sum(e.count for e in evs)
    check(count == reps, f"profiler saw {count} launches of {kernel}, expected {reps}")
    return sum(e.self_device_time_total for e in evs) / count / 1e3


def laplace_codes(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """Quantised Laplacian int8 codes, the shape of a codec's latents."""
    u = torch.rand(n, generator=gen, device=dev) - 0.5
    x = -LAPLACE_SCALE * torch.sign(u) * torch.log1p(-2 * u.abs())
    return x.round().clamp(-127, 127).to(torch.int8)


def make_stripes(k: int, lo: int, hi: int, seed: int, dev):
    lens = torch.randint(lo, hi + 1, (k, S), generator=torch.Generator().manual_seed(seed))
    total = int(lens.sum())
    data = laplace_codes(total, torch.Generator(device=dev).manual_seed(seed), dev)
    stripes, manifests, off = [], [], 0
    for row in lens.tolist():
        flats = []
        for n in row:
            flats.append(data[off: off + n])
            off += n
        stripes.append(flats)
        manifests.append([{"n_i8": n, "gop": i} for i, n in enumerate(row)])
    return stripes, manifests, total


# ------------------------------------------------------------- bounds
def stripe_bound(seal: bool, R: int, n_words, coefs, with_p: bool, with_q: bool):
    """(bound_ms, bound_by) of one stripe launch: bytes each way vs int32 ops,
    counted for this stripe's ragged shards (``n_words`` valid words each,
    padded to R rows of 128 words).  Only the valid words need a keystream
    and an XOR; the seal's padding seals to 0 and folds nothing into P/Q,
    while the unseal folds every stored word."""
    S_, words = len(n_words), len(n_words) * R * 128
    n_par = int(with_p) + int(with_q)
    valid = sum(n_words)
    read = valid if seal else words                # seal reads only the valid codes
    nbytes = 4 * read + 4 * words + 4 * R * 128 * n_par + S_ * 13 * 4
    ops = sum(-(-n // 16) for n in n_words) * (20 * 4 * 12 + 16)  # ChaCha20 + feed-forward
    ops += valid                                   # XOR with the keystream
    folded = [n if seal else R * 128 for n in n_words]
    if with_p:
        ops += sum(folded)
    if with_q:                                     # SWAR GF multiply by g^s: 5 ops per
        ops += sum(m * (5 * (int(c).bit_length() - 1) + bin(int(c)).count("1"))
                   for m, c in zip(folded, coefs))  # xtime step, 1 XOR per set bit
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def polymul_bound(n: int, batch: int):
    nbytes = 4 * n + 8 * n * batch
    ops = 2 * n * n * batch
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rans_bound(name: str, n_valid, n_words, T: int):
    """(bound_ms, bound_by, serial floor ms, what was counted) of one rANS
    launch over shards with ``n_valid`` valid bytes and ``n_words`` emitted
    words each, padded to T rows.  Bytes: the encode reads the valid codes and writes its dense
    outputs (words, mask: 3 bytes a position) with the tables and states; a
    decode reads the emitted words with the header tables and writes its
    dense (S, T, 128) codes.  Operations: per valid symbol and per shard,
    ``RANS_OPS_PER_SYMBOL`` / ``RANS_OPS_PER_SHARD``.  The serial floor is T
    dependent steps of ``RANS_STEP_CYCLES`` each."""
    S_, pos = len(n_valid), len(n_valid) * T * 128
    header = 256 * 4 + 128 * 4 + 4                   # freq, states, n_valid per shard
    if name == "rans_encode":
        nbytes = sum(n_valid) + 3 * pos + S_ * header
    else:
        nbytes = 2 * sum(n_words) + S_ * header + pos
        if name == "rans_decode_v0":
            nbytes += S_ * 128 * 4                    # lane lengths
    ops = RANS_OPS_PER_SYMBOL[name] * sum(n_valid) + RANS_OPS_PER_SHARD[name] * S_
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    floor_ms = T * RANS_STEP_CYCLES[name] / SM_CLOCK_HZ * 1e3
    detail = (f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M ops over {sum(n_valid)} valid "
              f"symbols, {sum(n_words)} words")
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"),
            floor_ms, detail)


def row_major_streams(words: torch.Tensor, mask: torch.Tensor):
    """Version-1 streams from the dense encode: each shard's emitted words
    row by row, lanes in order -> ((S, W) int16, n_words), W = max + 1."""
    m = mask.bool()
    n_words = m.sum((1, 2)).tolist()
    out = torch.zeros((len(n_words), max(n_words) + 1), dtype=torch.int16, device=words.device)
    for s_, n in enumerate(n_words):
        out[s_, :n] = words[s_][m[s_]]
    return out, n_words


def lane_major_streams(words: torch.Tensor, mask: torch.Tensor):
    """Version-0 streams of the same encode, as the older format lays them:
    each lane's words in row order, lane after lane -> ((S, W) int16, lane
    lengths (S, 128) int32).  The package has no v0 encoder; this helper
    re-lays a v1 encoding for the checks."""
    m = mask.bool()
    n_words = m.sum((1, 2)).tolist()
    out = torch.zeros((len(n_words), max(n_words) + 1), dtype=torch.int16, device=words.device)
    for s_, n in enumerate(n_words):
        out[s_, :n] = words[s_].t()[m[s_].t()]
    return out, mask.sum(1, dtype=torch.int32)


# ------------------------------------------------------------- phase 1
def phase_kernels(dev):
    """Each kernel against its plain version on the card, at path shapes."""
    stripes, _, _ = make_stripes(1, SHARD_MIN, SHARD_MAX, SEED + 7, dev)
    flats = stripes[0]
    g = torch.Generator().manual_seed(SEED + 8)
    keys = torch.randint(0, 2**32, (S, 8), generator=g).to(torch.uint32).to(dev)
    nonces = torch.randint(0, 2**31 - 1, (S, 3), generator=g).to(torch.uint32).to(dev)
    codes, n_words, _ = seal_ops._stack_padded(flats)
    meta = seal_ops._meta_arrays(keys, nonces, n_words, dev)
    R = codes.shape[1]
    coefs = meta[3].to(torch.int64).reshape(-1).tolist()
    out, errs = {}, {"seal": [], "unseal": [], "polymul": []}

    for parity in ("raid6", "raid5", "none"):
        got = seal_stripe_kernel(codes, *meta, parity=parity)
        want = seal_ref.seal_stripe_ref(codes, *meta, parity=parity)
        torch.cuda.synchronize()
        check(all(same(a, b) for a, b in zip(got, want)), f"seal {parity} exact")
        errs["seal"] += list(zip(got, want))
        print(f"kernel seal[{parity}] S={S} R={R}: exact")
    sealed = seal_stripe_kernel(codes, *meta, parity="raid6")

    ids = (2, 6)
    sub = rows_of(sealed[0], ids)
    sub_meta = seal_ops._meta_arrays(rows_of(keys, ids), rows_of(nonces, ids),
                                     [n_words[i] for i in ids], dev, ids)
    zero_meta = (torch.zeros((S, 8), dtype=torch.uint32, device=dev),
                 torch.zeros((S, 3), dtype=torch.uint32, device=dev), meta[2], meta[3])
    for label, args, parity in (("full", (sealed[0], *meta), "raid6"),
                                ("subset(2,6)", (sub, *sub_meta), "none"),
                                ("zero-key", (sealed[0], *zero_meta), "raid6")):
        got = unseal_stripe_kernel(*args, parity=parity)
        want = seal_ref.unseal_stripe_ref(*args, parity=parity)
        torch.cuda.synchronize()
        check(all(same(a, b) for a, b in zip(got, want)), f"unseal {label} exact")
        errs["unseal"] += list(zip(got, want))
        print(f"kernel unseal[{label}]: exact")
    check(same(unseal_stripe_kernel(sealed[0], *zero_meta)[1], sealed[1]),
          "zero-key parity equals the seal's")
    check(all(same(unseal_stripe_kernel(sealed[0], *meta, parity="none")[0][i].reshape(-1)
                   [: flats[i].shape[0]], flats[i]) for i in range(S)), "unseal decodes")

    q = rlwe.RLWEParams().q
    n = rlwe.RLWEParams().n
    a = torch.randint(0, q, (n,), generator=g, dtype=torch.int32).to(dev)
    for batch in (1, 8):
        vecs = torch.randint(0, q, (batch, n), generator=g, dtype=torch.int32).to(dev)
        got = negacyclic_matmul(a, vecs, q)
        want = poly_ref.negacyclic_matmul_ref(a, vecs, q)
        torch.cuda.synchronize()
        check(same(got, want), f"polymul B={batch} exact")
        errs["polymul"].append((got, want))
        print(f"kernel polymul n={n} B={batch}: exact")

    # timings at the path's shapes; the seal/unseal inputs rotate over 10
    # copies (68 MB at R = 1656, more than the 50 MB of L2), as a batch of
    # fresh stripes would
    n_rot = 10
    codes_rot = [codes.clone() for _ in range(n_rot)]
    sealed_rot = [sealed[0].clone() for _ in range(n_rot)]
    vec1 = torch.randint(0, q, (1, n), generator=g, dtype=torch.int32).to(dev)
    timings = {
        "seal": ("stripe_kernel",
                 lambda i: seal_stripe_kernel(codes_rot[i % n_rot], *meta),
                 lambda i: seal_ref.seal_stripe_ref(codes_rot[i % n_rot], *meta),
                 stripe_bound(True, R, n_words, coefs, True, True)),
        "unseal": ("stripe_kernel",
                   lambda i: unseal_stripe_kernel(sealed_rot[i % n_rot], *meta),
                   lambda i: seal_ref.unseal_stripe_ref(sealed_rot[i % n_rot], *meta),
                   stripe_bound(False, R, n_words, coefs, True, True)),
        "polymul": ("negacyclic_kernel",
                    lambda i: negacyclic_matmul(a, vec1, q),
                    lambda i: poly_ref.negacyclic_matmul_ref(a, vec1, q),
                    polymul_bound(n, 1)),
    }
    for name, (kname, kern, plain, (bound_ms, bound_by)) in timings.items():
        out[name] = {"max_abs_err": max_abs_err(errs[name]),
                     "issue_ms": time_ms(kern, reps=50),
                     "plain_ms": time_ms(plain, reps=3, warmup=1),
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    return out, {name: (kname, kern) for name, (kname, kern, _, _) in timings.items()}


def phase_rans_kernels(dev):
    """The three rANS kernels against their plain versions on the card, bit
    for bit: encode (words, mask, freq and states in full) on a full-size
    path stripe and on an edge stripe at T = 8192, v1 decode of their
    streams, v0 decode of the golden fixture and of the same streams re-laid
    lane-major; every decode must also give back the input codes."""
    stripes, _, _ = make_stripes(1, SHARD_MIN, SHARD_MAX, SEED + 11, dev)
    path = stripes[0]
    T = entropy_ops.rows_for(max(int(f.shape[0]) for f in path))
    check(T == entropy_ops.rows_for(SHARD_MAX), f"the path stripe codes at the largest shard's "
          f"rows (got {T})")
    full = T * 128
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    all256 = laplace_codes(full, g, dev)
    all256[:256] = torch.arange(-128, 128, device=dev).to(torch.int8)
    edge = [torch.zeros(0, dtype=torch.int8, device=dev),            # n_valid = 0
            laplace_codes(full, g, dev),                              # exactly full
            torch.full((full,), -3, dtype=torch.int8, device=dev),   # one symbol
            all256,                                                   # all 256 symbols
            torch.randint(-128, 128, (full,), generator=g, device=dev,
                          dtype=torch.int8)]                         # uniform: goes raw
    errs = {"rans_encode": [], "rans_decode": [], "rans_decode_v0": []}
    runs = {}
    for label, flats in (("path", path), ("edge", edge)):
        codes = entropy_ops._stage_codes(flats, T)
        n_valid = torch.tensor([[f.shape[0]] for f in flats], dtype=torch.int32).to(dev)
        got = rans_encode_kernel(codes, n_valid)
        want = rans_ref.rans_encode_ref(codes, n_valid)
        torch.cuda.synchronize()
        check(all(same(a, b) for a, b in zip(got, want)), f"rans_encode {label} exact")
        errs["rans_encode"] += list(zip(got, want))
        print(f"kernel rans_encode[{label}] S={len(flats)} T={T}: exact")
        words, mask, freq, states = got
        stream, n_words = row_major_streams(words, mask)
        dec = rans_decode_kernel(stream, freq, states, n_valid, rows=T)
        want = rans_ref.rans_decode_ref(stream, freq, states, n_valid, rows=T)
        torch.cuda.synchronize()
        check(same(dec, want) and same(dec, codes), f"rans_decode {label} exact")
        errs["rans_decode"].append((dec, want))
        print(f"kernel rans_decode[{label}]: exact, equals the input codes")
        v0, lane_lens = lane_major_streams(words, mask)
        dec0 = rans_decode_v0_kernel(v0, lane_lens, freq, states, n_valid, rows=T)
        want = rans_ref.rans_decode_ref_v0(v0, lane_lens, freq, states, n_valid, rows=T)
        torch.cuda.synchronize()
        check(same(dec0, want) and same(dec0, codes), f"rans_decode_v0 {label} exact")
        errs["rans_decode_v0"].append((dec0, want))
        print(f"kernel rans_decode_v0[{label}, re-laid lane-major]: exact, equals the input codes")
        runs[label] = (codes, n_valid, stream, v0, lane_lens, freq, states, n_words)

    golden = json.loads(GOLDEN_V0.read_text())
    comps = [torch.tensor(list(base64.b64decode(b)), dtype=torch.uint8).view(torch.int8).to(dev)
             for b in golden["streams_b64"]]
    wants = [torch.tensor(list(base64.b64decode(b)), dtype=torch.uint8).view(torch.int8).to(dev)
             for b in golden["payloads_b64"]]
    got = entropy_ops.decode_payloads(comps, golden["metas"], device=dev)
    check(all(same(a, b) for a, b in zip(got, wants)), "golden v0 fixture decodes")
    coded = [i for i, m in enumerate(golden["metas"]) if not m.get("raw")]
    gfreq, glens, gstates, gstream = entropy_ops._parse(
        entropy_ops._stack_streams([comps[i] for i in coded]))
    gnv = torch.tensor([[golden["metas"][i]["n_raw"]] for i in coded], dtype=torch.int32).to(dev)
    gT = golden["metas"][0]["rows"]
    dec0 = rans_decode_v0_kernel(gstream, glens, gfreq, gstates, gnv, rows=gT)
    want = rans_ref.rans_decode_ref_v0(gstream, glens, gfreq, gstates, gnv, rows=gT)
    torch.cuda.synchronize()
    check(same(dec0, want), "rans_decode_v0 golden exact")
    errs["rans_decode_v0"].append((dec0, want))
    print(f"kernel rans_decode_v0[golden fixture, T={gT}]: exact, equals the recorded payloads")

    # timings on the path stripe; inputs rotate over copies that together
    # exceed the 50 MB L2 (codes 8 MiB, streams ~5 MB per stripe)
    codes, n_valid, stream, v0, lane_lens, freq, states, n_words = runs["path"]
    n_rot_codes = 8
    n_rot_stream = max(2, -(-60_000_000 // (2 * stream.numel())))
    codes_rot = [codes.clone() for _ in range(n_rot_codes)]
    stream_rot = [stream.clone() for _ in range(n_rot_stream)]
    v0_rot = [v0.clone() for _ in range(n_rot_stream)]
    nv = n_valid.reshape(-1).tolist()
    fns = {
        "rans_encode": (lambda i: rans_encode_kernel(codes_rot[i % n_rot_codes], n_valid),
                        lambda i: rans_ref.rans_encode_ref(codes, n_valid)),
        "rans_decode": (lambda i: rans_decode_kernel(stream_rot[i % n_rot_stream], freq, states,
                                                     n_valid, rows=T),
                        lambda i: rans_ref.rans_decode_ref(stream, freq, states, n_valid,
                                                           rows=T)),
        "rans_decode_v0": (lambda i: rans_decode_v0_kernel(v0_rot[i % n_rot_stream], lane_lens,
                                                           freq, states, n_valid, rows=T),
                           lambda i: rans_ref.rans_decode_ref_v0(v0, lane_lens, freq, states,
                                                                 n_valid, rows=T)),
    }
    out = {}
    for name, (kern, plain) in fns.items():
        bound_ms, bound_by, floor_ms, detail = rans_bound(name, nv, n_words, T)
        out[name] = {"max_abs_err": max_abs_err(errs[name]),
                     "ms": time_ms(kern, reps=20),
                     "plain_ms": time_ms(plain, reps=1, warmup=1),
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                     "floor_ms": floor_ms, "counted": detail}
    return out


def phase_device_times(stats, kernels, counts) -> None:
    """Each kernel's own device time from the profiler.  Runs after the main
    path: once CUPTI is attached, every launch in the process costs more on
    the host, which would inflate the main path's and the plain versions'
    times."""
    for name, (kname, kern) in kernels.items():
        st = stats[name]
        st["ms"] = device_ms(kern, 50, kname)
        exact = "exact" if st["max_abs_err"] == 0 else f"max_abs_err {st['max_abs_err']}"
        print(f"time {name}: {exact}, {counts[name]} launches on the main path, kernel "
              f"{st['ms']:.4f} ms on the device ({st.pop('issue_ms'):.4f} ms per call back "
              f"to back), plain {st['plain_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms "
              f"({st['bound_by']})")


def phase_card_vs_cpu(dev):
    """A small stripe sealed on the card equals the same stripe sealed on the
    CPU from the same seed, with codec none and with rANS, and both restore
    on the card."""
    stripes, manifests, _ = make_stripes(1, 3000, 9000, SEED + 9, dev)
    for codec in ("none", "rans"):
        cfg = pipeline.ArchiveConfig(codec_name=codec)
        archives = {}
        for where in (dev, torch.device("cpu")):
            g = torch.Generator().manual_seed(SEED + 10)
            pub, s = rlwe.keygen(g, device=where)
            flats = [f.to(where) for f in stripes[0]]
            archives[where.type] = (pipeline.seal_payload_stripe(pub, flats, manifests[0], g,
                                                                 cfg, device=where), s)
        (card, s_card), (cpu, _) = archives["cuda"], archives["cpu"]
        check([b.manifest for b in card.blocks] == [b.manifest for b in cpu.blocks],
              f"{codec}: card manifests equal CPU manifests")
        for bc, bh in zip(card.blocks, cpu.blocks):
            check(torch.equal(bc.sealed.body.cpu().view(torch.int32),
                              bh.sealed.body.view(torch.int32)), f"{codec}: card body = CPU body")
            check(torch.equal(bc.sealed.kem_c1.cpu(), bh.sealed.kem_c1), "card KEM = CPU KEM")
        for k in ("p", "q"):
            check(torch.equal(card.parity[k].cpu(), cpu.parity[k]), f"card {k} equals CPU {k}")
        for label, stripe in (("card", card), ("CPU", cpu)):
            got, _ = pipeline.restore_stripe_payloads(s_card, stripe, cfg, device=dev)
            check(all(torch.equal(a, b) for a, b in zip(got, stripes[0])),
                  f"{codec}: the {label}-sealed stripe restores on the card")
        print(f"archive {codec}: card stripe equals CPU stripe from the same seed; both "
              f"restore on the card")


# ------------------------------------------------------------- phase 2
def drive_archive(dev, cfg, stripes, manifests, seed: int):
    """Seal K stripes, restore them in full (parity checked), read a 2-shard
    subset of each, read shards {1, 5} of 8 stripes degraded, and scrub every
    stripe with zero keys, one flipped bit detected and located.  Returns
    (archives, pub, s, seconds per phase, restores that read a coded rANS
    shard)."""
    t = {}
    coded_reads = 0

    def coded(st, ids):
        return int(any(not st.blocks[i].manifest["entropy"].get("raw") for i in ids))

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(seed)
    pub, s = rlwe.keygen(g, device=dev)
    gens = [torch.Generator().manual_seed(seed + 100 + k) for k in range(len(stripes))]
    archives = pipeline.seal_payload_stripes(pub, stripes, manifests, gens, cfg, device=dev)
    torch.cuda.synchronize()
    t["seal_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for k, st in enumerate(archives):
        got, _ = pipeline.restore_stripe_payloads(s, st, cfg, device=dev)
        check(all(torch.equal(a, b) for a, b in zip(got, stripes[k])), f"restore stripe {k}")
        coded_reads += coded(st, range(S))
    torch.cuda.synchronize()
    t["restore_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for k, st in enumerate(archives):
        ids = [k % S, (k + 3) % S]
        got, _ = pipeline.restore_stripe_payloads(s, st, cfg, shards=ids, device=dev)
        check(all(torch.equal(a, stripes[k][i]) for a, i in zip(got, ids)), f"subset {k}")
        coded_reads += coded(st, ids)
    torch.cuda.synchronize()
    t["subset_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for k in range(DEGRADED_STRIPES):
        st = archives[k]
        records = pipeline.stripe_manifests(st)
        lost = pipeline.StripeArchive([None if i in LOST else b for i, b in enumerate(st.blocks)],
                                      st.parity)
        ids = [*LOST, 0]
        got, _ = pipeline.restore_stripe_payloads(s, lost, cfg, shards=ids, manifests=records,
                                                  device=dev)
        check(all(torch.equal(a, stripes[k][i]) for a, i in zip(got, ids)), f"degraded {k}")
        coded_reads += coded(st, ids)
    torch.cuda.synchronize()
    t["degraded_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for k, st in enumerate(archives):
        par = pipeline.recompute_stripe_parity(st, device=dev)
        for name in ("p", "q"):
            check(bool((par[name] == st.parity[name].cpu().numpy()).all()), f"scrub {k} {name}")
    bad_k, bad_shard = len(archives) // 2, 3
    st = archives[bad_k]
    body = st.blocks[bad_shard].sealed.body.clone()
    body.view(torch.int32)[1000] ^= 1 << 21
    blocks = list(st.blocks)
    blocks[bad_shard] = blocks[bad_shard]._replace(
        sealed=blocks[bad_shard].sealed._replace(body=body))
    par = pipeline.recompute_stripe_parity(pipeline.StripeArchive(blocks, st.parity), device=dev)
    sp = par["p"] ^ st.parity["p"].cpu().numpy()
    sq = par["q"] ^ st.parity["q"].cpu().numpy()
    check(bool(sp.any()) and bool(sq.any()), "scrub detects the flipped bit")
    check(raid.raid6_syndrome_locate(sp, sq, S) == bad_shard, "syndromes locate the shard")
    torch.cuda.synchronize()
    t["scrub_s"] = time.perf_counter() - t0
    return archives, pub, s, t, coded_reads


def v0_archives(dev, pub, stripes, manifests, seed: int):
    """Version-0 rANS stripes, as an older archive holds them: each stripe's
    payloads coded, the streams re-laid lane-major, sealed as the stored
    bodies, with manifests that record the coder's metas without a version.
    Set-up for the main path's v0 restores (it launches kernels itself)."""
    out = []
    for k, flats in enumerate(stripes):
        comps, metas = entropy_ops.encode_payloads(flats, device=dev)
        T = metas[0]["rows"]
        codes = entropy_ops._stage_codes(flats, T)
        n_valid = torch.tensor([[f.shape[0]] for f in flats], dtype=torch.int32).to(dev)
        words, mask, _, _ = rans_encode_kernel(codes, n_valid)
        lane_words = lane_major_streams(words, mask)[0]
        v0 = [c if m.get("raw") else
              torch.cat([c[: entropy_ops.HEADER_BYTES],
                         lane_words[j, : (m["n_comp"] - entropy_ops.HEADER_BYTES) // 2]
                         .view(torch.int8)])
              for j, (c, m) in enumerate(zip(comps, metas))]
        g = torch.Generator().manual_seed(seed + k)
        st = pipeline.seal_payload_stripe(pub, v0, [{"n_i8": int(c.shape[0])} for c in v0], g,
                                          pipeline.ArchiveConfig(codec_name="none"), device=dev)
        v0_metas = [{key: v for key, v in m.items() if key != "version"} for m in metas]
        blocks = [b._replace(manifest=dict(mf, entropy=em))
                  for b, mf, em in zip(st.blocks, manifests[k], v0_metas)]
        out.append(pipeline.StripeArchive(blocks, st.parity))
    return out


def phase_rans_main_path(dev, stripes, manifests, total):
    """The default archive, codec rANS, through its entry points."""
    cfg = pipeline.ArchiveConfig()
    check(cfg.codec_name == "rans", "the default codec is rANS")
    v0_setup_pub, v0_s = rlwe.keygen(torch.Generator().manual_seed(SEED + 30), device=dev)
    v0_stripes = v0_archives(dev, v0_setup_pub, stripes[:V0_STRIPES], manifests[:V0_STRIPES],
                             SEED + 40)
    torch.cuda.synchronize()

    _build.reset_launches()
    archives, pub, s, t, coded_reads = drive_archive(dev, cfg, stripes, manifests, SEED)
    t0 = time.perf_counter()
    for k, st in enumerate(v0_stripes):
        check(all("version" not in b.manifest["entropy"] for b in st.blocks), "v0 manifests")
        got, _ = pipeline.restore_stripe_payloads(v0_s, st, cfg, device=dev)
        check(all(torch.equal(a, b) for a, b in zip(got, stripes[k])), f"v0 restore {k}")
    torch.cuda.synchronize()
    t["v0_restore_s"] = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)

    metas = [b.manifest["entropy"] for a in archives for b in a.blocks]
    comp = sum(m["n_comp"] for m in metas)
    n_raw = sum(bool(m.get("raw")) for m in metas)
    print(f"rANS main path: " + ", ".join(f"{k} {v:.3f}" for k, v in t.items())
          + f"; seal {total / t['seal_s'] / 1e9:.3f} GB/s incl. rANS and KEM, restore "
          f"{total / t['restore_s'] / 1e9:.3f} GB/s; ratio {total / comp:.4f} "
          f"({total} -> {comp} bytes, {n_raw} of {len(metas)} shards raw)")
    print(f"rANS launches: {counts}")
    K_ = len(archives)
    check(counts["rans_encode"] == K_, "one rANS encode launch per rANS stripe sealed")
    check(counts["seal"] == K_, "one seal launch per stripe sealed")
    check(counts["rans_decode"] == coded_reads,
          f"one rANS decode launch per restore with a coded shard ({coded_reads})")
    check(counts["rans_decode_v0"] == V0_STRIPES, "one v0 decode launch per v0 restore")
    check(counts["unseal"] == 3 * K_ + DEGRADED_STRIPES + 1 + V0_STRIPES, "unseal launches")
    check(counts["polymul"] >= 2 * S * K_, "polymul launches >= 2 S K")
    return counts


def phase_none_path(dev, stripes, manifests, total):
    """PR 12's path: the same archive with codec none, then a zlib phase."""
    cfg = pipeline.ArchiveConfig(codec_name="none", parity="raid6")
    z_stripes, z_manifests, z_total = make_stripes(ZLIB_K, SHARD_MIN // 4, ZLIB_MAX,
                                                   SEED + 1, dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    archives, pub, s, t, _ = drive_archive(dev, cfg, stripes, manifests, SEED)
    t0 = time.perf_counter()
    zcfg = cfg._replace(codec_name="zlib")
    z_gens = [torch.Generator().manual_seed(SEED + 900 + k) for k in range(ZLIB_K)]
    z_archives = pipeline.seal_payload_stripes(pub, z_stripes, z_manifests, z_gens, zcfg,
                                               device=dev)
    comp = sum(int(b.manifest["entropy"]["n_comp"]) for a in z_archives for b in a.blocks)
    for k, st in enumerate(z_archives):
        got, _ = pipeline.restore_stripe_payloads(s, st, zcfg, device=dev)
        check(all(torch.equal(a, b) for a, b in zip(got, z_stripes[k])), f"zlib restore {k}")
    torch.cuda.synchronize()
    t["zlib_s"] = time.perf_counter() - t0

    counts = dict(_build.LAUNCHES)
    K_ = len(archives)
    print("none path: " + ", ".join(f"{k} {v:.3f}" for k, v in t.items())
          + f"; seal {total / t['seal_s'] / 1e9:.3f} GB/s incl. KEM, "
          f"restore {total / t['restore_s'] / 1e9:.3f} GB/s; zlib ratio {z_total / comp:.3f} "
          f"({ZLIB_K} stripes, {z_total} bytes)")
    print(f"none launches: {counts}")
    check(counts["seal"] == K_ + ZLIB_K, "one seal launch per stripe sealed")
    check(counts["unseal"] == 3 * K_ + DEGRADED_STRIPES + 1 + ZLIB_K, "unseal launches")
    check(counts["polymul"] >= 2 * S * K_, "polymul launches >= 2 S K")
    check(all(counts[k] == 0 for k in ("rans_encode", "rans_decode", "rans_decode_v0")),
          "codec none launches no rANS kernel")
    return counts


def phase_trace(dev, codec: str):
    """Where the archive's time goes: seal then restore 4 stripes under the
    profiler; device busy share of the wall time and the top kernels."""
    cfg = pipeline.ArchiveConfig(codec_name=codec, parity="raid6")
    stripes, manifests, total = make_stripes(4, SHARD_MIN, SHARD_MAX, SEED + 2, dev)
    g = torch.Generator().manual_seed(SEED + 3)
    pub, s = rlwe.keygen(g, device=dev)
    gens = [torch.Generator().manual_seed(SEED + 4 + k) for k in range(4)]
    pipeline.seal_payload_stripes(pub, stripes[:1], manifests[:1], gens[:1], cfg, device=dev)
    for label in ("seal", "restore"):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if label == "seal":
                archives = pipeline.seal_payload_stripes(pub, stripes, manifests, gens, cfg,
                                                         device=dev)
            else:
                for st in archives:
                    pipeline.restore_stripe_payloads(s, st, cfg, device=dev)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        avgs = [e for e in prof.key_averages() if e.device_type == CUDA_EVENT]
        busy_ms = sum(e.self_device_time_total for e in avgs) / 1e3
        top = sorted(avgs, key=lambda e: -e.self_device_time_total)[:5]
        print(f"trace {codec} {label}, a 4-stripe trace ({total} bytes): wall {wall_ms:.3f} ms, "
              f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}; top: "
              + "; ".join(f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                          for e in top))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {', '.join(_build.SOURCES)}")

    t_start = time.perf_counter()
    stats, kernel_fns = phase_kernels(dev)
    rans_stats = phase_rans_kernels(dev)
    phase_card_vs_cpu(dev)
    stripes, manifests, total = make_stripes(K, SHARD_MIN, SHARD_MAX, SEED, dev)
    torch.cuda.synchronize()
    print(f"payload: {K} stripes x {S} shards, {total} bytes")
    counts = phase_rans_main_path(dev, stripes, manifests, total)
    none_counts = phase_none_path(dev, stripes, manifests, total)
    phase_device_times(stats, kernel_fns, counts)
    for name, st in rans_stats.items():
        print(f"time {name}: exact, {counts[name]} launches on the main path, kernel "
              f"{st['ms']:.4f} ms (CUDA events), plain {st['plain_ms']:.4f} ms, bound "
              f"{st['bound_ms']:.4f} ms ({st['bound_by']}: {st.pop('counted')}), serial "
              f"floor {st.pop('floor_ms'):.4f} ms")
    stats.update(rans_stats)
    for codec in ("none", "rans"):
        phase_trace(dev, codec)
    print(f"phases: {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        check(counts[name] > 0, f"{name} ran on the rANS main path")
        if name in ("seal", "unseal", "polymul"):
            check(none_counts[name] > 0, f"{name} ran on the codec-none path")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts[name], **stats[name]})
    print(smi.stdout.strip())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
