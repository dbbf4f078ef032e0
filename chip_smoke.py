#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA sources in ``src/repro_torch/csrc`` (one nvcc each, all
   started together) and prints the build seconds.
2. Holds every kernel of the sealed-stripe archive against its plain PyTorch
   version on the card, bit for bit, at the shapes the archive gives it:
   seal (raid6, raid5, none), unseal (full, subset with global shard ids,
   zero keys) and the KEM's ring multiply, and times the plain versions and
   the kernels' calls back to back (CUDA events).  A small stripe sealed on
   the card must also equal the same stripe sealed on the CPU from the same
   seed.
3. Drives the archive through its entry points at an edge server's size:
   K = 64 RAID-6 stripes of S = 8 shards, each shard one GOP of int8 codes
   drawn as a quantised Laplacian, ragged between 256 KiB and 1 MiB (about
   320 MiB).  Seal, full restore with the parity check (byte-exact against
   the inputs), a 2-shard subset read of every stripe, a degraded read with
   shards {1, 5} lost on 8 stripes, a zero-key scrub of every stripe with
   one injected bit flip that must be detected and located, then a smaller
   zlib phase.  The launch counters are zeroed just before and read just
   after, and every kernel must have run.
4. Times each kernel's own device time from the profiler's trace, and
   traces sealing and restoring 4 stripes: the device's busy and idle share
   and its top kernels.  Both run last, because the profiler slows every
   later launch on the host.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line; without a CUDA device it exits 2.
"""

from __future__ import annotations

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
ZLIB_K, ZLIB_MAX = 4, 256 << 10
LAPLACE_SCALE = 6.0

# H100 SXM roofs: HBM3 rate from NVIDIA's data sheet; INT32 issue rate is
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost (half the FP32 lanes behind the
# data sheet's 67 TFLOP/s FP32).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

CUDA_EVENT = torch.autograd.DeviceType.CUDA  # profiler entries that are device kernels

SOURCES = {
    "seal": ("src/repro_torch/csrc/seal.cu", "src/repro/kernels/seal/seal.py:140"),
    "unseal": ("src/repro_torch/csrc/seal.cu", "src/repro/kernels/seal/seal.py:173"),
    "polymul": ("src/repro_torch/csrc/polymul.cu", "src/repro/kernels/polymul/polymul.py:45"),
}


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
    CPU from the same seed, and both restore on the card."""
    stripes, manifests, _ = make_stripes(1, 3000, 9000, SEED + 9, dev)
    cfg = pipeline.ArchiveConfig(codec_name="none")
    archives = {}
    for where in (dev, torch.device("cpu")):
        g = torch.Generator().manual_seed(SEED + 10)
        pub, s = rlwe.keygen(g, device=where)
        flats = [f.to(where) for f in stripes[0]]
        archives[where.type] = (pipeline.seal_payload_stripe(pub, flats, manifests[0], g, cfg,
                                                             device=where), s)
    (card, s_card), (cpu, _) = archives["cuda"], archives["cpu"]
    for bc, bh in zip(card.blocks, cpu.blocks):
        check(torch.equal(bc.sealed.body.cpu().view(torch.int32),
                          bh.sealed.body.view(torch.int32)), "card body equals CPU body")
        check(torch.equal(bc.sealed.kem_c1.cpu(), bh.sealed.kem_c1), "card KEM equals CPU KEM")
    for k in ("p", "q"):
        check(torch.equal(card.parity[k].cpu(), cpu.parity[k]), f"card {k} equals CPU {k}")
    for label, stripe in (("card", card), ("CPU", cpu)):
        got, _ = pipeline.restore_stripe_payloads(s_card, stripe, cfg, device=dev)
        check(all(torch.equal(a, b) for a, b in zip(got, stripes[0])),
              f"the {label}-sealed stripe restores on the card")
    print("archive: card stripe equals CPU stripe from the same seed; both restore on the card")


# ------------------------------------------------------------- phase 2
def phase_main_path(dev):
    cfg = pipeline.ArchiveConfig(codec_name="none", parity="raid6")
    stripes, manifests, total = make_stripes(K, SHARD_MIN, SHARD_MAX, SEED, dev)
    z_stripes, z_manifests, z_total = make_stripes(ZLIB_K, SHARD_MIN // 4, ZLIB_MAX,
                                                   SEED + 1, dev)
    torch.cuda.synchronize()
    print(f"payload: {K} stripes x {S} shards, {total} bytes; zlib: {ZLIB_K} stripes, "
          f"{z_total} bytes")

    _build.reset_launches()
    t = {}
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(SEED)
    pub, s = rlwe.keygen(g, device=dev)
    gens = [torch.Generator().manual_seed(SEED + 100 + k) for k in range(K)]
    archives = pipeline.seal_payload_stripes(pub, stripes, manifests, gens, cfg, device=dev)
    torch.cuda.synchronize()
    t["seal_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for k, st in enumerate(archives):
        got, _ = pipeline.restore_stripe_payloads(s, st, cfg, device=dev)
        check(all(torch.equal(a, b) for a, b in zip(got, stripes[k])), f"restore stripe {k}")
    torch.cuda.synchronize()
    t["restore_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for k, st in enumerate(archives):
        ids = [k % S, (k + 3) % S]
        got, _ = pipeline.restore_stripe_payloads(s, st, cfg, shards=ids, device=dev)
        check(all(torch.equal(a, stripes[k][i]) for a, i in zip(got, ids)), f"subset {k}")
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
    torch.cuda.synchronize()
    t["degraded_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for k, st in enumerate(archives):
        par = pipeline.recompute_stripe_parity(st, device=dev)
        for name in ("p", "q"):
            check(bool((par[name] == st.parity[name].cpu().numpy()).all()), f"scrub {k} {name}")
    bad_k, bad_shard = K // 2, 3
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
    print("main path: " + ", ".join(f"{k} {v:.3f}" for k, v in t.items())
          + f"; seal {total / t['seal_s'] / 1e9:.3f} GB/s incl. KEM, "
          f"restore {total / t['restore_s'] / 1e9:.3f} GB/s; zlib ratio {z_total / comp:.3f}")
    print(f"launches: {counts}")
    check(counts["seal"] == K + ZLIB_K, "one seal launch per stripe sealed")
    check(counts["unseal"] == 3 * K + DEGRADED_STRIPES + 1 + ZLIB_K, "unseal launches")
    check(counts["polymul"] >= 2 * S * K, "polymul launches >= 2 S K")
    return counts


def phase_trace(dev):
    """Where the archive's time goes: seal then restore 4 stripes under the
    profiler; device busy share of the wall time and the top kernels."""
    cfg = pipeline.ArchiveConfig(codec_name="none", parity="raid6")
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
        print(f"trace {label} 4 stripes ({total} bytes): wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}; top: "
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

    stats, kernel_fns = phase_kernels(dev)
    phase_card_vs_cpu(dev)
    counts = phase_main_path(dev)
    phase_device_times(stats, kernel_fns, counts)
    phase_trace(dev)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        check(counts[name] > 0, f"{name} ran on the main path")
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
