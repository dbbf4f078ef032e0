"""The port's rANS coder against the JAX package: the same numpy inputs into
both, bit-exact outputs.

Covers the table builders, the dense encode outputs (against the Pallas
encoder in interpret mode at a small size, and against the staged jnp
oracle over every pow2 row bucket), the packed streams and their metas,
decoding each other's streams (version 1, and version 0 through a
lane-major re-laying of a version-1 encoding and the golden fixture), and
the meta checks.  The port runs its plain PyTorch path (``device="cpu"``).
"""

import base64
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.entropy import ops as jops  # noqa: E402
from repro.kernels.entropy import rans as jrans  # noqa: E402
from repro.kernels.entropy import ref as jref  # noqa: E402
from repro_torch.kernels.entropy import ops as tops  # noqa: E402
from repro_torch.kernels.entropy import ref as tref  # noqa: E402
from repro_torch.kernels.entropy.rans import (  # noqa: E402
    rans_decode_kernel,
    rans_decode_v0_kernel,
    rans_encode_kernel,
)

CPU = "cpu"
L = 128
GOLDEN = Path(__file__).resolve().parent / "data_rans_v0.json"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b):
    a, b = _np(a), _np(b)
    if a.dtype != b.dtype and a.dtype.itemsize == b.dtype.itemsize:
        b = b.view(a.dtype)  # the port keeps u16/u32 bits in int16/int32
    return a.shape == b.shape and np.array_equal(a, b)


def _latents(rng, n, sigma=2.0):
    return np.clip(np.round(rng.normal(0.0, sigma, n)), -128, 127).astype(np.int8)


def _stripe(T, seed):
    """Shards pinning bucket T's edges: exactly full, one byte short, the
    first byte of the last row, a sub-header shard, an incompressible shard,
    one symbol only, and an empty shard (n_valid = 0)."""
    rng = np.random.default_rng(seed)
    full = T * L
    return [
        _latents(rng, full),
        _latents(rng, full - 1),
        _latents(rng, (T - 1) * L + 1),
        _latents(rng, 5),
        rng.integers(-128, 128, full, dtype=np.int8),
        np.full(full // 2, -7, np.int8),
        np.zeros(0, np.int8),
    ]


def _staged(flats, T):
    """(S, T, 128) zero-padded codes and (S, 1) n_valid, as numpy."""
    codes = np.zeros((len(flats), T * L), np.int8)
    for s, f in enumerate(flats):
        codes[s, : f.size] = f
    n_valid = np.array([[f.size] for f in flats], np.int32)
    return codes.reshape(len(flats), T, L), n_valid


def _lane_major(flats, comps, metas):
    """Re-lay version-1 streams as version 0 (the reference has no version-0
    encoder): the same header, the emitted words sorted by lane, then by
    row, from the dense encode of the same payloads."""
    codes, n_valid = _staged(flats, metas[0]["rows"])
    words, mask, _, _ = tref.rans_encode_ref(torch.from_numpy(codes), torch.from_numpy(n_valid))
    out, out_metas = [], []
    for s, (c, m) in enumerate(zip(comps, metas)):
        c = np.asarray(c)
        if not m.get("raw"):
            lane_words = words[s].numpy().T[mask[s].numpy().T.astype(bool)]
            c = np.concatenate([c[: jops.HEADER_BYTES], lane_words.view(np.int8)])
        out.append(c)
        out_metas.append({k: v for k, v in m.items() if k != "version"})
    return out, out_metas


# ---------------------------------------------------------- table builders
def _count_cases():
    rng = np.random.default_rng(5)
    one = np.zeros(256, np.int64)
    one[42] = 12345
    skew = np.zeros(256, np.int64)
    skew[:3] = (1 << 24) - 300, 200, 100
    big = np.zeros(256, np.int64)
    big[:4] = 1 << 22
    ties = np.zeros(256, np.int64)
    ties[[9, 3, 200]] = 77
    return {
        "single": one,
        "all256": np.full(256, 7),
        "skewed": skew,
        "total_2^24": big,
        "ties": ties,
        "empty": np.zeros(256, np.int64),
        "random": rng.integers(0, 1000, 256),
        "random_2^24": rng.multinomial(1 << 24, rng.dirichlet(np.full(256, 0.3))),
    }


@pytest.mark.parametrize("case", sorted(_count_cases()))
def test_tables_match(case):
    counts = _count_cases()[case]
    assert counts.sum() <= 1 << 24  # the datapath's bound (C-ref1)
    want = np.asarray(jrans.build_freq_table(jnp.asarray(counts, jnp.int32)))
    got = tref.build_freq_table(torch.from_numpy(counts))
    assert got.dtype == torch.int32 and _eq(got, want)
    assert int(got.sum()) == tref.PROB_SCALE
    assert _eq(tref.build_dec_table(got).to(torch.int32), np.asarray(jrans.build_dec_table(want)))
    assert _eq(tref.slot_to_symbol(got[None])[0].to(torch.int32),
               np.asarray(jrans.slot_to_symbol(jnp.asarray(want))))


def test_freq_table_property_within_the_datapath_bound():
    rng = np.random.default_rng(11)
    batch = []
    for _ in range(64):
        k = int(rng.integers(1, 257))
        counts = np.zeros(256, np.int64)
        idx = rng.choice(256, k, replace=False)
        counts[idx] = rng.multinomial(int(rng.integers(1, 1 << 24)), rng.dirichlet(np.ones(k)))
        batch.append(counts)
    batch = np.stack(batch)
    got = tref.build_freq_table(torch.from_numpy(batch))
    for counts, f in zip(batch, got):
        assert _eq(f, np.asarray(jrans.build_freq_table(jnp.asarray(counts, jnp.int32))))
    assert (got.sum(1) == tref.PROB_SCALE).all()
    assert bool(((got >= 1) | (torch.from_numpy(batch) == 0)).all())


def test_constants_and_geometry_match():
    for name in ("N_LANES", "PROB_BITS", "PROB_SCALE", "RANS_L", "T_TILE", "STREAM_VERSION"):
        assert getattr(tref, name) == getattr(jrans, name), name
    assert tops.HEADER_BYTES == jops.HEADER_BYTES and tops.MAX_ROWS == jops.MAX_ROWS
    for n in (0, 1, 127, 128, 1024, 1025, 65536, 1 << 20, (1 << 20) + 1):
        assert tops.rows_for(n) == jops.rows_for(n)
    for T in (8, 16, 512, 8192):
        assert tops.stream_word_cap(T) == jops.stream_word_cap(T)
    assert tops.entropy_traffic(3000, 1000) == jops.entropy_traffic(3000, 1000)


# ------------------------------------------------------------ dense encode
def test_encode_matches_pallas_kernel():
    """Against the TPU kernel itself, run in interpret mode (S = 4, T = 32)."""
    rng = np.random.default_rng(3)
    T = 32
    flats = [_latents(rng, T * L), rng.integers(-128, 128, 3000, dtype=np.int8),
             _latents(rng, 1), np.zeros(0, np.int8)]
    codes, n_valid = _staged(flats, T)
    want = jrans.rans_encode_pallas(jnp.asarray(codes), jnp.asarray(n_valid), interpret=True)
    got = rans_encode_kernel(torch.from_numpy(codes), torch.from_numpy(n_valid))
    assert [g.dtype for g in got] == [torch.int16, torch.uint8, torch.int32, torch.int32]
    assert all(_eq(g, w) for g, w in zip(got, want))
    assert int(got[2][3, 0]) == tref.PROB_SCALE  # n_valid = 0: the reference's table
    assert bool((got[3][3] == tref.RANS_L).all())


@pytest.mark.parametrize("T", [8, 16, 32, 64, 128, 256, 512])
def test_encode_every_bucket_matches(T):
    """Dense outputs against the staged oracle, then the packed streams and
    metas against ``encode_payloads``, in every pow2 row bucket."""
    flats = _stripe(T, seed=40 + T)
    codes, n_valid = _staged(flats, T)
    want = jref.rans_encode_ref(jnp.asarray(codes), jnp.asarray(n_valid))
    got = tref.rans_encode_ref(torch.from_numpy(codes), torch.from_numpy(n_valid))
    assert all(_eq(g, w) for g, w in zip(got, want))
    cj, mj = jops.encode_payloads([jnp.asarray(f) for f in flats], use_pallas=False)
    ct, mt = tops.encode_payloads([torch.from_numpy(f) for f in flats], device=CPU)
    assert mt == mj
    assert all(m["rows"] == T for m in mt)
    assert mt[3]["raw"] and mt[4]["raw"] and mt[6]["raw"]
    if T >= 32:
        assert not mt[0].get("raw") and mt[5]["n_comp"] == tops.HEADER_BYTES
    assert all(_eq(a, b) for a, b in zip(ct, cj))


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("T", [8, 64, 512])
def test_streams_decode_both_ways(T):
    flats = _stripe(T, seed=70 + T)
    cj, mj = jops.encode_payloads([jnp.asarray(f) for f in flats], use_pallas=False)
    got = tops.decode_payloads([np.asarray(c) for c in cj], mj, device=CPU)
    assert all(_eq(g, f) for g, f in zip(got, flats))
    ct, mt = tops.encode_payloads([torch.from_numpy(f) for f in flats], device=CPU)
    back = jops.decode_payloads([jnp.asarray(c.numpy()) for c in ct], mt, use_pallas=T <= 8)
    assert all(_eq(b, f) for b, f in zip(back, flats))


def test_decode_matches_pallas_kernel():
    """The version-1 decode against the TPU kernel in interpret mode, on
    the streams of a small stripe, n_valid = 0 included."""
    T = 16
    flats = _stripe(T, seed=9)
    codes, n_valid = _staged(flats, T)
    words, mask, freq, states = tref.rans_encode_ref(torch.from_numpy(codes),
                                                     torch.from_numpy(n_valid))
    m = mask.bool()
    W = int(m.sum((1, 2)).max()) + 3
    stream = torch.zeros((len(flats), W), dtype=torch.int16)
    for s in range(len(flats)):
        stream[s, : int(m[s].sum())] = words[s][m[s]]
    want = jrans.rans_decode_pallas(jnp.asarray(stream.numpy().view(np.uint16)),
                                    jnp.asarray(freq.numpy()),
                                    jnp.asarray(states.numpy().view(np.uint32)),
                                    jnp.asarray(n_valid), rows=T, interpret=True)
    got = rans_decode_kernel(stream, freq, states, torch.from_numpy(n_valid), rows=T)
    assert _eq(got, want) and _eq(got, codes)


@pytest.mark.parametrize("T", [32, 128])
def test_version0_relaid_streams_decode_like_jax(T):
    """A version-1 encoding re-laid lane-major is a version-0 stream: the
    port's v0 decoder and the reference's agree on it, and on the parsed
    operands the plain v0 decode equals the reference's."""
    flats = _stripe(T, seed=90 + T)
    c1, m1 = jops.encode_payloads([jnp.asarray(f) for f in flats], use_pallas=False)
    c0, m0 = _lane_major(flats, c1, m1)
    got = tops.decode_payloads(c0, m0, device=CPU)
    assert all(_eq(g, f) for g, f in zip(got, flats))
    back = jops.decode_payloads([jnp.asarray(c) for c in c0], m0, use_pallas=False)
    assert all(_eq(b, f) for b, f in zip(back, flats))
    coded = [i for i, m in enumerate(m0) if not m.get("raw")]
    comp = tops._stack_streams([torch.from_numpy(c0[i]) for i in coded]).numpy()
    nv = np.array([[m0[i]["n_raw"]] for i in coded], np.int32)
    lw, jf, js = jops._parse_streams_v0(jnp.asarray(comp.view(np.uint8)), rows=T)
    want = jref.rans_decode_ref_v0(lw, jf, js, jnp.asarray(nv))
    freq, lane_lens, states, stream = tops._parse(torch.from_numpy(comp))
    assert _eq(tref.lane_major_words(stream, lane_lens, T).to(torch.int32),
               np.asarray(lw).astype(np.int32))
    got = rans_decode_v0_kernel(stream, lane_lens, freq, states, torch.from_numpy(nv), rows=T)
    assert _eq(got, want)


def test_golden_v0_fixture_decodes():
    g = json.loads(GOLDEN.read_text())
    comps = [np.frombuffer(base64.b64decode(b), np.int8) for b in g["streams_b64"]]
    wants = [np.frombuffer(base64.b64decode(b), np.int8) for b in g["payloads_b64"]]
    assert "version" not in g["metas"][0] and g["metas"][1].get("raw") is True
    got = tops.decode_payloads(comps, g["metas"], device=CPU)
    assert all(_eq(a, b) for a, b in zip(got, wants))
    # re-encoding gives a version-1 stream of the same size, as in JAX
    _, metas1 = tops.encode_payloads([torch.from_numpy(w.copy()) for w in wants], device=CPU)
    assert metas1[0]["version"] == tref.STREAM_VERSION
    assert metas1[0]["n_comp"] == g["metas"][0]["n_comp"]


# ------------------------------------------------------------ meta checks
def _bad_cases():
    rng = np.random.default_rng(1)
    flats = [_latents(rng, 5000), _latents(rng, 3000)]
    comp, metas = tops.encode_payloads([torch.from_numpy(f) for f in flats], device=CPU)
    raw_c, raw_m = tops.encode_payloads([torch.from_numpy(_latents(rng, 5))], device=CPU)
    short = comp[0][:100]
    return {
        "n_comp": ([comp[0]], [dict(metas[0], n_comp=metas[0]["n_comp"] + 4)]),
        "rows": (comp, [metas[0], dict(metas[1], rows=metas[1]["rows"] * 2)]),
        "count": (comp, metas[:1]),
        "empty": ([], []),
        "raw_len": (raw_c, [dict(raw_m[0], n_comp=5, n_raw=6)]),
        "header": ([short], [dict(metas[0], n_comp=100)]),
        "versions": (comp, [metas[0], dict(metas[1], version=0)]),
    }


@pytest.mark.parametrize("case", ["n_comp", "rows", "count", "empty", "raw_len", "header",
                                  "versions"])
def test_corrupt_metas_raise_like_jax(case):
    comps, metas = _bad_cases()[case]
    with pytest.raises(ValueError) as want:
        jops.decode_payloads([jnp.asarray(c.numpy()) for c in comps], metas, use_pallas=False)
    with pytest.raises(ValueError) as got:
        tops.decode_payloads(comps, metas, device=CPU)
    assert str(got.value) == str(want.value)


def test_encode_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="at least one shard"):
        tops.encode_payloads([], device=CPU)
    big = torch.zeros(tops.MAX_ROWS * L + 1, dtype=torch.int8)
    with pytest.raises(ValueError, match="split it across more stripe shards"):
        tops.encode_payloads([big], device=CPU)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without ``device=`` the coder runs on the card; where there is none
    it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flats = [torch.from_numpy(_latents(np.random.default_rng(2), 5000))]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.encode_payloads(flats)
    comps, metas = tops.encode_payloads(flats, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.decode_payloads(comps, metas)


def test_kernel_wrappers_check_operands_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel's operand checks,
    never to the plain version (meta tensors: no card, no library needed)."""
    meta = torch.device("meta")
    nv = torch.empty((1, 1), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="rows 12 not a positive multiple"):
        rans_encode_kernel(torch.empty((1, 12, L), dtype=torch.int8, device=meta), nv)
    with pytest.raises(ValueError, match="shape"):
        rans_encode_kernel(torch.empty((1, 8, 100), dtype=torch.int8, device=meta), nv)
    stream = torch.empty((1, 40), dtype=torch.int16, device=meta)
    freq = torch.empty((1, 256), dtype=torch.int32, device=meta)
    states = torch.empty((1, L), dtype=torch.int32, device=meta)
    with pytest.raises(TypeError, match="dtype"):
        rans_decode_kernel(stream.to(torch.int32), freq, states, nv, rows=8)
    with pytest.raises(ValueError, match="lane_lens"):
        rans_decode_v0_kernel(stream, freq, freq, states, nv, rows=8)
