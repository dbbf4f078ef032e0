"""The port's ChaCha20, GF(256)/RAID and fused stripe seal against the JAX
package: the same numpy inputs into both, bit-exact outputs.

The JAX side runs its Pallas kernels in interpret mode (``use_pallas=True``
on the CPU) at a small size, plus its staged jnp reference over a wider
sweep; the port runs its plain PyTorch path (``device="cpu"``).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.archival import raid as jraid  # noqa: E402
from repro.core.crypto import chacha as jchacha  # noqa: E402
from repro.kernels.seal import ops as jops  # noqa: E402
from repro_torch.core.archival import raid as traid  # noqa: E402
from repro_torch.core.crypto import chacha as tchacha  # noqa: E402
from repro_torch.kernels.seal import ops as tops  # noqa: E402

CPU = "cpu"


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _eq(a, b):
    return np.array_equal(_np(a), _np(b))


# ------------------------------------------------------------------ ChaCha20
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chacha_block_matches(seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 2**32, 8, dtype=np.uint32)
    nonce = rng.integers(0, 2**32, 3, dtype=np.uint32)
    counters = rng.integers(0, 2**32, 37, dtype=np.uint32)
    want = jchacha.chacha20_block(jnp.asarray(key), jnp.asarray(counters), jnp.asarray(nonce))
    got = tchacha.chacha20_block(torch.from_numpy(key), torch.from_numpy(counters),
                                 torch.from_numpy(nonce))
    assert got.dtype == torch.uint32
    assert _eq(got, want)


@pytest.mark.parametrize("n_words,counter0", [(1, 0), (100, 5), (1000, 2**31 - 5)])
def test_keystream_and_xor_stream_match(n_words, counter0):
    rng = np.random.default_rng(n_words)
    key = rng.integers(0, 2**32, 8, dtype=np.uint32)
    nonce = rng.integers(0, 2**32, 3, dtype=np.uint32)
    data = rng.integers(0, 2**32, n_words, dtype=np.uint32)
    want = jchacha.keystream(jnp.asarray(key), jnp.asarray(nonce), n_words, counter0)
    got = tchacha.keystream(torch.from_numpy(key), torch.from_numpy(nonce), n_words, counter0)
    assert _eq(got, want)
    want_x = jchacha.xor_stream(jnp.asarray(key), jnp.asarray(nonce), jnp.asarray(data), counter0)
    got_x = tchacha.xor_stream(torch.from_numpy(key), torch.from_numpy(nonce),
                               torch.from_numpy(data), counter0)
    assert _eq(got_x, want_x)
    assert tchacha.bucket_n_words(n_words) == jchacha.bucket_n_words(n_words)


# ---------------------------------------------------------------- GF / RAID
def test_gf_tables_mul_div_match():
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8))
    a, b = a.reshape(-1), b.reshape(-1)
    assert _eq(traid.gf_mul(torch.from_numpy(a), torch.from_numpy(b)), jraid.gf_mul(a, b))
    nz = b != 0
    assert _eq(traid.gf_div(torch.from_numpy(a[nz]), torch.from_numpy(b[nz])),
               jraid.gf_div(a[nz], b[nz]))
    assert [traid.gf_pow_gen(i) for i in range(300)] == [jraid.gf_pow_gen(i) for i in range(300)]


@pytest.mark.parametrize("missing", [[0], [2], [1, 3], [0, 4]])
def test_raid_encode_reconstruct_match(missing):
    rng = np.random.default_rng(len(missing) * 10 + missing[0])
    data = rng.integers(0, 256, (5, 700), dtype=np.uint8)
    tdata = torch.from_numpy(data)
    assert _eq(traid.raid5_encode(tdata), jraid.raid5_encode(jnp.asarray(data)))
    tp, tq = traid.raid6_encode(tdata)
    jp, jq = jraid.raid6_encode(jnp.asarray(data))
    assert _eq(tp, jp) and _eq(tq, jq)
    t_rows = [None if i in missing else tdata[i] for i in range(5)]
    j_rows = [None if i in missing else jnp.asarray(data[i]) for i in range(5)]
    got = traid.raid6_reconstruct(t_rows, tp, tq, missing)
    want = jraid.raid6_reconstruct(j_rows, jp, jq, missing)
    for i in missing:
        assert _eq(got[i], want[i]) and _eq(got[i], data[i])
    if len(missing) == 1:
        (i,) = missing
        assert _eq(traid.raid5_reconstruct(t_rows, tp, i), data[i])
        q_only = traid.raid6_reconstruct(t_rows, None, tq, missing)
        assert _eq(q_only[i], jraid.raid6_reconstruct(j_rows, None, jq, missing)[i])


@pytest.mark.parametrize("shard", [0, 3, 6])
def test_syndrome_locate_matches(shard):
    rng = np.random.default_rng(shard)
    data = rng.integers(0, 256, (7, 512), dtype=np.uint8)
    tp, tq = traid.raid6_encode(torch.from_numpy(data))
    bad = data.copy()
    bad[shard, rng.integers(0, 512, 3)] ^= np.uint8(0x5A)
    tp2, tq2 = traid.raid6_encode(torch.from_numpy(bad))
    sp, sq = _np(tp ^ tp2), _np(tq ^ tq2)
    assert traid.raid6_syndrome_locate(sp, sq, 7) == shard
    assert jraid.raid6_syndrome_locate(sp, sq, 7) == shard
    two = bad.copy()
    two[(shard + 1) % 7, 0] ^= np.uint8(1)
    tp3, tq3 = traid.raid6_encode(torch.from_numpy(two))
    sp3, sq3 = _np(tp ^ tp3), _np(tq ^ tq3)
    assert traid.raid6_syndrome_locate(sp3, sq3, 7) == jraid.raid6_syndrome_locate(sp3, sq3, 7)


# -------------------------------------------------------------- stripe seal
def _inputs(seed, lens, zero_keys=False):
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(-128, 128, n).astype(np.int8) for n in lens]
    S = len(lens)
    keys = rng.integers(0, 2**32, (S, 8), dtype=np.uint32)
    nonces = rng.integers(0, 2**32, (S, 3), dtype=np.uint32)
    if zero_keys:
        keys[:] = 0
        nonces[:] = 0
    return payloads, keys, nonces


def _check_stripe(got, want, parity):
    assert _eq(got.sealed, want.sealed)
    assert got.n_words == want.n_words and got.n_i8 == want.n_i8
    assert (got.p is None) == (want.p is None) and (got.q is None) == (want.q is None)
    if want.p is not None:
        assert _eq(got.p, want.p)
    if want.q is not None:
        assert _eq(got.q, want.q)


# JAX in interpret mode at S <= 4, R <= 16
@pytest.mark.parametrize("parity", ["raid6", "raid5", "none"])
def test_seal_unseal_match_pallas(parity):
    payloads, keys, nonces = _inputs(7, [5000, 4093, 1, 2500])
    want = jops.seal_stripe([jnp.asarray(p) for p in payloads], jnp.asarray(keys),
                            jnp.asarray(nonces), parity=parity, use_pallas=True, pad_rows=16)
    got = tops.seal_stripe([torch.from_numpy(p) for p in payloads], torch.from_numpy(keys),
                           torch.from_numpy(nonces), parity=parity, pad_rows=16, device=CPU)
    _check_stripe(got, want, parity)
    jflats, jp, jq = jops.unseal_stripe(want, jnp.asarray(keys), jnp.asarray(nonces),
                                        parity=parity, use_pallas=True)
    tflats, tp, tq = tops.unseal_stripe(got, torch.from_numpy(keys), torch.from_numpy(nonces),
                                        parity=parity, device=CPU)
    for t, j, p in zip(tflats, jflats, payloads):
        assert _eq(t, j) and _eq(t, p)
    for t, j in ((tp, jp), (tq, jq)):
        assert (t is None) == (j is None)
        if j is not None:
            assert _eq(t, j)


def test_unseal_subset_and_zero_keys_match_pallas():
    payloads, keys, nonces = _inputs(8, [3000, 2048, 4096, 777])
    want = jops.seal_stripe([jnp.asarray(p) for p in payloads], jnp.asarray(keys),
                            jnp.asarray(nonces), use_pallas=True)
    got = tops.seal_stripe([torch.from_numpy(p) for p in payloads], torch.from_numpy(keys),
                           torch.from_numpy(nonces), device=CPU)
    _check_stripe(got, want, "raid6")
    # subset read with GLOBAL shard ids: shards (3, 1) only
    ids = (3, 1)
    jsub = jops.SealedStripe(want.sealed[jnp.asarray(ids)], None, None,
                             tuple(want.n_words[i] for i in ids), tuple(want.n_i8[i] for i in ids))
    tsub = tops.SealedStripe(got.sealed[list(ids)], None, None, jsub.n_words, jsub.n_i8)
    for parity in ("none", "raid6"):
        jf, jp, jq = jops.unseal_stripe(jsub, jnp.asarray(keys[list(ids)]),
                                        jnp.asarray(nonces[list(ids)]), parity=parity,
                                        use_pallas=True, shard_ids=ids)
        tf, tp, tq = tops.unseal_stripe(tsub, torch.from_numpy(keys[list(ids)]),
                                        torch.from_numpy(nonces[list(ids)]), parity=parity,
                                        shard_ids=ids, device=CPU)
        for t, j, i in zip(tf, jf, ids):
            assert _eq(t, j) and _eq(t, payloads[i])
        if parity == "raid6":
            assert _eq(tp, jp) and _eq(tq, jq)
    # zero-key scrub: parity recomputed over the stored bodies equals the seal's
    zeros8, zeros3 = np.zeros((4, 8), np.uint32), np.zeros((4, 3), np.uint32)
    _, jp, jq = jops.unseal_stripe(want, jnp.asarray(zeros8), jnp.asarray(zeros3),
                                   use_pallas=True)
    _, tp, tq = tops.unseal_stripe(got, torch.from_numpy(zeros8), torch.from_numpy(zeros3),
                                   device=CPU)
    assert _eq(tp, jp) and _eq(tq, jq) and _eq(tp, got.p) and _eq(tq, got.q)


# wider sweep against the JAX staged reference
@pytest.mark.parametrize("lens,pad_rows,parity,zero_keys", [
    ([1], None, "raid6", False),
    ([512 * 8 * 3, 17, 512 * 8 * 2 + 5], None, "raid6", False),
    ([9000, 100, 4, 8000, 3, 5000], 32, "raid5", False),
    ([2000, 6000], 24, "none", False),
    ([4096, 1000, 300], None, "raid6", True),
])
def test_seal_unseal_sweep_matches_staged(lens, pad_rows, parity, zero_keys):
    payloads, keys, nonces = _inputs(sum(lens), lens, zero_keys)
    want = jops.seal_stripe([jnp.asarray(p) for p in payloads], jnp.asarray(keys),
                            jnp.asarray(nonces), parity=parity, use_pallas=False,
                            pad_rows=pad_rows)
    got = tops.seal_stripe([torch.from_numpy(p) for p in payloads], torch.from_numpy(keys),
                           torch.from_numpy(nonces), parity=parity, pad_rows=pad_rows,
                           device=CPU)
    _check_stripe(got, want, parity)
    tflats, _, _ = tops.unseal_stripe(got, torch.from_numpy(keys), torch.from_numpy(nonces),
                                      parity=parity, device=CPU)
    for t, p in zip(tflats, payloads):
        assert _eq(t, p)


def test_geometry_helpers_match():
    for n in (0, 1, 127, 128, 129, 1023, 1024, 1025, 5000, 70000):
        assert tops.pad_rows_for(n) == jops.pad_rows_for(n)
        assert tops.bucket_rows_for(n) == jops.bucket_rows_for(n)
    for parity in ("none", "raid5", "raid6"):
        assert tops.datapath_traffic(8, 4096, parity) == jops.datapath_traffic(8, 4096, parity)


def test_seal_rejects_bad_input():
    payloads, keys, nonces = _inputs(0, [100, 200])
    with pytest.raises(ValueError):
        tops.seal_stripe([torch.from_numpy(p) for p in payloads], keys, nonces,
                         parity="raid7", device=CPU)
    with pytest.raises(ValueError):
        tops.seal_stripe([torch.from_numpy(p) for p in payloads], keys, nonces,
                         pad_rows=4, device=CPU)
    with pytest.raises(ValueError):
        tops.seal_stripe([], keys[:0], nonces[:0], device=CPU)
