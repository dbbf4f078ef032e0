"""The sealed-stripe archive as a whole: stripes cross between the JAX
package and the port both ways, through ``repro_torch.core.archival.interop``
and the on-disk form (JSON records, ``<u4`` bodies, u8 parity).

Full restores, degraded reads with one and two lost shards, subset reads and
the zero-key parity scrub agree byte for byte, for codecs ``rans``, ``none``
and ``zlib`` (and ``zstd`` from JAX to the port).  JAX seals with its Pallas
kernels in interpret mode; for ``rans`` that is its default one-launch fused
write, which the port's chained write equals byte for byte.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.archival import pipeline as jpl  # noqa: E402
from repro.core.archival import raid as jraid  # noqa: E402
from repro.core.crypto import hybrid as jhybrid  # noqa: E402
from repro.core.crypto import rlwe as jrlwe  # noqa: E402
from repro.core.crypto.hybrid import SealedBlock as JSealedBlock  # noqa: E402
from repro_torch.core.archival import interop  # noqa: E402
from repro_torch.core.archival import pipeline as tpl  # noqa: E402
from repro_torch.core.archival import raid as traid  # noqa: E402
from repro_torch.core.crypto import hybrid as thybrid  # noqa: E402
from repro_torch.core.crypto import rlwe as trlwe  # noqa: E402

CPU = "cpu"
LENS = (3000, 1237, 4096, 2222)


def _payloads(seed, lens=LENS):
    """Quantised-Laplacian int8 shards, so the host codec has work to do."""
    rng = np.random.default_rng(seed)
    flats = [np.clip(np.round(rng.laplace(0, 4, n)), -127, 127).astype(np.int8) for n in lens]
    return flats, [{"n_i8": int(n), "gop": i} for i, n in enumerate(lens)]


def _via_disk(state):
    """Round-trip records through JSON text, as the journal stores them."""
    records, bodies, parity = state
    return json.loads(json.dumps(records)), bodies, parity


# ---- the JAX package's side of the on-disk form (test-only glue)
def _jax_to_state(stripe):
    records = jpl.stripe_manifests_to_json(jpl.stripe_manifests(stripe))
    bodies = [np.asarray(b.sealed.body).astype("<u4") for b in stripe.blocks]
    parity = {k: (int(v) if k == "pad_to" else np.asarray(v, np.uint8))
              for k, v in stripe.parity.items()}
    return records, bodies, parity


def _jax_from_state(records, bodies, parity):
    metas = jpl.stripe_manifests_from_json(records)
    blocks = [
        None if body is None else jpl.ArchivedBlock(
            JSealedBlock(m["kem_c1"], m["kem_c2"], m["nonce"],
                         jnp.asarray(np.asarray(body, np.uint32)), m["n_words"]),
            m["manifest"])
        for m, body in zip(metas, bodies)
    ]
    par = {k: (v if k == "pad_to" else jnp.asarray(v)) for k, v in parity.items()}
    return jpl.StripeArchive(blocks, par), metas


def _lose(state, lost):
    records, bodies, parity = state
    return records, [None if i in lost else b for i, b in enumerate(bodies)], parity


def _same_payloads(got, flats, ids):
    assert len(got) == len(ids)
    for g, i in zip(got, ids):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert np.array_equal(g, flats[i]), f"shard {i}"


@pytest.fixture(scope="module")
def keys():
    jpub, js = jrlwe.keygen(jax.random.PRNGKey(3))
    tpub, ts = interop.keypair_from_numpy(np.asarray(jpub.a), np.asarray(jpub.b),
                                          np.asarray(js), device=CPU)
    return jpub, js, tpub, ts


@pytest.mark.parametrize("codec", ["rans", "none", "zlib", "zstd"])
def test_jax_sealed_restores_in_port(keys, codec):
    jpub, js, tpub, ts = keys
    flats, manifests = _payloads(1)
    cfg_j = jpl.ArchiveConfig(codec_name=codec)
    stripe = jpl.seal_payload_stripe(jpub, [jnp.asarray(f) for f in flats], manifests,
                                     jax.random.PRNGKey(9), cfg_j, use_pallas=True)
    state = _via_disk(_jax_to_state(stripe))
    cfg_t = tpl.ArchiveConfig(codec_name=codec)
    port = interop.stripe_from_state(*state, device=CPU)
    got, _ = tpl.restore_stripe_payloads(ts, port, cfg_t, device=CPU)
    _same_payloads(got, flats, range(4))
    got, _ = tpl.restore_stripe_payloads(ts, port, cfg_t, shards=[2, 0], device=CPU)
    _same_payloads(got, flats, [2, 0])
    records = tpl.stripe_manifests_from_json(state[0], device=CPU)
    for lost in ([1], [0, 3]):
        degraded = interop.stripe_from_state(*_lose(state, lost), device=CPU)
        got, _ = tpl.restore_stripe_payloads(ts, degraded, cfg_t, shards=[3, 1, 0],
                                             manifests=records, device=CPU)
        _same_payloads(got, flats, [3, 1, 0])
    # the port writes the same on-disk form back
    back = interop.stripe_to_state(port)
    assert back[0] == state[0]
    assert all(np.array_equal(a, b) for a, b in zip(back[1], state[1]))
    assert back[2].keys() == state[2].keys()
    assert all(np.array_equal(back[2][k], state[2][k]) for k in state[2])


@pytest.mark.parametrize("codec", ["rans", "none", "zlib"])
def test_port_sealed_restores_in_jax(codec):
    # the port's own key pair: the reference decapsulates with the port's s
    g = torch.Generator().manual_seed(21)
    pub, s = trlwe.keygen(g, device=CPU)
    _, _, s_np = interop.keypair_to_numpy(pub, s)
    flats, manifests = _payloads(2)
    cfg_t = tpl.ArchiveConfig(codec_name=codec)
    [stripe] = tpl.seal_payload_stripes(pub, [[torch.from_numpy(f) for f in flats]],
                                        [manifests], [g], cfg_t, pad_rows=16, device=CPU)
    state = _via_disk(interop.stripe_to_state(stripe))
    # an entropy codec re-buckets pad_rows on the compressed sizes
    assert state[2]["pad_to"] == 16 * 128 or codec != "none"
    cfg_j = jpl.ArchiveConfig(codec_name=codec)
    jstripe, metas = _jax_from_state(*state)
    got, _ = jpl.restore_stripe_payloads(jnp.asarray(s_np), jstripe, cfg_j, use_pallas=True)
    _same_payloads(got, flats, range(4))
    for lost in ([2], [1, 3]):
        jdeg, _ = _jax_from_state(*_lose(state, lost))
        got, _ = jpl.restore_stripe_payloads(jnp.asarray(s_np), jdeg, cfg_j, shards=[1, 2, 3],
                                             manifests=metas, use_pallas=False)
        _same_payloads(got, flats, [1, 2, 3])
    # and the port restores its own stripe, full and degraded
    got, _ = tpl.restore_stripe_payloads(s, stripe, cfg_t, device=CPU)
    _same_payloads(got, flats, range(4))
    tdeg = interop.stripe_from_state(*_lose(state, [0, 2]), device=CPU)
    got, _ = tpl.restore_stripe_payloads(
        s, tdeg, cfg_t, shards=[0, 2], device=CPU,
        manifests=tpl.stripe_manifests_from_json(state[0], device=CPU))
    _same_payloads(got, flats, [0, 2])


@pytest.mark.parametrize("parity", ["raid6", "raid5"])
def test_scrub_parity_and_locate_match(keys, parity):
    jpub, js, tpub, ts = keys
    flats, manifests = _payloads(3)
    stripe = jpl.seal_payload_stripe(jpub, [jnp.asarray(f) for f in flats], manifests,
                                     jax.random.PRNGKey(4),
                                     jpl.ArchiveConfig(codec_name="none", parity=parity),
                                     use_pallas=True)
    state = _jax_to_state(stripe)
    port = interop.stripe_from_state(*state, device=CPU)
    want = jpl.recompute_stripe_parity(stripe, use_pallas=True)
    got = tpl.recompute_stripe_parity(port, device=CPU)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]) and np.array_equal(got[k], state[2][k])
    # flip one bit of shard 2's body: both sides see the same syndromes
    bodies = [b.copy() for b in state[1]]
    bodies[2][5] ^= np.uint32(1 << 13)
    jbad, _ = _jax_from_state(state[0], bodies, state[2])
    tbad = interop.stripe_from_state(state[0], bodies, state[2], device=CPU)
    want = jpl.recompute_stripe_parity(jbad, use_pallas=True)
    got = tpl.recompute_stripe_parity(tbad, device=CPU)
    sp = got["p"] ^ state[2]["p"]
    assert np.array_equal(sp, want["p"] ^ state[2]["p"]) and sp.any()
    if parity == "raid6":
        sq = got["q"] ^ state[2]["q"]
        assert np.array_equal(sq, want["q"] ^ state[2]["q"])
        assert traid.raid6_syndrome_locate(sp, sq, 4) == 2
        assert jraid.raid6_syndrome_locate(sp, sq, 4) == 2
    with pytest.raises(ValueError, match="parity mismatch"):
        tpl.restore_stripe_payloads(ts, tbad, device=CPU)


def test_manifests_json_and_stripe_parity_match(keys):
    jpub, js, tpub, ts = keys
    flats, manifests = _payloads(4)
    g = torch.Generator().manual_seed(4)
    stripe = tpl.seal_payload_stripe(tpub, [torch.from_numpy(f) for f in flats], manifests, g,
                                     tpl.ArchiveConfig(codec_name="none"), device=CPU)
    recs = tpl.stripe_manifests_to_json(tpl.stripe_manifests(stripe))
    text = json.dumps(recs)
    back = tpl.stripe_manifests_from_json(json.loads(text), device=CPU)
    assert tpl.stripe_manifests_to_json(back) == recs
    assert jpl.stripe_manifests_to_json(jpl.stripe_manifests_from_json(json.loads(text))) == recs
    jstripe, _ = _jax_from_state(*interop.stripe_to_state(stripe))
    for mode in ("raid5", "raid6"):
        want = jpl.stripe_parity(jstripe.blocks, mode)
        got = tpl.stripe_parity(stripe.blocks, mode, device=CPU)
        assert got["pad_to"] == want["pad_to"]
        for k in ("p", "q"):
            if k in want:
                assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_scrub_locates_a_flip_in_a_rans_stripe(keys):
    """The zero-key scrub of a rANS stripe (JAX's fused write): the port
    recomputes the stored strips, and a flipped bit in one coded shard's
    body gives the same syndromes on both sides and is located."""
    jpub, js, tpub, ts = keys
    flats, manifests = _payloads(7)
    stripe = jpl.seal_payload_stripe(jpub, [jnp.asarray(f) for f in flats], manifests,
                                     jax.random.PRNGKey(8), jpl.ArchiveConfig(),
                                     use_pallas=True)
    state = _jax_to_state(stripe)
    assert not state[0][2]["manifest"]["entropy"].get("raw")  # shard 2 is coded
    got = tpl.recompute_stripe_parity(interop.stripe_from_state(*state, device=CPU), device=CPU)
    assert all(np.array_equal(got[k], state[2][k]) for k in ("p", "q"))
    bodies = [b.copy() for b in state[1]]
    bodies[2][300] ^= np.uint32(1 << 3)
    tbad = interop.stripe_from_state(state[0], bodies, state[2], device=CPU)
    got = tpl.recompute_stripe_parity(tbad, device=CPU)
    want = jpl.recompute_stripe_parity(_jax_from_state(state[0], bodies, state[2])[0],
                                       use_pallas=True)
    sp, sq = got["p"] ^ state[2]["p"], got["q"] ^ state[2]["q"]
    assert np.array_equal(sp, want["p"] ^ state[2]["p"]) and sp.any()
    assert np.array_equal(sq, want["q"] ^ state[2]["q"])
    assert traid.raid6_syndrome_locate(sp, sq, 4) == 2
    with pytest.raises(ValueError, match="parity mismatch"):
        tpl.restore_stripe_payloads(ts, tbad, device=CPU)


def test_default_config_seals_rans_like_jax(keys):
    """``ArchiveConfig()`` seals rANS in both packages: the port's chained
    write gives the manifests, body lengths and parity geometry of JAX's
    default fused write, and its sealed bodies hold the same streams."""
    jpub, js, tpub, ts = keys
    flats, manifests = _payloads(5, lens=(3000, 1237, 4096, 700))
    cfg = tpl.ArchiveConfig()
    assert cfg.codec_name == jpl.ArchiveConfig().codec_name == "rans"
    g = torch.Generator().manual_seed(0)
    [port] = tpl.seal_payload_stripes(tpub, [[torch.from_numpy(f) for f in flats]],
                                      [manifests], [g], cfg, device=CPU)
    ref = jpl.seal_payload_stripe(jpub, [jnp.asarray(f) for f in flats], manifests,
                                  jax.random.PRNGKey(5), jpl.ArchiveConfig(), use_pallas=True)
    assert [b.manifest for b in port.blocks] == [b.manifest for b in ref.blocks]
    assert port.blocks[3].manifest["entropy"]["raw"]  # 700 bytes: smaller than a header
    assert [b.sealed.n_valid_u32 for b in port.blocks] == [b.sealed.n_valid_u32
                                                            for b in ref.blocks]
    assert port.parity["pad_to"] == ref.parity["pad_to"]
    for bp, bj in zip(port.blocks, ref.blocks):
        assert np.array_equal(thybrid.unseal(ts, bp.sealed).view(torch.int32).numpy(),
                              np.asarray(jhybrid.unseal(js, bj.sealed)).view(np.int32))
    got, _ = tpl.restore_stripe_payloads(ts, port, cfg, device=CPU)
    _same_payloads(got, flats, range(4))


def test_restore_rejects_bad_requests(keys):
    _, _, tpub, ts = keys
    flats, manifests = _payloads(6)
    g = torch.Generator().manual_seed(1)
    stripe = tpl.seal_payload_stripe(tpub, [torch.from_numpy(f) for f in flats], manifests, g,
                                     tpl.ArchiveConfig(codec_name="none", parity="raid5"),
                                     device=CPU)
    with pytest.raises(ValueError, match="duplicate"):
        tpl.restore_stripe_payloads(ts, stripe, shards=[1, 1], device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        tpl.restore_stripe_payloads(ts, stripe, shards=[4], device=CPU)
    lost = tpl.StripeArchive([None, None] + stripe.blocks[2:], stripe.parity)
    with pytest.raises(ValueError, match="replicated metadata"):
        tpl.restore_stripe_payloads(ts, lost, shards=[0], device=CPU)
    with pytest.raises(ValueError, match="RAID-5"):
        tpl.restore_stripe_payloads(ts, lost, shards=[0], device=CPU,
                                    manifests=tpl.stripe_manifests(stripe))
    with pytest.raises(ValueError, match="every shard body"):
        tpl.recompute_stripe_parity(lost, device=CPU)
