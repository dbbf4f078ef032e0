"""The port's negacyclic polymul and R-LWE KEM against the JAX package.

Randomness is held equal at the seam after the draws: JAX draws the noise
with its own keys, and the same numbers go into the port as numpy.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.crypto import hybrid as jhybrid  # noqa: E402
from repro.core.crypto import rlwe as jrlwe  # noqa: E402
from repro.kernels.polymul import ops as jpoly  # noqa: E402
from repro_torch.core.crypto import hybrid as thybrid  # noqa: E402
from repro_torch.core.crypto import rlwe as trlwe  # noqa: E402
from repro_torch.kernels.polymul import ops as tpoly  # noqa: E402
from repro_torch.kernels.polymul import ref as tref  # noqa: E402

P = jrlwe.RLWEParams()
TP = trlwe.RLWEParams()


def _t(x, dtype=torch.int32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("n,batch,q", [(256, 1, 12289), (256, 5, 12289), (64, 3, 7681),
                                       (8, 2, 17)])
def test_polymul_fixed_matches(n, batch, q):
    rng = np.random.default_rng(n + batch)
    a = rng.integers(0, q, n).astype(np.int32)
    vecs = rng.integers(0, q, (batch, n)).astype(np.int32)
    want = jpoly.polymul_fixed(jnp.asarray(a), jnp.asarray(vecs), q)
    got = tpoly.polymul_fixed(_t(a), _t(vecs), q)
    assert got.dtype == torch.int32 and _eq(got, want)


@pytest.mark.parametrize("dtype,lim", [(np.int32, 2**31 - 1), (np.int64, 2**40)])
def test_polymul_fixed_reduces_any_integer_input(dtype, lim):
    q, n = 12289, 64
    rng = np.random.default_rng(11)
    a = rng.integers(-lim, lim, n).astype(dtype)
    vecs = rng.integers(-lim, lim, (3, n)).astype(dtype)
    want = jpoly.polymul_fixed(jnp.asarray(np.mod(a, q).astype(np.int32)),
                               jnp.asarray(np.mod(vecs, q).astype(np.int32)), q)
    got = tpoly.polymul_fixed(torch.from_numpy(a), torch.from_numpy(vecs), q)
    assert got.dtype == torch.int32 and _eq(got, want)


def test_polymul_general_and_matrix_match():
    rng = np.random.default_rng(3)
    q = 12289
    a = rng.integers(0, q, (4, 32)).astype(np.int32)
    b = rng.integers(0, q, (4, 32)).astype(np.int32)
    assert _eq(tpoly.polymul(_t(a), _t(b), q), jpoly.polymul(jnp.asarray(a), jnp.asarray(b), q))
    from repro.kernels.polymul import ref as jref

    assert _eq(tref.negacyclic_matrix(_t(a[0]), q), jref.negacyclic_matrix(jnp.asarray(a[0]), q))
    assert _eq(tref.center(_t(a), q), jref.center(jnp.asarray(a), q))


def _jax_keypair(seed):
    pub, s = jrlwe.keygen(jax.random.PRNGKey(seed), P)
    return pub, s, trlwe.PublicKey(_t(pub.a), _t(pub.b)), _t(s)


def test_encrypt_bits_matches_with_jax_noise():
    jpub, _, tpub, _ = _jax_keypair(0)
    B = 3
    key = jax.random.PRNGKey(11)
    m = jax.random.bernoulli(jax.random.PRNGKey(12), 0.5, (B, P.n)).astype(jnp.int32)
    want = jrlwe.encrypt_bits(jpub, m, key, P)
    # the same draws encrypt_bits makes from ``key``
    kr, k1, k2 = jax.random.split(key, 3)
    noise = tuple(_t(jrlwe._sample_cbd(k, (B, P.n), P.cbd_k, P.q)) for k in (kr, k1, k2))
    got = trlwe.encrypt_bits(tpub, _t(m), noise, TP)
    assert _eq(got.c1, want.c1) and _eq(got.c2, want.c2)
    assert _eq(trlwe.decrypt_bits(_t(np.asarray(jrlwe.keygen(jax.random.PRNGKey(0), P)[1])),
                                  got, TP), m)


def test_keygen_public_key_from_jax_draws():
    jpub, js, _, ts = _jax_keypair(5)
    # keygen's draws, as the reference makes them: b = a o s + e
    _, _, ke = jax.random.split(jax.random.PRNGKey(5), 3)
    e = _t(jrlwe._sample_cbd(ke, (P.n,), P.cbd_k, P.q))
    b = torch.remainder(tpoly.polymul_fixed(_t(jpub.a), ts[None], P.q)[0] + e, P.q)
    assert _eq(b, jpub.b)


@pytest.mark.parametrize("seed", [1, 2])
def test_decapsulate_recovers_jax_session(seed):
    jpub, js, _, ts = _jax_keypair(seed)
    ct, shared = jrlwe.kem_encapsulate(jpub, jax.random.PRNGKey(100 + seed), P)
    got = trlwe.kem_decapsulate(ts, trlwe.Ciphertext(_t(ct.c1), _t(ct.c2)), TP)
    assert got.dtype == torch.uint32 and _eq(got, shared)


@pytest.mark.parametrize("seed", [0, 7])
def test_port_kem_roundtrip_and_jax_decapsulates(seed):
    g = torch.Generator().manual_seed(seed)
    pub, s = trlwe.keygen(g, TP, device="cpu")
    ct, shared = trlwe.kem_encapsulate(pub, g, TP)
    assert _eq(trlwe.kem_decapsulate(s, ct, TP), shared)
    # the reference decapsulates the port's ciphertext with the port's secret
    want = jrlwe.kem_decapsulate(jnp.asarray(s.numpy()),
                                 jrlwe.Ciphertext(jnp.asarray(ct.c1.numpy()),
                                                  jnp.asarray(ct.c2.numpy())), P)
    assert _eq(shared, want)
    # a seeded generator replays the same keys
    g2 = torch.Generator().manual_seed(seed)
    pub2, s2 = trlwe.keygen(g2, TP, device="cpu")
    assert _eq(pub2.a, pub.a.numpy()) and _eq(s2, s.numpy())


def test_pack_unpack_bits_match():
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (3, 256)).astype(np.int32)
    words = trlwe.pack_bits_u32(_t(bits))
    assert _eq(words, jrlwe.pack_bits_u32(jnp.asarray(bits)))
    assert _eq(trlwe.unpack_bits_u32(words, 250), jrlwe.unpack_bits_u32(
        jrlwe.pack_bits_u32(jnp.asarray(bits)), 250))


def test_hybrid_seal_crosses_to_jax():
    g = torch.Generator().manual_seed(9)
    pub, s = trlwe.keygen(g, TP, device="cpu")
    data = bytes(range(256)) * 7 + b"tail"
    words = thybrid.bytes_to_u32(data, device="cpu")
    assert _eq(words, jhybrid.bytes_to_u32(data))
    block = thybrid.seal(pub, words, g, TP)
    assert block.n_valid_u32 == words.numel() and not _eq(block.body, words.numpy())
    assert thybrid.u32_to_bytes(thybrid.unseal(s, block, TP), len(data)) == data
    # the reference opens the port's block with the port's secret
    jblock = jhybrid.SealedBlock(*(jnp.asarray(t.numpy()) for t in block[:4]), block.n_valid_u32)
    opened = jhybrid.unseal(jnp.asarray(s.numpy()), jblock, P)
    assert jhybrid.u32_to_bytes(opened, len(data)) == data
