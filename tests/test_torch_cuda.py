"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc (Hopper, sm_90a); elsewhere they
skip.  On a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.archival import pipeline  # noqa: E402
from repro_torch.core.crypto import rlwe  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
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

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; run on the card")
    return torch.device("cuda")


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    as_i32 = (lambda t: t.view(torch.int32) if t.dtype == torch.uint32 else t)
    return a.shape == b.shape and torch.equal(as_i32(a).cpu(), as_i32(b).cpu())


def _stripe(cuda, lens, seed):
    rng = np.random.default_rng(seed)
    flats = [torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)).to(cuda) for n in lens]
    keys = torch.from_numpy(rng.integers(0, 2**32, (len(lens), 8), dtype=np.uint32)).to(cuda)
    nonces = torch.from_numpy(rng.integers(0, 2**32, (len(lens), 3), dtype=np.uint32)).to(cuda)
    codes, n_words, _ = seal_ops._stack_padded(flats)
    return flats, codes, seal_ops._meta_arrays(keys, nonces, n_words, cuda)


@pytest.mark.parametrize("parity", ["raid6", "raid5", "none"])
def test_stripe_kernel_matches_plain(cuda, parity):
    flats, codes, meta = _stripe(cuda, [70000, 1, 65536, 4093, 33333], 1)
    launches = _build.LAUNCHES["seal"]
    got = seal_stripe_kernel(codes, *meta, parity=parity)
    assert _build.LAUNCHES["seal"] == launches + 1
    want = seal_ref.seal_stripe_ref(codes, *meta, parity=parity)
    assert all(_same(a, b) for a, b in zip(got, want))
    back = unseal_stripe_kernel(got[0], *meta, parity=parity)
    assert all(_same(a, b) for a, b in zip(back, seal_ref.unseal_stripe_ref(got[0], *meta,
                                                                             parity=parity)))
    for s, f in enumerate(flats):
        assert _same(back[0][s].reshape(-1)[: f.shape[0]], f)


def test_polymul_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(0)
    q, n = 12289, 256
    a = torch.randint(0, q, (n,), generator=g, dtype=torch.int32).to(cuda)
    vecs = torch.randint(0, q, (5, n), generator=g, dtype=torch.int32).to(cuda)
    assert _same(negacyclic_matmul(a, vecs, q), poly_ref.negacyclic_matmul_ref(a, vecs, q))
    # any int32 is reduced mod q in the kernel, as in the plain version
    wide = vecs * 1000 - 2**30
    assert _same(negacyclic_matmul(a - q, wide, q), poly_ref.negacyclic_matmul_ref(a, wide, q))


def test_card_archive_equals_cpu_archive(cuda):
    rng = np.random.default_rng(2)
    flats = [torch.from_numpy(rng.integers(-9, 9, n).astype(np.int8)) for n in (5000, 300, 4096)]
    manifests = [{"n_i8": int(f.shape[0])} for f in flats]
    cfg = pipeline.ArchiveConfig(codec_name="none")
    out = []
    for dev in (cuda, torch.device("cpu")):
        g = torch.Generator().manual_seed(3)
        pub, s = rlwe.keygen(g, device=dev)
        st = pipeline.seal_payload_stripe(pub, [f.to(dev) for f in flats], manifests, g, cfg,
                                          device=dev)
        got, _ = pipeline.restore_stripe_payloads(s, st, cfg, device=dev)
        assert all(_same(a, b.to(dev)) for a, b in zip(got, flats))
        out.append(st)
    card, cpu = out
    for a, b in zip(card.blocks, cpu.blocks):
        assert _same(a.sealed.body, b.sealed.body)
    assert _same(card.parity["q"], cpu.parity["q"])


def _rans_stripe(cuda, T, lens, seed):
    """Zero-padded (S, T, 128) codes: Laplacian shards, and an incompressible
    one at index 2, with their (S, 1) n_valid."""
    rng = np.random.default_rng(seed)
    codes = np.zeros((len(lens), T * 128), np.int8)
    for s, n in enumerate(lens):
        codes[s, :n] = (rng.integers(-128, 128, n) if s == 2 else
                        np.clip(np.round(rng.laplace(0, 3, n)), -127, 127))
    n_valid = np.array(lens, np.int32).reshape(-1, 1)
    return (torch.from_numpy(codes.reshape(len(lens), T, 128)).to(cuda),
            torch.from_numpy(n_valid).to(cuda))


@pytest.mark.parametrize("T", [8, 256])
def test_rans_kernels_match_plain(cuda, T):
    full = T * 128
    codes, n_valid = _rans_stripe(cuda, T, [full, 0, full, full - 1, 129, 1], T)
    launches = dict(_build.LAUNCHES)
    enc = rans_encode_kernel(codes, n_valid)
    assert all(_same(a, b) for a, b in zip(enc, rans_ref.rans_encode_ref(codes, n_valid)))
    words, mask, freq, states = enc
    m = mask.bool()
    n_words = m.sum((1, 2)).tolist()
    stream = torch.zeros((len(n_words), max(n_words) + 1), dtype=torch.int16, device=cuda)
    lane_major = torch.zeros_like(stream)
    for s, n in enumerate(n_words):
        stream[s, :n] = words[s][m[s]]
        lane_major[s, :n] = words[s].t()[m[s].t()]
    dec = rans_decode_kernel(stream, freq, states, n_valid, rows=T)
    assert _same(dec, rans_ref.rans_decode_ref(stream, freq, states, n_valid, rows=T))
    assert _same(dec, codes)
    lane_lens = mask.sum(1, dtype=torch.int32)
    dec0 = rans_decode_v0_kernel(lane_major, lane_lens, freq, states, n_valid, rows=T)
    assert _same(dec0, rans_ref.rans_decode_ref_v0(lane_major, lane_lens, freq, states, n_valid,
                                                   rows=T))
    assert _same(dec0, codes)
    assert all(_build.LAUNCHES[k] == launches[k] + 1
               for k in ("rans_encode", "rans_decode", "rans_decode_v0"))


def test_card_rans_archive_equals_cpu_archive(cuda):
    rng = np.random.default_rng(4)
    flats = [torch.from_numpy(np.clip(np.round(rng.laplace(0, 3, n)), -127, 127)
                              .astype(np.int8)) for n in (50000, 3000, 70000, 1000)]
    manifests = [{"n_i8": int(f.shape[0])} for f in flats]
    cfg = pipeline.ArchiveConfig()
    out = []
    for dev in (cuda, torch.device("cpu")):
        g = torch.Generator().manual_seed(5)
        pub, s = rlwe.keygen(g, device=dev)
        st = pipeline.seal_payload_stripe(pub, [f.to(dev) for f in flats], manifests, g, cfg,
                                          device=dev)
        got, _ = pipeline.restore_stripe_payloads(s, st, cfg, device=dev)
        assert all(_same(a, b.to(dev)) for a, b in zip(got, flats))
        out.append(st)
    card, cpu = out
    assert [b.manifest for b in card.blocks] == [b.manifest for b in cpu.blocks]
    for a, b in zip(card.blocks, cpu.blocks):
        assert _same(a.sealed.body, b.sealed.body)
    assert _same(card.parity["q"], cpu.parity["q"])


def test_wrapper_raises_on_bad_operands(cuda):
    flats, codes, meta = _stripe(cuda, [1000], 3)
    with pytest.raises(ValueError):
        seal_stripe_kernel(codes[:, :, :100], *meta)
    with pytest.raises(TypeError):
        seal_stripe_kernel(codes.to(torch.int32), *meta)


def test_kernels_launch_on_a_device_that_is_not_current(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: launches on cuda:1 while cuda:0 is current")
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    flats, codes, meta = _stripe(dev, [5000, 300, 4096], 4)
    got = seal_stripe_kernel(codes, *meta)
    assert all(_same(a, b) for a, b in zip(got, seal_ref.seal_stripe_ref(codes, *meta)))
    back = unseal_stripe_kernel(got[0], *meta)
    assert all(_same(a, b) for a, b in zip(back, seal_ref.unseal_stripe_ref(got[0], *meta)))
    g = torch.Generator().manual_seed(1)
    q, n = 12289, 256
    a = torch.randint(0, q, (n,), generator=g, dtype=torch.int32).to(dev)
    vecs = torch.randint(0, q, (3, n), generator=g, dtype=torch.int32).to(dev)
    assert _same(negacyclic_matmul(a, vecs, q), poly_ref.negacyclic_matmul_ref(a, vecs, q))
    assert torch.cuda.current_device() == 0
