"""The port's CUDA kernels and decoders on a card (marker ``cuda``).

Every test skips where ``torch.cuda.is_available()`` is False.  This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
"""

import numpy as np
import pytest
import torch

import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu_torch.ops import cuda_gf2, cuda_minsum
from ldpcdecoders_tpu_torch.ops import minsum as plain_minsum

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def systems(rng, B, m, n, dens):
    H = (rng.random((B, m, n)) < dens).astype(np.int64)
    W = (n + 31) // 32
    Hpad = np.pad(H, ((0, 0), (0, 0), (0, W * 32 - n))).reshape(B, m, W, 32)
    words = (Hpad << np.arange(32)).sum(axis=3)  # [B, m, W] < 2**32
    Ht = np.ascontiguousarray(words.transpose(0, 2, 1)).astype(np.uint32).view(np.int32)
    return H, torch.as_tensor(Ht)


# m > 1024 exercises rows strided over the block; n % 32 != 0 a ragged word
SHAPES = [(5, 60, 80, 0.3), (4, 31, 33, 0.5), (3, 96, 240, 0.05), (2, 1100, 1300, 0.004)]


@pytest.mark.parametrize("B,m,n,dens", SHAPES)
def test_osd0_kernel_matches_plain_version(dev, B, m, n, dens):
    rng = np.random.default_rng(m)
    H, Ht = systems(rng, B, m, n, dens)
    bp = (rng.random((B, n)) < 0.2).astype(np.int32)
    extra = (rng.random((B, n)) < 0.1).astype(np.int64)
    resid = (np.einsum("bmn,bn->bm", H, extra) % 2).astype(np.int32)
    resid[0] = rng.random(m) < 0.5  # possibly outside the row space
    resid[-1] = 0  # nothing to correct
    args = [torch.as_tensor(a) for a in (resid, bp)]
    want = cuda_gf2.gf2_osd0_ref(Ht, *args, n)
    before = cuda_gf2.gf2_osd0_cuda.launches
    got = cuda_gf2.gf2_osd0_cuda(Ht.to(dev), *(a.to(dev) for a in args), n)
    torch.cuda.synchronize()
    assert cuda_gf2.gf2_osd0_cuda.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("B,m,n,dens", SHAPES)
def test_eliminate_kernel_matches_plain_version(dev, B, m, n, dens):
    rng = np.random.default_rng(n)
    _, Ht = systems(rng, B, m, n, dens)
    s = torch.as_tensor((rng.random((B, m)) < 0.5).astype(np.int32))
    want = cuda_gf2.gf2_eliminate_ref(Ht, s, n)
    got = cuda_gf2.gf2_eliminate_cuda(Ht.to(dev), s.to(dev), n)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_wrappers_check_inputs(dev):
    n, m = 64, 20
    Ht = torch.zeros((2, 2, m), dtype=torch.int32, device=dev)
    s = torch.zeros((2, m), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int32"):
        cuda_gf2.gf2_eliminate_cuda(Ht, s.to(torch.int64), n)
    with pytest.raises(ValueError, match="words per row"):
        cuda_gf2.gf2_eliminate_cuda(Ht, s, 100)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gf2.gf2_eliminate_cuda(Ht, torch.zeros((m, 2), dtype=torch.int32,
                                                    device=dev).t(), n)
    big = torch.zeros((1, 989, 864), dtype=torch.int32, device=dev)  # bb144 DEM lane
    with pytest.raises(ValueError, match="shared memory"):
        cuda_gf2.gf2_eliminate_cuda(big, torch.zeros((1, 864), dtype=torch.int32,
                                                     device=dev), 31648)


@pytest.mark.parametrize("order", [0, 2])
def test_decoder_on_card_matches_cpu(dev, order):
    H = pt.parity_check_matrix(240, 8, 4, rng=17)
    rng = np.random.default_rng(order)
    errs = rng.random((32, 240)) < 0.12
    syns = ((errs @ H.T) % 2).astype(np.uint8)
    graph = pt.TannerGraph.from_pcm(H)
    cpu = pt.BeliefPropagationOSDDecoder(graph, 0.12, 20, osd_order=order, device="cpu")
    gpu = pt.BeliefPropagationOSDDecoder(graph, 0.12, 20, osd_order=order, device=dev)
    e_c, c_c, i_c, a_c, _ = cpu.batch_decode_detailed(syns)
    e_g, c_g, i_g, a_g, _ = gpu.batch_decode_detailed(syns)
    assert np.array_equal(c_c, c_g) and np.array_equal(i_c, i_g)
    assert not c_c.all()
    assert (((e_g.astype(np.int64) @ H.T) % 2) == syns).all()
    # lanes whose reliability order agrees must agree bitwise (exp may
    # differ by an ulp between the CPU and the card)
    same = []
    for lp in (a_c["log_probabs"], a_g["log_probabs"]):
        p = torch.exp(torch.as_tensor(lp))
        same.append(torch.argsort(-torch.maximum(p, 1 - p), dim=1, stable=True).numpy())
    agree = (same[0] == same[1]).all(axis=1)
    assert agree.mean() >= 0.75
    assert np.array_equal(e_c[agree], e_g[agree])


def random_graph(rng, m, n, dens, heavy_row=False):
    """A random Tanner graph with degree-1 checks and padded slots."""
    H = (rng.random((m, n)) < dens).astype(np.uint8)
    if heavy_row:
        H[0] = 1
    H[-1] = 0
    H[-1, rng.integers(n)] = 1  # a degree-1 check
    H[rng.integers(m), H.sum(axis=0) == 0] = 1  # no isolated variable
    return pt.TannerGraph.from_pcm(H)


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


# (B, m, n, density, heavy row): m not a multiple of 32, dc = 1 (m x m
# identity-like), dc > 64 (signs past the register mask), B = 1 and B = 0
MINSUM_SHAPES = [(5, 37, 75, 0.1, False), (1, 33, 50, 0.2, False), (3, 21, 90, 0.1, True),
                 (0, 37, 75, 0.1, False), (4, 1, 1, 1.0, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,m,n,dens,heavy", MINSUM_SHAPES)
def test_minsum_kernels_match_plain_versions(dev, dtype, B, m, n, dens, heavy):
    rng = np.random.default_rng(m * n + B)
    g = random_graph(rng, m, n, dens, heavy) if n > 1 else pt.TannerGraph.from_pcm(
        np.ones((1, 1), np.uint8))
    if heavy:
        assert g.max_dc > 64
    c2v, v2c, chk_mask, var_mask = (torch.as_tensor(a) for a in g.slot_major())
    c2v, v2c = c2v.to(torch.int32), v2c.to(torch.int32)
    dc, dv = g.max_dc, g.max_dv
    nu = torch.as_tensor(rng.normal(size=(B, dv * n)) * 3).to(dtype)
    nu[:, ::7] = 0.0
    nu[:, 1::11] = nu[:, :1].expand(-1, nu[:, 1::11].shape[1])  # ties
    Ng = torch.as_tensor(rng.normal(size=(B, dc, m)) * 3).to(dtype)
    syn = torch.as_tensor(rng.random((B, m)) < 0.5)
    mu_flat = torch.as_tensor(rng.normal(size=(B, dc * m)) * 3).to(dtype)
    L0 = torch.as_tensor(rng.normal(size=(B, n)) * 2).to(dtype)
    W = torch.as_tensor(rng.uniform(0.3, 1.4, size=(dv, n))).to(dtype)
    on = lambda *ts: [None if t is None else t.to(dev) for t in ts]  # noqa: E731

    for alpha, beta in ((1.0, 0.0), (0.8125, 0.15625)):
        for x, idx in ((nu, c2v), (Ng, None)):
            want = cuda_minsum.minsum_check_cuda(x, idx, syn, chk_mask, alpha, beta)
            before = cuda_minsum.minsum_check_cuda.launches
            got = cuda_minsum.minsum_check_cuda(*on(x, idx, syn, chk_mask), alpha, beta)
            torch.cuda.synchronize()
            assert cuda_minsum.minsum_check_cuda.launches == before + (B > 0)
            assert got.dtype == dtype and torch.equal(bits(got.cpu()), bits(want))
    for w in (None, W):
        for want_nu in (True, False):
            want = cuda_minsum.minsum_var_cuda(mu_flat, v2c, var_mask, L0, w, want_nu)
            got = cuda_minsum.minsum_var_cuda(*on(mu_flat, v2c, var_mask, L0, w), want_nu)
            torch.cuda.synchronize()
            assert (got[0] is None) == (not want_nu)
            for a, b in zip(got, want):
                if a is not None:
                    assert torch.equal(bits(a.cpu()), bits(b))
    # the plain versions on the card equal the plain versions on the CPU
    got = plain_minsum.check_update_ref(*on(nu, c2v, syn, chk_mask), 0.8125, 0.15625)
    want = plain_minsum.check_update_ref(nu, c2v, syn, chk_mask, 0.8125, 0.15625)
    assert torch.equal(bits(got.cpu()), bits(want))


def test_minsum_wrappers_check_inputs(dev):
    g = pt.TannerGraph.from_pcm(pt.parity_check_matrix(60, 6, 3, rng=19))
    c2v, v2c, chk_mask, var_mask = (torch.as_tensor(a).to(dev) for a in g.slot_major())
    c2v, v2c = c2v.to(torch.int32), v2c.to(torch.int32)
    nu = torch.zeros((2, g.max_dv * g.n), device=dev)
    syn = torch.zeros((2, g.m), dtype=torch.bool, device=dev)
    with pytest.raises(TypeError, match="int32"):
        cuda_minsum.minsum_check_cuda(nu, c2v.to(torch.int64), syn, chk_mask, 1.0, 0.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_minsum.minsum_check_cuda(nu.to(torch.float16), c2v, syn, chk_mask, 1.0, 0.0)
    with pytest.raises(TypeError, match="bool"):
        cuda_minsum.minsum_check_cuda(nu, c2v, syn.to(torch.uint8), chk_mask, 1.0, 0.0)
    with pytest.raises(ValueError, match="expected cuda"):
        cuda_minsum.minsum_check_cuda(nu, c2v.cpu(), syn, chk_mask, 1.0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_minsum.minsum_var_cuda(torch.zeros((g.max_dc * g.m, 2), device=dev).t(), v2c,
                                    var_mask, torch.zeros((2, g.n), device=dev))
    with pytest.raises(TypeError, match="L0"):
        cuda_minsum.minsum_var_cuda(torch.zeros((2, g.max_dc * g.m), device=dev), v2c,
                                    var_mask, torch.zeros((2, g.n), device=dev,
                                                          dtype=torch.bfloat16))


@pytest.mark.parametrize("kw", [dict(), dict(dtype=torch.bfloat16), dict(damping=0.4),
                                dict(layout="check", check_every=4),
                                dict(alpha=0.8, beta=0.1, track_best=True)])
def test_minsum_on_card_matches_cpu(dev, kw):
    H = pt.parity_check_matrix(240, 8, 4, rng=37)
    rng = np.random.default_rng(3)
    errs = rng.random((32, 240)) < 0.05
    syns = torch.as_tensor(((errs @ H.T) % 2).astype(np.uint8))
    graph = pt.TannerGraph.from_pcm(H)
    cpu = pt.MinSumDecode(graph, 0.05, 30, device="cpu", **kw)
    gpu = pt.MinSumDecode(graph, 0.05, 30, device=dev, **kw)
    before = cuda_minsum.minsum_var_cuda.launches
    want = cpu(syns)
    got = gpu(syns.to(dev))
    assert cuda_minsum.minsum_var_cuda.launches > before
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(bits(got[3].cpu()), bits(want[3]))


def test_default_device_is_the_card(dev):
    H = pt.parity_check_matrix(60, 6, 3, rng=19)
    for dec in (pt.MinSumDecoder(H, 0.05, 10), pt.BeliefPropagationDecoder(H, 0.05, 10),
                pt.BeliefPropagationOSDDecoder(H, 0.05, 10, inner="minsum")):
        assert dec.device == torch.device("cuda", torch.cuda.current_device())
        g, c = dec.batch_decode(np.zeros((2, H.shape[0]), np.uint8))
        assert c.all() and not g.any()
