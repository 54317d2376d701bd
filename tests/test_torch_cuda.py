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
from ldpcdecoders_tpu_torch.ops import cuda_gf2

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
