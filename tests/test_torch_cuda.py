"""The port's CUDA kernels and decoders on a card (marker ``cuda``).

Every test skips where ``torch.cuda.is_available()`` is False.  This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
"""

import dataclasses
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu_torch.ops import cuda_gf2, cuda_minsum, cuda_qc, gf2
from ldpcdecoders_tpu_torch.ops import minsum as plain_minsum
from ldpcdecoders_tpu_torch.ops.qc_minsum import (QCTerms, qc_flooding_state, qc_minsum_ref,
                                                  qc_smem_bytes)

pytestmark = pytest.mark.cuda
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def systems_from(H):
    """Dense 0/1 ``[B, m, n]`` -> transposed packed ``Ht [B, W, m]`` int32."""
    B, m, n = H.shape
    W = (n + 31) // 32
    Hpad = np.pad(H, ((0, 0), (0, 0), (0, W * 32 - n))).reshape(B, m, W, 32)
    words = (Hpad << np.arange(32)).sum(axis=3)  # [B, m, W] < 2**32
    Ht = np.ascontiguousarray(words.transpose(0, 2, 1)).astype(np.uint32).view(np.int32)
    return torch.as_tensor(Ht)


def systems(rng, B, m, n, dens):
    H = (rng.random((B, m, n)) < dens).astype(np.int64)
    return H, systems_from(H)


# m > 1024 exercises rows strided over the block; n % 32 != 0 a ragged word;
# the lane of (1400, 1120) leaves room for a table of 16 rows only, so the
# launcher narrows the panel to 4 columns; (40, 100) at density 0.2 has
# duplicate and dependent rows and columns without a pivot
SHAPES = [(5, 60, 80, 0.3), (4, 31, 33, 0.5), (3, 96, 240, 0.05), (2, 1100, 1300, 0.004),
          (2, 1400, 1120, 0.004), (3, 40, 100, 0.2)]


def osd0_inputs(rng, H, B, m, n):
    bp = (rng.random((B, n)) < 0.2).astype(np.int32)
    extra = (rng.random((B, n)) < 0.1).astype(np.int64)
    resid = (np.einsum("bmn,bn->bm", H, extra) % 2).astype(np.int32)
    resid[0] = rng.random(m) < 0.5  # possibly outside the row space
    resid[-1] = 0  # nothing to correct
    return torch.as_tensor(resid), torch.as_tensor(bp)


@pytest.mark.parametrize("B,m,n,dens", SHAPES)
def test_osd0_kernel_matches_plain_version(dev, B, m, n, dens):
    rng = np.random.default_rng(m)
    H, Ht = systems(rng, B, m, n, dens)
    args = osd0_inputs(rng, H, B, m, n)
    want = cuda_gf2.gf2_osd0_ref(Ht, *args, n)
    assert torch.equal(gf2.gf2_osd0_blocked(Ht, *args, n), want)
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
    for a, b in zip(gf2.gf2_eliminate_blocked(Ht, s, n), want):
        assert torch.equal(a, b)
    got = cuda_gf2.gf2_eliminate_cuda(Ht.to(dev), s.to(dev), n)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("panel", [1, 2, 4, 8])
@pytest.mark.parametrize("B,m,n,dens", [(5, 60, 80, 0.3), (3, 40, 100, 0.2),
                                        (2, 1100, 1300, 0.004)])
def test_gf2_kernels_at_every_panel_width(dev, panel, B, m, n, dens):
    """The launcher's narrower panels (and P = 1, which has no table) give
    the same bits as the widest; the all-zero system and a full-rank lane
    that ends inside a panel are among the lanes."""
    rng = np.random.default_rng(m + n)
    H, Ht = systems(rng, B, m, n, dens)
    H[-1] = 0
    H[0] = 0  # identity on columns 3..m+2: full rank reached inside a panel
    H[0, np.arange(m), np.arange(m) + 3] = 1
    Ht = systems_from(H)
    s = torch.as_tensor((rng.random((B, m)) < 0.5).astype(np.int32))
    resid, bp = osd0_inputs(rng, H, B, m, n)
    got = cuda_gf2.gf2_eliminate_cuda(Ht.to(dev), s.to(dev), n, _max_panel=panel)
    torch.cuda.synchronize()
    for a, b in zip(got, cuda_gf2.gf2_eliminate_ref(Ht, s, n)):
        assert torch.equal(a.cpu(), b)
    got = cuda_gf2.gf2_osd0_cuda(Ht.to(dev), resid.to(dev), bp.to(dev), n, _max_panel=panel)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cuda_gf2.gf2_osd0_ref(Ht, resid, bp, n))


def test_osd0_kernel_lanes_stop_inside_a_panel(dev):
    """Lane b's residual is column b of its system: OSD-0 stops at the entry
    of column b + 1, at every offset of a panel of 8, and must neither
    record nor apply the panel's later pivots."""
    B, m, n = 24, 70, 120
    rng = np.random.default_rng(3)
    H, Ht = systems(rng, B, m, n, 0.3)
    Ht = systems_from(H)
    resid = torch.as_tensor(np.stack([H[b, :, b] for b in range(B)]).astype(np.int32))
    bp = torch.as_tensor((rng.random((B, n)) < 0.2).astype(np.int32))
    want, (trips, *_) = gf2.gf2_osd0(Ht, resid, bp, n, return_work=True)
    assert sorted(set((trips % 8).tolist())) == list(range(8))
    assert torch.equal(gf2.gf2_osd0_blocked(Ht, resid, bp, n), want)
    got = cuda_gf2.gf2_osd0_cuda(Ht.to(dev), resid.to(dev), bp.to(dev), n)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_gf2_launcher_plan_is_launch_plan(dev):
    """The plan the built launcher reports (panel width, padding, packed
    ``bp_err``, bytes) is the one ``launch_plan`` computes in Python, over
    shapes on both sides of every limit: 1024 rows, each panel width, the
    bare lane, no fit."""
    assert cuda_gf2.launcher_plan(35, 1400, osd0=True).panel == 4
    seen = set()
    rows = sorted({*range(1, 70), *range(70, 2400, 37), 1023, 1024, 1025, 1051, 1400, 1600})
    for m in rows:
        for W in (*range(1, 36), *range(36, 130, 3), 54, 55, 118, 119):
            for osd0 in (False, True):
                for panel in (8, 4, 2, 1):
                    want = cuda_gf2.launch_plan(W, m, osd0=osd0, panel=panel)
                    assert cuda_gf2.launcher_plan(W, m, osd0=osd0, panel=panel) == want, (W, m)
                    seen.add((want.panel, want.pad))
    assert seen == {(8, True), (4, True), (2, True), (1, True), (1, False), (0, False)}


def test_gf2_phase_clocks_build(dev):
    """The build with ``LDPC_GF2_PHASE_CLOCKS`` gives the same bits and
    leaves block 0's phase clocks; a panel cap that is no power of two is
    refused."""
    import ctypes

    from ldpcdecoders_tpu_torch._build import load_library

    lib = load_library(("LDPC_GF2_PHASE_CLOCKS",))
    rng = np.random.default_rng(8)
    H, Ht = systems(rng, 2, 60, 80, 0.3)
    resid, bp = osd0_inputs(rng, H, 2, 60, 80)
    got = cuda_gf2.gf2_osd0_cuda(Ht.to(dev), resid.to(dev), bp.to(dev), 80, _lib=lib)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cuda_gf2.gf2_osd0_ref(Ht, resid, bp, 80))
    clocks = (ctypes.c_longlong * 5)()
    assert lib.ldpc_gf2_phase_clocks(clocks) == 0
    trips, behind, overlapped, whole, panels = clocks
    assert 0 < trips < whole and 0 < panels <= 10 and behind > 0 and overlapped > 0
    with pytest.raises(ValueError, match="panel"):
        cuda_gf2.gf2_osd0_cuda(Ht.to(dev), resid.to(dev), bp.to(dev), 80, _max_panel=3)


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
    # the bb144 DEM lane fits no block: the device-memory body takes it
    big = torch.zeros((1, 989, 864), dtype=torch.int32, device=dev)
    before = cuda_gf2.gf2_eliminate_cuda.routes["global"]
    _, s2, piv = cuda_gf2.gf2_eliminate_cuda(big, torch.zeros((1, 864), dtype=torch.int32,
                                                              device=dev), 31648)
    assert cuda_gf2.gf2_eliminate_cuda.routes["global"] == before + 1
    assert (piv == 31648).all() and (s2 == 0).all()
    # rows past what the body's state and row list fit in shared memory
    many = torch.zeros((1, 1, 30000), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_gf2.gf2_eliminate_cuda(many, torch.zeros((1, 30000), dtype=torch.int32,
                                                      device=dev), 32)


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
                                dict(alpha=0.8, beta=0.1, track_best=True),
                                dict(layout="check", damping=0.4, check_every=8),
                                dict(layout="check", dtype=torch.bfloat16, lane_damping=True,
                                     track_best=True, check_every=8),
                                dict(lane_damping=True, edge_weights=True)])
def test_minsum_on_card_matches_cpu(dev, kw):
    H = pt.parity_check_matrix(240, 8, 4, rng=37)
    rng = np.random.default_rng(3)
    errs = rng.random((32, 240)) < 0.05
    syns = torch.as_tensor(((errs @ H.T) % 2).astype(np.uint8))
    graph = pt.TannerGraph.from_pcm(H)
    gamma = None
    if kw.get("lane_damping"):  # per-variable strengths, negative ones among them
        gamma = torch.as_tensor(rng.uniform(-0.24, 0.66, (32, 240)).astype(np.float32))
    if kw.get("edge_weights"):
        kw = dict(kw, edge_weights=rng.uniform(0.5, 1.2, (30, graph.max_dv, 240)))
    cpu = pt.MinSumDecode(graph, 0.05, 30, device="cpu", **kw)
    gpu = pt.MinSumDecode(graph, 0.05, 30, device=dev, **kw)
    before = cuda_minsum.minsum_var_iter_cuda.launches
    want = cpu(syns, None, gamma)
    got = gpu(syns.to(dev), None, None if gamma is None else gamma.to(dev))
    assert cuda_minsum.minsum_var_iter_cuda.launches > before
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


# ---- the whole-decode group-circulant kernel --------------------------------


def random_terms(rng, mb, nb, l, m, per_row, light_row=False):
    """Random group-circulant terms: ``per_row`` per base row (several may
    share a block), every block column covered; ``light_row`` makes the
    last base row a weight-1 row."""
    terms = set()
    for i in range(mb):
        want = 1 if (light_row and i == mb - 1) else per_row
        row = set()
        while len(row) < want:
            row.add((i, int(rng.integers(nb)), int(rng.integers(l)), int(rng.integers(m))))
        terms |= row
    for j in range(nb):
        if not any(t[1] == j for t in terms):
            terms.add((int(rng.integers(mb - light_row)), j, int(rng.integers(l)),
                       int(rng.integers(m))))
    return QCTerms.build(sorted(terms), mb, nb, (l, m))


def qc_inputs(rng, terms, B, per):
    """Syndromes of random errors through the lifted code, and per-lane priors."""
    Z, n = terms.Z, terms.nb * terms.Z
    errs = rng.random((B, n)) < per
    syn = np.zeros((B, terms.mb * Z), np.uint8)
    w = np.arange(Z)
    u, v = np.divmod(w, terms.m)
    for i, j, a, b in terms.edges:
        sig = ((u + a) % terms.l) * terms.m + (v + b) % terms.m
        syn[:, i * Z + w] ^= errs[:, j * Z + sig]
    pri = np.log((1 - per) / per) * rng.uniform(0.5, 1.5, size=(B, n))
    pri[:, ::9] = 0.0  # erased bits
    return torch.as_tensor(syn), torch.as_tensor(pri.astype(np.float32))


# (B, mb, nb, l, m, terms per row, weight-1 row): odd Z, Z not a multiple of
# 32 with several terms per block, Z above 1024 (positions strided over the
# threads), a lift of 15 positions (half a warp) over 37 lanes, B = 1
QC_SHAPES = [(5, 3, 5, 7, 1, 3, False), (9, 2, 4, 6, 6, 4, True), (3, 2, 3, 1100, 1, 2, False),
             (37, 2, 4, 3, 5, 5, False), (1, 3, 6, 12, 6, 4, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("B,mb,nb,l,m,per_row,light", QC_SHAPES)
def test_qc_kernel_matches_plain_version(dev, dtype, schedule, B, mb, nb, l, m, per_row, light):
    rng = np.random.default_rng(B * 1000 + l)
    terms = random_terms(rng, mb, nb, l, m, per_row, light)
    table = torch.as_tensor(terms.table(), device=dev)
    syn, pri = qc_inputs(rng, terms, B, 0.03)
    for priors in (None, pri, pri[0].contiguous()):
        kw = dict(alpha=0.8125, beta=0.15625, schedule=schedule, dtype=dtype)
        want = qc_minsum_ref(syn, terms, 3.0, 12, priors=priors, **kw)
        before = cuda_qc.qc_minsum_cuda.launches
        got = cuda_qc.qc_minsum_cuda(syn.to(dev), terms, table, 3.0, 12,
                                     priors=None if priors is None else priors.to(dev), **kw)
        torch.cuda.synchronize()
        assert cuda_qc.qc_minsum_cuda.launches == before + 1
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
        assert torch.equal(bits(got[3].cpu()), bits(want[3]))  # min-sum: bitwise


def sweep_codes(name):
    """Codes for the layered sweep's two kinds of base row: one phase where
    the row's block columns are distinct, two where one repeats."""
    if name == "distinct":  # path (j)'s base graph at Z=32
        base = pt.random_qc_base_matrix(24, 6, 3, 32, rng=7)
        bi, bj = np.nonzero(base >= 0)
        return QCTerms.build([(int(i), int(j), int(base[i, j]), 0) for i, j in zip(bi, bj)],
                             12, 24, (32, 1))
    if name == "bb72":  # three terms in each block column of the one row
        return pt.QCMinSumDecoder.for_bicycle("bb72", "x", 0.01, 4, device="cpu").qc_terms
    if name == "odd_Z":  # distinct columns on a 9 x 5 lift: Z = 45
        rng = np.random.default_rng(45)
        return QCTerms.build([(i, j, int(rng.integers(9)), int(rng.integers(5)))
                              for i in range(4) for j in rng.choice(10, 4, replace=False)]
                             + [(4, j, 0, j % 5) for j in range(10)], 5, 10, (9, 5))
    # mixed: distinct rows, a row repeating a column, rows past the 8 edges
    # held in registers (weight 11 distinct; weight 40 with repeats, signs
    # past 32)
    terms = [(0, 0, 1, 2), (0, 1, 3, 0), (0, 2, 4, 4), (1, 2, 0, 1), (1, 2, 5, 3), (1, 3, 2, 2)]
    terms += [(2, j, (3 * j) % 9, (2 * j + 1) % 5) for j in range(11)]
    terms += [(3, j % 30, (j * 7) % 9, (j * 3) % 5) for j in range(40)]
    return QCTerms.build(terms, 4, 30, (9, 5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("code", ["distinct", "bb72", "odd_Z", "mixed"])
def test_qc_sweep_one_and_two_phase_rows(dev, code, dtype):
    """The layered sweep bitwise against the plain version on rows of either
    kind; lane 0 (syndrome 0) stops after one sweep, lane 1 (half its
    checks violated) runs all ``max_iters``, in the same launch; priors
    that decide some bits 1 before the first sweep."""
    terms = sweep_codes(code)
    two = sum(terms.two_phase_rows)
    assert {"distinct": two == 0, "bb72": two == terms.mb, "odd_Z": two == 0,
            "mixed": 0 < two < terms.mb}[code]
    rng = np.random.default_rng(terms.Z + terms.Eb)
    table = torch.as_tensor(terms.table(), device=dev)
    syn, pri = qc_inputs(rng, terms, 12, 0.02)
    syn[0] = 0
    syn[1] = torch.as_tensor(rng.random(syn.shape[1]) < 0.5)
    neg = pri.clone()
    neg[2:, 1::13] *= -1.0  # decisions of 1 before the first sweep
    for priors in (None, pri, pri[0].contiguous(), neg):
        kw = dict(alpha=0.8125, beta=0.15625, schedule="layered", dtype=dtype)
        want = qc_minsum_ref(syn, terms, 3.0, 14, priors=priors, **kw)
        got = cuda_qc.qc_minsum_cuda(syn.to(dev), terms, table, 3.0, 14,
                                     priors=None if priors is None else priors.to(dev), **kw)
        torch.cuda.synchronize()
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
        assert torch.equal(bits(got[3].cpu()), bits(want[3]))
        assert want[2][0] == 1 and want[1][0] and want[2][1] == 14 and not want[1][1]
    # flooding and sum-product take the same row update
    for kw in (dict(alpha=0.75, beta=0.0), dict(algorithm="sumproduct"),
               dict(algorithm="sumproduct", schedule="layered")):
        want = qc_minsum_ref(syn.to(dev), terms, 3.0, 14, **kw)
        got = cuda_qc.qc_minsum_cuda(syn.to(dev), terms, table, 3.0, 14, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)
        if "algorithm" in kw:
            torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=0.024)
        else:
            assert torch.equal(bits(got[3]), bits(want[3]))

@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_qc_kernel_sumproduct(dev, schedule):
    rng = np.random.default_rng(5)
    terms = random_terms(rng, 3, 6, 12, 6, 4)
    table = torch.as_tensor(terms.table(), device=dev)
    syn, pri = qc_inputs(rng, terms, 21, 0.02)
    kw = dict(schedule=schedule, algorithm="sumproduct")
    want = qc_minsum_ref(syn.to(dev), terms, 3.5, 15, **kw)  # the card's own tanh / log1p
    got = cuda_qc.qc_minsum_cuda(syn.to(dev), terms, table, 3.5, 15, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    # the same library functions in the same order: a few float32
    # spacings at the clamp's slope at most (measured: bitwise)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=0.024)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("code", ["distinct", "bb72", "odd_Z", "mixed"])
def test_qc_flooding_body_matches_plain_version(dev, code, dtype):
    """The flooding sweep bitwise against the plain version: two-min states
    (rows of at most 27 edges; "mixed" has rows of 11 edges, past the 8
    held in registers, and of 40, past the sign word, so it keeps every
    message), a prior vector, per-lane priors and priors that decide bits 1
    before the first sweep; lane 0 (syndrome 0) stops after one sweep, lane
    1 runs all ``max_iters``; no sweep at ``max_iters`` 0."""
    terms = sweep_codes(code)
    want_state = "messages" if code == "mixed" else "two_min"
    assert qc_flooding_state(terms, False) == want_state
    rng = np.random.default_rng(terms.Z + terms.Eb)
    table = torch.as_tensor(terms.table(), device=dev)
    syn, pri = qc_inputs(rng, terms, 12, 0.02)
    syn[0] = 0
    syn[1] = torch.as_tensor(rng.random(syn.shape[1]) < 0.5)
    neg = pri.clone()
    neg[2:, 1::13] *= -1.0
    for priors, knobs, iters in ((None, dict(alpha=0.8125, beta=0.15625), 14),
                                 (pri, dict(alpha=0.75), 14), (pri[0].contiguous(), {}, 14),
                                 (neg, dict(beta=0.5), 14), (pri, {}, 0)):
        kw = dict(dtype=dtype, **knobs)
        want = qc_minsum_ref(syn, terms, 3.0, iters, priors=priors, **kw)
        before = dict(cuda_qc.qc_minsum_cuda.routes)
        got = cuda_qc.qc_minsum_cuda(syn.to(dev), terms, table, 3.0, iters,
                                     priors=None if priors is None else priors.to(dev), **kw)
        torch.cuda.synchronize()
        assert cuda_qc.qc_minsum_cuda.routes[f"flooding_{want_state}"] == (
            before[f"flooding_{want_state}"] + 1)
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
        assert torch.equal(bits(got[3].cpu()), bits(want[3]))
        if iters:
            assert want[2][0] == 1 and want[1][0] and want[2][1] == iters and not want[1][1]
        else:
            assert not want[1].any() and not want[2].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("code", ["distinct", "bb72", "mixed"])
def test_qc_flooding_sumproduct_matches_plain_version(dev, code, dtype):
    """Flooding sum-product (every message kept), with and without per-lane
    priors: flags and sweeps bitwise, LLRs within 2**13 float32 spacings
    (the same tanhf / log1pf as torch's kernels on the card; near the clamp
    one spacing of a tanh product moves a message 1e5 times as much)."""
    terms = sweep_codes(code)
    rng = np.random.default_rng(terms.Eb)
    table = torch.as_tensor(terms.table(), device=dev)
    syn, pri = qc_inputs(rng, terms, 12, 0.02)
    syn[0] = 0
    for priors in (None, pri.to(dev)):
        kw = dict(algorithm="sumproduct", dtype=dtype, priors=priors)
        want = qc_minsum_ref(syn.to(dev), terms, 3.5, 15, **kw)
        got = cuda_qc.qc_minsum_cuda(syn.to(dev), terms, table, 3.5, 15, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)
        assert (bits(got[3]) - bits(want[3])).abs().max() <= 2**13


def test_qc_launcher_smem_is_qc_smem_bytes(dev):
    """The launcher's own shared-memory sum (``ldpc_qc_smem_bytes``) and its
    Python mirror agree on every mode and size over random codes."""
    from ldpcdecoders_tpu_torch import _build

    lib = _build.load_library()
    rng = np.random.default_rng(11)
    for case in range(60):
        mb, nb = int(rng.integers(1, 6)), int(rng.integers(2, 12))
        l, m = int(rng.integers(1, 40)), int(rng.choice([1, 1, 3, 6]))
        per_row = min(int(rng.integers(1, 45)), nb * l * m)
        terms = random_terms(rng, mb, nb, l, m, per_row, bool(case % 2) and mb > 1)
        for threads, size, layered, sumprod, prior in itertools.product(
                (terms.Z, 32), (4, 2), (0, 1), (0, 1), (0, 1)):
            got = lib.ldpc_qc_smem_bytes(terms.l, terms.m, terms.mb, terms.nb, terms.Eb,
                                         terms.max_row_weight, terms.buffered_row_weight,
                                         threads, size, layered, sumprod, prior)
            want = qc_smem_bytes(terms, threads, size, bool(layered), bool(sumprod),
                                 prior=bool(prior) and not layered)
            assert got == want, (case, threads, size, layered, sumprod, prior)


def test_qc_wrapper_edges_and_refusal(dev):
    rng = np.random.default_rng(1)
    terms = random_terms(rng, 2, 4, 8, 1, 3)
    table = torch.as_tensor(terms.table(), device=dev)
    before = cuda_qc.qc_minsum_cuda.launches
    out = cuda_qc.qc_minsum_cuda(torch.zeros((0, 16), dtype=torch.uint8, device=dev), terms,
                                 table, 3.0, 5)
    assert [tuple(t.shape) for t in out] == [(0, 32), (0,), (0,), (0, 32)]
    assert cuda_qc.qc_minsum_cuda.launches == before  # nothing to launch
    syn = torch.zeros((2, 16), dtype=torch.uint8, device=dev)
    err, conv, iters, llrs = cuda_qc.qc_minsum_cuda(syn, terms, table, 3.0, 0)  # no sweep
    assert not conv.any() and not iters.any() and not err.any() and (llrs == 3.0).all()
    with pytest.raises(ValueError, match=r"syndromes must be \[B, 16\]"):
        cuda_qc.qc_minsum_cuda(syn[:, :8], terms, table, 3.0, 5)
    with pytest.raises(TypeError, match="int32"):
        cuda_qc.qc_minsum_cuda(syn, terms, table.to(torch.int64), 3.0, 5)
    with pytest.raises(ValueError, match="expected cuda"):
        cuda_qc.qc_minsum_cuda(syn, terms, table.cpu(), 3.0, 5)
    with pytest.raises(TypeError, match="float32"):
        cuda_qc.qc_minsum_cuda(syn, terms, table, 3.0, 5,
                               priors=torch.zeros(32, dtype=torch.float64, device=dev))
    # (6, 3)-regular nb=24: at Z=512 float32 fits a block in either schedule
    # (flooding with its two-min states); at Z=1024 float32 flooding does
    # not, bfloat16 flooding does
    base = pt.random_qc_base_matrix(24, 6, 3, 512, rng=7)
    zeros = np.zeros((2, 12 * 512), np.uint8)
    for schedule in ("layered", "flooding"):
        g, c = pt.QCMinSumDecoder(base, 512, 0.04, 4, schedule=schedule).batch_decode(zeros)
        assert c.all() and not g.any()
    base = pt.random_qc_base_matrix(24, 6, 3, 1024, rng=7)
    zeros = np.zeros((2, 12 * 1024), np.uint8)
    with pytest.raises(ValueError, match="shared memory"):
        pt.QCMinSumDecoder(base, 1024, 0.04, 4)
    g, c = pt.QCMinSumDecoder(base, 1024, 0.04, 4, dtype=torch.bfloat16).batch_decode(zeros)
    assert c.all() and not g.any()


@pytest.mark.parametrize("kw", [dict(), dict(schedule="layered"),
                                dict(schedule="layered", dtype=torch.bfloat16)])
def test_qc_decoders_on_card_match_cpu(dev, kw):
    base = pt.random_qc_base_matrix(12, 6, 3, 64, rng=3)
    H = pt.qc_lift(base, 64)
    rng = np.random.default_rng(4)
    errs = rng.random((48, H.shape[1])) < 0.04
    syn = ((errs @ H.T) % 2).astype(np.uint8)
    cpu = pt.QCMinSumDecoder(base, 64, 0.04, 20, device="cpu", **kw)
    gpu = pt.QCMinSumDecoder(base, 64, 0.04, 20, **kw)
    assert gpu.device.type == "cuda"
    for per in (None, 0.03, np.where(rng.random((48, H.shape[1])) < 0.1, 0.5, 0.04)):
        want = cpu.batch_decode_detailed(syn, per=per)
        got = gpu.batch_decode_detailed(syn, per=per)
        for a, b in zip(got[:3], want[:3]):
            assert np.array_equal(a, b)
        assert np.array_equal(got[3]["llrs"].view(np.uint32), want[3]["llrs"].view(np.uint32))
    # flooding: the kernel against the lifted backend (the min-sum kernels).
    # Their variable updates add the prior first and last, so a total that
    # cancels to a rounding residue decides differently for a sweep
    # (tests/test_torch_qc.py shows those totals): the same lanes converge,
    # every one of them, to the same correction, which reproduces its
    # syndrome; lanes that never converge drift apart
    if not kw:
        lifted = pt.QCMinSumDecoder(base, 64, 0.04, 20, backend="lifted")
        outs = [d.batch_decode(syn) for d in (gpu, lifted)]
        for e, c in outs:
            assert (((e.astype(np.int64) @ H.T) % 2)[c] == syn[c]).all()
        conv = outs[0][1]
        assert conv.sum() >= 20 and np.array_equal(conv, outs[1][1])
        assert (outs[0][0][conv] == outs[1][0][conv]).all()


def test_spacetime_for_bicycle_on_card_matches_cpu(dev):
    cpu = pt.SpaceTimeDecoder.for_bicycle("bb72", "x", 3, 0.01, 40, meas_error_rate=0.015,
                                          device="cpu")
    gpu = pt.SpaceTimeDecoder.for_bicycle("bb72", "x", 3, 0.01, 40, meas_error_rate=0.015)
    rng = np.random.default_rng(5)
    x = (rng.random((40, cpu.n_cols)) < cpu._prior[None, :]).astype(np.uint8)
    det = (x @ cpu.A.T.toarray() % 2).astype(np.uint8)
    before = cuda_qc.qc_minsum_cuda.launches
    want = cpu.batch_decode_detailed(det)
    got = gpu.batch_decode_detailed(det)
    assert cuda_qc.qc_minsum_cuda.launches == before + 1
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)
    assert np.array_equal(got[3]["inner"]["llrs"].view(np.uint32),
                          want[3]["inner"]["llrs"].view(np.uint32))
    assert got[1].mean() > 0.9


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dv", [33, 40, 64, 65, 100])
def test_minsum_var_kernel_sums_heavy_columns_as_the_plain_version(dev, dtype, dv):
    """Past 32 slots a variable's messages are summed by windows of 32
    (ops/minsum.py slot_sum, the reference's order): the kernel and the
    plain version bitwise."""
    rng = np.random.default_rng(dv)
    m, n = dv + 3, 70
    H = (rng.random((m, n)) < 0.1).astype(np.uint8)
    H[:dv, 0] = 1  # variable 0 has degree dv
    H[:, 0][dv:] = 0
    H[rng.integers(m), H.sum(axis=0) == 0] = 1
    g = pt.TannerGraph.from_pcm(H)
    assert g.max_dv == dv
    _, v2c, _, var_mask = (torch.as_tensor(a) for a in g.slot_major())
    v2c = v2c.to(torch.int32)
    # magnitudes over six decades: a reordered sum rounds differently
    mu_flat = torch.as_tensor(rng.normal(size=(6, g.max_dc * m))
                              * 10.0 ** rng.integers(-3, 4, (6, g.max_dc * m))).to(dtype)
    L0 = torch.as_tensor(rng.normal(size=(6, n))).to(dtype)
    want = cuda_minsum.minsum_var_cuda(mu_flat, v2c, var_mask, L0)
    got = cuda_minsum.minsum_var_cuda(*(t.to(dev) for t in (mu_flat, v2c, var_mask, L0)))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(bits(a.cpu()), bits(b))


def bb144_dem():
    import scipy.sparse as sp

    z = np.load(REPO / "benchmarks/results/bb144_r6_p0.003.npz")
    A = sp.csr_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
    return A, z["priors"], z["obs"]


@pytest.mark.parametrize("layout", ["check", "var"])
def test_minsum_kernels_at_the_bb144_dem_shape(dev, layout):
    """K3/K4 on the 864 x 31,648 circuit-level graph (check degree up to
    294, past the 64 signs K3 keeps in registers): bitwise against their
    plain versions, float32 and bfloat16."""
    A, pr, _ = bb144_dem()
    g = pt.TannerGraph.from_pcm(np.asarray(A.todense()))
    assert (g.max_dc, g.max_dv) == (294, 12)
    rng = np.random.default_rng(1)
    x = (rng.random((8, g.n)) < pr * 3).astype(np.float32)
    syn = torch.as_tensor((x @ A.T.toarray()) % 2 == 1)
    for dtype in (torch.float32, torch.bfloat16):
        ms = pt.MinSumDecode(g, float(pr.mean()), 4, dtype=dtype, layout=layout, device="cpu")
        L0 = torch.as_tensor(np.log((1 - pr) / pr)).to(dtype).expand(8, -1).contiguous()
        if layout == "check":
            x_in = L0.index_select(1, ms.chk_varidx).reshape(8, g.max_dc, g.m)
            idx = None
        else:
            x_in = L0[:, None, :].expand(8, g.max_dv, g.n).reshape(8, -1).contiguous()
            idx = ms.c2v
        mu = cuda_minsum.minsum_check_cuda(x_in, idx, syn, ms.chk_mask, 1.0, 0.0)
        got_mu = cuda_minsum.minsum_check_cuda(
            x_in.to(dev), None if idx is None else idx.to(dev), syn.to(dev),
            ms.chk_mask.to(dev), 1.0, 0.0)
        assert torch.equal(bits(got_mu.cpu()), bits(mu))
        want = cuda_minsum.minsum_var_cuda(mu.reshape(8, -1), ms.v2c, ms.var_mask, L0)
        got = cuda_minsum.minsum_var_cuda(*(t.to(dev) for t in (
            mu.reshape(8, -1), ms.v2c, ms.var_mask, L0)))
        for a, b in zip(got, want):
            assert torch.equal(bits(a.cpu()), bits(b))
        if layout == "check":  # the next iteration's form, per-variable gammas
            gam = torch.as_tensor(rng.uniform(-0.24, 0.66, (8, g.n))).to(dtype)
            nu0 = x_in.reshape(8, g.max_dc, g.m)
            mu_w, nu_w = mu.clone(), nu0.clone()
            plain_minsum.check_iter_ref(mu_w, want[1], ms.chk_varidx, syn, ms.chk_mask, 1.0,
                                        0.0, gam, nu_w)
            mu_g, nu_g = mu.to(dev), nu0.to(dev)
            cuda_minsum.minsum_check_iter_cuda(
                mu_g, got[1], ms.chk_varidx.to(dev), syn.to(dev), ms.chk_mask.to(dev), 1.0,
                0.0, gamma=gam.to(dev), nu=nu_g)
            real = ms.chk_mask.reshape(-1)
            for a, b in ((mu_g, mu_w), (nu_g, nu_w)):
                assert torch.equal(bits(a.cpu()).reshape(8, -1)[:, real],
                                   bits(b).reshape(8, -1)[:, real])


GAMMAS = [None, "scalar", "lane", "var"]


def gamma_for(kind, rng, B, n, dtype):
    """A damping factor of each kind the kernels take, negative strengths
    among the per-variable ones."""
    if kind is None:
        return None
    if kind == "scalar":
        return torch.tensor(0.4).to(dtype)
    if kind == "lane":
        return torch.as_tensor(rng.uniform(-0.2, 0.7, B)).to(dtype)
    return torch.as_tensor(rng.uniform(-0.24, 0.66, (B, n))).to(dtype)


def iter_graph(name):
    """Graphs of the iteration forms' card tests: checks past 64 slots,
    variables past 16 (not kept in registers) and past 32 slots (summed by
    windows), tests/test_torch_staged.py's small DEM, a Gallager code; and
    ("empty") the first with a check of no real slot."""
    rng = np.random.default_rng(len(name))
    if name == "dem":
        A = (rng.random((40, 300)) < 0.08).astype(np.uint8)  # _small_dem(5)'s shape
        A[:, A.sum(axis=0) == 0] = 1
        return pt.TannerGraph.from_pcm(A)
    if name == "gallager":
        return pt.TannerGraph.from_pcm(pt.parity_check_matrix(60, 6, 3, rng=19))
    H = (rng.random((45, 120)) < 0.08).astype(np.uint8)
    H[0, :90] = 1  # a check of degree 90
    H[:40, 1] = 1  # a variable of degree 40
    H[5:25, 2] = 1  # and one of degree 20
    H[rng.integers(45), H.sum(axis=0) == 0] = 1
    if name == "empty":
        H[7] = 0
        H[8, H.sum(axis=0) == 0] = 1
    return pt.TannerGraph.from_pcm(H)


@pytest.mark.parametrize("graph_name", ["heavy", "dem", "gallager"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gamma_kind", GAMMAS)
def test_minsum_check_iter_kernel_matches_plain_version(dev, graph_name, dtype, gamma_kind):
    """K3's check-layout iteration form (rebuild, damping mix, check update,
    in place) against check_iter_ref, bitwise on the real slots, in the
    staged and the flat form; the padded slots are left as they were."""
    g = iter_graph(graph_name)
    rng = np.random.default_rng(7)
    B, dc, m, n = 5, g.max_dc, g.m, g.n
    ms = pt.MinSumDecode(g, 0.05, 2, layout="check", device="cpu")
    real = ms.chk_mask.reshape(-1)
    mu0 = torch.as_tensor(rng.normal(size=(B, dc, m)) * 2).to(dtype)
    mu0[:, :, ::3] = torch.round(mu0[:, :, ::3])  # ties and zeros
    nu0 = torch.as_tensor(rng.normal(size=(B, dc, m)) * 3).to(dtype)
    total = torch.as_tensor(rng.normal(size=(B, n)) * 4).to(dtype)
    syn = torch.as_tensor(rng.random((B, m)) < 0.5)
    gamma = gamma_for(gamma_kind, rng, B, n, dtype)
    on = lambda t: None if t is None else t.to(dev)  # noqa: E731
    for alpha, beta in ((1.0, 0.0), (0.8125, 0.15625)):
        mu_w, nu_w = mu0.clone(), None if gamma is None else nu0.clone()
        plain_minsum.check_iter_ref(mu_w, total, ms.chk_varidx, syn, ms.chk_mask, alpha, beta,
                                    gamma, nu_w)
        for stage in (None, False, True):
            mu_g, nu_g = mu0.to(dev), None if gamma is None else nu0.to(dev)
            before = cuda_minsum.minsum_check_iter_cuda.launches
            out = cuda_minsum.minsum_check_iter_cuda(
                mu_g, on(total), on(ms.chk_varidx), on(syn), on(ms.chk_mask), alpha, beta,
                gamma=on(gamma), nu=nu_g, chk_deg=on(ms.chk_deg), _stage=stage)
            torch.cuda.synchronize()
            assert out is mu_g and cuda_minsum.minsum_check_iter_cuda.launches == before + 1
            got = bits(mu_g.cpu()).reshape(B, -1)
            assert torch.equal(got[:, real], bits(mu_w).reshape(B, -1)[:, real])
            assert torch.equal(got[:, ~real], bits(mu0).reshape(B, -1)[:, ~real])
            if gamma is not None:
                got = bits(nu_g.cpu()).reshape(B, -1)
                assert torch.equal(got[:, real], bits(nu_w).reshape(B, -1)[:, real])
                assert torch.equal(got[:, ~real], bits(nu0).reshape(B, -1)[:, ~real])


@pytest.mark.parametrize("graph_name", ["heavy", "dem", "gallager"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["check", "var"])
def test_minsum_var_iter_kernel_matches_plain_version(dev, graph_name, dtype, layout):
    """K4's iteration form against var_iter_ref, bitwise: the totals, the
    frozen err / llrs of the lanes not done, and in the variable layout the
    leave-one-out messages in place (real slots), with every damping kind
    and with and without per-edge weights."""
    g = iter_graph(graph_name)
    rng = np.random.default_rng(8)
    B, dc, m, dv, n = 6, g.max_dc, g.m, g.max_dv, g.n
    ms = pt.MinSumDecode(g, 0.05, 2, device="cpu")
    real = ms.var_mask.reshape(-1)
    mu_flat = torch.as_tensor(rng.normal(size=(B, dc * m))
                              * 10.0 ** rng.integers(-3, 4, (B, dc * m))).to(dtype)
    L0 = torch.as_tensor(rng.normal(size=(B, n)) * 2).to(dtype)
    nu0 = torch.as_tensor(rng.normal(size=(B, dv, n)) * 3).to(dtype)
    W = torch.as_tensor(rng.uniform(0.3, 1.4, size=(dv, n))).to(dtype)
    done = torch.as_tensor(rng.random(B) < 0.4)
    err0 = torch.as_tensor((rng.random((B, n)) < 0.5).astype(np.float32))
    llr0 = torch.as_tensor(rng.normal(size=(B, n))).to(dtype)
    on = lambda t: None if t is None else t.to(dev)  # noqa: E731
    cases = ([(None, None)] if layout == "check" else
             [(gk, w) for gk in GAMMAS for w in (None, W)])
    for gamma_kind, w in cases:
        gamma = gamma_for(gamma_kind, rng, B, n, dtype)
        outs = []
        for where in ("cpu", dev):
            nu = None if layout == "check" else nu0.clone().to(where)
            total = torch.full((B, n), 7.0, dtype=dtype, device=where)
            err, llrs = err0.to(where), llr0.to(where)
            before = cuda_minsum.minsum_var_iter_cuda.launches
            ret = cuda_minsum.minsum_var_iter_cuda(
                mu_flat.to(where), ms.v2c.to(where), ms.var_mask.to(where), L0.to(where),
                W=None if w is None else w.to(where), nu=nu,
                gamma=None if gamma is None else gamma.to(where), total=total,
                done=done.to(where), err=err, llrs=llrs,
                var_deg=None if where == "cpu" else on(ms.var_deg))
            assert ret is total
            assert cuda_minsum.minsum_var_iter_cuda.launches == before + (where != "cpu")
            outs.append([None if t is None else t.cpu() for t in (nu, total, err, llrs)])
        (nu_w, *want), (nu_g, *got) = outs
        for a, b in zip(got, want):
            assert torch.equal(bits(a), bits(b))
        if nu_w is not None:
            assert torch.equal(bits(nu_g).reshape(B, -1)[:, real],
                               bits(nu_w).reshape(B, -1)[:, real])
            assert torch.equal(bits(nu_g).reshape(B, -1)[:, ~real],
                               bits(nu0).reshape(B, -1)[:, ~real])


def test_minsum_iter_wrappers_check_inputs(dev):
    g = iter_graph("heavy")
    ms = pt.MinSumDecode(g, 0.05, 2, layout="check", device=dev)
    B, dc, m, n = 2, g.max_dc, g.m, g.n
    mu = torch.zeros((B, dc, m), device=dev)
    total = torch.zeros((B, n), device=dev)
    syn = torch.zeros((B, m), dtype=torch.bool, device=dev)
    args = (ms.chk_varidx, syn, ms.chk_mask, 1.0, 0.0)
    with pytest.raises(ValueError, match="damps"):
        cuda_minsum.minsum_check_iter_cuda(mu, total, *args, nu=mu.clone())
    with pytest.raises(ValueError, match="damps"):
        cuda_minsum.minsum_check_iter_cuda(mu, total, *args, gamma=ms.gam)
    with pytest.raises(ValueError, match="gamma"):
        cuda_minsum.minsum_check_iter_cuda(mu, total, *args, gamma=torch.zeros((B, 3), device=dev),
                                           nu=mu.clone())
    with pytest.raises(TypeError, match="total"):
        cuda_minsum.minsum_check_iter_cuda(mu, total.to(torch.bfloat16), *args)
    with pytest.raises(ValueError, match="chk_deg"):
        cuda_minsum.minsum_check_iter_cuda(mu, total, *args, chk_deg=ms.var_deg)
    with pytest.raises(ValueError, match="real slots come first"):
        cuda_minsum.minsum_check_iter_cuda(mu, total, *args[:2], ms.chk_mask.flip(0), 1.0, 0.0)
    mu_flat, L0 = mu.reshape(B, -1), total.clone()
    var = (ms.v2c, ms.var_mask, L0)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="go together"):
        cuda_minsum.minsum_var_iter_cuda(mu_flat, *var, done=done)
    with pytest.raises(ValueError, match="alias"):
        cuda_minsum.minsum_var_iter_cuda(mu_flat, *var, done=done, err=total.clone(), llrs=L0)
    with pytest.raises(ValueError, match="previous messages"):
        cuda_minsum.minsum_var_iter_cuda(mu_flat, *var, gamma=ms.gam)
    with pytest.raises(ValueError, match="nu has shape"):
        cuda_minsum.minsum_var_iter_cuda(mu_flat, *var, nu=mu.clone(), gamma=ms.gam)
    before = (cuda_minsum.minsum_check_iter_cuda.launches,
              cuda_minsum.minsum_var_iter_cuda.launches)
    cuda_minsum.minsum_check_iter_cuda(mu[:0], total[:0], ms.chk_varidx, syn[:0], ms.chk_mask,
                                       1.0, 0.0)  # nothing to launch
    assert (cuda_minsum.minsum_check_iter_cuda.launches,
            cuda_minsum.minsum_var_iter_cuda.launches) == before


LANE_TILES = [64, 128]


def tiled_inputs(g, dtype, Bp, gamma_kind, seed):
    """Lane-major inputs of K3/K4 for ``Bp`` lanes (ties and zeros among the
    messages, negative per-variable strengths among the gammas)."""
    rng = np.random.default_rng(seed)
    dc, m, n = g.max_dc, g.m, g.n
    mu0 = torch.as_tensor(rng.normal(size=(Bp, dc, m)) * 2).to(dtype)
    mu0[:, :, ::3] = torch.round(mu0[:, :, ::3])
    return dict(
        mu=mu0, nu=torch.as_tensor(rng.normal(size=(Bp, dc, m)) * 3).to(dtype),
        total=torch.as_tensor(rng.normal(size=(Bp, n)) * 4).to(dtype),
        L0=torch.as_tensor(rng.normal(size=(Bp, n)) * 2).to(dtype),
        syn=torch.as_tensor(rng.random((Bp, m)) < 0.5),
        gamma=gamma_for(gamma_kind, rng, Bp, n, dtype),
        done=torch.as_tensor(rng.random(Bp) < 0.4),
        err=torch.as_tensor((rng.random((Bp, n)) < 0.5).astype(np.float32)),
        llrs=torch.as_tensor(rng.normal(size=(Bp, n))).to(dtype))


def packed_lane_iters():
    """``minsum_check_lane_iters_packed`` in the profiler session's record,
    outside any call."""
    from ldpcdecoders_tpu_torch.utils import profiling

    rec = profiling.profiled()
    return 0 if rec is None else rec.counters.get("minsum_check_lane_iters_packed", 0)


def check_tiled_kernels(dev, g, dtype, x, lane_tile):
    """K3's gathered and iteration forms and K4's totals with the freeze on
    lane tiles of ``x``'s lanes against the plain lane-major versions (on
    the card), bitwise; mu / nu keep their padded slots.  In bfloat16 each
    K3 launch takes the packed body and, under a profiler, adds its lanes to
    ``minsum_check_lane_iters_packed``; in float32 none."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _check_tiled_kernels(dev, g, dtype, x, lane_tile)


def _check_tiled_kernels(dev, g, dtype, x, lane_tile):
    T, Bp = lane_tile, x["mu"].shape[0]
    packed = Bp if dtype == torch.bfloat16 else 0  # the lanes a K3 launch counts
    counted = packed_lane_iters()
    ms = pt.MinSumDecode(g, 0.05, 2, layout="check", device=dev, dtype=dtype)
    c = {k: None if v is None else v.to(dev) for k, v in x.items()}
    tile = lambda t: t if t is None or t.ndim == 0 else plain_minsum.tile_lanes(t, T)  # noqa: E731
    untile = lambda t: plain_minsum.untile_lanes(t, T)  # noqa: E731
    real = ms.chk_mask.reshape(-1)
    alpha, beta = 0.8125, 0.15625
    routes = {w: dict(w.routes) for w in (cuda_minsum.minsum_check_cuda,
                                          cuda_minsum.minsum_check_iter_cuda,
                                          cuda_minsum.minsum_var_iter_cuda)}

    want = plain_minsum.check_update_ref(c["L0"], ms.chk_varidx, c["syn"], ms.chk_mask, alpha,
                                         beta)
    got = cuda_minsum.minsum_check_cuda(tile(c["L0"]), ms.chk_varidx, tile(c["syn"]),
                                        ms.chk_mask, alpha, beta, chk_deg=ms.chk_deg,
                                        lane_tile=T)
    torch.cuda.synchronize()
    assert got.shape == (Bp // T, g.max_dc, g.m, T)
    assert torch.equal(bits(untile(got)), bits(want))
    assert packed_lane_iters() == counted + packed

    gamma = c["gamma"]
    mu_w, nu_w = c["mu"].clone(), None if gamma is None else c["nu"].clone()
    plain_minsum.check_iter_ref(mu_w, c["total"], ms.chk_varidx, c["syn"], ms.chk_mask, alpha,
                                beta, gamma, nu_w)
    mu_k, nu_k = tile(c["mu"]), None if gamma is None else tile(c["nu"])
    out = cuda_minsum.minsum_check_iter_cuda(mu_k, tile(c["total"]), ms.chk_varidx,
                                             tile(c["syn"]), ms.chk_mask, alpha, beta,
                                             gamma=tile(gamma), nu=nu_k, chk_deg=ms.chk_deg,
                                             lane_tile=T)
    torch.cuda.synchronize()
    assert out is mu_k
    assert packed_lane_iters() == counted + 2 * packed
    for k, w, before in ((mu_k, mu_w, c["mu"]), (nu_k, nu_w, c["nu"])):
        if w is None:
            continue
        got = bits(untile(k)).reshape(Bp, -1)
        assert torch.equal(got[:, real], bits(w).reshape(Bp, -1)[:, real])
        assert torch.equal(got[:, ~real], bits(before).reshape(Bp, -1)[:, ~real])

    mu_flat = mu_w.reshape(Bp, -1)
    tot_w, err_w, llr_w = torch.empty_like(c["L0"]), c["err"].clone(), c["llrs"].clone()
    plain_minsum.var_iter_ref(mu_flat, ms.v2c, ms.var_mask, c["L0"], total=tot_w,
                              done=c["done"], err=err_w, llrs=llr_w)
    tot_k, err_k, llr_k = tile(torch.empty_like(c["L0"])), tile(c["err"]), tile(c["llrs"])
    assert cuda_minsum.minsum_var_iter_cuda(
        tile(mu_flat), ms.v2c, ms.var_mask, tile(c["L0"]), total=tot_k, done=tile(c["done"]),
        err=err_k, llrs=llr_k, var_deg=ms.var_deg, lane_tile=T) is tot_k
    torch.cuda.synchronize()
    for a, b in ((tot_k, tot_w), (err_k, err_w), (llr_k, llr_w)):
        assert torch.equal(bits(untile(a)), bits(b))
    for w, before in routes.items():  # one tiled launch each, none lane-major
        assert w.routes == dict(before, lane_tiled=before["lane_tiled"] + 1)


@pytest.mark.parametrize("graph_name", ["heavy", "dem", "gallager", "empty"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gamma_kind", GAMMAS)
@pytest.mark.parametrize("lane_tile", LANE_TILES)
def test_minsum_tiled_kernels_match_plain_versions(dev, graph_name, dtype, gamma_kind,
                                                   lane_tile):
    """The tiled K3/K4 on two tiles and on five, every damping kind, checks
    whose degrees are no multiple of the slots loaded together and (graph
    "empty") a check of no real slot: bitwise the plain versions."""
    g = iter_graph(graph_name)
    for tiles in (2, 5):
        x = tiled_inputs(g, dtype, tiles * lane_tile, gamma_kind, seed=7)
        check_tiled_kernels(dev, g, dtype, x, lane_tile)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gamma_kind", GAMMAS)
@pytest.mark.parametrize("lane_tile", LANE_TILES)
def test_minsum_tiled_kernels_at_the_bb144_dem_shape(dev, dtype, gamma_kind, lane_tile):
    """The tiled K3/K4 on the 864 x 31,648 circuit-level graph (check degree
    up to 294, variables up to 12), three tiles, every damping kind: bitwise
    the plain versions."""
    A, pr, _ = bb144_dem()
    g = pt.TannerGraph.from_pcm(np.asarray(A.todense()))
    assert g.max_dc == 294
    Bp = 3 * lane_tile
    x = tiled_inputs(g, dtype, Bp, gamma_kind, seed=9)
    x["L0"] = torch.as_tensor(np.log((1 - pr) / pr)).to(dtype).expand(Bp, -1).contiguous()
    check_tiled_kernels(dev, g, dtype, x, lane_tile)


@pytest.mark.parametrize("lane_tile", LANE_TILES)
def test_minsum_packed_plan_on_card(dev, lane_tile):
    """The packed check body's block at the bb144 DEM's degree: whole warps,
    its shared memory within a block, and a block an SM at least, for every
    form it takes."""
    for gathered, gamma_kind in ((True, 0), (False, 0), (False, 1), (False, 2)):
        plan = cuda_minsum.packed_plan(294, lane_tile, gathered=gathered,
                                       gamma_kind=gamma_kind)
        assert plan["threads"] % 32 == 0 and plan["threads"] > 0
        assert 0 < plan["smem_bytes"] <= 232448
        assert plan["registers"] > 0 and plan["blocks_per_sm"] >= 1


def check_var_inplace_tiled(dev, g, dtype, lane_tile, gamma_kind, weighted, Bp, L0=None,
                            seed=12):
    """K4's variable-layout form on lane tiles (leave-one-out messages in
    place, weights, the damping mix, the totals and the freeze) against its
    plain lane-major twin on the card, bitwise; the padded slots of nu are
    left as they were, and the launch counts as ``lane_tiled_nu``."""
    T = lane_tile
    rng = np.random.default_rng(seed)
    dc, m, dv, n = g.max_dc, g.m, g.max_dv, g.n
    ms = pt.MinSumDecode(g, 0.05, 2, device=dev, dtype=dtype)
    mu_flat = torch.as_tensor(rng.normal(size=(Bp, dc * m)).astype(np.float32)
                              * 10.0 ** rng.integers(-3, 4, (Bp, dc * m)),
                              device=dev).to(dtype)
    if L0 is None:
        L0 = torch.as_tensor(rng.normal(size=(Bp, n)) * 2)
    L0 = L0.to(dev).to(dtype).contiguous()
    nu0 = torch.as_tensor(rng.normal(size=(Bp, dv, n)).astype(np.float32) * 3,
                          device=dev).to(dtype)
    W = (torch.as_tensor(rng.uniform(0.3, 1.4, size=(dv, n)), device=dev).to(dtype)
         if weighted else None)
    gamma = gamma_for(gamma_kind, rng, Bp, n, dtype)
    gamma = None if gamma is None else gamma.to(dev)
    done = torch.as_tensor(rng.random(Bp) < 0.4, device=dev)
    err0 = torch.as_tensor((rng.random((Bp, n)) < 0.5).astype(np.float32), device=dev)
    llr0 = torch.as_tensor(rng.normal(size=(Bp, n)), device=dev).to(dtype)
    tile = lambda t: t if t is None or t.ndim == 0 else plain_minsum.tile_lanes(t, T)  # noqa: E731
    untile = lambda t: plain_minsum.untile_lanes(t, T)  # noqa: E731

    nu_w, tot_w, err_w, llr_w = nu0.clone(), torch.empty_like(L0), err0.clone(), llr0.clone()
    plain_minsum.var_iter_ref(mu_flat, ms.v2c, ms.var_mask, L0, W=W, nu=nu_w, gamma=gamma,
                              total=tot_w, done=done, err=err_w, llrs=llr_w)
    w = cuda_minsum.minsum_var_iter_cuda
    before = dict(w.routes)
    nu_k, tot_k, err_k, llr_k = tile(nu0), tile(torch.empty_like(L0)), tile(err0), tile(llr0)
    assert w(tile(mu_flat), ms.v2c, ms.var_mask, tile(L0), W=W, nu=nu_k, gamma=tile(gamma),
             total=tot_k, done=tile(done), err=err_k, llrs=llr_k, var_deg=ms.var_deg,
             lane_tile=T) is tot_k
    torch.cuda.synchronize()
    assert w.routes == dict(before, lane_tiled_nu=before["lane_tiled_nu"] + 1)
    real = ms.var_mask.reshape(-1)
    got = bits(untile(nu_k)).reshape(Bp, -1)
    assert torch.equal(got[:, real], bits(nu_w).reshape(Bp, -1)[:, real])
    assert torch.equal(got[:, ~real], bits(nu0).reshape(Bp, -1)[:, ~real])
    for a, b in ((tot_k, tot_w), (err_k, err_w), (llr_k, llr_w)):
        assert torch.equal(bits(untile(a)), bits(b))


@pytest.mark.parametrize("graph_name", ["heavy", "dem", "gallager"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gamma_kind", GAMMAS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("lane_tile", LANE_TILES)
def test_minsum_var_inplace_tiled_kernel_matches_plain_version(dev, graph_name, dtype,
                                                               gamma_kind, weighted, lane_tile):
    """The variable layout's K4 on two lane tiles, every damping kind, with
    and without weights, on variables past the registers' 12 slots and past
    32 (summed by windows): bitwise the plain version."""
    check_var_inplace_tiled(dev, iter_graph(graph_name), dtype, lane_tile, gamma_kind, weighted,
                            2 * lane_tile)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gamma_kind", GAMMAS)
@pytest.mark.parametrize("lane_tile", LANE_TILES)
def test_minsum_var_inplace_tiled_kernel_at_the_bb144_dem_shape(dev, dtype, gamma_kind,
                                                                 lane_tile):
    """The variable layout's K4 on lane tiles at the bb144 R=6 DEM's shape
    (variables of 12 slots, all in flight), two tiles, with per-edge
    weights and every damping kind: bitwise the plain version."""
    A, pr, _ = bb144_dem()
    g = pt.TannerGraph.from_pcm(np.asarray(A.todense()))
    assert g.max_dv == 12
    L0 = torch.as_tensor(np.log((1 - pr) / pr)).expand(2 * lane_tile, -1)
    check_var_inplace_tiled(dev, g, dtype, lane_tile, gamma_kind, True, 2 * lane_tile, L0)


@pytest.mark.parametrize("B", [200, 256, 2048])
def test_minsum_var_layout_decode_on_card_is_lane_major(dev, B):
    """``MinSumDecode(layout="var")`` at the BP+OSD cell's inner settings
    (damping 0.4, a check every iteration) on the bb144 R=6 DEM, records
    drawn from its priors: the batch's own tiles (``MinSumDecode._tile``:
    128 lanes at 200, 256 and 2048; narrower, and lane-major where the
    lanes' messages fit L2, where the loop compacts) bitwise the lane-major
    decode (``_lane_tile=1``) on every output, K4's variable-layout form
    launched on tiles."""
    from ldpcdecoders_tpu_torch.utils import profiling

    A, pr, _ = bb144_dem()
    g = pt.TannerGraph.from_pcm(np.asarray(A.todense()))
    rng = np.random.default_rng(B)
    x = rng.random((B, g.n)) < pr
    syn = torch.as_tensor(((A @ x.T.astype(np.int64)).T % 2).astype(np.uint8), device=dev)
    outs = {}
    for T in (None, 1):
        ms = pt.MinSumDecode(g, pr, 120, device=dev, damping=0.4, _lane_tile=T)
        wrappers = (cuda_minsum.minsum_check_cuda, cuda_minsum.minsum_var_iter_cuda)
        before = [dict(w.routes) for w in wrappers]
        with profiling.recording() as rec:
            outs[T] = [t.cpu() for t in ms(syn)]
        c = rec.counters
        if T is None:
            assert ms._tile(B, dev) == 128
            assert 0 < c["minsum_lane_iters_tiled"] <= c["minsum_lane_iters_launched"]
            assert wrappers[0].routes["lane_tiled"] > before[0]["lane_tiled"]
            assert wrappers[1].routes["lane_tiled_nu"] > before[1]["lane_tiled_nu"]
        else:
            assert c["minsum_lane_iters_tiled"] == 0
            for w, b in zip(wrappers, before):
                assert w.routes == dict(b, lane_major=w.routes["lane_major"])
    for a, b in zip(outs[None], outs[1]):
        assert torch.equal(bits(a) if a.is_floating_point() else a,
                           bits(b) if b.is_floating_point() else b)
    conv = outs[1][1]
    assert conv.any() and not conv.all(), "the case needs lanes on both sides"


def test_bposd_cs_inner_on_tiles_is_lane_major_on_card(dev):
    """BP+OSD-CS through ``DetectorGraphDecoder`` as the BP+OSD cell runs it
    (portbench/configs/bb144_r6_bposd_cs.json: min-sum inner damped by 0.4,
    1,000 iterations, the device OSD-CS of order 40 on the failed lanes), on
    256 records drawn from the DEM's priors: bitwise the same decoder with
    its inner decode forced lane-major."""
    A, pr, O = bb144_dem()
    rng = np.random.default_rng(25)
    x = rng.random((256, A.shape[1])) < pr
    det = ((A @ x.T.astype(np.int64)).T % 2).astype(np.uint8)
    kw = dict(observables=O, device=dev, decoder="bposd", inner="minsum", damping=0.4,
              osd_order=40, osd_method="combination_sweep", osd_scope="failed")
    outs = []
    for T in (None, 1):
        dec = pt.DetectorGraphDecoder(A.astype(np.uint8), pr, 1000, **kw)
        dec.inner.bp._lane_tile = T
        before = cuda_minsum.minsum_var_iter_cuda.routes["lane_tiled_nu"]
        outs.append(dec.batch_decode_detailed(det))
        tiled = cuda_minsum.minsum_var_iter_cuda.routes["lane_tiled_nu"] - before
        assert (tiled > 0) == (T is None)
    (err_t, conv_t, iters_t, *_), (err_l, conv_l, iters_l, *_) = outs
    assert np.array_equal(err_t, err_l) and np.array_equal(conv_t, conv_l)
    assert np.array_equal(iters_t, iters_l)
    assert not conv_l.all(), "the case needs lanes that reach the OSD"


def test_minsum_tiled_launch_failure_raises(dev, monkeypatch):
    """A tiled launch the library refuses (a tile it was not built for)
    raises: no wrapper falls back to the plain version or to lane-major
    tiles, counts a launch, or touches the state."""
    g = iter_graph("dem")
    ms = pt.MinSumDecode(g, 0.05, 2, layout="check", device=dev)
    monkeypatch.setattr(cuda_minsum, "LANE_TILES", (16, 64, 128))
    T, dc, m, n = 16, g.max_dc, g.m, g.n
    mu = torch.ones((1, dc, m, T), device=dev)
    total = torch.ones((1, n, T), device=dev)
    syn = torch.zeros((1, m, T), dtype=torch.bool, device=dev)
    wrappers = (cuda_minsum.minsum_check_cuda, cuda_minsum.minsum_check_iter_cuda,
                cuda_minsum.minsum_var_iter_cuda)
    before = [(w.launches, dict(w.routes)) for w in wrappers]
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_minsum.minsum_check_cuda(total, ms.chk_varidx, syn, ms.chk_mask, 1.0, 0.0,
                                      lane_tile=T)
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_minsum.minsum_check_iter_cuda(mu, total, ms.chk_varidx, syn, ms.chk_mask, 1.0, 0.0,
                                           lane_tile=T)
    out = torch.zeros_like(total)
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_minsum.minsum_var_iter_cuda(mu.reshape(1, dc * m, T), ms.v2c, ms.var_mask, total,
                                         total=out, lane_tile=T)
    with pytest.raises(ValueError, match="staged form"):
        cuda_minsum.minsum_check_iter_cuda(mu, total, ms.chk_varidx, syn, ms.chk_mask, 1.0, 0.0,
                                           _stage=True, lane_tile=T)
    torch.cuda.synchronize()
    assert [(w.launches, w.routes) for w in wrappers] == before
    assert bool((mu == 1).all()) and bool((out == 0).all())


@pytest.mark.parametrize("config", ["stage0", "deep"])
def test_minsum_decode_tiled_on_card_matches_cpu(dev, config):
    """``MinSumDecode(layout="check")`` on 64-lane tiles on the card, 33
    records (a ragged tile), the staged decoder's two inner
    configurations checked every 8 iterations: every output bitwise the
    lane-major decode on the CPU, every launch tiled."""
    g = iter_graph("dem")
    A = g.H
    rng = np.random.default_rng(3)
    pr = np.full(g.n, 0.02)
    x = rng.random((33, g.n)) < pr
    syn = torch.as_tensor(((x.astype(np.int64) @ A.T) % 2).astype(np.uint8))
    kw, dtype, gamma = dict(damping=0.4), torch.float32, None
    if config == "deep":
        kw, dtype = dict(lane_damping=True, track_best=True), torch.bfloat16
        gamma = torch.as_tensor(rng.uniform(-0.24, 0.66, (33, g.n)), dtype=torch.float32)
    mods = {d: pt.MinSumDecode(g, pr, 20, device=d, dtype=dtype, layout="check",
                               check_every=8, _lane_tile=T, **kw)
            for d, T in (("cpu", 1), (dev, 64))}
    routes = {w: dict(w.routes) for w in (cuda_minsum.minsum_check_iter_cuda,
                                          cuda_minsum.minsum_var_iter_cuda)}
    want = mods["cpu"](syn, None, gamma)
    got = mods[dev](syn.to(dev), None, None if gamma is None else gamma.to(dev))
    for a, b in zip(got, want):
        a = a.cpu()
        assert torch.equal(bits(a) if a.is_floating_point() else a,
                           bits(b) if b.is_floating_point() else b)
    for w, before in routes.items():
        assert w.routes["lane_major"] == before["lane_major"]
        assert w.routes["lane_tiled"] > before["lane_tiled"]


@pytest.mark.parametrize("config", ["stage0", "deep", "var"])
def test_minsum_compaction_on_card(dev, config, monkeypatch):
    """The loop narrows its state at its checks, at the bb144 R=6 DEM's
    shape in the staged decoder's two inner configurations (check layout)
    and in the variable layout damped by 0.4 (96 iterations checked every
    8): 256 records picked from a seeded pool by
    how they converge, 80 empty (done at the first check), 120 that
    converge from iteration 24 on, 56 that never do, start on 128-lane
    tiles, narrow to 64-lane tiles and end lane-major (the check layout;
    the variable layout keeps 56 lanes on a 64-lane tile) within one decode
    (the rule's costs set to 0, so that it narrows wherever the width
    shrinks: the rule itself is tests/test_torch_minsum.py's).
    Every output is bitwise each lane decoded alone on the card and the
    batch decoded with the kernels' plain versions on the card; the
    lane-iterations launched are the sum of the widths' segments."""
    from ldpcdecoders_tpu_torch.models import minsum as minsum_module
    from ldpcdecoders_tpu_torch.utils import profiling

    monkeypatch.setattr(minsum_module, "_GATHER_LANE_ITERS", 0.0)
    monkeypatch.setattr(minsum_module, "_GATHER_FIXED_BYTES", 0.0)

    A, pr, _ = bb144_dem()
    g = pt.TannerGraph.from_pcm(np.asarray(A.todense()))
    rng = np.random.default_rng(5)
    kw, dtype = dict(damping=0.4), torch.float32
    if config == "deep":
        kw, dtype = dict(lane_damping=True, track_best=True), torch.bfloat16
    ms = pt.MinSumDecode(g, float(pr.mean()), 96, device=dev, dtype=dtype,
                         layout="var" if config == "var" else "check", check_every=8, **kw)
    pool = 3072
    x = rng.random((pool, g.n)) < pr * rng.choice([1.0, 2.0, 3.0, 8.0], pool)[:, None]
    syn_pool = torch.as_tensor(((A @ x.T.astype(np.int64)).T % 2).astype(np.uint8), device=dev)
    gam_pool = (None if config != "deep" else torch.as_tensor(
        rng.uniform(-0.24, 0.66, (pool, g.n)), dtype=torch.float32, device=dev))
    _, conv, iters, _ = ms(syn_pool, None, gam_pool, early_exit=False)
    # the earliest 120 to converge from iteration 24 on: done well before the
    # cap, so that the decode still narrows to the 56 that never converge
    late = torch.nonzero(conv & (iters >= 24)).flatten()
    late = late[torch.sort(iters[late], stable=True).indices][:120]
    never = torch.nonzero(~conv).flatten()[:56]
    assert len(late) == 120 and len(never) == 56, "the pool lacks lanes of a kind"
    assert int(iters[late].max()) <= 72, "the pool's late lanes converge too late"
    pick = torch.cat([torch.zeros(80, dtype=torch.long, device=dev), late, never])
    order = torch.as_tensor(rng.permutation(256), device=dev)
    syn = syn_pool[pick][order]
    syn[order < 80] = 0
    gamma = None if gam_pool is None else gam_pool[pick][order]
    with profiling.recording() as rec:
        got = [t.cpu() for t in ms(syn, None, gamma)]
    alone = [ms(syn[b:b + 1], None, None if gamma is None else gamma[b:b + 1])
             for b in range(256)]
    alone = [torch.cat([a[i].cpu() for a in alone]) for i in range(4)]
    monkeypatch.setattr(cuda_minsum, "_messages", lambda name, x: True)  # the plain versions
    plain = [t.cpu() for t in ms(syn, None, gamma)]
    for a, b, c in zip(got, alone, plain):
        assert torch.equal(bits(a) if a.is_floating_point() else a,
                           bits(b) if b.is_floating_point() else b)
        assert torch.equal(bits(a) if a.is_floating_point() else a,
                           bits(c) if c.is_floating_point() else c)
    conv, iters = got[1], got[2]
    # the segments: each compaction after a check narrows the width to the
    # lanes not done there, on the tile the loop's rule gives (by layout)
    tiles, total, on_tiles, start, t, width = [ms._tile(256, dev)], 0, 0, 0, 0, 256
    for s in rec.spans:
        if s.name == "ldpc.minsum.check":
            t += 8
        elif s.name == "ldpc.minsum.compact":
            live = int((~(conv & (iters <= t))).sum())
            total += width * (t - start)
            on_tiles += width * (t - start) if tiles[-1] > 1 else 0
            tiles.append(ms._tile(live, dev))
            start, width = t, -(-live // tiles[-1]) * tiles[-1]
    assert tiles[:2] == [128, 64] and tiles[-1] == (64 if config == "var" else 1), tiles
    assert len(tiles) - 1 == rec.counters["minsum_compactions"]
    assert rec.counters["minsum_lane_iters_launched"] == total + width * (t - start)
    on_tiles += width * (t - start) if tiles[-1] > 1 else 0
    assert rec.counters["minsum_lane_iters_tiled"] == on_tiles > 0


def test_minsum_stage_plan_is_the_launchers(dev):
    """The staged check form's plan (threads, shared memory) in Python equals
    the launcher's, over row sizes up to past a block."""
    import ctypes

    from ldpcdecoders_tpu_torch import _build

    lib = _build.load_library()
    out = (ctypes.c_int * 2)()
    for row in (0, 4000, 63296, 126592, 200000, 232448, 300000):
        for m, dc in ((1, 1), (37, 16), (864, 294), (900, 10), (3000, 40), (864, 4000)):
            lib.ldpc_minsum_stage_plan(row, m, dc, out)
            assert cuda_minsum.stage_plan(row, m, dc) == (out[0], out[1])


def surface_d5_records(B, seed, scale):
    A, pr, O = pt.load_dem(str(REPO / "tests/fixtures/surface_d5_r5_p002.dem"))
    rng = np.random.default_rng(seed)
    x = (rng.random((B, A.shape[1])) < pr * scale).astype(np.uint8)
    return A, pr, O, ((A @ x.T).T % 2).astype(np.uint8)


STAGED_TIERS = {
    "fast": dict(gammas=(0.4,), stage0_iters=96, deep_iters=1000, lam=40, check_every=8,
                 layout="check"),
    "flagship": dict(gammas=(0.4,) + ((-0.24, 0.66),) * 5, stage0_iters=96, deep_iters=500,
                     deep_dtype=torch.bfloat16, relay_legs=8, lam=60, lam3=40,
                     layout="check", check_every=8),
}


@pytest.mark.parametrize("tier", list(STAGED_TIERS))
def test_staged_on_card_matches_cpu(dev, tier):
    """The staged decoder on surface_d5_r5_p002.dem, 64 records (noise
    scaled x4 so that lanes reach the deep ensemble, the relay legs and the
    host OSD): the card against the CPU, bitwise in out, solved and
    iters, with the min-sum kernels launched."""
    A, pr, O, det = surface_d5_records(64, 2, 4.0)
    cpu = pt.StagedDemDecoder(A, pr, observables=O, device="cpu", **STAGED_TIERS[tier])
    gpu = pt.StagedDemDecoder(A, pr, observables=O, device=dev, **STAGED_TIERS[tier])
    want = cpu.batch_decode_detailed(det)
    before = cuda_minsum.minsum_check_cuda.launches
    got = gpu.batch_decode_detailed(det)
    assert cuda_minsum.minsum_check_cuda.launches > before
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)
    assert (got[2] > gpu.stage0_iters).any() and (~got[1]).any()
    assert np.array_equal((got[0].astype(np.int64) @ A.T.toarray()) % 2, det)


def test_staged_on_card_chunks_stage0_with_the_bits_of_one_decode(dev):
    """Past the stage-0 cap (a 1 MB budget: 256 lanes a decode), 320 records
    run stage 0 in two chunks and the tail once, pooling both chunks'
    stragglers into smaller deep buckets: bitwise an unchunked decode on the
    card in out, solved and iters."""
    A, pr, O, det = surface_d5_records(320, 2, 4.0)
    kw = dict(observables=O, device=dev, **STAGED_TIERS["fast"])
    chunked = pt.StagedDemDecoder(A, pr, hbm_bytes=1_000_000, **kw)
    whole = pt.StagedDemDecoder(A, pr, **kw)
    assert chunked._max_stage0_batch == 256 < det.shape[0] <= whole._max_stage0_batch
    assert chunked.max_bucket < whole.max_bucket
    got, want = chunked.batch_decode_detailed(det), whole.batch_decode_detailed(det)
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)
    assert (got[2] > chunked.stage0_iters).any() and (~got[1]).any()


def test_detector_decoder_routes_and_launches_on_card(dev):
    """The d5 DEM's OSD lane fits a block: the device route, OSD-0 in K1,
    OSD-CS on K2's output; the card equals the CPU but for reliability
    ties of the sum-product inner (checked: the min-sum inner is
    bitwise)."""
    A, pr, O, det = surface_d5_records(64, 3, 4.0)
    for kw, kernel in ((dict(inner="minsum", damping=0.5), cuda_gf2.gf2_osd0_cuda),
                       (dict(inner="minsum", osd_method="combination_sweep", osd_order=10),
                        cuda_gf2.gf2_eliminate_cuda)):
        gpu = pt.DetectorGraphDecoder(A, pr, 50, observables=O, device=dev, **kw)
        cpu = pt.DetectorGraphDecoder(A, pr, 50, observables=O, device="cpu", **kw)
        assert gpu.inner.osd_impl == "device" and gpu.inner.osd is not None
        before = kernel.launches
        got = gpu.batch_decode(det)
        assert kernel.launches > before
        want = cpu.batch_decode(det)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert np.array_equal((got[0].astype(np.int64) @ A.T.toarray()) % 2, det)


# -- lanes past a block: the eliminations' device-memory body ------------------


def permuted_lanes(H, B, seed):
    """``B`` column permutations of a dense 0/1 ``H``, packed ``[B, W, m]``."""
    rng = np.random.default_rng(seed)
    Hs = np.stack([H[:, rng.permutation(H.shape[1])] for _ in range(B)]).astype(np.int64)
    return Hs, systems_from(Hs)


def dem_lanes(B, seed):
    import scipy.sparse as sp

    z = np.load(REPO / "benchmarks/results/bb144_r6_p0.003.npz")
    A = sp.csr_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
    return permuted_lanes(A.toarray(), B, seed)


@pytest.mark.parametrize("shape", ["gallager_2400", "bb144_dem"])
def test_device_memory_body_matches_plain_forms(dev, shape):
    """K1 and K2 on lanes past a block, [75, 1200] ((2400, 6, 3)) and
    [989, 864] (the bb144 R=6 DEM): bitwise the plain forms, through the
    device-memory route."""
    if shape == "gallager_2400":
        Hs, Ht = permuted_lanes(pt.parity_check_matrix(2400, 6, 3, rng=0), 3, 1)
    else:
        Hs, Ht = dem_lanes(2, 2)
    B, m, n = Hs.shape
    for osd0 in (False, True):  # the helper tested is the one the wrappers route by
        assert cuda_gf2.route(Ht.shape[1], m, osd0=osd0) == "global"
        assert cuda_gf2.body_of(cuda_gf2.launcher_plan(Ht.shape[1], m, osd0=osd0)) == "global"
    rng = np.random.default_rng(3)
    s = torch.as_tensor((rng.random((B, m)) < 0.5).astype(np.int32))
    resid, bp = osd0_inputs(rng, Hs, B, m, n)
    before = dict(cuda_gf2.gf2_eliminate_cuda.routes), dict(cuda_gf2.gf2_osd0_cuda.routes)
    got = cuda_gf2.gf2_eliminate_cuda(Ht.to(dev), s.to(dev), n)
    got0 = cuda_gf2.gf2_osd0_cuda(Ht.to(dev), resid.to(dev), bp.to(dev), n)
    torch.cuda.synchronize()
    assert cuda_gf2.gf2_eliminate_cuda.routes["global"] == before[0]["global"] + 1
    assert cuda_gf2.gf2_osd0_cuda.routes["global"] == before[1]["global"] + 1
    for a, b in zip(got, cuda_gf2.gf2_eliminate_ref(Ht.to(dev), s.to(dev), n)):
        assert torch.equal(a, b)
    assert torch.equal(got0, cuda_gf2.gf2_osd0_ref(Ht.to(dev), resid.to(dev), bp.to(dev), n))


def cluster_direct(Ht, s, n, *, cluster, bp=None):
    """The cluster body launched through the library at any shape (the
    wrappers route only lanes past a block to it): ``(Ht', s', pivcol)``,
    or OSD-0's correction where ``bp`` is given."""
    from ldpcdecoders_tpu_torch._build import load_library

    lib = load_library()
    B, W, m = Ht.shape
    stream = torch.cuda.current_stream().cuda_stream
    if bp is None:
        Ht2, s2 = torch.empty_like(Ht), torch.empty_like(s)
        piv = torch.empty((B, m), dtype=torch.int32, device=Ht.device)
        rc = lib.ldpc_gf2_eliminate_cluster(Ht.data_ptr(), s.data_ptr(), Ht2.data_ptr(),
                                            s2.data_ptr(), piv.data_ptr(), B, W, m, n, cluster,
                                            stream)
        out = (Ht2, s2, piv)
    else:
        corr = torch.empty((B, n), dtype=torch.int32, device=Ht.device)
        work = torch.empty_like(Ht)
        pivw = torch.empty((B, m), dtype=torch.int32, device=Ht.device)
        rc = lib.ldpc_gf2_osd0_cluster(Ht.data_ptr(), s.data_ptr(), bp.data_ptr(),
                                       corr.data_ptr(), work.data_ptr(), pivw.data_ptr(), B, W,
                                       m, n, cluster, stream)
        out = corr
    assert rc == 0, lib.ldpc_cuda_error_string(rc).decode()
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("B,m,n,dens", SHAPES + [(3, 70, 50, 0.3), (2, 1500, 64, 0.05)])
def test_cluster_body_at_small_lanes_and_every_cluster_size(dev, B, m, n, dens):
    """The cluster body at lanes a block would hold (ragged words, rows past
    1024, more rows than columns, dependent rows), launched directly with 2,
    4 and 8 CTAs a cluster: bitwise the plain forms."""
    rng = np.random.default_rng(m + n)
    H, Ht = systems(rng, B, m, n, dens)
    s = torch.as_tensor((rng.random((B, m)) < 0.5).astype(np.int32))
    resid, bp = osd0_inputs(rng, H, B, m, n)
    want = gf2.gf2_eliminate(Ht, s, n)[:3]
    want0 = gf2.gf2_osd0(Ht, resid, bp, n)
    for cluster in (2, 4, 8):
        got = cluster_direct(Ht.to(dev), s.to(dev), n, cluster=cluster)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        got0 = cluster_direct(Ht.to(dev), resid.to(dev), n, cluster=cluster, bp=bp.to(dev))
        assert torch.equal(got0.cpu(), want0)


@pytest.mark.parametrize("shape", ["gallager_2400", "bb144_dem"])
def test_cluster_body_every_size_against_the_launchers_choice(dev, shape):
    """Past a block: every cluster size gives the bits of the launcher's
    own choice, each counted as a device-memory launch; the launcher's
    cluster plan is one of 2, 4, 8 with the shared memory of
    ``global_smem_bytes``; a size outside those is refused."""
    if shape == "gallager_2400":
        Hs, Ht = permuted_lanes(pt.parity_check_matrix(2400, 6, 3, rng=0), 3, 11)
    else:
        Hs, Ht = dem_lanes(2, 12)
    B, m, n = Hs.shape
    rng = np.random.default_rng(13)
    s = torch.as_tensor((rng.random((B, m)) < 0.5).astype(np.int32)).to(dev)
    resid, bp = osd0_inputs(rng, Hs, B, m, n)
    Ht, resid, bp = Ht.to(dev), resid.to(dev), bp.to(dev)
    for osd0 in (False, True):
        plan = cuda_gf2.cluster_plan(B, m, osd0=osd0)
        assert plan.size in (2, 4, 8) and plan.active >= 1
        assert plan.bytes == cuda_gf2.global_smem_bytes(m)
    want = cuda_gf2.gf2_eliminate_cuda(Ht, s, n)
    want0 = cuda_gf2.gf2_osd0_cuda(Ht, resid, bp, n)
    before = dict(cuda_gf2.gf2_eliminate_cuda.routes), dict(cuda_gf2.gf2_osd0_cuda.routes)
    for cluster in (2, 4, 8):
        for a, b in zip(cuda_gf2.gf2_eliminate_cuda(Ht, s, n, _cluster=cluster), want):
            assert torch.equal(a, b), cluster
        assert torch.equal(cuda_gf2.gf2_osd0_cuda(Ht, resid, bp, n, _cluster=cluster),
                           want0), cluster
    assert cuda_gf2.gf2_eliminate_cuda.routes["global"] == before[0]["global"] + 3
    assert cuda_gf2.gf2_osd0_cuda.routes["global"] == before[1]["global"] + 3
    with pytest.raises(ValueError, match="cluster must be"):
        cuda_gf2.gf2_eliminate_cuda(Ht, s, n, _cluster=3)


@pytest.mark.parametrize("inner", ["sumproduct", "minsum"])
@pytest.mark.parametrize("order,scope", [(0, "all"), (2, "all"), (2, "failed")])
def test_fused_bposd_on_card_is_the_eager_decode_without_a_host_read(dev, order, scope, inner):
    """``fused=True`` on the card: no synchronizing call inside the decode
    (``torch.cuda.set_sync_debug_mode("error")`` raises on one), and every
    output bitwise the eager decoder's."""
    H = pt.parity_check_matrix(240, 8, 4, rng=17)
    rng = np.random.default_rng(17)
    syn = torch.as_tensor((((rng.random((64, 240)) < 0.06) @ H.T) % 2).astype(np.uint8),
                          device=dev)
    kw = dict(osd_order=order, osd_scope=scope, inner=inner, device=dev)
    fused = pt.BeliefPropagationOSDDecoder(H, 0.06, 20, fused=True, **kw)
    eager = pt.BeliefPropagationOSDDecoder(H, 0.06, 20, **kw)
    want = eager.batch_decode_detailed_async(syn)
    fused.batch_decode_detailed_async(syn)  # builds the kernels before the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fused.batch_decode_detailed_async(syn)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not bool(want[1].all()) and bool(want[1].any())
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(got[3]["log_probabs"], want[3]["log_probabs"])


def test_device_memory_osd0_by_chunks_of_lanes(dev, monkeypatch):
    """K1's device-memory body with a workspace of two lanes: five lanes
    run in three launches (2, 2, 1) at lane offsets 0, 2 and 4, bitwise the
    plain form."""
    from ldpcdecoders_tpu_torch.utils import hbm

    monkeypatch.setattr(hbm, "gf2_workspace_lanes", lambda W, m, **kw: 2)
    Hs, Ht = permuted_lanes(pt.parity_check_matrix(2400, 6, 3, rng=0), 5, 7)
    B, m, n = Hs.shape
    resid, bp = osd0_inputs(np.random.default_rng(8), Hs, B, m, n)
    before = cuda_gf2.gf2_osd0_cuda.routes["global"]
    got = cuda_gf2.gf2_osd0_cuda(Ht.to(dev), resid.to(dev), bp.to(dev), n)
    torch.cuda.synchronize()
    assert cuda_gf2.gf2_osd0_cuda.routes["global"] == before + 3
    want = cuda_gf2.gf2_osd0_ref(Ht, resid, bp, n)
    assert torch.equal(got.cpu(), want)
    assert len({tuple(row.tolist()) for row in want}) == B  # the lanes differ


def test_device_osd_past_a_block_on_card_matches_cpu(dev):
    H = pt.parity_check_matrix(2000, 10, 5, rng=3)
    rng = np.random.default_rng(4)
    syns = (((rng.random((6, H.shape[1])) < 0.07) @ H.T) % 2).astype(np.uint8)
    for kw in (dict(), dict(osd_order=2), dict(osd_method="combination_sweep", osd_order=8)):
        got = pt.BeliefPropagationOSDDecoder(H, 0.03, 10, device=dev, **kw).batch_decode(syns)
        want = pt.BeliefPropagationOSDDecoder(H, 0.03, 10, device="cpu", **kw).batch_decode(syns)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_peeling_and_mixed_on_card_match_cpu(dev):
    """Peeling with stopping sets (K2's device-memory body on the (2400, 6,
    3) code), and the mixed decoder with min-sum and OSD-0 / OSD-2: the
    card's outputs are the CPU's."""
    H = pt.parity_check_matrix(2400, 6, 3, rng=0)
    rng = np.random.default_rng(6)
    B, n = 64, H.shape[1]
    eps = rng.random((B, n)) < 0.42
    e = np.where(eps, rng.random((B, n)) < 0.5, False)
    syn = ((e @ H.T) % 2).astype(np.uint8)
    before = cuda_gf2.gf2_eliminate_cuda.routes["global"]
    gpu = pt.ErasurePeelingDecoder(H, device=dev)
    got = gpu.batch_decode_detailed(syn, eps)
    assert gpu.peeling.gf2_lanes > 0
    assert cuda_gf2.gf2_eliminate_cuda.routes["global"] == before + 1
    want = pt.ErasurePeelingDecoder(H, device="cpu").batch_decode_detailed(syn, eps)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    H = pt.parity_check_matrix(240, 6, 3, rng=0)
    eps = rng.random((B, 240)) < 0.12
    e = np.where(eps, rng.random((B, 240)) < 0.5, rng.random((B, 240)) < 0.01)
    syn = ((e @ H.T) % 2).astype(np.uint8)
    for kw in (dict(), dict(osd_order=0), dict(osd_order=2, algorithm="sumproduct")):
        got = pt.MixedChannelDecoder(H, 0.01, 30, device=dev, **kw).batch_decode_detailed(
            syn, eps)
        want = pt.MixedChannelDecoder(H, 0.01, 30, device="cpu", **kw).batch_decode_detailed(
            syn, eps)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


# -- the evaluation harness and the last two reference decoders ---------------


def test_bitflip_on_card_matches_cpu(dev):
    """Given the same tie-break draws the card's bit-flip decode is the
    CPU's, bitwise; with its own draws a seed repeats on the card."""
    H = pt.parity_check_matrix(240, 8, 4, rng=13)
    rng = np.random.default_rng(1)
    syn = (((rng.random((128, 240)) < 0.03).astype(np.int64) @ H.T) % 2).astype(np.uint8)
    draws = rng.random((60, 128, 240)).astype(np.float32)
    cpu = pt.BitFlipDecoder(H, 0.03, 60, device="cpu")
    gpu = pt.BitFlipDecoder(H, 0.03, 60, device=dev)
    want = cpu.bitflip(torch.as_tensor(syn), uniforms=lambda it: torch.as_tensor(draws[it]))
    got = gpu.bitflip(torch.as_tensor(syn, device=dev),
                      uniforms=lambda it: torch.as_tensor(draws[it], device=dev))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    a = gpu.batch_decode_detailed(syn, seed=3)
    b = gpu.batch_decode_detailed(syn, seed=3)
    for x, y in zip(a[:3], b[:3]):
        assert np.array_equal(x, y)
    assert a[1].mean() > 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bpots_on_card_decode_equivalent_to_cpu(dev, dtype):
    """The card's tanh/atanh may differ from the CPU's by an ulp: flags and
    iterations agree on at least 99% of 256 lanes, the estimates on 97%,
    and every converged lane reproduces its syndrome."""
    H = pt.parity_check_matrix(120, 6, 3, rng=61)
    rng = np.random.default_rng(9)
    syn = (((rng.random((256, 120)) < 0.05).astype(np.int64) @ H.T) % 2).astype(np.uint8)
    want = pt.BPOTSDecoder(H, 0.05, 100, dtype=dtype, device="cpu").batch_decode_detailed(syn)
    got = pt.BPOTSDecoder(H, 0.05, 100, dtype=dtype, device=dev).batch_decode_detailed(syn)
    assert (got[1] == want[1]).mean() >= 0.99 and (got[2] == want[2]).mean() >= 0.99
    assert (got[0] == want[0]).all(axis=1).mean() >= 0.97
    assert ((got[0].astype(np.int64) @ H.T) % 2 == syn)[got[1]].all()


def test_fer_sweep_on_card(dev):
    """Host sampling: the card's counts equal the CPU's where BP converges
    (per 0.01); per 0.2 sends every lane through K1, all
    syndrome-consistent; the device sampler repeats for a seed."""
    from ldpcdecoders_tpu_torch.harness import FERSweep

    H = pt.parity_check_matrix(1000, 10, 9, rng=42)
    out = {}
    for device in ("cpu", dev):
        out[str(device)] = FERSweep(
            H, lambda p, d=device: pt.BeliefPropagationOSDDecoder(H, p, 100, device=d), [0.01],
            batch=256, seed=0).run(trials_per_point=512)[0.01]
    strip = lambda s: {k: v for k, v in s.items() if k != "throughput_syndromes_per_s"}
    assert strip(out["cpu"]) == strip(out[str(dev)])
    before = cuda_gf2.gf2_osd0_cuda.launches
    s = FERSweep(H, lambda p: pt.BeliefPropagationOSDDecoder(H, p, 100, device=dev), [0.2],
                 batch=256, seed=0).run(trials_per_point=256)[0.2]
    assert cuda_gf2.gf2_osd0_cuda.launches > before and s["syndrome_match_rate"] == 1.0
    kw = dict(batch=256, seed=5, sample_on_device=True)
    a, b = (FERSweep(H, lambda p: pt.MinSumDecoder(H, p, 50, device=dev), [0.02], **kw).run(
        trials_per_point=512)[0.02] for _ in range(2))
    assert strip(a) == strip(b) and a["converged_fraction"] > 0.99


def test_css_and_spacetime_sweeps_on_card(dev):
    """The device route on the card (sampling, both block decodes through
    K1 where BP fails, the stabilizer verdict) repeats for a seed; the
    host route's counts equal the CPU's with the min-sum inner (bitwise on
    the card and the CPU)."""
    from ldpcdecoders_tpu_torch.harness import css_logical_sweep

    Hx, Hz = pt.surface_code_x(5), pt.surface_code_z(5)
    kw = dict(trials_per_point=512, batch=256, max_iters=30, seed=3, device=dev)
    before = cuda_gf2.gf2_osd0_cuda.launches
    a = css_logical_sweep(Hx, Hz, [0.05], **kw)
    assert cuda_gf2.gf2_osd0_cuda.launches > before
    assert a == {k: {**v, "throughput_pairs_per_s": a[k]["throughput_pairs_per_s"]}
                 for k, v in css_logical_sweep(Hx, Hz, [0.05], **kw).items()}
    assert a[0.05]["device_sampled"] and 0 < a[0.05]["any_logical_rate"] < 0.5
    host = dict(kw, on_device=False, decoder="minsum", trials_per_point=256)
    got = css_logical_sweep(Hx, Hz, [0.05], **host)[0.05]
    want = css_logical_sweep(Hx, Hz, [0.05], **dict(host, device="cpu"))[0.05]
    got.pop("throughput_pairs_per_s")
    want.pop("throughput_pairs_per_s")
    assert got == want


def test_dem_sweep_on_card(dev):
    """The d5 DEM: the device route repeats for a seed and launches K1;
    circuit-sampled shots give the CPU's counts with the min-sum inner."""
    from ldpcdecoders_tpu_torch.harness import dem_logical_sweep

    c = pt.css_memory_circuit(pt.surface_code_x(5), pt.surface_code_z(5), 5, p=0.003)
    dem = pt.circuit_dem(c)
    kw = dict(shots=2048, batch=1024, max_iters=60, seed=7, device=dev)
    before = cuda_gf2.gf2_osd0_cuda.launches
    a = dem_logical_sweep(dem, **kw)
    assert cuda_gf2.gf2_osd0_cuda.launches > before and a["device_sampled"]
    b = dem_logical_sweep(dem, **kw)
    assert (a["fails"], a["converged"]) == (b["fails"], b["converged"])
    host = dict(kw, circuit=c, inner="minsum", shots=1024)
    got, want = dem_logical_sweep(dem, **host), dem_logical_sweep(dem, **dict(host, device="cpu"))
    assert (got["fails"], got["converged"]) == (want["fails"], want["converged"])


def test_device_error_draws_on_card(dev):
    from ldpcdecoders_tpu_torch.utils.noise import sample_errors_device

    a = sample_errors_device(4, 4096, 1000, 0.01, device=dev)
    assert a.device.type == "cuda" and torch.equal(a, sample_errors_device(4, 4096, 1000, 0.01,
                                                                            device=dev))
    assert abs(a.float().mean().item() - 0.01) < 0.0005


@pytest.fixture
def nccl_group(dev):
    """A one-rank NCCL group, set up by ``make_mesh`` itself and torn down
    after the test."""
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is already set up")
    yield
    dist.destroy_process_group()


def test_one_rank_nccl_sharded_decodes_launch_k1_and_k3(dev, nccl_group):
    from ldpcdecoders_tpu_torch import parallel as par

    H = pt.parity_check_matrix(1000, 10, 9, rng=42)
    rng = np.random.default_rng(12)
    syn20 = (((rng.random((128, 1000)) < 0.2) @ H.T) % 2).astype(np.uint8)
    syn01 = (((rng.random((128, 1000)) < 0.01) @ H.T) % 2).astype(np.uint8)
    mesh = par.make_mesh()
    assert mesh.device_type == "cuda" and par.mesh.mesh_device(mesh) == dev
    dec = pt.BeliefPropagationOSDDecoder(H, 0.2, 50, device=dev)
    want = dec.batch_decode(syn20)
    before = cuda_gf2.gf2_osd0_cuda.launches
    got = par.sharded_batch_decode(dec, syn20, mesh)
    assert cuda_gf2.gf2_osd0_cuda.launches > before
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])

    mesh2 = par.make_mesh(axis_names=("data", "model"))
    ms = pt.MinSumDecoder(H, 0.01, 100, device=dev)
    e0, c0, i0, _, _ = ms.batch_decode_detailed(syn01)
    before = cuda_minsum.minsum_check_iter_cuda.launches, cuda_minsum.minsum_var_cuda.launches
    e, c, i = par.make_check_sharded_minsum_fn(ms.graph, 0.01, 100, mesh2)(syn01)
    assert cuda_minsum.minsum_check_iter_cuda.launches > before[0]
    assert cuda_minsum.minsum_var_cuda.launches > before[1]
    assert np.array_equal(c, c0) and np.array_equal(i, i0)
    assert np.array_equal(e[c], e0[c])


BUILDERS = ["make_bp_decode_fn", "make_minsum_decode_fn", "make_layered_minsum_fn",
            "make_minsum_q_decode_fn", "make_fused_bposd_fn", "make_syndrome_fn"]


@pytest.mark.parametrize("name", BUILDERS)
def test_builder_on_card_matches_cpu(dev, name):
    """Each of the reference's functional cores, built on the card and with
    ``device="cpu"``, on the same 64 lanes: BP's err / converged / iters
    bitwise and logp within rtol 1e-5, atol 1e-6 (float32 log may differ by
    an ulp); min-sum (damped, check layout: K3's iteration form and K4),
    layered, int8 and the syndrome (both routes) bitwise; the fused BP+OSD-0
    converged / iters bitwise and err bitwise on the lanes whose reliability
    order agrees (at least 3/4), every output syndrome-consistent."""
    from ldpcdecoders_tpu_torch.models import bp, bposd, layered, minsum, minsum_q
    from ldpcdecoders_tpu_torch.ops import syndrome

    H = pt.parity_check_matrix(240, 8, 4, rng=17)
    graph = pt.TannerGraph.from_pcm(H)
    rng = np.random.default_rng(64)
    errs = rng.random((64, 240)) < 0.06
    syn = ((errs @ H.T) % 2).astype(np.uint8)

    def both(build, x, *args, **kw):
        cpu = build(*args, device="cpu", **kw)(x)
        card = build(*args, device=dev, **kw)(torch.as_tensor(x, device=dev))
        torch.cuda.synchronize()
        if isinstance(card, torch.Tensor):
            return cpu, card.cpu()
        return cpu, [t.cpu() for t in card]

    if name == "make_syndrome_fn":
        x = errs.astype(np.float32)
        for g in (graph, dataclasses.replace(graph, H=None)):
            cpu, card = both(syndrome.make_syndrome_fn, x, g)
            assert torch.equal(card, cpu)
            assert np.array_equal(card.numpy(), (x @ H.T) % 2)
        return
    module = {"make_bp_decode_fn": bp, "make_minsum_decode_fn": minsum,
              "make_layered_minsum_fn": layered, "make_minsum_q_decode_fn": minsum_q,
              "make_fused_bposd_fn": bposd}[name]
    args = (graph, 0.06, 30) + ((0,) if name == "make_fused_bposd_fn" else ())
    kw = {}
    if name == "make_minsum_decode_fn":
        kw = dict(damping=0.4, layout="check", check_every=8)
    counted = (cuda_minsum.minsum_check_iter_cuda, cuda_minsum.minsum_var_iter_cuda,
               cuda_gf2.gf2_osd0_cuda)
    before = [w.launches for w in counted]
    want, got = both(getattr(module, name), syn, *args, **kw)
    after = [w.launches for w in counted]
    assert not bool(want[1].all()) and bool(want[1].any())
    for a, b in zip(got[1:3], want[1:3]):
        assert torch.equal(a, b)
    if name == "make_minsum_decode_fn":
        assert after[0] > before[0] and after[1] > before[1]
    if name not in ("make_bp_decode_fn", "make_fused_bposd_fn"):
        for a, b in ((got[0], want[0]), (got[3], want[3])):
            assert torch.equal(bits(a) if a.is_floating_point() else a,
                               bits(b) if b.is_floating_point() else b)
        return
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-6)
    agree = torch.ones(64, dtype=torch.bool)
    if name == "make_fused_bposd_fn":
        assert after[2] > before[2]
        assert (((got[0].numpy().astype(np.int64) @ H.T) % 2) == syn).all()
        orders = []
        for lp in (got[3], want[3]):
            p = torch.exp(lp)
            orders.append(torch.argsort(-torch.maximum(p, 1 - p), dim=1, stable=True))
        agree = (orders[0] == orders[1]).all(dim=1)
        assert agree.float().mean() >= 0.75
    assert torch.equal(got[0][agree], want[0][agree])
