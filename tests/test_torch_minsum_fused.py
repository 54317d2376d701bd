"""Port parity: the min-sum iteration's fused forms (ops/minsum.py
``check_iter_ref`` / ``var_iter_ref``, the plain versions of the kernels'
iteration forms) and ``MinSumDecode`` built on them.

  * The plain iteration forms against the composite they replace: the
    check update, the variable update and the plain torch passes around them
    (the check layout's rebuild ``total[var] - mu``, the damping mix, the
    freeze by ``torch.where``), iterated in the reference's order
    (``ldpcdecoders_tpu/models/minsum.py`` ``decode`` / ``decode_check``).
    The check layout's fused iteration starts one damping mix later (it
    mixes at the start of an iteration what the composite mixed at the end
    of the one before), so the two are compared iteration by iteration on
    what both hold: ``mu``, the totals, the messages entering the next check
    update, ``err`` and ``llrs``.  Bitwise on the real slots (a padded slot's
    value is never read), float32 and bfloat16, every damping form
    (negative per-variable strengths among them), both layouts, on
    tests/test_torch_staged.py's small DEM (variables of degree 40, checks
    past 32 slots) and a Gallager code.
  * ``MinSumDecode`` against the JAX package run op by op
    (``jax.disable_jit()``: XLA contracts no multiply-add there, ROADMAP
    queue 3), bitwise in err / converged / iters and the LLRs, in the
    staged decoder's check-layout configurations: stage 0 (float32, one
    damping factor) and deep (bfloat16, per-variable strengths,
    ``track_best``), ``check_every=8``, over 12 iterations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.models.minsum import make_minsum_decode_fn
from ldpcdecoders_tpu_torch.ops import cuda_minsum
from ldpcdecoders_tpu_torch.ops.minsum import (
    check_core_ref,
    check_iter_ref,
    check_update_ref,
    slot_degrees,
    var_iter_ref,
    var_update_ref,
)

torch.set_num_threads(1)

JNP_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
ITERS = 4


def small_dem(seed=5, D=40, N=300):
    """tests/test_torch_staged.py's ``_small_dem(5)``."""
    rng = np.random.default_rng(seed)
    A = (rng.random((D, N)) < 0.08).astype(np.uint8)
    A[:, A.sum(axis=0) == 0] = 1
    pr = np.clip(rng.random(N) * 0.01, 1e-4, 0.01)
    return A, pr


def code(name):
    """(H, per-variable prior) of a test code."""
    if name == "small_dem":
        A, pr = small_dem()
        return A, pr * 8
    H = lt.parity_check_matrix(240, 8, 4, rng=37)
    return H, np.full(H.shape[1], 0.05)


def bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def assert_real_equal(a, b, real):
    B = a.shape[0]
    assert torch.equal(bits(a).reshape(B, -1)[:, real], bits(b).reshape(B, -1)[:, real])


def gamma_of(kind, B, n, dtype):
    rng = np.random.default_rng(11)
    if kind is None:
        return None
    g = {"scalar": np.float32(0.4), "lane": rng.uniform(-0.2, 0.7, B),
         "var": rng.uniform(-0.24, 0.66, (B, n))}[kind]
    return torch.as_tensor(np.asarray(g, np.float32)).to(dtype)


def setup(code_name, dtype, layout, B=12):
    H, pr = code(code_name)
    g = pt.TannerGraph.from_pcm(H)
    ms = pt.MinSumDecode(g, 0.05, ITERS, device="cpu", dtype=dtype, layout=layout, alpha=0.8)
    rng = np.random.default_rng(4)
    x = rng.random((B, g.n)) < pr
    syn = torch.as_tensor(((x.astype(np.int64) @ H.T) % 2).astype(bool))
    L0 = torch.as_tensor(np.log((1 - pr) / pr)).to(dtype).expand(B, -1).contiguous()
    # lanes that froze at the second and the third iteration
    done_at = torch.as_tensor(rng.integers(1, ITERS + 2, B))
    return g, ms, syn, L0, done_at


@pytest.mark.parametrize("code_name", ["small_dem", "gallager"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gamma_kind", [None, "scalar", "lane", "var"])
def test_check_layout_iteration_equals_the_composite(code_name, dtype, gamma_kind):
    g, ms, syn, L0, done_at = setup(code_name, dtype, "check")
    B, dc, m, n = L0.shape[0], g.max_dc, g.m, g.n
    cvi, alpha = ms.chk_varidx, ms.alpha
    gamma = gamma_of(gamma_kind, B, n, dtype)
    if gamma is not None and gamma.ndim:
        g_chk = (gamma.reshape(B, 1, 1) if gamma.ndim == 1 else
                 gamma.index_select(1, cvi).reshape(B, dc, m))
    else:
        g_chk = gamma
    real = ms.chk_mask.reshape(-1)

    # the composite: state nu, the damping mix at the end of each iteration
    nu_c = L0.index_select(1, cvi).reshape(B, dc, m)
    err_c, llrs_c = torch.zeros((B, n)), L0
    # the fused forms: state mu, the totals and (damped) nu
    mu_f, nu_f = None, None if gamma is None else nu_c.clone()
    total_f = torch.empty((B, n), dtype=dtype)
    err_f, llrs_f = torch.zeros((B, n)), L0.clone()
    for it in range(ITERS):
        done = done_at <= it
        mu_c = check_core_ref(nu_c, syn, ms.chk_mask, alpha, 0.0)
        _, total_c = var_update_ref(mu_c.reshape(B, -1), ms.v2c, ms.var_mask, L0, want_nu=False)
        new = total_c.index_select(1, cvi).reshape(B, dc, m) - mu_c
        if gamma is not None:
            new = g_chk * nu_c + (1.0 - g_chk) * new
        err_c = torch.where(~done[:, None], (total_c < 0).to(torch.float32), err_c)
        llrs_c = torch.where(~done[:, None], total_c, llrs_c)

        if mu_f is None:
            mu_f = check_update_ref(L0, cvi, syn, ms.chk_mask, alpha, 0.0)
        else:
            assert check_iter_ref(mu_f, total_f, cvi, syn, ms.chk_mask, alpha, 0.0, gamma,
                                  nu_f) is mu_f
            if gamma is not None:  # the messages this iteration's check update took
                assert_real_equal(nu_f, nu_c, real)
        assert var_iter_ref(mu_f.reshape(B, -1), ms.v2c, ms.var_mask, L0, total=total_f,
                            done=done, err=err_f, llrs=llrs_f) is total_f
        assert_real_equal(mu_f, mu_c, real)
        assert torch.equal(bits(total_f), bits(total_c))
        assert torch.equal(err_f, err_c) and torch.equal(bits(llrs_f), bits(llrs_c))
        nu_c = new
    assert 0 < int((err_c != 0).sum()) < err_c.numel()


@pytest.mark.parametrize("code_name", ["small_dem", "gallager"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gamma_kind,weighted", [(None, False), (None, True), ("scalar", False),
                                                 ("lane", True), ("var", False)])
def test_var_layout_iteration_equals_the_composite(code_name, dtype, gamma_kind, weighted):
    g, ms, syn, L0, done_at = setup(code_name, dtype, "var")
    B, dv, n = L0.shape[0], g.max_dv, g.n
    gamma = gamma_of(gamma_kind, B, n, dtype)
    g_var = None if gamma is None else (
        gamma if gamma.ndim == 0 else gamma.reshape(B, 1, 1) if gamma.ndim == 1 else
        gamma.reshape(B, 1, n))
    W = (torch.as_tensor(np.random.default_rng(2).uniform(0.5, 1.2, (dv, n))).to(dtype)
         if weighted else None)
    real = ms.var_mask.reshape(-1)
    nu_c = torch.broadcast_to(L0[:, None, :], (B, dv, n)).contiguous()
    nu_f = nu_c.clone()
    err_c, llrs_c = torch.zeros((B, n)), L0
    err_f, llrs_f = torch.zeros((B, n)), L0.clone()
    total_f = torch.empty((B, n), dtype=dtype)
    for it in range(ITERS):
        done = done_at <= it
        mu_c = check_update_ref(nu_c.reshape(B, -1), ms.c2v, syn, ms.chk_mask, ms.alpha, 0.0)
        new, total_c = var_update_ref(mu_c.reshape(B, -1), ms.v2c, ms.var_mask, L0, W)
        if gamma is not None:
            new = g_var * nu_c + (1.0 - g_var) * new
        err_c = torch.where(~done[:, None], (total_c < 0).to(torch.float32), err_c)
        llrs_c = torch.where(~done[:, None], total_c, llrs_c)

        mu_f = check_update_ref(nu_f.reshape(B, -1), ms.c2v, syn, ms.chk_mask, ms.alpha, 0.0)
        var_iter_ref(mu_f.reshape(B, -1), ms.v2c, ms.var_mask, L0, W=W, nu=nu_f, gamma=gamma,
                     total=total_f, done=done, err=err_f, llrs=llrs_f)
        assert_real_equal(nu_f, new, real)
        assert torch.equal(bits(total_f), bits(total_c))
        assert torch.equal(err_f, err_c) and torch.equal(bits(llrs_f), bits(llrs_c))
        nu_c = new


# the staged decoder's inner decodes (models/staged.py): stage 0 and the
# deep ensemble in the check layout, checked every 8 iterations; records at
# a multiple of the priors that leaves lanes on both sides after 12
DECODES = {
    "stage0": (dict(layout="check", damping=0.4, check_every=8), None, torch.float32, 8),
    "stage0_track_best": (dict(layout="check", damping=0.4, check_every=8, track_best=True),
                          None, torch.float32, 8),
    "deep": (dict(layout="check", lane_damping=True, track_best=True, check_every=8), "var",
             torch.bfloat16, 4),
    "deep_lane_gamma": (dict(layout="check", lane_damping=True, track_best=True,
                             check_every=8), "lane", torch.float32, 4),
}


@pytest.mark.parametrize("name", list(DECODES))
def test_minsum_decode_matches_reference_op_by_op(name):
    """12 iterations on tests/test_torch_staged.py's small DEM: the port
    bitwise against the reference run op by op."""
    kw, gamma_kind, dtype, scale = DECODES[name]
    A, pr = small_dem()
    B = 32
    rng = np.random.default_rng(1)
    x = rng.random((B, A.shape[1])) < pr * scale
    syn = ((x.astype(np.int64) @ A.T) % 2).astype(np.uint8)
    gamma = None if gamma_kind is None else gamma_of(gamma_kind, B, A.shape[1], torch.float32)
    gref = lt.TannerGraph.from_pcm(A)
    fn = make_minsum_decode_fn(gref, pr, 12, dtype=JNP_DTYPE[dtype], **kw)
    args = [jnp.asarray(syn), None] + ([] if gamma is None else [jnp.asarray(gamma.numpy())])
    with jax.disable_jit():
        want = fn(*args)
    mod = pt.MinSumDecode(pt.TannerGraph.from_arrays(**dataclasses.asdict(gref)), pr, 12,
                          device="cpu", dtype=dtype, **kw)
    got = mod(torch.as_tensor(syn), None, gamma)
    for a, b in zip(want[:3], got[:3]):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(want[3]).astype(np.float32).view(np.uint32),
                          got[3].to(torch.float32).numpy().view(np.uint32))
    conv = np.asarray(want[1])
    assert conv.any() and not conv.all(), "the case needs lanes on both sides"


@pytest.mark.parametrize("row_bytes,m,dc,want", [
    (126592, 864, 294, (864, 126592 + 4 * 10 * 864)),  # the bb144 DEM's totals, float32
    (63296, 864, 294, (864, 63296 + 4 * 10 * 864)),  # bfloat16
    (4000, 900, 10, (928, 4000 + 4 * 928)),  # the Gallager code's totals
    (4 * 1000, 3000, 40, (1024, 4000 + 8 * 1024)),  # more checks than threads
    (230000, 864, 294, (0, 230000 + 4 * 10 * 128)),  # too large for a block: flat form
])
def test_stage_plan(row_bytes, m, dc, want):
    """The staged check form's plan: a block per lane, up to 1024 threads,
    the lane's row and a sign word per 32 slots and thread in shared memory."""
    assert cuda_minsum.stage_plan(row_bytes, m, dc) == want


@pytest.mark.parametrize("row_bytes,m,dc,staged", [
    (126592, 864, 294, False),  # float32 totals: one block an SM
    (63296, 864, 294, True),  # bfloat16 totals: two blocks an SM
    (36000, 900, 10, False),  # the Gallager code's var-layout rows: below 48 KB
    (4000, 900, 10, False),
])
def test_stages_by_default(row_bytes, m, dc, staged):
    """K3's launcher stages a gathered row only where it is at least 48 KB
    and two staged blocks fit an SM."""
    assert cuda_minsum.stages_by_default(row_bytes, m, dc) == staged


def test_slot_degrees_needs_real_slots_first():
    g = pt.TannerGraph.from_pcm(small_dem()[0])
    mask = torch.as_tensor(g.slot_major()[2])
    want = torch.as_tensor(g.chk_mask.sum(axis=1), dtype=torch.int32)
    assert torch.equal(slot_degrees(mask), want)
    with pytest.raises(ValueError, match="real slots come first"):
        slot_degrees(mask.flip(0))


def test_iteration_wrappers_refuse_mismatched_state():
    g, ms, syn, L0, _ = setup("small_dem", torch.float32, "check", B=2)
    mu = torch.zeros((2, g.max_dc, g.m))
    total = torch.zeros((2, g.n))
    with pytest.raises(ValueError, match="damps"):
        cuda_minsum.minsum_check_iter_cuda(mu, total, ms.chk_varidx, syn, ms.chk_mask, 1.0, 0.0,
                                           nu=mu.clone())
    with pytest.raises(ValueError, match="go together"):
        cuda_minsum.minsum_var_iter_cuda(mu.reshape(2, -1), ms.v2c, ms.var_mask, L0,
                                         done=torch.zeros(2, dtype=torch.bool))
