"""Port parity: the variable layout on lane tiles (csrc/minsum.cu "Lane
tiles"; ``MinSumDecode(layout="var")``).

  * ``var_iter_ref`` with ``nu`` on tiles (the plain twin of K4's in-place
    form on tiles) is bitwise its ``lane_tile=1`` form: float32 and
    bfloat16, no damping / scalar / ``[B]`` / ``[B, n]`` gammas (negative
    strengths among them), per-edge weights on and off, the freeze on and
    off, on a graph with variables of more than 32 slots (summed by windows
    of 32).
  * ``MinSumDecode(layout="var")`` on 64- and 128-lane tiles is bitwise the
    lane-major decode and the JAX package run op by op (err, converged,
    iters, LLRs) on a small Gallager code and on tests/test_torch_staged.py's
    small DEM, every knob of the variable layout; and with
    ``early_exit=False``.  tests/test_torch_minsum.py's compaction cases
    hold the layout across tile widths.
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
from ldpcdecoders_tpu_torch.ops.minsum import tile_lanes, untile_lanes, var_iter_ref
from ldpcdecoders_tpu_torch.utils import profiling

torch.set_num_threads(1)

JNP_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def small_dem(seed=5, D=40, N=300):
    """tests/test_torch_staged.py's ``_small_dem(5)``: variables of degree
    up to 40, checks past 32 slots."""
    rng = np.random.default_rng(seed)
    A = (rng.random((D, N)) < 0.08).astype(np.uint8)
    A[:, A.sum(axis=0) == 0] = 1
    return A, np.clip(rng.random(N) * 0.01, 1e-4, 0.01)


def gallager():
    return lt.parity_check_matrix(240, 8, 4, rng=37), None


CODES = {"dem": small_dem, "gallager": gallager}


def graphs(H):
    g = lt.TannerGraph.from_pcm(H)
    return g, pt.TannerGraph.from_arrays(**dataclasses.asdict(g))


def bits(t):
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def gamma_of(kind, B, n, dtype, seed=11):
    if kind is None:
        return None
    rng = np.random.default_rng(seed)
    g = {"scalar": np.float32(0.4), "lane": rng.uniform(-0.2, 0.7, B),
         "var": rng.uniform(-0.24, 0.66, (B, n))}[kind]
    return torch.as_tensor(np.asarray(g, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gamma_kind", [None, "scalar", "lane", "var"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("freeze", [False, True])
@pytest.mark.parametrize("lane_tile", [64, 128])
def test_var_iter_on_tiles_is_lane_major(dtype, gamma_kind, weighted, freeze, lane_tile):
    """K4's in-place form's plain twin on two tiles against
    ``lane_tile=1``: the leave-one-out messages, the totals and the frozen
    outputs, bitwise."""
    A, _ = small_dem()
    g = pt.TannerGraph.from_pcm(A)
    assert g.max_dv > 32
    T = lane_tile
    Bp = 2 * T  # two tiles
    rng = np.random.default_rng(T + 3 * weighted + freeze)
    ms = pt.MinSumDecode(g, 0.05, 2, device="cpu", dtype=dtype)
    dc, m, dv, n = g.max_dc, g.m, g.max_dv, g.n
    # magnitudes over six decades: a reordered sum rounds differently
    mu_flat = torch.as_tensor(rng.normal(size=(Bp, dc * m))
                              * 10.0 ** rng.integers(-3, 4, (Bp, dc * m))).to(dtype)
    L0 = torch.as_tensor(rng.normal(size=(Bp, n)) * 2).to(dtype)
    nu0 = torch.as_tensor(rng.normal(size=(Bp, dv, n)) * 3).to(dtype)
    W = (torch.as_tensor(rng.uniform(0.3, 1.4, size=(dv, n))).to(dtype) if weighted else None)
    gamma = gamma_of(gamma_kind, Bp, n, dtype)
    frozen = {}
    if freeze:
        frozen = dict(done=torch.as_tensor(rng.random(Bp) < 0.4),
                      err=torch.as_tensor((rng.random((Bp, n)) < 0.5).astype(np.float32)),
                      llrs=torch.as_tensor(rng.normal(size=(Bp, n))).to(dtype))
    tile = lambda t: t if t is None or t.ndim == 0 else tile_lanes(t, T)  # noqa: E731

    nu_w, tot_w = nu0.clone(), torch.full((Bp, n), 7.0, dtype=dtype)
    out_w = {k: v.clone() for k, v in frozen.items()}
    var_iter_ref(mu_flat, ms.v2c, ms.var_mask, L0, W=W, nu=nu_w, gamma=gamma, total=tot_w,
                 **out_w)

    nu_t, tot_t = tile(nu0), tile(torch.full((Bp, n), 7.0, dtype=dtype))
    out_t = {k: tile(v) for k, v in frozen.items()}
    assert nu_t.shape == (2, dv, n, T)
    assert var_iter_ref(tile(mu_flat), ms.v2c, ms.var_mask, tile(L0), W=W, nu=nu_t,
                        gamma=tile(gamma), total=tot_t, lane_tile=T, **out_t) is tot_t
    for a, b in ((nu_t, nu_w), (tot_t, tot_w), *((out_t[k], out_w[k]) for k in out_w)):
        assert torch.equal(bits(untile_lanes(a, T)), bits(b))
    assert not torch.equal(bits(nu_w), bits(nu0))


# name -> (decode keywords, gamma kind, dtype, check_every): the variable
# layout's knobs (per-iteration schedules drawn in ``schedule``)
KNOBS = {
    "plain": (dict(), None, torch.float32, 1),
    "damped": (dict(damping=0.4), None, torch.float32, 1),
    "damped_bf16": (dict(damping=0.4), None, torch.bfloat16, 1),
    "lane_B": (dict(lane_damping=True), "lane", torch.float32, 3),
    "lane_Bn_best": (dict(lane_damping=True, track_best=True), "var", torch.bfloat16, 4),
    "weights_alpha": (dict(edge_weights="weights", alpha="alpha", beta=0.1), None,
                      torch.float32, 1),
}


def schedule(kind, g, max_iters):
    rng = np.random.default_rng(9)
    if kind == "alpha":
        return rng.uniform(0.6, 1.0, max_iters).astype(np.float32)
    return rng.uniform(0.5, 1.2, (max_iters, g.max_dv, g.n)).astype(np.float32)


def decode_ref_and_tiles(code, name, B, max_iters, *, early_exit=True):
    """The JAX package op by op, then ``MinSumDecode(layout="var")`` at
    ``_lane_tile`` 1, 64 and 128 on the same records."""
    knobs, gamma_kind, dtype, check_every = KNOBS[name]
    H, pr = CODES[code]()
    g, gp = graphs(H)
    per = 0.04 if pr is None else pr
    rng = np.random.default_rng(B)
    x = rng.random((B, g.n)) < (0.04 if pr is None else pr * 4)
    syn = ((x.astype(np.int64) @ H.T) % 2).astype(np.uint8)
    kw = {k: schedule(v, g, max_iters) if isinstance(v, str) else v for k, v in knobs.items()}
    gamma = gamma_of(gamma_kind, B, g.n, torch.float32, seed=B)
    fn = make_minsum_decode_fn(g, per, max_iters, dtype=JNP_DTYPE[dtype],
                               check_every=check_every, **kw)
    args = [jnp.asarray(syn), None] + ([] if gamma is None else [jnp.asarray(gamma.numpy())])
    with jax.disable_jit():
        want = fn(*args)
    got = {}
    for T in (1, 64, 128):
        mod = pt.MinSumDecode(gp, per, max_iters, device="cpu", dtype=dtype,
                              check_every=check_every, _lane_tile=T, **kw)
        with profiling.recording() as rec:
            got[T] = mod(torch.as_tensor(syn), None, gamma, early_exit=early_exit)
        c = rec.counters
        assert c["minsum_lane_iters_tiled"] == (c["minsum_lane_iters_launched"] if T > 1 else 0)
    return want, got


def assert_equal_outputs(want, got):
    for a, b in zip(want[:3], got[:3]):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(want[3]).astype(np.float32).view(np.uint32),
                          got[3].to(torch.float32).numpy().view(np.uint32))


@pytest.mark.parametrize("code", list(CODES))
@pytest.mark.parametrize("name", list(KNOBS))
def test_var_layout_tiled_decode_matches_lane_major_and_reference(code, name):
    """24 iterations, 70 records (a whole 64-lane tile and a ragged one; one
    ragged 128-lane tile): every output of the tiled decodes bitwise the
    lane-major decode's and the JAX package's run op by op."""
    want, got = decode_ref_and_tiles(code, name, 70, 24)
    for T in (1, 64, 128):
        assert_equal_outputs(want, got[T])
        for a, b in zip(got[1], got[T]):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(bits(a), bits(b))
    conv = np.asarray(want[1])
    assert conv.any() and not conv.all(), "the case needs lanes on both sides"


@pytest.mark.parametrize("name", ["damped", "lane_Bn_best"])
def test_var_layout_tiled_decode_without_early_exit(name):
    """``early_exit=False`` (the fused BP+OSD: every iteration, no host
    read) on tiles: the lane-major decode's outputs, and the JAX
    package's."""
    want, got = decode_ref_and_tiles("dem", name, 70, 16, early_exit=False)
    for T in (1, 64, 128):
        assert_equal_outputs(want, got[T])
