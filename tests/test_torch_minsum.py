"""Port parity: the min-sum message updates and the min-sum decoder.

The same seeded numpy inputs go through ``ldpcdecoders_tpu`` (JAX on the
CPU; its Pallas kernels in interpret mode, as tests/test_pallas.py runs
them) and ``ldpcdecoders_tpu_torch``.

Tolerances, each stated where it is used:

  * float32: err / converged / iters and the LLRs are bitwise equal for every
    knob, on every lane and at full depth, when the reference runs op by op
    (``jax.disable_jit()``), which is how its arithmetic is defined.  Compiled
    as one program, XLA on the CPU contracts ``a * b + c`` into a fused
    multiply-add; the port rounds each product on its own (as torch does on
    the CPU and on a card).  So against the jitted reference the bitwise
    cases use values whose products are exact (alpha or beta trivial, damping
    0.5, power-of-two weights); at general values err / converged / iters
    are still equal on every lane, and the LLRs of every lane after two
    iterations lie within FMA_SPACINGS float32 spacings of the largest LLR
    magnitude (measured 2; the difference compounds with every further
    iteration, so deeper LLRs are held through the op-by-op run instead).
  * bfloat16: every result is rounded to bfloat16 after each operation in
    both packages, so nothing contracts: err / converged / iters equal, LLRs
    within one bfloat16 ulp (2**-7 relative; measured bitwise).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.models import priors as ref_priors
from ldpcdecoders_tpu.models.minsum import make_minsum_decode_fn
from ldpcdecoders_tpu.ops import clamps as ref_clamps
from ldpcdecoders_tpu.ops.pallas_minsum import check_update_pallas, var_update_pallas
from ldpcdecoders_tpu_torch.models import minsum as minsum_module
from ldpcdecoders_tpu_torch.models import priors
from ldpcdecoders_tpu_torch.models.minsum import from_reference_params
from ldpcdecoders_tpu_torch.ops import clamps, cuda_minsum
from ldpcdecoders_tpu_torch.ops.minsum import (
    check_core_ref,
    check_update_ref,
    var_core_ref,
    var_update_ref,
)
from ldpcdecoders_tpu_torch.utils import profiling

torch.set_num_threads(1)

MAX_ITERS = 30
FMA_SPACINGS = 4
BF16_ULP = 2.0**-7

JNP_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def graphs(H):
    """The reference's compiled graph and the port's, from the same arrays."""
    g = lt.TannerGraph.from_pcm(H)
    return g, pt.TannerGraph.from_arrays(**dataclasses.asdict(g))


@pytest.fixture(scope="module")
def gallager():
    H = lt.parity_check_matrix(240, 8, 4, rng=37)  # the code of tests/test_pallas.py
    return (H, *graphs(H))


@pytest.fixture(scope="module")
def toric():
    H = lt.toric_code_x(3)  # an irregular graph, as tests/test_minsum.py uses
    return (H, *graphs(H))


def syndromes_of(H, per, B, seed):
    rng = np.random.default_rng(seed)
    errs = rng.random((B, H.shape[1])) < per
    return ((errs @ H.T) % 2).astype(np.uint8)


def f32(x):
    """A float32 or bfloat16 array/tensor as float32 numpy (exact)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def assert_bitwise(a, b):
    a, b = f32(a), f32(b)
    assert a.shape == b.shape
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def tables(gp):
    c2v, v2c, chk_mask, var_mask = gp.slot_major()
    return (torch.as_tensor(c2v.astype(np.int32)), torch.as_tensor(v2c.astype(np.int32)),
            torch.as_tensor(chk_mask), torch.as_tensor(var_mask))


# -- the loop's compaction -------------------------------------------------


def small_dem(seed=5, D=40, N=300):
    """tests/test_torch_staged.py's ``_small_dem(5)``."""
    rng = np.random.default_rng(seed)
    A = (rng.random((D, N)) < 0.08).astype(np.uint8)
    A[:, A.sum(axis=0) == 0] = 1
    return A, np.clip(rng.random(N) * 0.01, 1e-4, 0.01)


def mixed_records(A, B, seed):
    """``B`` records whose lanes converge at different checks: an eighth with
    no detection event (done at the first check), the rest at rates of
    0.005, 0.01 (within a few iterations, or later) and 0.2 (never), in a
    seeded order.  On the card's tiles a batch of 256 checked every
    iteration goes 128 -> 64 -> 128 -> lane-major."""
    rng = np.random.default_rng(seed)
    counts = np.round(np.array([0.12, 0.3, 0.5]) * B).astype(int)
    rate = np.repeat([0.0, 0.005, 0.01, 0.2], [*counts, B - counts.sum()])
    x = rng.random((B, A.shape[1])) < rng.permutation(rate)[:, None]
    return ((x.astype(np.int64) @ A.T) % 2).astype(np.uint8)


def lane_iters_launched(spans, conv, iters, max_iters, check_every, tile, tiled_only=False):
    """The loop's lane-iterations, segment by segment: each
    ``ldpc.minsum.compact`` span after a check narrows the width to the
    lanes not done there (not converged by that check's iteration), padded
    to ``tile(live)`` lanes.  ``tiled_only``: the lane-major segments count
    0 (``minsum_lane_iters_tiled``)."""
    padded = lambda k: -(-k // tile(k)) * tile(k) * (tile(k) > 1 or not tiled_only)  # noqa: E731
    grid = [t for t in range(1, max_iters + 1) if t % check_every == 0 or t >= max_iters]
    width, start, k, t, total = padded(len(iters)), 0, 0, 0, 0
    for name in spans:
        if name == "ldpc.minsum.check":
            t, k = grid[k], k + 1
        elif name == "ldpc.minsum.compact":
            total += width * (t - start)
            width, start = padded(int((~(conv & (iters <= t))).sum())), t
    return total + width * (t - start)


# name -> (decode keywords, gamma kind, dtype, check_every, lanes, tiles): "card"
# takes the card's tiles on the CPU (lane_tile_for: 128, 64, lane-major),
# "cpu" the CPU's lane-major rows
COMPACT_CASES = {
    "check_damped_tiles": (dict(layout="check", damping=0.5), None, torch.float32, 1, 256,
                           "card"),
    "check_damped_tiles_every8": (dict(layout="check", damping=0.5), None, torch.float32, 8,
                                  256, "card"),
    "check_lane_Bn_best_tiles": (dict(layout="check", lane_damping=True, track_best=True),
                                 "var", torch.bfloat16, 3, 256, "card"),
    "check_lane_B_best_tiles": (dict(layout="check", lane_damping=True, track_best=True),
                                "lane_exact", torch.float32, 1, 200, "card"),
    "check_lane_B_best": (dict(layout="check", lane_damping=True, track_best=True),
                          "lane_exact", torch.float32, 1, 48, "cpu"),
    "check_plain": (dict(layout="check"), None, torch.float32, 3, 48, "cpu"),
    "var_plain": (dict(), None, torch.float32, 1, 48, "cpu"),
    "var_lane_B": (dict(lane_damping=True), "lane_exact", torch.float32, 3, 48, "cpu"),
    "var_lane_Bn": (dict(lane_damping=True), "var_exact", torch.float32, 8, 48, "cpu"),
    "var_damped_best": (dict(damping=0.5, track_best=True), None, torch.float32, 1, 48,
                        "cpu"),
    "var_edge_weights_alpha": (dict(edge_weights="weights_pow2", alpha="alpha"), None,
                               torch.float32, 3, 48, "cpu"),
    "var_damped_tiles": (dict(damping=0.5), None, torch.float32, 1, 256, "card"),
    "var_lane_Bn_best_tiles": (dict(lane_damping=True, track_best=True), "var_exact",
                               torch.bfloat16, 3, 256, "card"),
    "var_edge_weights_alpha_tiles": (dict(edge_weights="weights_pow2", alpha="alpha"), None,
                                     torch.float32, 1, 200, "card"),
    "converged_at_once": (dict(layout="check", damping=0.5), None, torch.float32, 3, 48,
                          "cpu"),
}


@pytest.mark.parametrize("name", list(COMPACT_CASES))
def test_compacted_decode_matches_reference_op_by_op(monkeypatch, name):
    """Lanes that converge at different checks leave the loop's state at
    its checks (the rule's fixed cost set to 0: on a state this small it
    never pays): errors, flags, iterations and LLRs stay bitwise the JAX
    package's run op by op; the lane-iterations launched are the sum of the
    narrowing widths' segments; a batch done at its first check stops there
    with no compaction."""
    knobs, gamma_kind, dtype, check_every, B, tiles = COMPACT_CASES[name]
    A, pr = small_dem()
    g, gp = graphs(A)
    max_iters = MAX_ITERS
    kw = {k: schedule(v, g)[:max_iters] if isinstance(v, str) and k != "layout" else v
          for k, v in knobs.items()}
    syn = (np.zeros((B, g.m), np.uint8) if name == "converged_at_once"
           else mixed_records(A, B, 7))
    gamma = None if gamma_kind is None else gamma_of(gamma_kind, B, g.n)
    fn = make_minsum_decode_fn(g, pr, max_iters, dtype=JNP_DTYPE[dtype],
                               check_every=check_every, **kw)
    args = [jnp.asarray(syn), None] + ([] if gamma is None else [jnp.asarray(gamma)])
    with jax.disable_jit():
        want = fn(*args)
    tile = (minsum_module.lane_tile_for if tiles == "card" else (lambda k: 1))
    # the gather's fixed cost outweighs any saving on a state this small
    monkeypatch.setattr(minsum_module, "_GATHER_FIXED_BYTES", 0.0)
    if tiles == "card":
        monkeypatch.setattr(minsum_module.MinSumDecode, "_tile",
                            lambda self, lanes, device: minsum_module.lane_tile_for(lanes))
    mod = pt.MinSumDecode(gp, pr, max_iters, device="cpu", dtype=dtype,
                          check_every=check_every, **kw)
    with profiling.recording() as rec:
        got = mod(torch.as_tensor(syn), None, None if gamma is None else torch.as_tensor(gamma))
    assert_flags_equal(want, got)
    assert_bitwise(want[3], got[3])
    names = [s.name for s in rec.spans]
    compactions = names.count("ldpc.minsum.compact")
    assert rec.counters.get("minsum_compactions", 0) == compactions
    conv, iters = got[1], got[2]
    launched = lane_iters_launched(names, conv, iters, max_iters, check_every, tile)
    assert rec.counters["minsum_lane_iters_launched"] == launched
    assert rec.counters["minsum_lane_iters_tiled"] == lane_iters_launched(
        names, conv, iters, max_iters, check_every, tile, tiled_only=True)
    if name == "converged_at_once":
        assert names.count("ldpc.minsum.check") == 1 and compactions == 0
        assert bool(conv.all()) and launched == B * check_every
        return
    assert compactions > 0 and rec.counters["minsum_compact_bytes"] > 0
    assert launched < B * int(iters.max())
    assert conv.any() and not conv.all(), "the case needs lanes on both sides"


@pytest.mark.parametrize("case", ["stage0_first_check", "stage0_later_check", "gallager",
                                  "gallager_straggler", "no_narrower_width", "near_the_cap",
                                  "card_tiles"])
def test_compaction_rule(monkeypatch, case):
    """The rule with its measured costs: narrow where the lane-iterations
    saved, over the iterations left but no more than the loop has run, pay
    the gather (per lane kept, and a fixed cost in bytes of state).  At the
    bb144 DEM's state (2.54 MB a lane) stage 0's first check keeps its
    width and a later one narrows; a Gallager-sized state (54 KB a lane)
    whose lanes converge within a few iterations never narrows; nothing
    narrows where the width would not shrink; on the card the kept lanes
    take their tile."""
    A, pr = small_dem()
    mod = pt.MinSumDecode(pt.TannerGraph.from_pcm(A), pr, 96, device="cpu", layout="check")
    cpu = torch.device("cpu")
    width, live, it, lane_bytes, want = {
        "stage0_first_check": (2048, 1700, 8, 2.54e6, None),
        "stage0_later_check": (2048, 1000, 16, 2.54e6, 1),
        "gallager": (8192, 1600, 1, 54e3, None),
        "gallager_straggler": (8192, 30, 2, 54e3, None),
        "no_narrower_width": (300, 300, 40, 2.54e6, None),
        "near_the_cap": (256, 200, 90, 2.54e6, None),
        "card_tiles": (2048, 100, 24, 2.54e6, 128),
    }[case]
    if case == "card_tiles":
        monkeypatch.setattr(minsum_module.MinSumDecode, "_tile",
                            lambda self, lanes, device: minsum_module.lane_tile_for(lanes))
    assert mod._compact_tile(width, live, it, lane_bytes, cpu) == want
    if case == "near_the_cap":  # the same narrowing with more iterations left pays
        assert mod._compact_tile(width, live, 40, lane_bytes, cpu) == 1


# -- host-side layers -----------------------------------------------------


@pytest.mark.parametrize("fn", ["per_to_llr", "per_to_depolarizing_llr"])
def test_llr_priors_match_reference_bitwise(fn):
    rng = np.random.default_rng(0)
    for per in (0.01, rng.uniform(0.001, 0.3, 17), rng.uniform(0.001, 0.5, (3, 17))):
        want = getattr(ref_priors, fn)(per, 17)
        got = getattr(priors, fn)(per, 17)
        assert got.dtype == np.float64 and np.array_equal(got, want)
    with pytest.raises(ValueError, match="per must be"):
        getattr(priors, fn)(np.zeros(5), 17)


def test_clamp_constants_match_reference():
    assert clamps.TANH_CLAMP == ref_clamps.TANH_CLAMP
    assert clamps.MSG_CLAMP == ref_clamps.MSG_CLAMP


# -- (a) the plain versions of the two kernels ----------------------------


@pytest.mark.parametrize("code", ["gallager", "toric"])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.8, 0.0), (1.0, 0.15)])
def test_check_core_ref_matches_pallas_kernel(request, code, alpha, beta):
    """float32, bitwise on the real edges of checks of degree >= 2 (the
    Pallas wrapper pads with another ``big`` than the default path, which
    shows at padded slots and at a degree-1 check)."""
    _, g, gp = request.getfixturevalue(code)
    rng = np.random.default_rng(3)
    B = 16
    Ng = (rng.normal(size=(B, g.max_dc, g.m)) * 3).astype(np.float32)
    Ng[:, :, ::5] = np.round(Ng[:, :, ::5])  # ties and zeros
    syn = rng.random((B, g.m)) < 0.5
    _, _, chk_mask, _ = tables(gp)
    want = np.asarray(check_update_pallas(
        jnp.asarray(Ng), jnp.asarray(syn), jnp.asarray(chk_mask.numpy()),
        alpha=alpha, beta=beta, interpret=True))
    a, b, _ = from_reference_params(alpha, beta, None, max_iters=1, max_dv=g.max_dv, n=g.n,
                                    dtype=torch.float32, device="cpu")
    got = check_core_ref(torch.as_tensor(Ng), torch.as_tensor(syn), chk_mask, a, b)
    keep = chk_mask.numpy() & (chk_mask.numpy().sum(axis=0) >= 2)[None]
    assert keep.any()
    assert_bitwise(np.where(keep, want, 0), np.where(keep, got.numpy(), 0))
    # the wrapper on CPU tensors runs the plain version and launches nothing
    launches = cuda_minsum.minsum_check_cuda.launches
    again = cuda_minsum.minsum_check_cuda(torch.as_tensor(Ng), None, torch.as_tensor(syn),
                                          chk_mask, a, b)
    assert torch.equal(again, got) and cuda_minsum.minsum_check_cuda.launches == launches


@pytest.mark.parametrize("code", ["gallager", "toric"])
def test_var_core_ref_matches_pallas_kernel(request, code):
    """float32, bitwise on real edges and on the totals."""
    _, g, gp = request.getfixturevalue(code)
    rng = np.random.default_rng(4)
    B = 16
    Mg = (rng.normal(size=(B, g.max_dv, g.n)) * 3).astype(np.float32)
    _, _, _, var_mask = tables(gp)
    L0 = float(np.float32(np.log(0.97 / 0.03)))
    nu_w, total_w = var_update_pallas(jnp.asarray(Mg), jnp.asarray(var_mask.numpy()), L0=L0,
                                      interpret=True)
    nu, total = var_core_ref(torch.as_tensor(Mg), var_mask, torch.tensor(L0))
    assert_bitwise(total_w, total)
    keep = var_mask.numpy()[None]
    assert_bitwise(np.where(keep, np.asarray(nu_w), 0), np.where(keep, nu.numpy(), 0))
    only_total = var_core_ref(torch.as_tensor(Mg), var_mask, torch.tensor(L0), want_nu=False)
    assert only_total[0] is None and torch.equal(only_total[1], total)


@pytest.mark.parametrize("code", ["gallager", "toric"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_iteration_matches_default_path(request, code, dtype):
    """gather + check update + gather + variable update against one
    iteration of the reference's default (jnp) path on per-lane priors:
    the LLRs after one iteration are ``total``.  Bitwise in both dtypes."""
    H, g, gp = request.getfixturevalue(code)
    rng = np.random.default_rng(5)
    B = 16
    syn = syndromes_of(H, 0.1, B, 5)
    L0 = (rng.normal(size=(B, g.n)) * 2).astype(np.float32)
    fn = jax.jit(make_minsum_decode_fn(g, 0.05, 1, alpha=0.8, dtype=JNP_DTYPE[dtype]))
    _, _, _, want = fn(jnp.asarray(syn), jnp.asarray(L0))
    c2v, v2c, chk_mask, var_mask = tables(gp)
    L0_t = torch.as_tensor(L0).to(dtype)
    nu_flat = L0_t[:, None, :].expand(B, g.max_dv, g.n).reshape(B, -1)
    alpha = float(torch.tensor(0.8).to(dtype))
    mu = check_update_ref(nu_flat, c2v, torch.as_tensor(syn).bool(), chk_mask, alpha, 0.0)
    nu, total = var_update_ref(mu.reshape(B, -1), v2c, var_mask, L0_t)
    assert nu.shape == (B, g.max_dv, g.n) and nu.dtype == dtype
    assert_bitwise(want, total)


# -- (b) the decoder, knob by knob ----------------------------------------


def schedule(kind, g):
    """Seeded per-iteration schedules, the same arrays for both packages."""
    rng = np.random.default_rng(9)
    if kind == "alpha":
        return rng.uniform(0.6, 1.0, MAX_ITERS).astype(np.float32)
    if kind == "weights_pow2":
        return rng.choice([0.5, 1.0], (MAX_ITERS, g.max_dv, g.n), p=[0.3, 0.7]).astype(np.float32)
    return rng.uniform(0.5, 1.2, (MAX_ITERS, g.max_dv, g.n)).astype(np.float32)


def gamma_of(kind, B, n):
    rng = np.random.default_rng(10)
    return {
        "lane_exact": rng.choice([0.0, 0.5], B),
        "var_exact": rng.choice([0.0, 0.5], (B, n)),
        "lane": rng.uniform(0.0, 0.5, B),
        "var": rng.uniform(-0.2, 0.5, (B, n)),
    }[kind].astype(np.float32)


# name -> (decode-function keywords, gamma kind); products in these are
# exact, so a fused multiply-add changes nothing and float32 is bitwise
EXACT_KNOBS = {
    "plain": ({}, None),
    "alpha0.8": (dict(alpha=0.8), None),
    "beta0.15": (dict(alpha=1.0, beta=0.15), None),
    "per_iteration_alpha": (dict(alpha="alpha"), None),
    "edge_weights": (dict(edge_weights="weights_pow2"), None),
    "damping0.5": (dict(damping=0.5), None),
    "lane_damping_B": (dict(lane_damping=True), "lane_exact"),
    "lane_damping_Bn": (dict(lane_damping=True), "var_exact"),
    "check_every4": (dict(check_every=4), None),
    "layout_check": (dict(layout="check"), None),
    "layout_check_damped": (dict(layout="check", damping=0.5, check_every=4), None),
    "layout_check_lane_damping_Bn": (dict(layout="check", lane_damping=True), "var_exact"),
    "track_best": (dict(track_best=True, check_every=4), None),
    "track_best_check": (dict(track_best=True, check_every=4, layout="check"), None),
}

# the same knobs at general values: the jitted reference's fused
# multiply-add shows
FMA_KNOBS = {
    "alpha0.8_beta0.15": (dict(alpha=0.8, beta=0.15), None),
    "per_iteration_alpha_beta": (dict(alpha="alpha", beta=0.1), None),
    "edge_weights": (dict(edge_weights="weights"), None),
    "damping0.4": (dict(damping=0.4), None),
    "lane_damping_B": (dict(lane_damping=True), "lane"),
    "lane_damping_Bn": (dict(lane_damping=True, layout="check"), "var"),
}


def decode_both(H, g, gp, per, knobs, gamma_kind, dtype, *, B=24, seed=1, L0=None,
                max_iters=MAX_ITERS, jit=True):
    """One batch through the reference (jitted, or op by op) and the port."""
    kw = {k: schedule(v, g)[:max_iters] if isinstance(v, str) and k != "layout" else v
          for k, v in knobs.items()}
    syn = syndromes_of(H, per, B, seed)
    gamma = None if gamma_kind is None else gamma_of(gamma_kind, B, g.n)
    fn = make_minsum_decode_fn(g, per, max_iters, dtype=JNP_DTYPE[dtype], **kw)
    args = [jnp.asarray(syn), None if L0 is None else jnp.asarray(L0)]
    if gamma is not None:
        args.append(jnp.asarray(gamma))
    if jit:
        want = jax.jit(fn)(*args)
    else:
        with jax.disable_jit():
            want = fn(*args)
    mod = pt.MinSumDecode(gp, per, max_iters, device="cpu", dtype=dtype, **kw)
    got = mod(torch.as_tensor(syn), None if L0 is None else torch.as_tensor(L0),
              None if gamma is None else torch.as_tensor(gamma))
    return want, got


def assert_flags_equal(want, got):
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.bool
    assert got[2].dtype == torch.int32
    for a, b in zip(want[:3], got[:3]):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", list(EXACT_KNOBS))
def test_minsum_decode_matches_reference_bitwise(gallager, name):
    """float32: err / converged / iters and LLRs bit for bit."""
    H, g, gp = gallager
    knobs, gamma_kind = EXACT_KNOBS[name]
    want, got = decode_both(H, g, gp, 0.04, knobs, gamma_kind, torch.float32)
    assert_flags_equal(want, got)
    assert_bitwise(want[3], got[3])
    conv = np.asarray(want[1])
    assert conv.any(), "the case needs lanes that converge"
    if name in ("plain", "check_every4", "layout_check", "track_best", "track_best_check"):
        assert not conv.all(), "the case needs lanes that do not converge"


@pytest.mark.parametrize("name", list(FMA_KNOBS))
def test_minsum_decode_matches_reference_at_general_values(gallager, name):
    """float32 at values whose products are inexact.  The reference run op
    by op compiles every operation on its own, so nothing contracts: err /
    converged / iters and the LLRs are bit for bit the port's, on every lane
    and at full depth.  The jitted reference (products fused into the sums)
    still gives the same err / converged / iters on every lane."""
    H, g, gp = gallager
    knobs, gamma_kind = FMA_KNOBS[name]
    want, got = decode_both(H, g, gp, 0.04, knobs, gamma_kind, torch.float32, jit=False)
    assert_flags_equal(want, got)
    assert_bitwise(want[3], got[3])
    assert np.asarray(want[2]).max() >= 10, "the case needs lanes that run deep"
    jitted, _ = decode_both(H, g, gp, 0.04, knobs, gamma_kind, torch.float32)
    assert_flags_equal(jitted, got)


@pytest.mark.parametrize("name", list(FMA_KNOBS))
def test_minsum_decode_jit_differs_by_fused_multiply_add_only(gallager, name):
    """What separates the jitted reference from the port is the rounding of
    the products that XLA fuses into the following sum: after two iterations
    every lane's LLRs agree within FMA_SPACINGS float32 spacings of the
    largest LLR magnitude (rtol 0), and the op-by-op reference at the same
    depth is bitwise equal to the port."""
    H, g, gp = gallager
    knobs, gamma_kind = FMA_KNOBS[name]
    want, got = decode_both(H, g, gp, 0.04, knobs, gamma_kind, torch.float32, max_iters=2)
    a, b = np.asarray(want[3]), got[3].numpy()
    atol = FMA_SPACINGS * float(np.spacing(np.abs(a).max()))
    np.testing.assert_allclose(b, a, rtol=0, atol=atol)
    exact, _ = decode_both(H, g, gp, 0.04, knobs, gamma_kind, torch.float32, max_iters=2,
                           jit=False)
    assert_bitwise(exact[3], got[3])


@pytest.mark.parametrize("name", ["plain", "beta0.15", "damping0.5", "check_every4",
                                  "layout_check", "track_best"])
def test_minsum_decode_irregular_graph_bitwise(toric, name):
    H, g, gp = toric
    knobs, gamma_kind = EXACT_KNOBS[name]
    want, got = decode_both(H, g, gp, 0.08, knobs, gamma_kind, torch.float32, B=32, seed=4)
    assert_flags_equal(want, got)
    assert_bitwise(want[3], got[3])


@pytest.mark.parametrize("shape", ["scalar", "n", "Bn"])
def test_minsum_prior_override_bitwise(gallager, shape):
    """The ``L0`` override as a scalar, ``[n]`` and per-lane ``[B, n]``."""
    H, g, gp = gallager
    rng = np.random.default_rng(6)
    B = 24
    per = {"scalar": 0.04, "n": rng.uniform(0.02, 0.08, g.n),
           "Bn": rng.uniform(0.01, 0.1, (B, g.n))}[shape]
    L0 = np.asarray(ref_priors.per_to_llr(per, g.n), np.float32)
    want, got = decode_both(H, g, gp, 0.01, {}, None, torch.float32, B=B, L0=L0)
    assert_flags_equal(want, got)
    assert_bitwise(want[3], got[3])


# -- (c) bfloat16 ----------------------------------------------------------


@pytest.mark.parametrize("name", ["plain", "alpha0.8", "per_iteration_alpha", "edge_weights",
                                  "damping0.5", "lane_damping_Bn", "check_every4",
                                  "layout_check", "track_best"])
def test_minsum_decode_bfloat16(gallager, name):
    """err / converged / iters equal; LLRs within one bfloat16 ulp."""
    H, g, gp = gallager
    knobs, gamma_kind = EXACT_KNOBS[name]
    want, got = decode_both(H, g, gp, 0.04, knobs, gamma_kind, torch.bfloat16)
    assert_flags_equal(want, got)
    assert got[3].dtype == (torch.float32 if knobs.get("track_best") else torch.bfloat16)
    np.testing.assert_allclose(f32(got[3]), f32(want[3]), rtol=BF16_ULP, atol=0)


@pytest.mark.parametrize("name", ["alpha0.8_beta0.15", "edge_weights", "damping0.4"])
def test_minsum_decode_bfloat16_general_values(gallager, name):
    """bfloat16 rounds after every operation, so nothing contracts."""
    H, g, gp = gallager
    knobs, gamma_kind = FMA_KNOBS[name]
    want, got = decode_both(H, g, gp, 0.04, knobs, gamma_kind, torch.bfloat16)
    assert_flags_equal(want, got)
    np.testing.assert_allclose(f32(got[3]), f32(want[3]), rtol=BF16_ULP, atol=0)


# -- the decoder class ----------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(alpha=0.8), dict(damping=0.5, check_every=4),
                                dict(layout="check"), dict(dtype="bfloat16")])
def test_minsum_decoder_matches_reference(gallager, kw):
    H, g, gp = gallager
    syn = syndromes_of(H, 0.04, 16, 2)
    kw_ref, kw_port = dict(kw), dict(kw)
    if "dtype" in kw:
        kw_ref["dtype"], kw_port["dtype"] = jnp.bfloat16, torch.bfloat16
    ref = lt.MinSumDecoder(g, 0.04, MAX_ITERS, **kw_ref)
    port = pt.MinSumDecoder(gp, 0.04, MAX_ITERS, device="cpu", **kw_port)
    rng = np.random.default_rng(2)
    for per in (None, 0.02, rng.uniform(0.01, 0.1, (16, g.n))):
        e_r, c_r, i_r, a_r, _ = ref.batch_decode_detailed(syn, per=per)
        e_p, c_p, i_p, a_p, stats = port.batch_decode_detailed(syn, per=per)
        assert e_p.dtype == np.int8 and set(a_p) == {"llrs"}
        assert np.array_equal(e_r, e_p) and np.array_equal(c_r, c_p)
        assert np.array_equal(i_r, i_p)
        assert a_p["llrs"].dtype == np.float32  # bfloat16 LLRs come back widened
        assert_bitwise(a_r["llrs"], a_p["llrs"])
        assert stats.converged_fraction == float(np.mean(c_r))


def test_minsum_api_contract(gallager):
    H, _, gp = gallager
    dec = pt.MinSumDecoder(H, 0.01, 50, device="cpu")
    assert isinstance(dec, torch.nn.Module)
    assert {"c2v", "v2c", "chk_mask", "var_mask"} <= {n.split(".")[-1] for n, _ in
                                                      dec.named_buffers()}
    assert dec.minsum.c2v.dtype == torch.int32
    rng = np.random.default_rng(1)
    err_true = rng.random(H.shape[1]) < 0.01
    guess, ok = dec.decode((H @ err_true) % 2)
    assert ok and np.array_equal(guess.astype(bool), err_true)
    guess0, ok0 = dec.decode(np.zeros(H.shape[0], np.uint8))
    assert ok0 and not guess0.any()
    syn = syndromes_of(H, 0.01, 5, 3)
    g, c = pt.batchdecode(dec, syn)
    assert np.array_equal(dec.decode(syn[2])[0], g[2])
    out = dec.batch_decode_detailed_async(torch.as_tensor(syn))
    assert all(isinstance(t, torch.Tensor) for t in out[:3]) and set(out[3]) == {"llrs"}
    assert np.array_equal(out[0].numpy(), g) and np.array_equal(out[1].numpy(), c)
    with pytest.raises(ValueError, match="expected syndromes of shape"):
        dec.batch_decode(syn[:, :-1])


# -- (d) the errors --------------------------------------------------------


def test_minsum_validation(toric):
    _, g, gp = toric
    make = lambda **kw: pt.MinSumDecode(gp, 0.03, 10, device="cpu", **kw)  # noqa: E731
    for kw, match in (
        (dict(damping=1.0), "damping must be in"),
        (dict(damping=-0.1), "damping must be in"),
        (dict(lane_damping=True, damping=0.3), "lane_damping"),
        (dict(check_every=0), "check_every"),
        (dict(layout="bogus"), "layout"),
        (dict(layout="check", alpha=np.full(10, 0.8)), "layout='check'"),
        (dict(layout="check", edge_weights=np.ones((10, g.max_dv, g.n))), "layout='check'"),
        (dict(edge_weights=np.ones((9, g.max_dv, g.n))), "edge_weights must be"),
        (dict(dtype=torch.float16), "dtype"),
    ):
        with pytest.raises(ValueError, match=match):
            make(**kw)
        if "dtype" not in kw and "check'" not in match:
            with pytest.raises(ValueError):  # the reference refuses the same
                make_minsum_decode_fn(g, 0.03, 10, **kw)
    syn = torch.zeros((4, g.m), dtype=torch.uint8)
    with pytest.raises(ValueError, match="gamma"):
        make(lane_damping=True)(syn)
    with pytest.raises(ValueError, match="lane_damping"):
        make()(syn, None, torch.zeros(4))
    with pytest.raises(ValueError, match="per must be"):
        pt.MinSumDecoder(gp, 0.03, 10, device="cpu").batch_decode(syn.numpy(), per=np.ones(5))


def test_from_reference_params():
    kw = dict(max_iters=4, max_dv=3, n=5, device="cpu")
    a, b, w = from_reference_params(0.8, 0.0, None, dtype=torch.float32, **kw)
    assert a == float(np.float32(0.8)) and b == 0.0 and w is None
    a, b, _ = from_reference_params(0.8, 0.0, None, dtype=torch.bfloat16, **kw)
    assert a == float(jnp.bfloat16(0.8))
    sched = np.array([0.9, 0.8, 0.7, 0.6])
    a, b, w = from_reference_params(sched, 0.1, np.ones((4, 3, 5)), dtype=torch.float32, **kw)
    assert a == [float(np.float32(x)) for x in sched] and b == [float(np.float32(0.1))] * 4
    assert w.dtype == torch.float32 and w.shape == (4, 3, 5) and w.is_contiguous()
    with pytest.raises(ValueError, match="edge_weights must be"):
        from_reference_params(0.8, 0.0, np.ones((4, 5, 3)), dtype=torch.float32, **kw)


def test_no_device_means_the_card():
    """A decoder built without ``device`` never runs on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only refusal")
    H = lt.parity_check_matrix(60, 6, 3, rng=19)
    for build in (lambda: pt.MinSumDecoder(H, 0.05, 10),
                  lambda: pt.BeliefPropagationDecoder(H, 0.05, 10),
                  lambda: pt.BeliefPropagationOSDDecoder(H, 0.05, 10),
                  lambda: pt.MinSumDecoder(H, 0.05, 10, device="cuda")):
        with pytest.raises(RuntimeError, match="cuda"):
            build()


# -- (e) decode_soft -------------------------------------------------------


@pytest.mark.parametrize("family", ["minsum", "bp"])
def test_decode_soft_matches_reference(gallager, family):
    H, g, gp = gallager
    rng = np.random.default_rng(8)
    B = 12
    # BPSK over AWGN around the all-zero codeword
    sigma = 0.7
    llrs = 2.0 * (1.0 + sigma * rng.normal(size=(B, g.n))) / sigma**2
    if family == "minsum":
        ref, port = lt.MinSumDecoder(g, 0.05, MAX_ITERS), pt.MinSumDecoder(
            gp, 0.05, MAX_ITERS, device="cpu")
    else:
        ref, port = lt.BeliefPropagationDecoder(g, 0.05, MAX_ITERS), pt.BeliefPropagationDecoder(
            gp, 0.05, MAX_ITERS, device="cpu")
    cw_r, c_r = lt.models.base.decode_soft(ref, llrs)
    cw_p, c_p = pt.decode_soft(port, llrs)
    assert cw_p.dtype == np.int8 and cw_p.shape == (B, g.n)
    assert np.array_equal(cw_r, cw_p) and np.array_equal(c_r, c_p)
    assert c_p.any() and not cw_p[c_p].any()  # converged lanes recover the zero codeword
    with pytest.raises(ValueError, match="expected llrs of shape"):
        pt.decode_soft(port, llrs[:, :-1])
