"""Port parity: the reference's six functional cores.

``make_bp_decode_fn``, ``make_minsum_decode_fn``, ``make_layered_minsum_fn``,
``make_minsum_q_decode_fn``, ``make_fused_bposd_fn`` and ``make_syndrome_fn``
are built by both packages on the same graph and fed the same seeded numpy
syndromes: the reference jitted on the CPU (or run op by op where stated),
the port with ``device="cpu"``.  Small codes only: ``parity_check_matrix(60,
3, 4, rng=1)``, ``(120, 6, 3, rng=2)``, and the latter's graph without its
dense H, which takes the syndrome's O(edges) gather route.

Tolerances (ROADMAP.md queue 3), each stated where it is used:

  * BP float32: err / converged / iters bitwise; logp within rtol 1e-5,
    atol 1e-6 (torch's and XLA's float32 ``log`` differ by an ulp);
  * BP bfloat16 (bench.py's bfloat16 sum-product configuration): bitwise;
  * min-sum float32: bitwise against the reference run op by op
    (``jax.disable_jit()``), for every knob.  Against the jitted reference,
    which contracts ``a * b + c`` into fused multiply-adds: the flags equal
    at full depth, and the LLRs after two iterations within FMA_SPACINGS
    float32 spacings of the largest LLR magnitude;
  * min-sum bfloat16, layered (op by op), int8 and the syndrome: bitwise;
  * fused BP+OSD: converged and iters bitwise, logp as BP's, err bitwise on
    every lane but those whose reliability order differs by a tie of
    ``exp(logp)`` (tests/test_torch_fused.py's allowance: each such lane
    shown to be a tie, at most a quarter of the lanes).

A prior given at call time may be a number, a numpy array or a tensor:
scalar, ``[n]`` or ``[B, n]``; each builder is called with each.
"""

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.models import bp as ref_bp
from ldpcdecoders_tpu.models import bposd as ref_bposd
from ldpcdecoders_tpu.models import layered as ref_layered
from ldpcdecoders_tpu.models import minsum as ref_minsum
from ldpcdecoders_tpu.models import minsum_q as ref_minsum_q
from ldpcdecoders_tpu.models import priors as ref_priors
from ldpcdecoders_tpu.ops import syndrome as ref_syndrome
from ldpcdecoders_tpu_torch.models import bp as port_bp
from ldpcdecoders_tpu_torch.models import bposd as port_bposd
from ldpcdecoders_tpu_torch.models import layered as port_layered
from ldpcdecoders_tpu_torch.models import minsum as port_minsum
from ldpcdecoders_tpu_torch.models import minsum_q as port_minsum_q
from ldpcdecoders_tpu_torch.ops import syndrome as port_syndrome
from ldpcdecoders_tpu_torch.ops.syndrome import SyndromeCheck
from test_torch_fused import tie_lanes

torch.set_num_threads(1)

B, ITERS = 16, 12
LOGP_TOL = dict(rtol=1e-5, atol=1e-6)
FMA_SPACINGS = 4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: name -> (n, wr, wc, rng) of parity_check_matrix, and whether the graph keeps H
CODES = {"small": ((60, 3, 4, 1), True), "medium": ((120, 6, 3, 2), True),
         "gather": ((120, 6, 3, 2), False)}

BUILDERS = {
    "make_bp_decode_fn": (ref_bp, port_bp),
    "make_minsum_decode_fn": (ref_minsum, port_minsum),
    "make_layered_minsum_fn": (ref_layered, port_layered),
    "make_minsum_q_decode_fn": (ref_minsum_q, port_minsum_q),
    "make_fused_bposd_fn": (ref_bposd, port_bposd),
    "make_syndrome_fn": (ref_syndrome, port_syndrome),
}


@functools.cache
def code(name):
    """``(H, reference graph, port graph)``; the gather code's graphs have no H."""
    (n, wr, wc, seed), dense = CODES[name]
    H = lt.parity_check_matrix(n, wr, wc, rng=seed)
    g = lt.TannerGraph.from_pcm(H)
    if not dense:
        g = dataclasses.replace(g, H=None)
    return H, g, pt.TannerGraph.from_arrays(**dataclasses.asdict(g))


def syndromes(H, per, seed, batch=B):
    rng = np.random.default_rng(seed)
    return (((rng.random((batch, H.shape[1])) < per) @ H.T) % 2).astype(np.uint8)


def raw(x):
    """The bit patterns of a float32 / bfloat16 array or tensor (ints as they are)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        elif x.dtype == torch.float32:
            x = x.view(torch.int32)
        return x.numpy()
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return x.view(np.int16)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_flags(want, got):
    """err / converged / iters equal, in the reference's dtypes."""
    assert (got[0].dtype, got[1].dtype, got[2].dtype) == (torch.int8, torch.bool, torch.int32)
    for w, g in zip(want[:3], got[:3]):
        assert np.array_equal(np.asarray(w), g.numpy())


def assert_bitwise(want, got):
    assert_flags(want, got)
    assert np.array_equal(raw(want[3]), raw(got[3]))


def assert_mixed(conv):
    conv = np.asarray(conv)
    assert conv.any() and not conv.all(), "the case needs lanes that fail and that converge"


# -- names and arguments -----------------------------------------------------


def build_both(name, g, gp):
    """Each package's builder on the small code, at its defaults."""
    ref_mod, port_mod = BUILDERS[name]
    args = () if name == "make_syndrome_fn" else (0.05, 10)
    if name == "make_fused_bposd_fn":
        args += (0,)
    return (getattr(ref_mod, name)(g, *args),
            getattr(port_mod, name)(gp, *args, device="cpu"))


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_takes_the_reference_arguments(name):
    """Each builder is in its port module's ``__all__`` and takes the
    reference's arguments under the same names, kinds, defaults and order
    (a torch dtype for a jnp one), plus a keyword ``device=None``; the
    function it returns takes the reference's returned function's."""
    ref_mod, port_mod = BUILDERS[name]
    assert name in port_mod.__all__ and name in ref_mod.__all__
    want = inspect.signature(getattr(ref_mod, name)).parameters
    got = inspect.signature(getattr(port_mod, name)).parameters
    assert list(got) == [*want, "device"]
    assert got["device"].kind is inspect.Parameter.KEYWORD_ONLY and got["device"].default is None
    for key, p in want.items():
        assert got[key].kind == p.kind, key
        if key == "dtype":
            assert p.default is jnp.float32 and got[key].default is torch.float32
        else:
            assert got[key].default == p.default, key
    _, g, gp = code("small")
    ref_fn, port_fn = build_both(name, g, gp)
    want = inspect.signature(ref_fn).parameters
    got = inspect.signature(port_fn).parameters
    assert [(k, p.kind, p.default) for k, p in got.items()] == [
        (k, p.kind, p.default) for k, p in want.items()]


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_without_a_device_means_the_card(name):
    """``device=None`` is the current CUDA card; without one the builder
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, _, gp = code("small")
    _, port_mod = BUILDERS[name]
    args = () if name == "make_syndrome_fn" else (0.05, 10)
    if name == "make_fused_bposd_fn":
        args += (0,)
    with pytest.raises(RuntimeError, match="is_available"):
        getattr(port_mod, name)(gp, *args)


@pytest.mark.parametrize("kw", [dict(layout="check", edge_weights="weights"),
                                dict(layout="check", alpha="per_iteration"),
                                dict(damping=1.0), dict(check_every=0),
                                dict(lane_damping=True, damping=0.2), dict(layout="slot")],
                         ids=["check_edge_weights", "check_per_iteration_alpha", "damping",
                              "check_every", "lane_and_baked_damping", "layout"])
def test_minsum_builder_refuses_what_the_reference_refuses(kw):
    """The reference's refusals of argument combinations, with its exception type."""
    _, g, gp = code("small")
    if kw.get("edge_weights"):
        kw = dict(kw, edge_weights=np.ones((10, g.max_dv, g.n), np.float32))
    if kw.get("alpha"):
        kw = dict(kw, alpha=np.full(10, 0.8, np.float32))
    with pytest.raises(ValueError):
        ref_minsum.make_minsum_decode_fn(g, 0.05, 10, **kw)
    with pytest.raises(ValueError):
        port_minsum.make_minsum_decode_fn(gp, 0.05, 10, device="cpu", **kw)


def test_fused_builder_refuses_what_the_reference_refuses():
    _, g, gp = code("small")
    for kw in (dict(osd_method="sweep"), dict(damping=0.3)):
        with pytest.raises(ValueError):
            ref_bposd.make_fused_bposd_fn(g, 0.05, 10, 0, **kw)
        with pytest.raises(ValueError):
            port_bposd.make_fused_bposd_fn(gp, 0.05, 10, 0, device="cpu", **kw)
    with pytest.raises(ValueError):
        ref_layered.make_layered_minsum_fn(g, 0.05, 10, damping=1.0)
    with pytest.raises(ValueError):
        port_layered.make_layered_minsum_fn(gp, 0.05, 10, damping=1.0, device="cpu")


# -- sum-product BP ----------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,per", [("small", 0.25), ("medium", 0.02), ("medium", 0.08),
                                      ("gather", 0.06)])
def test_bp_builder_matches_reference(name, per, dtype):
    """float32: err / converged / iters bitwise, logp within LOGP_TOL;
    bfloat16: bitwise."""
    H, g, gp = code(name)
    jdt, tdt = DTYPES[dtype]
    syn = syndromes(H, per, seed=11)
    want = jax.jit(ref_bp.make_bp_decode_fn(g, per, ITERS, jdt))(jnp.asarray(syn))
    got = port_bp.make_bp_decode_fn(gp, per, ITERS, tdt, device="cpu")(syn)
    assert got[3].dtype == tdt
    if dtype == "bfloat16":
        assert_bitwise(want, got)
    else:
        assert_flags(want, got)
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **LOGP_TOL)
    assert_mixed(want[1])


# -- min-sum -----------------------------------------------------------------


def minsum_knobs(kind, g):
    """Seeded knob values, the same arrays for both packages, and the gamma
    the call takes (None where it takes none)."""
    rng = np.random.default_rng(9)
    if kind == "edge_weights":
        return dict(edge_weights=rng.uniform(0.5, 1.2, (ITERS, g.max_dv, g.n)).astype(
            np.float32)), None
    if kind == "lane_damping":
        return dict(lane_damping=True), rng.uniform(0.0, 0.5, B).astype(np.float32)
    return {
        "default": {}, "damping0.4": dict(damping=0.4), "check_every8": dict(check_every=8),
        "layout_check": dict(layout="check"), "track_best": dict(track_best=True, check_every=4),
        "alpha0.8_beta0.15": dict(alpha=0.8, beta=0.15),
    }[kind], None


def minsum_both(name, per, kind, *, dtype="float32", jit=True, iters=ITERS, port_kw=None):
    H, g, gp = code(name)
    jdt, tdt = DTYPES[dtype]
    kw, gamma = minsum_knobs(kind, g)
    if "edge_weights" in kw:
        kw["edge_weights"] = kw["edge_weights"][:iters]
    syn = syndromes(H, per, seed=5)
    args = [jnp.asarray(syn), None] + ([] if gamma is None else [jnp.asarray(gamma)])
    fn = ref_minsum.make_minsum_decode_fn(g, per, iters, dtype=jdt, **kw)
    if jit:
        want = jax.jit(fn)(*args)
    else:
        with jax.disable_jit():
            want = fn(*args)
    port = port_minsum.make_minsum_decode_fn(gp, per, iters, dtype=tdt, device="cpu", **kw,
                                             **(port_kw or {}))
    got = port(syn, None, gamma)
    return want, got


@pytest.mark.parametrize("kind", ["default", "damping0.4", "check_every8", "lane_damping",
                                  "layout_check", "track_best", "edge_weights",
                                  "alpha0.8_beta0.15"])
def test_minsum_builder_matches_reference_op_by_op(kind):
    """float32, each knob: every output bitwise against the reference run op
    by op (nothing contracts there, and the port rounds each product)."""
    want, got = minsum_both("medium", 0.05, kind, jit=False)
    assert_bitwise(want, got)
    assert_mixed(want[1])


@pytest.mark.parametrize("kind", ["default", "damping0.4", "alpha0.8_beta0.15"])
def test_minsum_builder_against_the_jitted_reference(kind):
    """float32 against the jitted reference: the flags equal at full depth;
    the LLRs after two iterations within FMA_SPACINGS float32 spacings of
    the largest LLR magnitude."""
    want, got = minsum_both("medium", 0.05, kind)
    assert_flags(want, got)
    want, got = minsum_both("medium", 0.05, kind, iters=2)
    w = np.asarray(want[3])
    spacing = np.spacing(np.abs(w).max())
    assert np.abs(got[3].numpy() - w).max() <= FMA_SPACINGS * spacing


@pytest.mark.parametrize("kind", ["default", "damping0.4", "layout_check"])
def test_minsum_builder_bfloat16_matches_reference(kind):
    """bfloat16: every result is rounded after each operation in both
    packages, so nothing contracts: bitwise against the jitted reference."""
    want, got = minsum_both("medium", 0.05, kind, dtype="bfloat16")
    assert got[3].dtype == torch.bfloat16
    assert_bitwise(want, got)
    assert_mixed(want[1])


@pytest.mark.parametrize("port_kw", [dict(use_pallas=True), dict(use_pallas=True,
                                                                 pallas_interpret=True),
                                     dict(vectorized_check=True),
                                     dict(vectorized_check=False)],
                         ids=["use_pallas", "pallas_interpret", "vectorized", "unrolled"])
def test_minsum_builder_tpu_knobs_are_the_default(port_kw):
    """The reference's TPU knobs change nothing in the port: each decode is
    the default's, bitwise, and the default is the jitted reference's (alpha
    1 and beta 0 make every product exact)."""
    want, default = minsum_both("gather", 0.05, "default")
    _, got = minsum_both("gather", 0.05, "default", port_kw=port_kw)
    assert_bitwise(want, default)
    for g, d in zip(got, default):
        assert np.array_equal(raw(g), raw(d))


# -- layered, int8 -----------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(alpha=0.8, beta=0.25, damping=0.3),
                                dict(dtype="bfloat16")], ids=["default", "damped", "bfloat16"])
def test_layered_builder_matches_reference_op_by_op(kw):
    """Bitwise against the reference run op by op."""
    H, g, gp = code("medium")
    jdt, tdt = DTYPES[kw.pop("dtype", "float32")]
    syn = syndromes(H, 0.06, seed=7)
    with jax.disable_jit():
        want = ref_layered.make_layered_minsum_fn(g, 0.06, ITERS, dtype=jdt, **kw)(
            jnp.asarray(syn))
    got = port_layered.make_layered_minsum_fn(gp, 0.06, ITERS, dtype=tdt, device="cpu",
                                              **kw)(syn)
    assert_bitwise(want, got)
    assert_mixed(want[1])


@pytest.mark.parametrize("name,scale,beta_q", [("medium", 4.0, 1), ("medium", 2.0, 0),
                                               ("gather", 4.0, 1), ("small", 4.0, 1)])
def test_minsum_q_builder_matches_reference(name, scale, beta_q):
    """int8 is integer work: bitwise against the jitted reference."""
    H, g, gp = code(name)
    syn = syndromes(H, 0.05, seed=3)
    want = jax.jit(ref_minsum_q.make_minsum_q_decode_fn(g, 0.05, ITERS, scale=scale,
                                                        beta_q=beta_q))(jnp.asarray(syn))
    got = port_minsum_q.make_minsum_q_decode_fn(gp, 0.05, ITERS, scale=scale, beta_q=beta_q,
                                                device="cpu")(syn)
    assert got[3].dtype == torch.int32
    assert_bitwise(want, got)


# -- fused BP+OSD --------------------------------------------------------------


def assert_fused(want, got, H, syn):
    """converged / iters bitwise, logp within LOGP_TOL, err bitwise but for
    reliability ties, every output syndrome-consistent."""
    assert got[0].dtype == torch.int8
    for w, g in zip(want[1:3], got[1:3]):
        assert np.array_equal(np.asarray(w), g.numpy())
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **LOGP_TOL)
    ties = tie_lanes(want[3], got[3])
    e_ref, e = np.asarray(want[0]).astype(np.int64), got[0].numpy().astype(np.int64)
    bad = np.flatnonzero((e_ref != e).any(axis=1))
    assert set(bad) <= set(ties) and len(ties) <= B // 4, (bad, ties)
    assert (((e @ H.T) % 2) == syn).all()


@pytest.mark.parametrize("order,scope,inner", [(0, "all", None), (2, "all", None),
                                               (2, "failed", "minsum"), (0, "all", "minsum")])
def test_fused_bposd_builder_matches_reference(order, scope, inner):
    """OSD-0 and OSD-2 against the reference's jitted builder, and bitwise
    the port's ``BeliefPropagationOSDDecoder(fused=True)``: one fused decode."""
    H, g, gp = code("medium")
    syn = syndromes(H, 0.06, seed=23)
    kw = dict(osd_scope=scope, inner=inner)
    want = jax.jit(ref_bposd.make_fused_bposd_fn(g, 0.06, ITERS, order, **kw))(
        jnp.asarray(syn))
    got = port_bposd.make_fused_bposd_fn(gp, 0.06, ITERS, order, device="cpu", **kw)(syn)
    assert_mixed(want[1])
    assert_fused(want, got, H, syn)
    dec = pt.BeliefPropagationOSDDecoder(gp, 0.06, ITERS, osd_order=order, fused=True,
                                         device="cpu", **kw)
    e, c, i, aux, _ = dec.batch_decode_detailed(syn)
    for a, b in zip((e, c, i, aux["log_probabs"]), got):
        assert np.array_equal(raw(a), raw(b))


# -- the syndrome ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["small", "medium", "gather"])
def test_syndrome_builder_matches_reference(name):
    """Bitwise on both routes (the dense matmul where the graph keeps H,
    else the O(edges) gather), against the reference and ``(err @ H.T) % 2``."""
    H, g, gp = code(name)
    assert SyndromeCheck(gp, torch.device("cpu")).dense == CODES[name][1]
    rng = np.random.default_rng(4)
    err = (rng.random((B, H.shape[1])) < 0.3).astype(np.float32)
    want = np.asarray(ref_syndrome.make_syndrome_fn(g)(jnp.asarray(err)))
    got = port_syndrome.make_syndrome_fn(gp, device="cpu")(err)
    assert got.dtype == torch.float32 and got.shape == (B, H.shape[0])
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, (err @ H.T) % 2)
    assert np.array_equal(port_syndrome.make_syndrome_fn(gp, device="cpu")(
        torch.as_tensor(err.astype(np.int8))).numpy(), want)


# -- priors at call time -----------------------------------------------------------


PRIOR_KINDS = ["scalar", "vector", "lanes"]


def prior_of(kind, n, to):
    """A per-bit error rate: one number, ``[n]`` or ``[B, n]``; ``to`` maps
    it to the builder's prior domain (float32 for the floating ones).  Given
    to the port as a Python number, a numpy array and a tensor in turn."""
    rng = np.random.default_rng(12)
    per = {"scalar": 0.04, "vector": rng.uniform(0.02, 0.08, n),
           "lanes": rng.uniform(0.02, 0.08, (B, n))}[kind]
    ref = np.asarray(to(per, n), np.float32)
    port = float(ref) if kind == "scalar" else ref if kind == "vector" else torch.as_tensor(ref)
    return jnp.asarray(ref), port


@pytest.mark.parametrize("kind", PRIOR_KINDS)
def test_bp_builder_takes_a_prior_at_call_time(kind):
    H, g, gp = code("medium")
    syn = syndromes(H, 0.05, seed=31)
    ref_prior, port_prior = prior_of(kind, g.n, ref_priors.per_to_ratio)
    want = jax.jit(ref_bp.make_bp_decode_fn(g, 0.05, ITERS))(jnp.asarray(syn), ref_prior)
    got = port_bp.make_bp_decode_fn(gp, 0.05, ITERS, device="cpu")(syn, port_prior)
    assert_flags(want, got)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **LOGP_TOL)


@pytest.mark.parametrize("kind", PRIOR_KINDS)
def test_minsum_builder_takes_a_prior_at_call_time(kind):
    """Bitwise against the jitted reference (alpha 1, beta 0: every product exact)."""
    H, g, gp = code("medium")
    syn = syndromes(H, 0.05, seed=31)
    ref_prior, port_prior = prior_of(kind, g.n, ref_priors.per_to_llr)
    want = jax.jit(ref_minsum.make_minsum_decode_fn(g, 0.05, ITERS))(jnp.asarray(syn),
                                                                     ref_prior)
    got = port_minsum.make_minsum_decode_fn(gp, 0.05, ITERS, device="cpu")(syn, port_prior)
    assert_bitwise(want, got)


@pytest.mark.parametrize("kind", PRIOR_KINDS)
def test_layered_builder_takes_a_prior_at_call_time(kind):
    """Bitwise against the jitted reference (undamped at beta 0 nothing contracts)."""
    H, g, gp = code("medium")
    syn = syndromes(H, 0.05, seed=31)
    ref_prior, port_prior = prior_of(kind, g.n, ref_priors.per_to_llr)
    want = jax.jit(ref_layered.make_layered_minsum_fn(g, 0.05, ITERS))(jnp.asarray(syn),
                                                                       ref_prior)
    got = port_layered.make_layered_minsum_fn(gp, 0.05, ITERS, device="cpu")(syn, port_prior)
    assert_bitwise(want, got)


@pytest.mark.parametrize("kind", PRIOR_KINDS)
def test_minsum_q_builder_takes_a_prior_at_call_time(kind):
    """Bitwise.  The reference takes a scalar or ``[n]`` quantized prior (its
    broadcast refuses ``[B, n]``); the port also takes ``[B, n]``, held
    here against the reference on each half of the batch with that half's
    ``[n]`` row (a lane's outputs do not depend on the other lanes)."""
    H, g, gp = code("medium")
    syn = syndromes(H, 0.05, seed=31)
    rng = np.random.default_rng(13)
    fn = jax.jit(ref_minsum_q.make_minsum_q_decode_fn(g, 0.05, ITERS))
    port = port_minsum_q.make_minsum_q_decode_fn(gp, 0.05, ITERS, device="cpu")
    if kind == "lanes":
        rows = rng.integers(6, 16, (2, g.n)).astype(np.int32)
        halves = [fn(jnp.asarray(syn[:B // 2]), jnp.asarray(rows[0])),
                  fn(jnp.asarray(syn[B // 2:]), jnp.asarray(rows[1]))]
        want = [np.concatenate([np.asarray(h[k]) for h in halves]) for k in range(4)]
        got = port(syn, torch.as_tensor(np.repeat(rows, B // 2, axis=0)))
    else:
        prior = 10 if kind == "scalar" else rng.integers(6, 16, g.n).astype(np.int32)
        want = fn(jnp.asarray(syn), jnp.asarray(prior))
        got = port(syn, prior)
    assert_bitwise(want, got)


@pytest.mark.parametrize("kind", PRIOR_KINDS)
def test_fused_bposd_builder_takes_a_prior_at_call_time(kind):
    H, g, gp = code("medium")
    syn = syndromes(H, 0.06, seed=31)
    ref_prior, port_prior = prior_of(kind, g.n, ref_priors.per_to_ratio)
    want = jax.jit(ref_bposd.make_fused_bposd_fn(g, 0.06, ITERS, 0))(jnp.asarray(syn),
                                                                     ref_prior)
    got = port_bposd.make_fused_bposd_fn(gp, 0.06, ITERS, 0, device="cpu")(syn, port_prior)
    assert_fused(want, got, H, syn)
