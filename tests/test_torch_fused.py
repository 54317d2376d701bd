"""Port parity: the fused BP+OSD (``fused=True``), against the reference's
jitted fused program (``make_fused_bposd_fn`` under ``jax.jit``) and the
port's own eager path, on the CPU.

The fused decode runs the inner decoder through all ``max_iters``
iterations (no host read of the converged flags) and the OSD on every lane,
keeping its output where the inner decoder failed (OSD-0, OSD-w under
``osd_scope="failed"``) or on every lane (OSD-w, ``osd_scope="all"``).
Against the eager path it is bitwise in every output.  Against the
reference: ``converged`` and ``iters`` bitwise, ``logp`` within rtol 1e-5,
atol 1e-6 (float32 ``log`` and ``exp`` differ by an ulp between torch and
XLA), and ``err`` bitwise on every lane but those whose reliability order
differs by such a tie (tests/test_torch_bposd.py's allowance, at most a
quarter of the lanes, each shown to be a tie).
"""

import jax
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt

torch.set_num_threads(1)

N, WR, WC, SEED, PER, ITERS, B = 120, 6, 3, 23, 0.06, 12, 24


@pytest.fixture(scope="module")
def case():
    H = lt.parity_check_matrix(N, WR, WC, rng=SEED)
    rng = np.random.default_rng(SEED)
    errs = rng.random((B, N)) < PER
    return H, ((errs @ H.T) % 2).astype(np.uint8)


def tie_lanes(logp_ref, logp_port):
    """Lanes whose reliability order differs between the packages.  Each
    must be a tie: at every position where the two orders differ, the two
    columns' reliabilities (``max(p, 1 - p)``, ``p = exp(logp)``, the
    reference's) lie within 8 float32 spacings: an ulp of ``logp`` moves
    ``exp(logp)`` by ``|logp|`` ulps, up to 6 at these magnitudes."""
    lp = np.asarray(logp_ref, np.float32)
    rel = np.maximum(np.exp(lp), np.float32(1) - np.exp(lp))
    lp2 = np.asarray(logp_port, np.float32)
    rel2 = np.maximum(np.exp(lp2), np.float32(1) - np.exp(lp2))
    p_ref = np.argsort(-rel, axis=1, kind="stable")
    p_port = np.argsort(-rel2, axis=1, kind="stable")
    lanes = np.flatnonzero((p_ref != p_port).any(axis=1))
    for b in lanes:
        pos = np.flatnonzero(p_ref[b] != p_port[b])
        a, c = rel[b][p_ref[b][pos]], rel[b][p_port[b][pos]]
        assert (np.abs(a - c) <= 8 * np.spacing(np.maximum(a, c))).all(), f"lane {b}: no tie"
    return lanes


@pytest.mark.parametrize("inner", ["sumproduct", "minsum"])
@pytest.mark.parametrize("scope", ["all", "failed"])
@pytest.mark.parametrize("order", [0, 2])
def test_fused_matches_reference_and_eager(case, order, scope, inner):
    H, syns = case
    kw = dict(osd_order=order, osd_scope=scope, inner=inner)
    ref = lt.BeliefPropagationOSDDecoder(H, PER, ITERS, fused=True, **kw)
    fused = pt.BeliefPropagationOSDDecoder(H, PER, ITERS, fused=True, device="cpu", **kw)
    eager = pt.BeliefPropagationOSDDecoder(H, PER, ITERS, device="cpu", **kw)
    assert fused.fused and not eager.fused
    g_r, c_r, i_r, a_r, _ = ref.batch_decode_detailed(syns)
    g_f, c_f, i_f, a_f, _ = fused.batch_decode_detailed(syns)
    g_e, c_e, i_e, a_e, _ = eager.batch_decode_detailed(syns)
    assert c_f.any() and not c_f.all(), "the case needs lanes that fail and that converge"
    for got, want in ((g_f, g_e), (c_f, c_e), (i_f, i_e)):
        assert np.array_equal(got, want)
    assert np.array_equal(a_f["log_probabs"].view(np.uint32), a_e["log_probabs"].view(np.uint32))
    assert np.array_equal(c_f, c_r) and np.array_equal(i_f, i_r)
    np.testing.assert_allclose(a_f["log_probabs"], np.asarray(a_r["log_probabs"]), rtol=1e-5,
                               atol=1e-6)
    ties = tie_lanes(a_r["log_probabs"], a_f["log_probabs"])
    bad = np.flatnonzero((np.asarray(g_r).astype(np.int64) != g_f.astype(np.int64)).any(axis=1))
    assert set(bad) <= set(ties) and len(ties) <= B // 4, (bad, ties)
    assert (((g_f.astype(np.int64) @ H.T) % 2) == syns).all()


def test_fused_with_a_per_override_and_a_min_sum_instance(case):
    """A per-call prior and a constructed damped MinSumDecoder inner: the
    fused decode equals the eager one bitwise."""
    H, syns = case
    inner = pt.MinSumDecoder(H, PER, ITERS, damping=0.3, device="cpu")
    for fused in (True, False):
        dec = pt.BeliefPropagationOSDDecoder(H, PER, ITERS, inner=inner, fused=fused,
                                             device="cpu")
        out = dec.batch_decode_detailed(syns, per=0.05)
        if fused:
            want = out
    for got, exp in zip(out[:3], want[:3]):
        assert np.array_equal(got, exp)


def test_config_builds_fused_bposd_as_the_reference():
    """ROADMAP's fault-7 probe: ``DecoderConfig(kind="bposd", per=0.05,
    max_iters=10, fused=True).build(H)`` builds in both packages and decodes
    alike."""
    H = lt.parity_check_matrix(60, 3, 4, rng=1)
    cfg = dict(kind="bposd", per=0.05, max_iters=10, fused=True)
    ref = lt.DecoderConfig(**cfg).build(H)
    port = pt.DecoderConfig(**cfg).build(H, device="cpu")
    assert port.fused
    rng = np.random.default_rng(2)
    syns = (((rng.random((16, 60)) < 0.08) @ H.T) % 2).astype(np.uint8)
    g_r, c_r, i_r, a_r, _ = ref.batch_decode_detailed(syns)
    g, c, i, a, _ = port.batch_decode_detailed(syns)
    assert np.array_equal(c, c_r) and np.array_equal(i, i_r)
    np.testing.assert_allclose(a["log_probabs"], np.asarray(a_r["log_probabs"]), rtol=1e-5,
                               atol=1e-6)
    ties = tie_lanes(a_r["log_probabs"], a["log_probabs"])
    bad = np.flatnonzero((np.asarray(g_r).astype(np.int64) != g.astype(np.int64)).any(axis=1))
    assert set(bad) <= set(ties)


def test_fused_refuses_the_host_osd_as_the_reference():
    H = lt.parity_check_matrix(60, 3, 4, rng=1)
    for make in (lambda: lt.BeliefPropagationOSDDecoder(H, 0.05, 10, osd_impl="host",
                                                         fused=True),
                 lambda: pt.BeliefPropagationOSDDecoder(H, 0.05, 10, osd_impl="host",
                                                         fused=True, device="cpu")):
        with pytest.raises(ValueError, match="host round-trip; fused=True cannot trace it"):
            make()


@pytest.mark.parametrize("inner", ["sumproduct", "minsum"])
def test_inner_without_early_exit_keeps_the_outputs(case, inner):
    """``early_exit=False`` runs every iteration with no host read; the
    outputs are the early-exit loop's."""
    H, syns = case
    dec = pt.BeliefPropagationOSDDecoder(H, 0.02, ITERS, inner=inner, device="cpu")
    s = torch.as_tensor(syns)
    a = dec.bp(s, None)
    b = dec.bp(s, None, early_exit=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
