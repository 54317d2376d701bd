"""Port parity: BP-OTS (models/bpots.py).

Float64 traces.  The port's per-iteration records (``trace=True``) are held
against the JAX package's ``make_bpots_decode_fn(..., dtype=float64,
trace=True)`` under ``jax.enable_x64`` and against the NumPy golden
``ldpcdecoders_tpu.golden.bpots_decode``.  They are not bitwise: XLA's
float64 ``tanh`` on the CPU differs from libm's (and torch's) in the last
bit for about 60% of arguments, and the 0.99999 clamps amplify such a
difference over the iterations.  So, as the JAX package's own golden test
does (tests/test_bpots.py:95-111), the decisions, oscillation counters,
mismatch counts, weights, best-(mismatch, weight) tracking and the bias
flags must be equal at every iteration, and the LLRs within
``LLR_SPACINGS`` = 2^18 float64 spacings at the message clamp (100, whose
spacing is 1.42e-14): 3.7e-9.  The largest difference seen is 97,898 such
spacings (1.39e-9: 16.841985511742692 against 16.841985510351485, the
(120, 6, 3) code, syndrome seed 3, lane 22, iteration 59).  Where the two pick a different
bias node it must be an exact tie (equal oscillation counts, ``|llr|``
equal to rtol 1e-9), and the lane's traces separate from there.

Float32.  The flags and outputs are held decode-equivalent: XLA's float32
``tanh`` is a rational approximation, torch's is not, and a trapping set
can turn such a difference into another decision.  Over 256 lanes, the
converged flags and iteration counts agree on at least 99% of the lanes,
the error estimates on at least 97%, and every converged lane of either
reproduces its syndrome.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.codes import cycle_matrix, toric_code_x
from ldpcdecoders_tpu.golden import bpots_decode as golden_bpots
from ldpcdecoders_tpu.models.bpots import make_bpots_decode_fn as ref_make
from ldpcdecoders_tpu_torch.models.bpots import make_bpots_decode_fn, select_bias_nodes

torch.set_num_threads(1)

LLR_SPACINGS = 2**18
LLR_TOL = LLR_SPACINGS * np.spacing(100.0)


def assert_llrs_close(got, want, ctx):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.abs(got - want) > LLR_TOL
    assert not bad.any(), f"{ctx}: {got[bad][:4]} vs {want[bad][:4]}"


def port_trace(H, syns, per, max_iters, T, C):
    dec = make_bpots_decode_fn(pt.TannerGraph.from_pcm(H), per, max_iters, T, C, device="cpu",
                               dtype=torch.float64, trace=True)
    outputs, records = dec(torch.as_tensor(syns))
    return [o.numpy() for o in outputs], {k: v.numpy() for k, v in records.items()}


def jax_trace(H, syns, per, max_iters, T, C):
    with jax.enable_x64():
        fn = jax.jit(ref_make(lt.TannerGraph.from_pcm(H), per, max_iters, T, C,
                              dtype=jnp.float64, trace=True))
        outputs, records = fn(jnp.asarray(syns))
        return [np.asarray(o) for o in outputs], {k: np.asarray(v) for k, v in records.items()}


def tie_equivalent(osc, absllr, ours, theirs, ctx, *, check_osc):
    if check_osc:
        assert osc[ours] == osc[theirs], ctx
    np.testing.assert_allclose(absllr[ours], absllr[theirs], rtol=1e-9, err_msg=ctx)


def compare_lane(rec, want_at, b, T_len, ctx0):
    """Compare lane ``b`` of the port's records with ``want_at(t)`` (a dict
    of the same keys for iteration t); returns (diverged, any_bias)."""
    any_bias = False
    for t in range(T_len):
        w = want_at(t)
        if w is None:
            break
        ctx = f"{ctx0} lane {b} iter {t}"
        for k in ("dec", "osc"):
            assert np.array_equal(rec[k][t, b], w[k]), f"{ctx} {k}"
        for k in ("mis", "weight", "best_mis", "best_w"):
            assert rec[k][t, b] == w[k], f"{ctx} {k}"
        assert_llrs_close(rec["llrs"][t, b], w["llrs"], ctx)
        assert bool(rec["biased"][t, b]) == bool(w["biased"]), ctx
        if w["biased"]:
            any_bias = True
            j1, j2 = int(rec["j1"][t, b]), int(rec["j2"][t, b])
            if (j1, j2) != (int(w["j1"]), int(w["j2"])):
                osc, absllr = np.asarray(w["osc"]), np.abs(np.asarray(w["llrs"]))
                if j1 != int(w["j1"]):
                    tie_equivalent(osc, absllr, j1, int(w["j1"]), ctx + " j1", check_osc=True)
                if j2 != int(w["j2"]):
                    tie_equivalent(osc, absllr, j2, int(w["j2"]), ctx + " j2", check_osc=False)
                return True, any_bias
    return False, any_bias


def trapping(n, B, seed):
    H = cycle_matrix(n)
    errs = np.random.default_rng(seed).random((B, n)) < 0.5
    return H, (errs @ H.T) % 2


def noisy(H, B, per, seed):
    errs = np.random.default_rng(seed).random((B, H.shape[1])) < per
    return (errs @ H.T) % 2


TRACE_CASES = {  # name: (H, syndromes, per, max_iters, T, C, the bias path must fire)
    "cycle8": (*trapping(8, 6, 17), 0.01, 40, 9, 2.0, True),
    "toric3": (toric_code_x(3), noisy(toric_code_x(3), 4, 0.08, 19), 0.08, 30, 5, 2.0, False),
    "gallager60": (lt.parity_check_matrix(60, 6, 3, rng=31),
                   noisy(lt.parity_check_matrix(60, 6, 3, rng=31), 4, 0.15, 23), 0.15, 30, 5,
                   2.0, False),
    "gallager120": (lt.parity_check_matrix(120, 6, 3, rng=61),
                    noisy(lt.parity_check_matrix(120, 6, 3, rng=61), 32, 0.06, 3), 0.06, 60, 9,
                    2.0, True),
}


@pytest.mark.parametrize("name", sorted(TRACE_CASES))
def test_float64_trace_against_the_jax_package(name):
    H, syns, per, max_iters, T, C, need_bias = TRACE_CASES[name]
    (best, done, iters, llrs), rec = port_trace(H, syns, per, max_iters, T, C)
    (w_best, w_done, w_iters, w_llrs), want = jax_trace(H, syns, per, max_iters, T, C)
    any_bias = False
    for b in range(syns.shape[0]):
        diverged, biased = compare_lane(
            rec, lambda t: {k: v[t, b] for k, v in want.items()}, b, max_iters, name)
        any_bias |= biased
        if not diverged:
            assert done[b] == w_done[b] and iters[b] == w_iters[b], f"lane {b}"
            assert np.array_equal(best[b], w_best[b]), f"lane {b}"
            assert_llrs_close(llrs[b], w_llrs[b], f"lane {b} final")
    assert any_bias or not need_bias, "the OTS bias path never fired"


@pytest.mark.parametrize("name", sorted(TRACE_CASES))
def test_float64_trace_against_the_golden(name):
    H, syns, per, max_iters, T, C, need_bias = TRACE_CASES[name]
    (best, done, _, _), rec = port_trace(H, syns, per, max_iters, T, C)
    any_bias = False
    for b in range(syns.shape[0]):
        gt = []
        g_best, g_conv = golden_bpots(H, syns[b], per, max_iters, T=T, C=C, trace=gt)
        diverged, biased = compare_lane(
            rec, lambda t: gt[t] if t < len(gt) else None, b, max_iters, name)
        any_bias |= biased
        if not diverged:
            assert bool(done[b]) == g_conv, f"lane {b}"
            if g_conv:
                assert np.array_equal(best[b], g_best), f"lane {b}"
    assert any_bias or not need_bias, "the OTS bias path never fired"


@pytest.mark.parametrize("code,per,max_iters", [((120, 6, 3, 61), 0.05, 100),
                                                ((120, 6, 3, 61), 0.1, 100),
                                                ((240, 8, 4, 13), 0.04, 60)])
def test_float32_decode_equivalent(code, per, max_iters):
    n, wr, wc, seed = code
    H = lt.parity_check_matrix(n, wr, wc, rng=seed)
    syn = noisy(H, 256, per, 9).astype(np.uint8)
    want = lt.BPOTSDecoder(H, per, max_iters).batch_decode_detailed(syn)
    got = pt.BPOTSDecoder(H, per, max_iters, device="cpu").batch_decode_detailed(syn)
    assert got[0].dtype == np.int8 and got[3]["llrs"].dtype == np.float32
    assert (got[1] == want[1]).mean() >= 0.99 and (got[2] == want[2]).mean() >= 0.99
    assert (got[0] == want[0]).all(axis=1).mean() >= 0.97
    for err, conv in ((got[0], got[1]), (want[0], want[1])):
        assert ((err.astype(np.int64) @ H.T) % 2 == syn)[conv].all()


def test_select_bias_nodes_tie_order():
    """Hand-made ties (tests/test_bpots.py's): max oscillation, then the
    smaller |llr|, then the first index; j2 the first least |llr|."""
    osc = torch.tensor([[2, 2, 0, 1], [3, 0, 3, 3], [0, 0, 0, 0]])
    absllr = torch.tensor([[5.0, 3.0, 0.1, 9.0],
                           [4.0, 0.2, 4.0, 4.0],
                           [1.0, 0.5, 2.0, 3.0]])
    j1, j2, has_osc = select_bias_nodes(osc, absllr)
    assert j1.tolist() == [1, 0, 1]
    assert j2.tolist() == [2, 1, 1]
    assert has_osc.tolist() == [True, True, False]
    # an |llr| tie among the most oscillating nodes and a global |llr| tie
    j1, j2, _ = select_bias_nodes(torch.tensor([[1, 4, 4, 4]]),
                                  torch.tensor([[0.5, 2.0, 0.5, 0.5]], dtype=torch.float64))
    assert (j1.item(), j2.item()) == (2, 0)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_trapping_set_resistance(n):
    """Weight-2 errors on cycle matrices decode to a matching syndrome for
    each (T, C) of tests/test_bpots.py (test_bpots.jl:56-86)."""
    H = cycle_matrix(n)
    err = np.zeros(n, np.uint8)
    err[:2] = 1
    syn = (H @ err) % 2
    for T, C in ((3, 1.0), (5, 2.0), (9, 3.0)):
        guess, _ = pt.BPOTSDecoder(H, 0.01, 100, T=T, C=C, device="cpu").decode(syn)
        assert np.array_equal((H @ guess.astype(int)) % 2, syn), (T, C)


@pytest.mark.parametrize("noise", [0.01, 0.05, 0.1])
def test_toric_code_syndrome_match_rate(noise):
    """At least 85% of random d=3 toric syndromes matched, T=9, C=3.0,
    max_iters=50 (test_bpots.jl:116-137)."""
    H = toric_code_x(3)
    syns = noisy(H, 100, 0.5, 5)
    guesses, _ = pt.BPOTSDecoder(H, noise, 50, T=9, C=3.0, device="cpu").batch_decode(syns)
    assert ((guesses.astype(int) @ H.T) % 2 == syns).all(axis=1).mean() >= 0.85


def test_per_override_equals_a_decoder_built_there():
    H = lt.parity_check_matrix(120, 6, 3, rng=61)
    syn = noisy(H, 32, 0.05, 4)
    a = pt.BPOTSDecoder(H, 0.01, 40, device="cpu").batch_decode_detailed(syn, per=0.05)
    b = pt.BPOTSDecoder(H, 0.05, 40, device="cpu").batch_decode_detailed(syn)
    for x, y in zip(a[:3], b[:3]):
        assert np.array_equal(x, y)
    assert np.array_equal(a[3]["llrs"].view(np.uint32), b[3]["llrs"].view(np.uint32))
    # a per-lane [B, n] prior goes through, as in the JAX package
    per = np.full((32, H.shape[1]), 0.05)
    c = pt.BPOTSDecoder(H, 0.01, 40, device="cpu").batch_decode_detailed(syn, per=per)
    assert np.array_equal(c[0], b[0])


def test_bool_and_int_syndromes():
    H = cycle_matrix(8)
    err = np.zeros(8, np.uint8)
    err[:2] = 1
    syn = (H @ err) % 2
    dec = pt.BPOTSDecoder(H, 0.01, 100, T=9, C=3.0, device="cpu")
    assert np.array_equal(dec.decode(syn.astype(bool))[0], dec.decode(syn.astype(np.int64))[0])
