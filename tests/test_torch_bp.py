"""Port parity: exclusive products, syndrome checks and sum-product BP.

The same seeded numpy inputs go through ``ldpcdecoders_tpu`` (JAX on the
CPU) and ``ldpcdecoders_tpu_torch``.  err / converged / iters and the
exclusive products must agree bitwise: the port keeps the reference's
association order.  ``logp`` is compared within rtol 1e-5, atol 1e-6,
because torch's and XLA's float32 ``log`` differ by an ulp on a few
percent of inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.golden import bp_decode as golden_bp
from ldpcdecoders_tpu.ops import exclusive as ref_excl
from ldpcdecoders_tpu.ops.syndrome import make_syndrome_fn as ref_syndrome_fn
from ldpcdecoders_tpu_torch.ops.exclusive import exclusive_prods, guarded_exclusive_prod_scan
from ldpcdecoders_tpu_torch.ops.syndrome import SyndromeCheck

torch.set_num_threads(1)

LOGP_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def medium_code():
    # the reference's BP test code (tests/test_bp.py)
    return lt.parity_check_matrix(240, 8, 4, rng=11)


def assert_bitwise(a, b):
    """Equal float32 arrays bit for bit (any NaN matches any NaN)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    assert np.array_equal(nan_a, nan_b)
    assert np.array_equal(a[~nan_a].view(np.uint32), b[~nan_b].view(np.uint32))


def special_factors(rng, shape):
    x = rng.normal(size=shape).astype(np.float32) * 3
    pick = rng.random(shape)
    x[pick < 0.05] = 0.0
    x[(pick >= 0.05) & (pick < 0.08)] = np.inf
    x[(pick >= 0.08) & (pick < 0.11)] = -np.inf
    x[(pick >= 0.11) & (pick < 0.13)] = np.nan
    x[(pick >= 0.13) & (pick < 0.15)] = -0.0
    return x


@pytest.mark.parametrize("d", [1, 4, 9, 10])
def test_exclusive_prods_bitwise(d):
    rng = np.random.default_rng(d)
    x = special_factors(rng, (6, d, 37))
    fwd_ref, bwd_ref = ref_excl.exclusive_prods(jnp.asarray(x), axis=1)
    fwd, bwd = exclusive_prods(torch.as_tensor(x), dim=1)
    assert_bitwise(fwd_ref, fwd)
    assert_bitwise(bwd_ref, bwd)
    with np.errstate(invalid="ignore"):  # 0 * inf
        assert_bitwise(np.asarray(fwd_ref) * np.asarray(bwd_ref), (fwd * bwd).numpy())


@pytest.mark.parametrize("d", [1, 3, 9])
def test_guarded_exclusive_prod_scan_bitwise(d):
    rng = np.random.default_rng(10 + d)
    x = special_factors(rng, (5, d, 41))
    init = special_factors(rng, (5, 41))
    excl_ref, total_ref = ref_excl.guarded_exclusive_prod_scan(
        jnp.asarray(x), jnp.asarray(init), axis=1)
    excl, total = guarded_exclusive_prod_scan(torch.as_tensor(x), torch.as_tensor(init), dim=1)
    assert_bitwise(excl_ref, excl)
    assert_bitwise(total_ref, total)
    assert not np.isnan(total.numpy()).any()  # the guard resets NaN products


def test_syndrome_forms_match_reference(medium_code):
    H = medium_code
    rng = np.random.default_rng(1)
    err = (rng.random((9, H.shape[1])) < 0.1).astype(np.float32)
    dense = pt.TannerGraph.from_pcm(H)
    sparse = pt.TannerGraph.from_edges(*np.nonzero(H), *H.shape)
    want = np.asarray(ref_syndrome_fn(lt.TannerGraph.from_pcm(H))(jnp.asarray(err)))
    for graph in (dense, sparse):
        fn = SyndromeCheck(graph, "cpu")
        assert fn.dense == (graph.H is not None)
        got = fn(torch.as_tensor(err)).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(got, (err @ H.T) % 2)


def decode_both(H, built_per, max_iters, syns, **kw):
    """Decode with both packages; the port's decoder is built on the
    reference's compiled graph arrays."""
    ref = lt.BeliefPropagationDecoder(H, built_per, max_iters)
    port = pt.BeliefPropagationDecoder(
        pt.TannerGraph.from_arrays(**dataclasses.asdict(ref.graph)), built_per, max_iters)
    r = ref.batch_decode_detailed(syns, **kw)
    p = port.batch_decode_detailed(syns, **kw)
    return r, p


def assert_bp_outputs_match(r, p):
    e_r, c_r, i_r, a_r, _ = r
    e_p, c_p, i_p, a_p, stats = p
    assert e_p.dtype == np.int8 and c_p.dtype == np.bool_ and i_p.dtype == np.int32
    assert np.array_equal(e_r, e_p)
    assert np.array_equal(c_r, c_p)
    assert np.array_equal(i_r, i_p)
    np.testing.assert_allclose(a_p["log_probabs"], np.asarray(a_r["log_probabs"]), **LOGP_TOL)
    assert stats.converged_fraction == float(np.mean(c_r))


@pytest.mark.parametrize("per,max_iters", [(0.02, 25), (0.06, 30), (0.15, 8)])
def test_bp_matches_reference_decoder(medium_code, per, max_iters):
    H = medium_code
    rng = np.random.default_rng(int(per * 1000))
    errs = rng.random((16, H.shape[1])) < per
    syns = (errs @ H.T) % 2
    r, p = decode_both(H, per, max_iters, syns)
    assert_bp_outputs_match(r, p)


def test_bp_matches_golden_exactly(medium_code):
    """Same case as the reference's golden test (tests/test_bp.py)."""
    H = medium_code
    rng = np.random.default_rng(2)
    per, B = 0.02, 16
    errs = rng.random((B, H.shape[1])) < per
    syns = (errs @ H.T) % 2
    dec = pt.BeliefPropagationDecoder(H, per, 25)
    err, conv, iters, aux, _ = dec.batch_decode_detailed(syns)
    for b in range(B):
        ge, gc, glogp, giters = golden_bp(H, syns[b], per, 25, dtype=np.float32)
        assert np.array_equal(err[b], ge.astype(np.int8)), f"lane {b}"
        assert bool(conv[b]) == gc, f"lane {b}"
        assert int(iters[b]) == giters, f"lane {b}"
        np.testing.assert_allclose(aux["log_probabs"][b], glogp, **LOGP_TOL)


def test_bp_per_override(medium_code):
    H = medium_code
    rng = np.random.default_rng(7)
    errs = rng.random((8, H.shape[1])) < 0.05
    syns = (errs @ H.T) % 2
    per_vec = np.linspace(0.02, 0.08, H.shape[1])
    per_lane = rng.uniform(0.01, 0.1, size=(8, H.shape[1]))
    for per in (0.05, per_vec, per_lane):
        r, p = decode_both(H, 0.01, 20, syns, per=per)
        assert_bp_outputs_match(r, p)
    # an override equals a decoder built at that rate
    built = pt.BeliefPropagationDecoder(H, 0.05, 20).batch_decode(syns)
    over = pt.BeliefPropagationDecoder(H, 0.01, 20).batch_decode(syns, per=0.05)
    assert np.array_equal(built[0], over[0]) and np.array_equal(built[1], over[1])
    dec = pt.BeliefPropagationDecoder(H, 0.01, 20)
    with pytest.raises(ValueError, match="per-lane prior batch"):
        dec.batch_decode(syns, per=per_lane[:3])


def test_bp_api_contract(medium_code):
    H = medium_code
    dec = pt.BeliefPropagationDecoder(H, 0.01, 50, device="cpu")
    assert isinstance(dec, torch.nn.Module)
    assert {"c2v", "v2c", "chk_mask", "var_mask"} <= {n.split(".")[-1] for n, _ in
                                                      dec.named_buffers()}
    rng = np.random.default_rng(3)
    err_true = rng.random(H.shape[1]) < 0.01
    syn = (H @ err_true) % 2
    guess, ok = pt.decode(dec, syn)
    assert ok and np.array_equal(guess.astype(bool), err_true)
    guess0, ok0 = dec.decode(np.zeros(H.shape[0], np.uint8))
    assert ok0 and not guess0.any()
    errs = rng.random((5, H.shape[1])) < 0.01
    syns = (errs @ H.T) % 2
    g, c = pt.batchdecode(dec, syns)
    assert g.shape == (5, H.shape[1]) and g.dtype == np.int8 and c.shape == (5,)
    assert np.array_equal(dec.decode(syns[2])[0], g[2])
    ga, ca = dec.batch_decode_async(torch.as_tensor(syns))
    assert isinstance(ga, torch.Tensor) and np.array_equal(ga.numpy(), g)
    with pytest.raises(ValueError, match="expected syndromes of shape"):
        dec.batch_decode(syns[:, :-1])
