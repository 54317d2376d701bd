"""Port parity: erasure peeling, the mixed erasure + flip channel and its sweep.

The same seeded numpy inputs go through ``ldpcdecoders_tpu`` (JAX on the
CPU, jitted) and ``ldpcdecoders_tpu_torch`` on the CPU.  Tolerances:

  * peeling is bool and int work: ``err``, ``ok`` and ``depth`` bitwise,
    stopping sets completed by the GF(2) elimination included;
  * the mixed decoder with min-sum (alpha 1, beta 0) and with sum-product:
    ``err`` / ``ok`` / peel rounds / BP iterations bitwise (ROADMAP.md
    queue 3: BP and min-sum flags are bitwise, BP's LLRs within rtol 1e-5,
    which does not move a hard decision here); with ``osd_order`` the OSD
    outputs are bitwise too (no reliability ties in these cases);
  * ``mixed_fer_sweep``: every count equal to the reference's on the same
    numpy streams, a checkpoint resumed in either package.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu import harness as ref_harness
from ldpcdecoders_tpu_torch import harness

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def code():
    return lt.parity_check_matrix(240, 6, 3, rng=0)


def erasure_case(H, B, p_erase, p_flip, seed):
    rng = np.random.default_rng(seed)
    n = H.shape[1]
    eps = rng.random((B, n)) < p_erase
    e = np.where(eps, rng.random((B, n)) < 0.5, rng.random((B, n)) < p_flip)
    return eps, e, ((e @ H.T) % 2).astype(np.uint8)


@pytest.mark.parametrize("on_stuck", ["gf2", "fail"])
@pytest.mark.parametrize("p_erase", [0.1, 0.35, 0.5])
def test_peeling_matches_reference(code, on_stuck, p_erase):
    """Low erasure peels clean; 0.35 and 0.5 leave stopping sets, which
    ``gf2`` completes and ``fail`` reports (0.5 also has unsolvable lanes)."""
    eps, e, syn = erasure_case(code, 48, p_erase, 0.0, seed=int(100 * p_erase))
    port = pt.ErasurePeelingDecoder(code, on_stuck=on_stuck, device="cpu")
    ref = lt.ErasurePeelingDecoder(code, on_stuck=on_stuck)
    err, ok, depth = port.batch_decode_detailed(syn, eps)
    want = ref._decode_fn(syn, eps)
    for g, w in zip((err, ok, depth), want):
        assert np.array_equal(g, np.asarray(w))
    if p_erase >= 0.35:
        stuck_lanes = port.peeling.gf2_lanes if on_stuck == "gf2" else (~ok).sum()
        assert stuck_lanes > 0, "the case needs stopping sets"
    if on_stuck == "gf2":
        assert (err[ok].astype(bool) == e[ok]).all() or p_erase > 0.1
        assert (((err.astype(np.int64) @ code.T) % 2)[ok] == syn[ok]).all()
    e1, ok1 = port.decode(syn[0], eps[0])
    assert np.array_equal(e1, err[0]) and ok1 == ok[0]


def test_peeling_sparse_graph_and_validation(code):
    eps, _, syn = erasure_case(code, 16, 0.3, 0.0, seed=5)
    Hs = sp.csr_matrix(code)
    port = pt.ErasurePeelingDecoder(Hs, on_stuck="fail", device="cpu")
    ref = lt.ErasurePeelingDecoder(Hs, on_stuck="fail")
    for g, w in zip(port.batch_decode(syn, eps), ref.batch_decode(syn, eps)):
        assert np.array_equal(g, np.asarray(w))
    with pytest.raises(ValueError, match="needs a dense H"):
        pt.ErasurePeelingDecoder(Hs, device="cpu")
    with pytest.raises(ValueError, match="on_stuck"):
        pt.ErasurePeelingDecoder(code, on_stuck="bogus", device="cpu")
    dec = pt.ErasurePeelingDecoder(code, device="cpu")
    with pytest.raises(ValueError, match="expected erasures"):
        dec.batch_decode(syn, eps[:, :10])
    with pytest.raises(ValueError, match="expected syndromes"):
        dec.batch_decode(syn[:, :5], eps)
    # a capped round count stops peeling early, as the reference's does
    capped = pt.ErasurePeelingDecoder(code, on_stuck="fail", max_rounds=1, device="cpu")
    rcap = lt.ErasurePeelingDecoder(code, on_stuck="fail", max_rounds=1)
    for g, w in zip(capped.batch_decode(syn, eps), rcap.batch_decode(syn, eps)):
        assert np.array_equal(g, np.asarray(w))


MIXED = [
    dict(algorithm="minsum"),
    dict(algorithm="sumproduct"),
    dict(algorithm="minsum", strategy="bp"),
    dict(algorithm="minsum", osd_order=0),
    dict(algorithm="sumproduct", osd_order=2),
]


@pytest.mark.parametrize("kw", MIXED, ids=["minsum", "sumproduct", "bp_only", "osd0", "osd2"])
def test_mixed_matches_reference(code, kw):
    eps, e, syn = erasure_case(code, 64, 0.12, 0.01, seed=7)
    port = pt.MixedChannelDecoder(code, 0.01, 30, device="cpu", **kw)
    ref = lt.MixedChannelDecoder(code, 0.01, 30, **kw)
    got = port.batch_decode_detailed(syn, eps)
    want = ref.batch_decode_detailed(syn, eps)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, np.asarray(w))
    assert got[3] == want[3] and got[3] > 0
    if kw.get("osd_order") is not None:
        assert port.mixed.osd_ran
        assert (((got[0].astype(np.int64) @ code.T) % 2) == syn).all(axis=1)[got[1]].all()
    # a per-call flip probability (per lane)
    per = np.where(eps, 0.02, 0.005)
    for g, w in zip(port.batch_decode(syn, eps, per=per), ref.batch_decode(syn, eps, per=per)):
        assert np.array_equal(g, np.asarray(w))


def test_mixed_clean_batch_skips_bp_and_validation(code):
    eps, _, syn = erasure_case(code, 16, 0.05, 0.0, seed=3)
    port = pt.MixedChannelDecoder(code, 0.01, 30, device="cpu")
    err, ok, rounds, bp_iters = port.batch_decode_detailed(syn, eps)
    want = lt.MixedChannelDecoder(code, 0.01, 30).batch_decode_detailed(syn, eps)
    assert ok.all() and bp_iters == 0 == want[3]
    assert np.array_equal(err, np.asarray(want[0])) and np.array_equal(rounds, want[2])
    with pytest.raises(ValueError, match="algorithm"):
        pt.MixedChannelDecoder(code, 0.01, 5, algorithm="bogus", device="cpu")
    with pytest.raises(ValueError, match="strategy"):
        pt.MixedChannelDecoder(code, 0.01, 5, strategy="bogus", device="cpu")
    e1, ok1 = port.decode(syn[1], eps[1])
    assert np.array_equal(e1, err[1]) and ok1 == ok[1]


def test_mixed_fer_sweep_matches_reference_and_resumes(code, tmp_path):
    kw = dict(trials_per_point=96, batch=32, seed=5, max_iters=30)
    rates = [0.05, 0.3]
    want = ref_harness.mixed_fer_sweep(code, 0.01, rates, **kw)
    got = harness.mixed_fer_sweep(code, 0.01, rates, device="cpu", **kw)
    keys = ("trials", "exact_failure_rate", "exact_failure_ci95", "syndrome_mismatch_rate",
            "ok_rate", "bp_engaged_steps", "steps", "mean_peel_rounds")
    for eps in rates:
        assert {k: got[eps][k] for k in keys} == {k: want[eps][k] for k in keys}
    assert got[0.3]["exact_failure_rate"] > 0 and got[0.05]["bp_engaged_steps"] > 0
    # a sweep cut short by its budget resumes from the checkpoint to the same counts,
    # and a checkpoint the reference wrote resumes in the port
    path = str(tmp_path / "mixed.json")
    harness.mixed_fer_sweep(code, 0.01, rates, device="cpu", checkpoint_path=path,
                            max_seconds=0.0, **kw)
    ref_path = str(tmp_path / "ref.json")
    ref_harness.mixed_fer_sweep(code, 0.01, rates, checkpoint_path=ref_path,
                                **dict(kw, trials_per_point=64))
    for p in (path, ref_path):
        res = harness.mixed_fer_sweep(code, 0.01, rates, device="cpu", checkpoint_path=p, **kw)
        for eps in rates:
            assert {k: res[eps][k] for k in keys} == {k: want[eps][k] for k in keys}
    with open(path) as f:
        assert json.load(f)["p_flip"] == 0.01
    with pytest.raises(ValueError, match="different seed"):
        harness.mixed_fer_sweep(code, 0.01, rates, device="cpu", checkpoint_path=path,
                                **dict(kw, seed=6))
