"""Port parity: space-time detector graphs and ``SpaceTimeDecoder``.

The same seeded numpy detector records go through ``ldpcdecoders_tpu`` (JAX
on the CPU) and ``ldpcdecoders_tpu_torch`` on the CPU.  The reference's
``for_bicycle`` runs its fused Pallas kernel in interpret mode with
``batch_tile=8`` (built once per module); the port's runs the plain version
of its whole-decode kernel.

Tolerances: the numpy layers are bitwise; cumulative corrections,
``converged``, ``iters`` and the per-round split are equal on every lane;
min-sum LLRs (layered, alpha 0.8, beta 0: no inexact product feeds a sum)
are bitwise; sum-product log-probabilities of the generic inner decoders are
within rtol 1e-5, atol 1e-6 (``log`` differs by an ulp, as in
tests/test_torch_bp.py).
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.codes import spacetime as ref_spacetime
from ldpcdecoders_tpu_torch.codes import spacetime
from ldpcdecoders_tpu_torch.codes.bicycle import named_bicycle_code

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toric():
    return lt.toric_code_x(3)  # [9, 18], as tests/test_spacetime.py uses


# ---- the carried numpy layers ------------------------------------------------


@pytest.mark.parametrize("rounds,perfect_last", [(1, True), (3, True), (2, False), (4, False)])
def test_spacetime_pcm_and_prior_match_reference(toric, rounds, perfect_last):
    for H in (toric, sp.csr_matrix(toric)):
        A = spacetime.spacetime_pcm(H, rounds, perfect_last=perfect_last)
        A_ref = ref_spacetime.spacetime_pcm(H, rounds, perfect_last=perfect_last)
        assert A.shape == A_ref.shape and A.dtype == A_ref.dtype and (A != A_ref).nnz == 0
    if rounds == 1 and perfect_last:
        assert np.array_equal(A.toarray(), toric)
    rng = np.random.default_rng(rounds)
    for per, q in ((0.01, 0.02), (rng.uniform(0.01, 0.1, 18), rng.uniform(0.01, 0.1, 9))):
        got = spacetime.spacetime_prior(18, 9, rounds, per, q, perfect_last=perfect_last)
        want = ref_spacetime.spacetime_prior(18, 9, rounds, per, q, perfect_last=perfect_last)
        assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)
        assert got.shape == (A.shape[1],)


def test_detectors_of_matches_reference():
    rng = np.random.default_rng(5)
    s = (rng.random((7, 4, 9)) < 0.3).astype(np.uint8)
    d = spacetime.detectors_of(s)
    assert d.dtype == np.uint8 and np.array_equal(d, ref_spacetime.detectors_of(s))
    assert np.array_equal(spacetime.detectors_of(s[0]), d[0])
    assert np.array_equal(np.cumsum(d.reshape(7, 4, 9), axis=1) % 2, s)
    with pytest.raises(ValueError, match=r"expected \[B, R, m\]"):
        spacetime.detectors_of(s[0, 0])
    with pytest.raises(ValueError, match="rounds must be >= 1"):
        spacetime.spacetime_pcm(np.eye(3), 0)
    with pytest.raises(ValueError, match="0/1 matrix"):
        spacetime.spacetime_pcm(2 * np.eye(3), 2)


# ---- generic inner decoders ----------------------------------------------------


def records(dec, B, seed, scale=1.0):
    """Detector records of errors sampled from the decoder's own prior."""
    rng = np.random.default_rng(seed)
    x = (rng.random((B, dec.n_cols)) < scale * dec._prior[None, :]).astype(np.uint8)
    return x, np.asarray((dec.A.astype(np.int32) @ x.T.astype(np.int32)).T % 2, np.uint8)


def assert_same_decode(got, want):
    for g, w in zip(got[:3], want[:3]):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for key in ("data_rounds", "meas"):
        w = np.asarray(want[3][key])
        assert got[3][key].shape == w.shape and np.array_equal(got[3][key], w)


@pytest.mark.parametrize("kind,knobs", [("bp", {}), ("minsum", {}), ("minsum", {"damping": 0.5}),
                                        ("bposd", {}), ("bposd", {"osd_order": 2})])
def test_generic_inner_matches_reference(toric, kind, knobs):
    R, per, q = 3, 0.03, 0.05
    ref = lt.SpaceTimeDecoder(toric, R, per, 20, meas_error_rate=q, decoder=kind, **knobs)
    dec = pt.SpaceTimeDecoder(toric, R, per, 20, meas_error_rate=q, decoder=kind, device="cpu",
                              **knobs)
    assert (dec.m, dec.n, dec.n_cols, dec.block_m, dec.block_n) == (
        ref.m, ref.n, ref.n_cols, ref.block_m, ref.block_n)
    assert (dec.A != ref.A).nnz == 0 and np.array_equal(dec._prior, ref._prior)
    _, det = records(dec, 24, seed=3, scale=1.5)
    want = ref.batch_decode_detailed(det)
    got = dec.batch_decode_detailed(det)
    assert_same_decode(got, want)
    if kind == "minsum":
        # damping 0.5 mixes with exact products: bitwise either way
        assert np.array_equal(got[3]["inner"]["llrs"].view(np.uint32),
                              np.asarray(want[3]["inner"]["llrs"]).view(np.uint32))
    else:
        np.testing.assert_allclose(got[3]["inner"]["log_probabs"],
                                   np.asarray(want[3]["inner"]["log_probabs"]),
                                   rtol=1e-5, atol=1e-6)
    if kind == "bposd":  # every output reproduces its record
        full = np.concatenate([got[3]["data_rounds"].reshape(24, -1),
                               got[3]["meas"].reshape(24, -1)], axis=1)
        assert np.array_equal((dec.A.astype(np.int32) @ full.T).T % 2, det)
    # overrides of the data and the measurement rate, and the raw history
    for over in (dict(per=0.05), dict(q=0.02), dict(per=np.full(18, 0.04), q=np.full(9, 0.03)),
                 dict(per=dec._prior * 1.2)):
        e_w, c_w = ref.batch_decode(det, **over)
        e_g, c_g = dec.batch_decode(det, **over)
        assert np.array_equal(e_g, np.asarray(e_w)) and np.array_equal(c_g, np.asarray(c_w))


def test_decode_history_and_single_round(toric):
    ref = lt.SpaceTimeDecoder(toric, 3, 0.03, 20, decoder="bp")
    dec = pt.SpaceTimeDecoder(toric, 3, 0.03, 20, decoder="bp", device="cpu")
    rng = np.random.default_rng(9)
    hist = (rng.random((6, 3, 9)) < 0.1).astype(np.uint8)
    e_w, c_w = ref.decode_history(hist)
    e_g, c_g = dec.decode_history(hist)
    assert np.array_equal(e_g, np.asarray(e_w)) and np.array_equal(c_g, np.asarray(c_w))
    e1, c1 = dec.decode_history(hist[0])
    assert np.array_equal(e1, e_g[0]) and c1 == bool(c_g[0])
    # rounds=1 with a perfect last round is single-shot decoding on H
    one = pt.SpaceTimeDecoder(toric, 1, 0.03, 20, decoder="minsum", device="cpu")
    shot = pt.MinSumDecoder(toric, 0.03, 20, device="cpu")
    syn = (((rng.random((8, 18)) < 0.05) @ toric.T) % 2).astype(np.uint8)
    got = one.batch_decode_detailed(syn)
    want = shot.batch_decode_detailed(syn)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[3]["meas"].shape == (8, 0, 9) and got[3]["data_rounds"].shape == (8, 1, 18)
    e_q, _ = one.batch_decode(syn, per=0.05)  # no measurement columns to slice q from
    assert np.array_equal(e_q, shot.batch_decode(syn, per=0.05)[0])


def test_validation(toric):
    dec = pt.SpaceTimeDecoder(toric, 2, 0.03, 10, decoder="bp", device="cpu")
    with pytest.raises(ValueError, match=r"expected detectors of shape \[B, 18\]"):
        dec.batch_decode(np.zeros((2, 9), np.uint8))
    with pytest.raises(NotImplementedError, match="'layered_minsum' is not ported"):
        pt.SpaceTimeDecoder(toric, 2, 0.03, 10, decoder="layered_minsum", device="cpu")
    # bit-flip is ported but takes no prior vector: refused as the reference does
    with pytest.raises(ValueError, match="cannot honor the mixed"):
        pt.SpaceTimeDecoder(toric, 2, 0.03, 10, decoder="bitflip", device="cpu")
    assert pt.SpaceTimeDecoder(toric, 2, 0.03, 10, decoder="bpots", device="cpu").inner.T == 9
    with pytest.raises(TypeError, match="unknown decoder knobs"):
        pt.SpaceTimeDecoder(toric, 2, 0.03, 10, decoder="bp", device="cpu", bogus=1)
    inner = pt.MinSumDecoder(toric, 0.03, 10, device="cpu")
    with pytest.raises(ValueError, match="injected inner is"):
        pt.SpaceTimeDecoder(toric, 2, 0.03, 10, _inner=inner)
    with pytest.raises(ValueError, match="block must be"):
        pt.SpaceTimeDecoder.for_bicycle("bb72", "y", 2, 0.01, 10, device="cpu")
    with pytest.raises(ValueError, match="unknown BB code"):
        pt.SpaceTimeDecoder.for_bicycle("bb999", "x", 2, 0.01, 10, device="cpu")
    with pytest.raises(ValueError, match="rounds must be >= 1"):
        pt.SpaceTimeDecoder.for_bicycle("bb72", "x", 0, 0.01, 10, device="cpu")


# ---- for_bicycle: the group-circulant space-time lift --------------------------


@functools.lru_cache(maxsize=None)
def ref_for_bicycle(block, rounds, perfect_last=True):
    return lt.SpaceTimeDecoder.for_bicycle(
        "bb72", block, rounds, 0.01, 40, meas_error_rate=0.015, backend="pallas",
        interpret=True, batch_tile=8, perfect_last=perfect_last)


@pytest.mark.parametrize("block,rounds,perfect_last", [("x", 3, True), ("z", 2, True),
                                                       ("x", 2, False)])
def test_for_bicycle_matches_reference_kernel(block, rounds, perfect_last):
    ref = ref_for_bicycle(block, rounds, perfect_last)
    dec = pt.SpaceTimeDecoder.for_bicycle("bb72", block, rounds, 0.01, 40, meas_error_rate=0.015,
                                          perfect_last=perfect_last, device="cpu")
    # the lift is the space-time matrix (verify_lift checked it), row
    # weights 7 and 8: six stabilizer terms and one or two identities
    Hx, Hz, _ = named_bicycle_code("bb72")
    A = spacetime.spacetime_pcm(Hx if block == "x" else Hz, rounds, perfect_last=perfect_last)
    assert (dec.A != A).nnz == 0 and (dec.inner.m, dec.inner.n) == A.shape
    assert dec.inner.schedule == "layered" and dec.inner.alpha == 0.8
    assert sorted(dec.inner.terms) == sorted(tuple(t) for t in ref.inner.terms)
    assert dec.inner.per == ref.inner.per
    weights = sorted({len(r) for r in dec.inner.qc_terms.row_edges})
    assert weights == ([7, 8] if rounds > 2 or not perfect_last else [7])
    # 21 records (no multiple of the reference's tile of 8) at twice the
    # prior's rates: lanes stop at different sweeps
    x, det = records(dec, 21, seed=5, scale=2.0)
    want = ref.batch_decode_detailed(det)
    got = dec.batch_decode_detailed(det)
    assert want[1].mean() > 0.5 and len(set(np.asarray(want[2]).tolist())) >= 3
    assert_same_decode(got, want)
    assert np.array_equal(got[3]["inner"]["llrs"].view(np.uint32),
                          np.asarray(want[3]["inner"]["llrs"]).view(np.uint32))
    # converged lanes reproduce the detector record through the model
    conv = got[1]
    full = np.concatenate([got[3]["data_rounds"].reshape(21, -1),
                           got[3]["meas"].reshape(21, -1)], axis=1)
    rec = np.asarray((dec.A.astype(np.int32) @ full.T.astype(np.int32)).T % 2, np.uint8)
    assert np.array_equal(rec[conv], det[conv])
    # the mixed prior reaches the inner: the defaults passed as overrides
    # change nothing, other rates agree with the reference
    e2, c2 = dec.batch_decode(det, per=0.01, q=0.015)
    assert np.array_equal(e2, got[0]) and np.array_equal(c2, got[1])
    e_w, c_w = ref.batch_decode(det, per=0.02, q=0.01)
    e_g, c_g = dec.batch_decode(det, per=0.02, q=0.01)
    assert np.array_equal(e_g, np.asarray(e_w)) and np.array_equal(c_g, np.asarray(c_w))


def test_for_bicycle_flooding_and_lifted_backend():
    """The lifted backend (generic min-sum on the same space-time graph)
    against the whole-decode path in flooding.  Several terms share a block,
    so the two variable updates add in different orders; with a uniform
    prior and alpha 1 many totals are sums of equal magnitudes that cancel
    to zero or to a rounding residue of either sign, so a decision can
    differ and with it a lane's path.  Parity is behavioural: both converge,
    every converged lane reproduces its record, and most lanes agree."""
    kw = dict(meas_error_rate=0.015, schedule="flooding", device="cpu")
    fused = pt.SpaceTimeDecoder.for_bicycle("bb72", "x", 3, 0.01, 30, **kw)
    lifted = pt.SpaceTimeDecoder.for_bicycle("bb72", "x", 3, 0.01, 30, backend="lifted", **kw)
    assert fused.inner.alpha == lifted.inner.alpha == 1.0
    _, det = records(fused, 16, seed=8)
    outs = [d.batch_decode_detailed(det) for d in (fused, lifted)]
    for e, c, _, aux, _ in outs:
        assert c.mean() > 0.9
        full = np.concatenate([aux["data_rounds"].reshape(16, -1), aux["meas"].reshape(16, -1)],
                              axis=1)
        rec = np.asarray((fused.A.astype(np.int32) @ full.T.astype(np.int32)).T % 2, np.uint8)
        assert np.array_equal(rec[c], det[c])
    assert (outs[0][0] == outs[1][0]).all(axis=1).mean() >= 0.75
    with pytest.raises(NotImplementedError, match="layered"):
        pt.SpaceTimeDecoder.for_bicycle("bb72", "x", 3, 0.01, 30, backend="lifted",
                                        device="cpu")
