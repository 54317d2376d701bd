"""Port parity: detector error models, the detector-graph decoder and the
ensemble.

``load_dem`` is held equal to the reference's (``A``, ``priors`` bitwise
in float64, ``O``) on every ``tests/fixtures/*.dem`` file and on the
inline cases of tests/test_detector.py.  ``DetectorGraphDecoder`` and
``EnsembleDecoder`` are held bitwise against the JAX package on the same
detector records: the BP+OSD inner orders OSD columns by ``exp(logp)``,
so an OSD lane may differ where two reliabilities tie within a few ulps
(shown per lane, as tests/test_torch_bposd.py does); min-sum members are
bitwise on every lane.
"""

import pathlib
import warnings

import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.models.detector import DetectorGraphDecoder as RefDetector
from ldpcdecoders_tpu.models.detector import load_dem as ref_load_dem
from ldpcdecoders_tpu.models.ensemble import EnsembleDecoder as RefEnsemble

from test_torch_bposd import assert_lanes_equal, orders

torch.set_num_threads(1)

FIXTURES = sorted(pathlib.Path(__file__).parent.joinpath("fixtures").glob("*.dem"))

INLINE = {
    "rep3": ("error(0.05) D0 L0\nerror(0.05) D0 D1\nerror(0.05) D1 D2\nerror(0.05) D2 L0\n"
             "detector D0\ndetector D1\ndetector D2\nlogical_observable L0\n"),
    "merge": "error(0.1) D0 D1\nerror(0.2) D1 D0\n",
    "decomposition": "error(0.01) D0 D1 ^ D1 D2 L0  # comment\n// another\n",
    "repeat": "repeat 5 {\n error(0.1) D0\n}",
    "shift": "shift_detectors 2\nerror(0.1) D0",
    "impossible": "error(0) D0 L0\nerror(0.1) D0 D1\n",
    "no_op": "error(0.3)\nerror(0.1) D0\n",
    "half": "error(0.5) D0\nerror(0.5) D0\n",
    "nested": "repeat 2 {\n repeat 3 {\n  error(0.02) D0 D1 L1\n  shift_detectors(1, 0) 1\n }\n"
              " detector(0, 0) D0\n}\nlogical_observable L0\n",
}
MALFORMED = {
    "banana D0": "unrecognized",
    "detector D0": "no error mechanisms",
    "error(0) D0\n": "no error mechanisms",
    "error(1) D0 D1\n": "deterministic",
    "error(1.5) D0\n": "out of range",
    "error(0.1) X0\n": "unknown error target",
    "repeat 2 {\nerror(0.1) D0\n": "unterminated",
    "}\n": "unmatched",
    "repeat x {\n}\n": "malformed repeat",
    "shift_detectors x\n": "malformed shift_detectors",
}


def tie_lanes(logp_ref, logp_port):
    """Lanes whose OSD column order differs between the packages.  The two
    packages' float32 ``logp`` differ by an ulp here and there, and ``exp``
    widens that (an ulp of a log-ratio of 11 is a dozen ulps of the ratio),
    and a DEM has many tied priors, so a lane may swap several groups of
    columns: each such lane must list, position by position, the
    reference's ``logp`` within 4 ulps in both orders."""
    perm_ref, perm, _ = orders(logp_ref, logp_port)
    lp = np.asarray(logp_ref, np.float32)
    lanes = np.flatnonzero((perm_ref != perm).any(axis=1))
    for b in lanes:
        a, c = lp[b][perm_ref[b]], lp[b][perm[b]]
        near = np.abs(a - c) <= 4 * np.spacing(np.maximum(np.abs(a), np.abs(c)))
        assert near.all(), f"lane {b}: no tie"
    return lanes


def assert_dem_equal(want, got):
    (A, p, O), (A2, p2, O2) = want, got
    assert A2.shape == A.shape and A2.dtype == A.dtype and (A2 != A).nnz == 0
    assert p2.dtype == p.dtype and np.array_equal(p2.view(np.uint64), p.view(np.uint64))
    assert O2.dtype == O.dtype and np.array_equal(O2, O)


@pytest.mark.parametrize("path", FIXTURES, ids=[p.stem for p in FIXTURES])
def test_load_dem_matches_reference_on_fixtures(path):
    assert len(FIXTURES) == 5
    assert_dem_equal(ref_load_dem(str(path)), pt.load_dem(str(path)))
    assert_dem_equal(ref_load_dem(path.read_text()), pt.load_dem(path.read_text()))


@pytest.mark.parametrize("name", list(INLINE))
def test_load_dem_matches_reference_inline(name):
    assert_dem_equal(ref_load_dem(INLINE[name]), pt.load_dem(INLINE[name]))


@pytest.mark.parametrize("text", list(MALFORMED))
def test_load_dem_rejects_what_the_reference_rejects(text):
    for fn in (ref_load_dem, pt.load_dem):
        with pytest.raises(ValueError, match=MALFORMED[text]):
            fn(text)


def test_load_dem_warns_on_undetectable_observables():
    for fn in (ref_load_dem, pt.load_dem):
        with pytest.warns(UserWarning, match="invisible to the decoder"):
            fn("error(0.01) L0\nerror(0.1) D0 L0\n")
    with pytest.warns(UserWarning, match="undetectable"):
        pt.DetectorGraphDecoder(np.array([[1, 0], [0, 0]], np.uint8), [0.1, 0.01], 10,
                                observables=np.array([[0, 1]], np.uint8), device="cpu")


def records(path, B, seed, scale=1.0):
    """Detector records and true observable flips sampled from the DEM."""
    A, pr, O = ref_load_dem(str(path))
    rng = np.random.default_rng(seed)
    x = (rng.random((B, A.shape[1])) < pr * scale).astype(np.uint8)
    return (A @ x.T).T % 2, (x @ O.T) % 2


D3 = pathlib.Path(__file__).parent / "fixtures" / "surface_d3_r3_p005.dem"


# min-sum knobs with exact products (damping 0.5, alpha 1): the jitted
# reference contracts no multiply-add that matters (ROADMAP queue 3)
@pytest.mark.parametrize("knobs", [dict(), dict(decoder="bposd", inner="minsum", damping=0.5),
                                   dict(decoder="bposd", osd_impl="host"),
                                   dict(decoder="bposd", osd_method="combination_sweep",
                                        osd_order=8),
                                   dict(decoder="minsum", damping=0.5)],
                         ids=["bposd", "bposd_minsum", "bposd_host", "bposd_cs", "minsum"])
def test_detector_decoder_matches_reference(knobs):
    det, obs = records(D3, 24, 3, scale=3.0)
    ref = RefDetector.from_dem(str(D3), 20, **knobs)
    port = pt.DetectorGraphDecoder.from_dem(str(D3), 20, device="cpu", **knobs)
    g_ref, c_ref = ref.batch_decode(det)
    g, c = port.batch_decode(det)
    f_ref, _ = ref.predict_observables(det)
    f, _ = port.predict_observables(det)
    assert g.dtype == np.int8 and np.array_equal(c, c_ref)
    assert c.any() and not c.all(), "the case needs lanes that fail and that converge"
    if knobs.get("decoder", "bposd") != "bposd":
        assert np.array_equal(g, g_ref) and np.array_equal(f, f_ref)
        return
    soft = port.inner.bp(torch.as_tensor(det), port.inner.bp.as_prior(port._prior))[3]
    soft = soft.float().numpy()
    ref_soft = np.asarray(ref.inner._bp_fn(np.asarray(det), ref.inner._prior_fn(
        ref._prior))[3], np.float32)
    if knobs.get("inner") == "minsum":  # LLRs bitwise: no reliability ties to allow
        assert np.array_equal(soft.view(np.uint32), ref_soft.view(np.uint32))
    ties = tie_lanes(ref_soft, soft)
    assert_lanes_equal(g_ref, g, np.asarray(port.A.todense()), det, ties, f"detector {knobs}")
    same = ~np.isin(np.arange(24), ties)
    assert np.array_equal(f[same], f_ref[same])


def test_detector_decoder_validation_and_densify():
    import scipy.sparse as sp

    with pytest.raises(ValueError, match="priors must be"):
        pt.DetectorGraphDecoder(np.eye(3, dtype=np.uint8), [0.1, 0.1], 5, device="cpu")
    with pytest.raises(ValueError, match="strictly"):
        pt.DetectorGraphDecoder(np.eye(2, dtype=np.uint8), [0.1, 1.0], 5, device="cpu")
    with pytest.raises(ValueError, match="observables must be"):
        pt.DetectorGraphDecoder(np.eye(2, dtype=np.uint8), [0.1, 0.1], 5,
                                observables=np.ones((1, 3), np.uint8), device="cpu")
    # bit-flip is ported but takes no prior: refused as the reference does
    with pytest.raises(ValueError, match="cannot honor per-mechanism priors"):
        pt.DetectorGraphDecoder(np.eye(2, dtype=np.uint8), [0.1, 0.1], 5, decoder="bitflip",
                                device="cpu")
    with pytest.raises(NotImplementedError, match="'layered_minsum' is not ported"):
        pt.DetectorGraphDecoder(np.eye(2, dtype=np.uint8), [0.1, 0.1], 5,
                                decoder="layered_minsum", device="cpu")
    dec = pt.DetectorGraphDecoder(np.eye(2, dtype=np.uint8), [0.1, 0.1], 10, device="cpu")
    with pytest.raises(ValueError, match="no observables"):
        dec.predict_observables(np.zeros((1, 2), np.uint8))
    with pytest.raises(ValueError, match="detectors"):
        dec.batch_decode(np.zeros((1, 5), np.uint8))
    # above the 4M-entry auto-densify threshold the bposd inner is given
    # the dense matrix deliberately (the reference's rule); its lane is past
    # a block of the elimination kernels, so the device OSD raises and the
    # host OSD is the caller's choice
    m, n = 1500, 3000
    A_big = sp.eye(m, n, dtype=np.uint8, format="csr")
    with pytest.raises(NotImplementedError, match="pass osd_impl='host'"):
        pt.DetectorGraphDecoder(A_big, np.full(n, 0.01), max_iters=5, device="cpu")
    big = pt.DetectorGraphDecoder(A_big, np.full(n, 0.01), max_iters=5, osd_impl="host",
                                  device="cpu")
    assert big.inner.graph.H is not None and big.inner.osd_impl == "host"
    syn = np.zeros((2, m), np.uint8)
    syn[1, 7] = 1
    x, conv = big.batch_decode(syn)
    assert conv.all() and x[1, 7] == 1 and x[0].sum() == 0


# -- the ensemble ---------------------------------------------------------

def ensemble_case():
    H = lt.parity_check_matrix(240, 8, 4, rng=17)
    rng = np.random.default_rng(21)
    syns = (((rng.random((24, 240)) < 0.06) @ H.T) % 2).astype(np.uint8)
    return H, syns


@pytest.mark.parametrize("priors", [False, True])
@pytest.mark.parametrize("kind", ["fused", "sequential"])
def test_ensemble_matches_reference(kind, priors):
    """Damping variants of one min-sum fuse into one lane-damped decode;
    mixed members run the sequential loop; both bitwise, with and without
    ML priors."""
    H, syns = ensemble_case()
    pr = np.random.default_rng(2).uniform(0.01, 0.1, 240) if priors else None

    def members(mod, **cpu):
        if kind == "fused":
            return [mod.MinSumDecoder(H, 0.06, 12, damping=d, **cpu) for d in (0.0, 0.3, 0.6)]
        return [mod.MinSumDecoder(H, 0.06, 12, damping=0.3, **cpu),
                mod.MinSumDecoder(H, 0.06, 12, alpha=0.75, **cpu),
                mod.BeliefPropagationDecoder(H, 0.06, 12, **cpu)]

    ref = RefEnsemble(members(lt), priors=pr)
    port = pt.EnsembleDecoder(members(pt, device="cpu"), priors=pr)
    assert (port.fused is not None) == (kind == "fused")
    assert (ref._fused_gammas is not None) == (kind == "fused")
    for per in (None, 0.05):
        w = ref.batch_decode_detailed(syns, per=per)
        g = port.batch_decode_detailed(syns, per=per)
        for a, b in zip(w[:3], g[:3]):
            assert np.array_equal(np.asarray(a), b)
        score = np.asarray(w[3]["ml_score"])
        if kind == "fused" and priors:
            # a float32 sum of the flipped positions' weights, added in
            # another order than XLA's: within 1e-5 relative (at most 240
            # terms of one sign, each rounding 2**-24 relative)
            np.testing.assert_allclose(g[3]["ml_score"], score, rtol=1e-5, atol=0)
        else:  # integer Hamming weights, or the same numpy float64 sums
            assert np.array_equal(score.astype(g[3]["ml_score"].dtype), g[3]["ml_score"])
        assert w[1].any() and not w[1].all(), "the case needs shots no member solves"


def test_ensemble_with_a_prior_vector_on_member_0():
    """A member 0 with a per-bit prior vector: the reference's fuse test
    compares the priors with ``!=`` and raises; the port takes the
    sequential loop and decodes as the members do one by one."""
    H, syns = ensemble_case()
    pvec = np.full(240, 0.06)
    pvec[::7] = 0.03
    ref_members = [lt.MinSumDecoder(H, pvec, 12, damping=0.2),
                   lt.MinSumDecoder(H, 0.06, 12, damping=0.4)]
    with pytest.raises(ValueError, match="truth value"):
        RefEnsemble(ref_members)
    port = pt.EnsembleDecoder([pt.MinSumDecoder(H, pvec, 12, damping=0.2, device="cpu"),
                               pt.MinSumDecoder(H, 0.06, 12, damping=0.4, device="cpu")])
    assert port.fused is None
    g, c, i, aux, _ = port.batch_decode_detailed(syns)
    # the sequential pick, rebuilt from the reference's members
    outs = [m.batch_decode_detailed(syns)[:3] for m in ref_members]
    consistent = [(((o[0].astype(np.int64) @ H.T) % 2) == syns).all(1) for o in outs]
    w = [np.where(cs, o[0].astype(np.float64).sum(1), np.inf) for o, cs in zip(outs, consistent)]
    pick = np.where(w[1] < w[0], 1, 0)
    assert np.array_equal(g, np.where(pick[:, None] == 1, outs[1][0], outs[0][0]))
    assert np.array_equal(c, consistent[0] | consistent[1])
    assert np.array_equal(i, outs[0][2] + outs[1][2])


def test_ensemble_validation():
    H, _ = ensemble_case()
    with pytest.raises(ValueError, match="at least one"):
        pt.EnsembleDecoder([])
    other = pt.MinSumDecoder(lt.parity_check_matrix(120, 6, 3, rng=51), 0.05, 5, device="cpu")
    with pytest.raises(ValueError, match="ensemble is"):
        pt.EnsembleDecoder([pt.MinSumDecoder(H, 0.05, 5, device="cpu"), other])
    with pytest.raises(ValueError, match="priors must be"):
        pt.EnsembleDecoder([other], priors=np.full(3, 0.1))
    with pytest.raises(ValueError, match="H must be"):
        pt.EnsembleDecoder([other], H=np.eye(3, dtype=np.uint8))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pt.EnsembleDecoder([other]).fused is None  # one member: nothing to fuse
