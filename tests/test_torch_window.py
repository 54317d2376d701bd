"""Port parity: sliding-window and windowed-DEM streaming decoders.

The same seeded numpy streams go through ``ldpcdecoders_tpu`` (JAX on the
CPU) and ``ldpcdecoders_tpu_torch`` on the CPU.  Tolerances:

  * ``SlidingWindowDecoder`` (the cases of tests/test_spacetime.py's
    windowed tests): the cumulative corrections bitwise, ``converged``
    within 1e-6 (a mean of float32 means), with the bposd inner (the
    reference builds it ``fused=True``, output-identical to the eager inner
    the port runs) and the min-sum inner;
  * ``WindowedDemDecoder`` (tests/test_demwindow.py's synthetic DEMs) with
    the bposd and min-sum inners: the mechanisms bitwise; with the staged
    inner (its relay draws and FMA-contracted damping differ from the
    reference's), the telescoping identity and every column committed once.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.codes.spacetime import spacetime_pcm, spacetime_prior
from ldpcdecoders_tpu.models.demwindow import WindowedDemDecoder as RefDemWindow
from ldpcdecoders_tpu.models.window import SlidingWindowDecoder as RefWindow
from ldpcdecoders_tpu.utils.noise import sample_errors, syndromes_of

torch.set_num_threads(1)


def history(H, b, rounds, per, q, rng):
    """tests/test_spacetime.py's ``_history``: ``b`` shots of ``rounds``
    noisy rounds, the last perfect; ``(syndromes [b, R, m], final error)``."""
    m, n = H.shape
    e = sample_errors(rng, b * rounds, n, per).reshape(b, rounds, n)
    cum = (np.cumsum(e, axis=1) & 1).astype(np.uint8)
    syn = np.stack([syndromes_of(H, cum[:, r]) for r in range(rounds)], axis=1)
    u = sample_errors(rng, b * rounds, m, q).reshape(b, rounds, m)
    u[:, -1] = 0
    return (syn ^ u.astype(np.uint8)).astype(np.uint8), cum[:, -1]


WINDOW_CASES = [
    dict(R=9, per=0.01, B=48, W=3, C=1, seed=21, decoder="bposd"),
    dict(R=9, per=0.015, B=64, W=4, C=2, seed=23, decoder="bposd"),
    dict(R=9, per=0.01, B=48, W=3, C=1, seed=21, decoder="minsum"),
    dict(R=3, per=0.01, B=16, W=4, C=2, seed=29, decoder="bposd"),  # one closed decode
]


@pytest.mark.parametrize("case", WINDOW_CASES,
                         ids=["w3c1_bposd", "w4c2_bposd", "w3c1_minsum", "short"])
def test_sliding_window_matches_reference(case):
    H = lt.toric_code_x(3)
    syn, _ = history(H, case["B"], case["R"], case["per"], case["per"],
                     np.random.default_rng(case["seed"]))
    kw = dict(window=case["W"], commit=case["C"], decoder=case["decoder"])
    port = pt.SlidingWindowDecoder(H, case["per"], 50, device="cpu", **kw)
    ref = RefWindow(H, case["per"], 50, **kw)
    E, info = port.decode_stream(syn, seed=5)
    E_ref, info_ref = ref.decode_stream(syn, seed=5)
    assert E.dtype == np.int8 and np.array_equal(E, np.asarray(E_ref))
    assert info["windows"] == info_ref["windows"] and info["rounds"] == case["R"]
    assert abs(info["converged"] - info_ref["converged"]) <= 1e-6
    if case["decoder"] == "bposd":
        # the stream telescopes: the estimate reproduces the final syndrome
        assert np.array_equal(syndromes_of(H, E.astype(np.uint8)), syn[:, -1])
    if case["R"] <= case["W"]:
        assert info["windows"] == 1


def test_sliding_window_validation_and_config():
    H = lt.toric_code_x(3)
    with pytest.raises(ValueError, match="window"):
        pt.SlidingWindowDecoder(H, 0.01, 10, window=1, device="cpu")
    with pytest.raises(ValueError, match="commit"):
        pt.SlidingWindowDecoder(H, 0.01, 10, window=3, commit=3, device="cpu")
    dec = pt.SlidingWindowDecoder(H, 0.01, 10, device="cpu")
    with pytest.raises(ValueError, match="expected syndromes"):
        dec.decode_stream(np.zeros((2, 4, 5), np.uint8))
    with pytest.raises(ValueError, match="expected detectors"):
        dec.decode_detector_stream(np.zeros((2, 4), np.uint8))
    kw = dict(kind="window", per=0.01, max_iters=30, window=3, commit=1, inner_kind="minsum")
    built = pt.DecoderConfig.from_json(lt.DecoderConfig(**kw).to_json()).build(H, device="cpu")
    ref = lt.DecoderConfig(**kw).build(H)
    assert isinstance(built, pt.SlidingWindowDecoder) and built.window == 3
    syn, _ = history(H, 8, 6, 0.01, 0.01, np.random.default_rng(2))
    assert np.array_equal(built.decode_stream(syn)[0], np.asarray(ref.decode_stream(syn)[0]))


def toric_stream(R=8, per=0.01, q=0.01, B=32, seed=0):
    """tests/test_demwindow.py's ``_toric_stream``."""
    H = lt.toric_code_x(3)
    m, n = H.shape
    A = spacetime_pcm(H, R)
    pr = spacetime_prior(n, m, R, per, q)
    rng = np.random.default_rng(seed)
    x = (rng.random((B, A.shape[1])) < pr).astype(np.uint8)
    det = np.asarray((A @ x.T).T % 2, np.uint8)
    return H, np.asarray(A.todense()), pr, x, det, m


@pytest.mark.parametrize("decoder", ["bposd", "minsum"])
def test_windowed_dem_matches_reference(decoder):
    _, A, pr, _, det, m = toric_stream(B=24, seed=4)
    kw = dict(detectors_per_round=m, window=3, commit=1, decoder=decoder, max_iters=40)
    port = pt.WindowedDemDecoder(A, pr, device="cpu", **kw)
    ref = RefDemWindow(A, pr, **kw)
    out, info = port.decode_detector_stream(det)
    out_ref, info_ref = ref.decode_detector_stream(det)
    assert np.array_equal(out, out_ref)
    assert info["windows"] == info_ref["windows"] > 2
    assert abs(info["converged"] - info_ref["converged"]) <= 1e-6
    # zero and single mechanisms
    z = np.zeros((2, A.shape[0]), np.uint8)
    assert not port.decode_detector_stream(z)[0].any()
    one = np.zeros((1, A.shape[1]), np.uint8)
    one[0, A.shape[1] // 2] = 1
    det1 = np.asarray((A @ one.T).T % 2, np.uint8)
    o1, _ = port.decode_detector_stream(det1.reshape(1, -1, m))
    assert np.array_equal(o1, ref.decode_detector_stream(det1)[0])
    if decoder == "bposd":
        np.testing.assert_array_equal((o1.astype(np.int32) @ A.T) % 2, det1.astype(np.int32))


def test_windowed_dem_bulk_windows_share_one_decoder_and_validation():
    _, A, pr, *_, m = toric_stream(R=12)
    wd = pt.WindowedDemDecoder(A, pr, detectors_per_round=m, window=3, commit=1,
                               decoder="minsum", max_iters=16, device="cpu")
    for i in range(len(wd._plan)):
        wd._decoder_for(*wd._window_model(i)[1:3])
    assert len(wd._dec_cache) <= 4, len(wd._dec_cache)
    plan_cols = np.concatenate([wd._window_model(i)[0][wd._window_model(i)[3]]
                                for i in range(len(wd._plan))])
    assert np.array_equal(np.sort(plan_cols), np.arange(A.shape[1]))
    with pytest.raises(ValueError, match="divide"):
        pt.WindowedDemDecoder(A, pr, detectors_per_round=m + 1, device="cpu")
    with pytest.raises(ValueError, match="commit"):
        pt.WindowedDemDecoder(A, pr, detectors_per_round=m, window=3, commit=3, device="cpu")
    with pytest.raises(ValueError, match="rounds < window"):
        pt.WindowedDemDecoder(A, pr, detectors_per_round=m, window=13, commit=1, device="cpu")
    with pytest.raises(ValueError, match="priors must be"):
        pt.WindowedDemDecoder(A, pr[:-1], detectors_per_round=m, device="cpu")
    A3 = np.zeros((8, 3), np.uint8)
    A3[0, 0] = A3[2, 0] = A3[4, 0] = 1  # rounds 0..2 (r=2)
    A3[1, 1] = A3[3, 2] = 1
    with pytest.raises(ValueError, match="spans"):
        pt.WindowedDemDecoder(A3, np.full(3, 0.01), detectors_per_round=2, window=3, commit=2,
                              device="cpu")
    with pytest.raises(ValueError, match="no observables"):
        wd.predict_observables(np.zeros((1, A.shape[0]), np.uint8))
    with pytest.raises(ValueError, match="expected"):
        wd.decode_detector_stream(np.zeros((1, 5), np.uint8))


def test_windowed_dem_staged_inner_telescopes():
    """The staged inner (stage0_iters = min(48, deep_iters)): every window
    is syndrome-consistent within its truncated model, so the committed
    estimate reproduces the whole record, and the observables agree with
    the reference's on most shots."""
    H, A, pr, x, det, m = toric_stream(R=6, B=16, seed=3)
    O = np.zeros((1, A.shape[1]), np.uint8)
    O[0, : 6 * H.shape[1]: H.shape[1]] = 1
    kw = dict(detectors_per_round=m, window=3, commit=1, decoder="staged", max_iters=32,
              observables=O, gammas=(0.2,), lam=8, min_bucket=16)
    wd = pt.WindowedDemDecoder(A, pr, device="cpu", **kw)
    out, info = wd.decode_detector_stream(det)
    np.testing.assert_array_equal(((out.astype(np.int32) @ A.T) % 2).astype(np.uint8), det)
    inner = next(iter(wd._dec_cache.values()))
    assert inner.stage0_iters == 32 and isinstance(inner, pt.StagedDemDecoder)
    flips, _ = wd.predict_observables(det)
    ref_flips, _ = RefDemWindow(A, pr, **kw).predict_observables(det)
    assert (flips == ref_flips).mean() >= 0.75


def host_windows(wd, det, per=None, seed=0):
    """The windows one at a time through each inner's public contract, the
    record kept and updated on the host: ``(err, converged, iters,
    window_converged)`` as the decoder contract defines them."""
    d = det.astype(np.uint8).copy()
    B = d.shape[0]
    err = np.zeros((B, wd.N), np.int8)
    iters = np.zeros(B, np.int64)
    wconv = np.zeros((B, len(wd._plan)), bool)
    for idx, (t, rounds, closed) in enumerate(wd._plan):
        cols, A_w, pr_w, cm = wd._window_model(idx)
        dec = wd._decoder_for(A_w, pr_w)
        x, conv, it, _, _ = dec.batch_decode_detailed(
            d[:, t * wd.r: (t + rounds) * wd.r], seed=seed + idx,
            per=None if per is None else per[cols])
        err[:, cols[cm]] = x[:, cm]
        wconv[:, idx] = conv
        iters += it
        if not closed:
            lo = (t + wd.commit) * wd.r
            flips = (wd.A[lo:, cols[cm]].astype(np.int64) @ x[:, cm].T.astype(np.int64)).T
            d[:, lo:] ^= (flips % 2).astype(np.uint8)
    return err, wconv.all(axis=1), iters, wconv


@pytest.mark.parametrize("decoder", ["minsum", "staged"])
@pytest.mark.parametrize("wc", [(3, 1), (4, 2)], ids=["w3c1", "w4c2"])
def test_windowed_dem_contract(wc, decoder):
    """The decoder contract on the device record: ``err`` bitwise the
    stream's (and the JAX package's, for the min-sum inner), ``converged``
    the AND and ``iters`` the sum over windows of each window's inner."""
    _, A, pr, _, det, m = toric_stream(B=24, seed=6)
    kw = dict(detectors_per_round=m, window=wc[0], commit=wc[1], decoder=decoder,
              max_iters=32)
    if decoder == "staged":
        kw.update(gammas=(0.3,), stage0_iters=8, lam=8, min_bucket=8)
    port = pt.WindowedDemDecoder(A, pr, device="cpu", **kw)
    err, conv, iters, aux, stats = port.batch_decode_detailed(det, seed=3)
    assert err.dtype == np.int8 and err.shape == (24, A.shape[1])
    assert conv.dtype == bool and conv.shape == iters.shape == (24,)
    out, info = port.decode_detector_stream(det, seed=3)
    assert np.array_equal(err, out)
    h_err, h_conv, h_iters, h_wconv = host_windows(port, det, seed=3)
    assert np.array_equal(err, h_err)
    assert np.array_equal(conv, h_conv) and np.array_equal(iters, h_iters)
    assert np.array_equal(aux["window_converged"], h_wconv)
    assert info["converged"] == pytest.approx(h_wconv.mean(axis=0).mean(), abs=1e-12)
    assert stats.batch_size == 24 and info["windows"] == len(port._plan) > 1
    if decoder == "minsum":
        ref_out, _ = RefDemWindow(A, pr, **kw).decode_detector_stream(det, seed=3)
        assert np.array_equal(err, np.asarray(ref_out))
    else:  # each window's staged answer reproduces its rows, so the whole record
        np.testing.assert_array_equal((err.astype(np.int32) @ A.T) % 2, det)


@pytest.mark.parametrize("wc", [(3, 1), (4, 2)], ids=["w3c1", "w4c2"])
def test_windowed_dem_per_vector_is_sliced_and_other_shapes_refused(wc):
    _, A, pr, _, det, m = toric_stream(B=16, seed=8)
    port = pt.WindowedDemDecoder(A, pr, detectors_per_round=m, window=wc[0], commit=wc[1],
                                 decoder="minsum", max_iters=24, device="cpu")
    per = np.clip(pr * np.random.default_rng(1).uniform(0.5, 3.0, pr.size), 1e-4, 0.4)
    err, conv, iters, _, _ = port.batch_decode_detailed(det, per=per)
    h_err, h_conv, h_iters, _ = host_windows(port, det, per=per)
    assert np.array_equal(err, h_err)
    assert np.array_equal(conv, h_conv) and np.array_equal(iters, h_iters)
    for bad in (0.01, per[:-1], np.tile(per, (det.shape[0], 1))):
        with pytest.raises(ValueError, match="per must be"):
            port.batch_decode_detailed(det, per=bad)
