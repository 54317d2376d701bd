"""The port's decode API takes ``seed=`` where the JAX package's does.

``seed`` keys a randomized decoder's draws in the reference (bit-flip
tie-breaks); every decoder of the port is deterministic and ignores it.
Each port decoder is called with ``seed=0`` and ``seed=5`` on the seeded
numpy syndromes of ``parity_check_matrix(60, 3, 4)`` (the QC decoders on a
small lift, the space-time decoders on bb72 records), and every output must
equal the call without ``seed``.
"""

import inspect

import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.models.detector import DetectorGraphDecoder as RefDetectorGraphDecoder
from ldpcdecoders_tpu.models.ensemble import EnsembleDecoder as RefEnsembleDecoder
from ldpcdecoders_tpu.models.spacetime import SpaceTimeDecoder as RefSpaceTimeDecoder
from ldpcdecoders_tpu.models.staged import StagedDemDecoder as RefStagedDemDecoder

torch.set_num_threads(1)

H = pt.parity_check_matrix(60, 3, 4, rng=11)
QC_BASE = pt.random_qc_base_matrix(8, 4, 2, 6, rng=2)


def _pcm_syndromes(Hm, B, per, seed):
    errs = np.random.default_rng(seed).random((B, Hm.shape[1])) < per
    return ((errs.astype(np.int64) @ Hm.T) % 2).astype(np.uint8)


def _bb72_records(dec, B, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((B, dec.n_cols)) < dec._prior[None, :]).astype(np.uint8)
    return (x @ dec.A.T.toarray() % 2).astype(np.uint8)


DECODERS = {
    "bp": lambda: pt.BeliefPropagationDecoder(H, 0.05, 10, device="cpu"),
    "minsum": lambda: pt.MinSumDecoder(H, 0.05, 10, device="cpu"),
    "bposd0": lambda: pt.BeliefPropagationOSDDecoder(H, 0.05, 10, device="cpu"),
    "bposd2": lambda: pt.BeliefPropagationOSDDecoder(H, 0.05, 10, osd_order=2, device="cpu"),
    "bposd_minsum": lambda: pt.BeliefPropagationOSDDecoder(H, 0.05, 10, inner="minsum",
                                                           device="cpu"),
    "qc_layered": lambda: pt.QCMinSumDecoder(QC_BASE, 6, 0.05, 10, schedule="layered",
                                             device="cpu"),
    "qc_lifted": lambda: pt.QCMinSumDecoder(QC_BASE, 6, 0.05, 10, backend="lifted",
                                            device="cpu"),
    "bposd_cs": lambda: pt.BeliefPropagationOSDDecoder(
        H, 0.05, 10, osd_order=6, osd_method="combination_sweep", device="cpu"),
    "bposd_host": lambda: pt.BeliefPropagationOSDDecoder(H, 0.05, 10, osd_impl="host",
                                                         device="cpu"),
    "ensemble": lambda: pt.EnsembleDecoder([pt.MinSumDecoder(H, 0.05, 10, damping=d,
                                                             device="cpu") for d in (0, 0.5)]),
    "detector": lambda: pt.DetectorGraphDecoder(H, np.full(60, 0.05), 10, device="cpu"),
    "staged": lambda: pt.StagedDemDecoder(H, np.full(60, 0.05), gammas=(0.3, (0.0, 0.5)),
                                          stage0_iters=8, deep_iters=16, lam=6, relay_legs=1,
                                          device="cpu"),
    "spacetime_bposd": lambda: pt.SpaceTimeDecoder(H, 2, 0.03, 10, device="cpu"),
    "spacetime_bb72": lambda: pt.SpaceTimeDecoder.for_bicycle("bb72", "x", 2, 0.01, 10,
                                                              device="cpu"),
}


def _inputs(name, dec):
    if name == "spacetime_bb72":
        return _bb72_records(dec, 6, 3)
    if name.startswith("qc"):
        return _pcm_syndromes(pt.qc_lift(QC_BASE, 6), 6, 0.06, 3)
    return _pcm_syndromes(H if name != "spacetime_bposd" else dec.A.toarray(), 6, 0.08, 3)


def _flat(out):
    """The arrays of a decode's output, in order (aux dictionaries opened)."""
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [a for x in out for a in _flat(x)]
    if isinstance(out, (np.ndarray, torch.Tensor, bool, np.bool_)):
        return [np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)]
    return []  # DecodeStats: a summary of the arrays above


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", sorted(DECODERS))
def test_seed_is_accepted_and_changes_nothing(name, seed):
    dec = DECODERS[name]()
    syn = _inputs(name, dec)
    calls = {
        "batch_decode": lambda **kw: dec.batch_decode(syn, **kw),
        "batch_decode_detailed": lambda **kw: dec.batch_decode_detailed(syn, **kw),
        "batch_decode_async": lambda **kw: dec.batch_decode_async(torch.as_tensor(syn), **kw),
        "batch_decode_detailed_async": lambda **kw: dec.batch_decode_detailed_async(
            torch.as_tensor(syn), **kw),
        "decode": lambda **kw: dec.decode(syn[1], **kw),
        "decode_per": lambda **kw: dec.decode(syn[2], per=0.07, **kw),
    }
    for what, call in calls.items():
        want = _flat(call())
        got = _flat(call(seed=seed))
        assert len(got) == len(want) > 0, what
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what
    if name.startswith("spacetime"):
        hist = np.random.default_rng(4).random((3, dec.rounds, dec.block_m)) < 0.1
        want = dec.decode_history(hist.astype(np.uint8))
        got = dec.decode_history(hist.astype(np.uint8), seed=seed)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("seed", [0, 5])
def test_decode_soft_takes_seed(seed):
    dec = pt.MinSumDecoder(H, 0.05, 10, device="cpu")
    llrs = np.random.default_rng(6).normal(2.0, 1.5, size=(5, H.shape[1]))
    want = pt.decode_soft(dec, llrs)
    got = pt.decode_soft(dec, llrs, seed=seed)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


PUBLIC = ("decode", "batch_decode", "batch_decode_async", "batch_decode_detailed",
          "batch_decode_detailed_async", "decode_history")


@pytest.mark.parametrize("port_cls,ref_cls", [
    (pt.Decoder, lt.models.base.Decoder),
    (pt.SpaceTimeDecoder, RefSpaceTimeDecoder),
    (pt.BeliefPropagationDecoder, lt.BeliefPropagationDecoder),
    (pt.MinSumDecoder, lt.MinSumDecoder),
    (pt.BeliefPropagationOSDDecoder, lt.BeliefPropagationOSDDecoder),
    (pt.QCMinSumDecoder, lt.QCMinSumDecoder),
    (pt.DetectorGraphDecoder, RefDetectorGraphDecoder),
    (pt.EnsembleDecoder, RefEnsembleDecoder),
    (pt.StagedDemDecoder, RefStagedDemDecoder),
])
def test_no_seedless_signature_the_reference_has(port_cls, ref_cls):
    """Every public decode method and ``_decode_batch`` of the reference that
    takes ``seed`` takes it in the port too, with the same default."""
    for name in (*PUBLIC, "_decode_batch"):
        ref = getattr(ref_cls, name, None)
        if ref is None or "seed" not in inspect.signature(ref).parameters:
            continue
        got = inspect.signature(getattr(port_cls, name)).parameters
        want = inspect.signature(ref).parameters["seed"]
        assert "seed" in got, f"{port_cls.__name__}.{name}"
        assert got["seed"].default == (0 if want.default is inspect.Parameter.empty
                                       else want.default), f"{port_cls.__name__}.{name}"
    assert "seed" in inspect.signature(pt.decode_soft).parameters
