"""BP+OSD-CS on detector error models against the benchmark's plain reference.

``DetectorGraphDecoder(decoder="bposd")`` with a damped min-sum inner
(the variable layout, a check every iteration), OSD-CS on the lanes it
leaves unconverged (``osd_scope="failed"``) and the device OSD path
(``osd_impl="device"``: on the CPU the elimination kernels' plain
versions), held bit for bit against ``portbench/reference/bposd.py`` on
seeded random DEMs: the error estimate, the converged flag and the
iteration count of every shot.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu_torch.models.priors import next_pow2

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from portbench.reference import bposd as ref_bposd  # noqa: E402

sys.path.remove(ROOT)


def random_dem(seed, D=60, N=400):
    """``A [D, N]`` with column weights 1-3, priors in [1e-3, 3e-2]."""
    rng = np.random.default_rng(seed)
    A = np.zeros((D, N), np.uint8)
    for j in range(N):
        A[rng.choice(D, rng.integers(1, 4), replace=False), j] = 1
    priors = np.exp(rng.uniform(np.log(1e-3), np.log(3e-2), N))
    return sp.csr_matrix(A), priors


def records(A, priors, B, seed, scale):
    rng = np.random.default_rng([seed, 1])
    x = (rng.random((B, A.shape[1])) < priors * scale).astype(np.uint8)
    return (x @ A.T.toarray() % 2).astype(np.uint8)


def stated(max_iters, damping, lam):
    return {"max_iters": max_iters, "inner": "minsum", "damping": damping, "alpha": 1.0,
            "check_every": 1, "layout": "var", "dtype": "float32",
            "osd_method": "combination_sweep", "osd_order": lam, "osd_scope": "failed",
            "osd_rank": "max_exp_llr"}


# (seed, batch, noise scale, iterations, damping, lam)
CASES = [(1, 48, 3.0, 30, 0.4, 12), (2, 40, 4.0, 40, 0.4, 40), (3, 64, 2.5, 25, 0.2, 8),
         (4, 33, 5.0, 20, 0.4, 2), (5, 56, 3.5, 30, 0.5, 1)]


@pytest.mark.parametrize("seed,B,scale,iters,damping,lam", CASES)
def test_detector_bposd_cs_matches_reference(seed, B, scale, iters, damping, lam):
    A, priors = random_dem(seed)
    det = records(A, priors, B, seed, scale)
    dec = pt.DetectorGraphDecoder(A, priors, iters, decoder="bposd", inner="minsum",
                                  damping=damping, osd_order=lam,
                                  osd_method="combination_sweep", osd_scope="failed",
                                  device="cpu")
    err, conv, it, aux, _ = dec.batch_decode_detailed(det)
    ref = ref_bposd.decode_stated(A, priors, stated(iters, damping, lam), det, "cpu")
    failing = int((~conv).sum())
    assert failing > 0  # the OSD runs
    assert np.array_equal(err, ref["err"])
    assert np.array_equal(conv, ref["converged"])
    assert np.array_equal(it, ref["iters"])
    # every answer reproduces its record (the DEM's records lie in A's span)
    assert np.array_equal(err.astype(np.uint8) @ A.T.toarray() % 2, det)
    if seed in (1, 2):  # these cases pad their bucket with copies of a lane
        assert next_pow2(failing) > failing


def test_reference_ranks_negative_llrs_last():
    llrs = torch.tensor([[3.0, -0.5, 0.25, -4.0, 3.0, 0.0]])
    order = ref_bposd.reliability_order(llrs)
    # exp(L) where L >= 0, else 1 - exp(L); ties keep their index order
    assert order.tolist() == [[0, 4, 2, 5, 3, 1]]


def test_reference_refuses_other_settings():
    A, priors = random_dem(1, D=8, N=20)
    with pytest.raises(NotImplementedError):
        ref_bposd.decode_stated(A, priors, dict(stated(5, 0.4, 2), osd_scope="all"),
                                np.zeros((1, 8), np.uint8), "cpu")
    with pytest.raises(NotImplementedError):
        ref_bposd.decode_stated(A, priors, dict(stated(5, 0.4, 2), lam3=4),
                                np.zeros((1, 8), np.uint8), "cpu")
