"""The plain references against the program, bit for bit, at small sizes on the CPU."""

import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from conftest import BENCH, tiny_dem_arrays

import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu_torch.native import gf2_osd_cs_host, gf2_pack_cols
from portbench import inputs
from portbench.reference import minsum as ref_minsum
from portbench.reference import osd as ref_osd
from portbench.reference import staged as ref_staged


def test_gallager_construction_matches_program():
    want = pt.parity_check_matrix(1000, 10, 9, rng=42)
    assert np.array_equal(inputs.gallager_pcm(1000, 10, 9, 42), want)


@pytest.mark.parametrize("layout", ["var", "check"])
@pytest.mark.parametrize("per,damping,check_every", [(0.02, 0.0, 1), (0.06, 0.0, 1),
                                                     (0.06, 0.3, 1), (0.04, 0.0, 4)])
def test_minsum_matches_program(layout, per, damping, check_every):
    rng = np.random.default_rng(11)
    H = pt.parity_check_matrix(120, 6, 3, rng=5)
    syn = ((rng.random((64, 120)) < per).astype(np.uint8) @ H.T % 2).astype(np.uint8)
    dec = pt.MinSumDecoder(H, per, 30, device="cpu", layout=layout, damping=damping,
                           check_every=check_every)
    err, conv, iters, aux, _ = dec.batch_decode_detailed(syn)
    ref = ref_minsum.decode_stated(H, np.full(120, per), {
        "max_iters": 30, "damping": damping, "check_every": check_every}, syn, "cpu")
    assert np.array_equal(err, ref["err"])
    assert np.array_equal(conv, ref["converged"])
    assert np.array_equal(iters, ref["iters"])
    assert np.array_equal(aux["llrs"], ref["llrs"])


@pytest.mark.parametrize("trial", range(12))
def test_osd_cs_matches_native(trial):
    rng = np.random.default_rng(100 + trial)
    m, n = int(rng.integers(8, 40)), int(rng.integers(40, 150))
    M = (rng.random((m, n)) < rng.uniform(0.05, 0.3)).astype(np.uint8)
    L = 5
    syn = ((rng.random((L, n)) < 0.1).astype(np.uint8) @ M.T % 2).astype(np.uint8)
    bp = (rng.random((L, n)) < 0.2).astype(np.uint8)
    order = np.argsort(rng.random((L, n)), axis=1).astype(np.int32)
    lam = int(rng.integers(0, 12))
    want, want_ok = gf2_osd_cs_host(gf2_pack_cols(M), m, lam, order, bp, syn)
    got, ok = ref_osd.osd_cs(torch.as_tensor(M), torch.as_tensor(syn), torch.as_tensor(bp),
                             torch.as_tensor(order.astype(np.int64)), lam)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ok.numpy(), want_ok)


def test_staged_matches_program():
    A, O, priors = tiny_dem_arrays()
    rng = np.random.default_rng(4)
    syn = ((rng.random((200, A.shape[1])) < priors).astype(np.uint8) @ A.T % 2).astype(np.uint8)
    s = dict(gammas=[0.4], stage0_iters=16, deep_iters=60, lam=10, check_every=8, layout="check")
    dec = pt.StagedDemDecoder(sp.csr_matrix(A), priors, observables=O, device="cpu",
                              hbm_bytes=8 << 30, **s)
    err, conv, iters, _, _ = dec.batch_decode_detailed(syn)
    ref = ref_staged.decode_stated(sp.csr_matrix(A), priors, s, syn, "cpu")
    assert len(ref["osd"]) > 20  # the sample reaches the host OSD
    assert np.array_equal(err, ref["err"])
    assert np.array_equal(conv, ref["converged"])
    assert np.array_equal(iters, ref["iters"])


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.minsum, portbench.reference.osd, "
            "portbench.reference.staged; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ldpcdecoders_tpu_torch', 'ldpcdecoders_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
