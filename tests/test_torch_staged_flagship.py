"""The staged decoder's flagship tier against the benchmark's plain reference.

``StagedDemDecoder`` with six members (one damped, five disordered-memory
pairs), bfloat16 deep messages, relay legs and the host OSD-CS with triples
(``lam3``), held bit for bit against ``portbench/reference/relay.py`` on a
small seeded DEM (column weights 1-3, so every variable sums its messages
one slot at a time): the error estimate, the converged flag and the
iteration count of every shot.  The reference's triple sweep
(``portbench/reference/osd3.py``) is held against the native OSD-CS on
random lanes; a shot decodes the same alone and in a bucket; and stage 0
in bfloat16 (the configuration's control) differs from the reference.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu_torch.native import gf2_osd_cs_host, gf2_pack_cols

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from portbench.reference import osd3 as ref_osd3  # noqa: E402
from portbench.reference import relay as ref_relay  # noqa: E402

sys.path.remove(ROOT)

PAIR = [-0.24, 0.66]


def random_dem(seed, D=48, N=260):
    """``A [D, N]`` with column weights 1-3 and priors from four levels."""
    rng = np.random.default_rng(seed)
    A = np.zeros((D, N), np.uint8)
    for j in range(N):
        A[rng.choice(D, rng.integers(1, 4), replace=False), j] = 1
    priors = np.array([0.004, 0.01, 0.02, 0.03])[rng.integers(0, 4, N)]
    return sp.csr_matrix(A), priors


def records(A, priors, S, seed, scale):
    rng = np.random.default_rng(seed)
    x = (rng.random((S, A.shape[1])) < scale * priors).astype(np.uint8)
    return (x @ A.T.toarray() % 2).astype(np.uint8)


def stated(relay_legs=3, lam3=8):
    return dict(gammas=[0.4] + [PAIR] * 5, stage0_iters=16, deep_iters=24, relay_iters=24,
                relay_legs=relay_legs, relay_range=PAIR, lam=10, lam3=lam3, check_every=8,
                alpha=1.0, dtype="float32", deep_dtype="bfloat16", osd_rank="abs_llr",
                layout="check", dmem_seed=0xD3E, relay_seed=0xE1A9)


def program(A, priors, s, **extra):
    """The decoder the stated settings describe, as the configuration builds it."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    kw = dict(gammas=s["gammas"], stage0_iters=s["stage0_iters"], deep_iters=s["deep_iters"],
              relay_iters=s["relay_iters"], relay_legs=s["relay_legs"],
              relay_range=s["relay_range"], lam=s["lam"], lam3=s["lam3"],
              check_every=s["check_every"], layout=s["layout"], dtype=dtypes[s["dtype"]],
              deep_dtype=dtypes[s["deep_dtype"]], min_bucket=4, hbm_bytes=8 << 30)
    kw.update(extra)
    return pt.StagedDemDecoder(A, priors, device="cpu", **kw)


@pytest.mark.parametrize("dem_seed,syn_seed,scale,legs,lam3", [
    (3, 4, 3.0, 3, 8),   # relay legs solve lanes, triples reach the OSD
    (7, 5, 2.5, 3, 12),
    (3, 6, 3.0, 0, 8),   # no relay: the OSD from the deep members
])
def test_flagship_matches_reference_bitwise(dem_seed, syn_seed, scale, legs, lam3):
    A, priors = random_dem(dem_seed)
    syn = records(A, priors, 96, syn_seed, scale)
    s = stated(legs, lam3)
    err, conv, iters, _, _ = program(A, priors, s).batch_decode_detailed(syn)
    ref = ref_relay.decode_stated(A, priors, s, syn, "cpu")
    assert np.array_equal(err, ref["err"])
    assert np.array_equal(conv, ref["converged"])
    assert np.array_equal(iters, ref["iters"])
    cap0, deep = s["stage0_iters"], s["deep_iters"]
    assert ((iters > cap0) & (iters <= cap0 + deep) & conv).any()  # the deep ensemble solves
    if legs:
        assert ((iters > cap0 + deep) & conv).any()  # relay legs solve lanes
    assert len(ref["osd"]) > 3 and (~conv).sum() == len(ref["osd"])  # the host OSD is reached
    assert np.array_equal((err.astype(np.int64) @ A.T.toarray()) % 2, syn)


def random_lanes(trial, L=6):
    """A random matrix, L lanes of syndromes, hard decisions and column
    orders, and sweep depths with ``lam3`` of at least 3."""
    rng = np.random.default_rng(300 + trial)
    m, n = int(rng.integers(8, 40)), int(rng.integers(40, 150))
    M = (rng.random((m, n)) < rng.uniform(0.05, 0.3)).astype(np.uint8)
    syn = ((rng.random((L, n)) < 0.1).astype(np.uint8) @ M.T % 2).astype(np.uint8)
    bp = (rng.random((L, n)) < 0.2).astype(np.uint8)
    order = np.argsort(rng.random((L, n)), axis=1).astype(np.int32)
    return M, syn, bp, order, int(rng.integers(0, 12)), int(rng.integers(3, 14))


@pytest.mark.parametrize("trial", range(10))
def test_triple_sweep_matches_native(trial):
    M, syn, bp, order, lam, lam3 = random_lanes(trial)
    want, want_ok = gf2_osd_cs_host(gf2_pack_cols(M), M.shape[0], lam, order, bp, syn,
                                    lam3=lam3)
    got, ok = ref_osd3.osd_cs(torch.as_tensor(M), torch.as_tensor(syn), torch.as_tensor(bp),
                              torch.as_tensor(order.astype(np.int64)), lam, lam3)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ok.numpy(), want_ok)


def test_triples_change_answers_on_the_sample():
    """The trials above reach the triple branch: ``lam3`` moves some answers."""
    moved = 0
    for trial in range(10):
        M, syn, bp, order, lam, lam3 = random_lanes(trial)
        args = (gf2_pack_cols(M), M.shape[0], lam, order, bp, syn)
        moved += int((gf2_osd_cs_host(*args, lam3=lam3)[0]
                      != gf2_osd_cs_host(*args, lam3=0)[0]).any(axis=1).sum())
    assert moved > 0


@pytest.mark.parametrize("side", ["program", "reference"])
def test_a_shot_decodes_the_same_alone(side):
    A, priors = random_dem(3)
    syn = records(A, priors, 48, 4, 3.0)
    s = stated()
    if side == "program":
        dec = program(A, priors, s)

        def decode(x):
            return dec.batch_decode_detailed(x)[:3]
    else:
        def decode(x):
            r = ref_relay.decode_stated(A, priors, s, x, "cpu")
            return r["err"], r["converged"], r["iters"]
    err, conv, iters = decode(syn)
    cap0, deep = s["stage0_iters"], s["deep_iters"]
    # a shot of each fate: the deep ensemble, a relay leg, the OSD
    picks = [np.flatnonzero(mask)[0] for mask in (
        (iters > cap0) & (iters <= cap0 + deep) & conv, (iters > cap0 + deep) & conv, ~conv)]
    for r in picks:
        e1, c1, i1 = decode(syn[r:r + 1])
        assert np.array_equal(e1[0], err[r]) and c1[0] == conv[r] and i1[0] == iters[r]


def test_stage0_in_bfloat16_differs_from_the_reference():
    A, priors = random_dem(3)
    syn = records(A, priors, 96, 4, 3.0)
    s = stated()
    err, conv, iters, _, _ = program(A, priors, s, dtype=torch.bfloat16).batch_decode_detailed(
        syn)
    ref = ref_relay.decode_stated(A, priors, s, syn, "cpu")
    same = (err == ref["err"]).all(axis=1) & (conv == ref["converged"]) & (iters == ref["iters"])
    assert (~same).sum() > 0


def test_reference_refuses_what_it_does_not_state():
    s = stated()
    for bad in (dict(s, osd_rank="legacy"), dict(s, gammas=[PAIR] * 2),
                {k: v for k, v in s.items() if k != "relay_seed"}):
        with pytest.raises(NotImplementedError):
            ref_relay.check_settings(bad)


class _Members(torch.nn.Module):
    """A deep decode that returns fixed member outputs (every lane converged)."""

    def __init__(self, err):
        super().__init__()
        self.err = err

    def forward(self, syn, L0, gamma):
        B = self.err.shape[0]
        return (self.err, torch.ones(B, dtype=torch.bool), torch.full((B,), 8, dtype=torch.int32),
                torch.zeros(self.err.shape))


@pytest.mark.parametrize("flips,want", [
    # member 0's exact score is 1 (2**24 + 1 - 2**24), which a float32 sum may
    # round to 0; member 1's is 0.5: the exact pick is member 1
    (([0, 1, 2], [3]), 1),
    # equal exact scores: the first member wins
    (([3], [4]), 0),
])
def test_deep_pick_is_exact_and_first_on_ties(flips, want):
    A, priors = random_dem(3)
    dec = program(A, priors, stated(), gammas=[0.4, 0.3])
    N = dec.N
    llr0 = torch.zeros(N, dtype=torch.float32)
    llr0[:5] = torch.tensor([2.0 ** 24, 1.0, -(2.0 ** 24), 0.5, 0.5])
    err = torch.zeros((2, N), dtype=torch.int8)
    for k, cols in enumerate(flips):
        err[k, cols] = 1
    dec.deep = _Members(err)
    det = torch.zeros((1, A.shape[0]), dtype=torch.uint8)
    pick, solved, _, _, _ = dec._deep_step(det, llr0, llr0, dec.gamma_arg)
    assert bool(solved[0]) and torch.equal(pick[0], err[want])
