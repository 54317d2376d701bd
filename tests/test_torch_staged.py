"""Port parity: the staged circuit-level decoder (``StagedDemDecoder``).

The same seeded detector records go through the JAX package's decoder, run
op by op (``jax.disable_jit()``: XLA contracts no multiply-add there, ROADMAP
queue 3), and the port's on the CPU: ``out``, ``solved`` and ``iters``
agree bitwise on every lane, in two configurations (one gamma; three
members with a disordered-memory pair, two relay legs, OSD-CS triples, the
check layout and a bfloat16 deep dtype) on two DEMs (the small random DEM
of tests/test_staged.py and ``surface_d3_r3_p005.dem``).  The deep
ensemble's ML pick sums a lane's float32 prior weights exactly (in
float64), XLA in float32; a pick could then differ only where two members'
exact scores lie within XLA's rounding of each other (none does here).

``run_eval`` samples with ``torch.Generator`` (torch cannot reproduce
``jax.random``), so it is held against the port's own synchronous path on
the same draws, as tests/test_staged.py holds the reference's.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.models.detector import load_dem as ref_load_dem
from ldpcdecoders_tpu.models.minsum import make_minsum_decode_fn
from ldpcdecoders_tpu.models.staged import StagedDemDecoder as RefStaged
from ldpcdecoders_tpu_torch.models.staged import draw_mechanisms

torch.set_num_threads(1)

D3 = pathlib.Path(__file__).parent / "fixtures" / "surface_d3_r3_p005.dem"


def _small_dem(seed=0, D=40, N=300, k=3):
    """tests/test_staged.py's DEM: its all-ones columns give variables of
    degree 40, past the 32 slots the reference sums one by one."""
    rng = np.random.default_rng(seed)
    A = (rng.random((D, N)) < 0.08).astype(np.uint8)
    A[:, A.sum(axis=0) == 0] = 1
    pr = np.clip(rng.random(N) * 0.01, 1e-4, 0.01)
    O = (rng.random((k, N)) < 0.1).astype(np.uint8)
    return A, pr, O


def dem(name):
    if name == "small":
        return _small_dem(5)
    A, pr, O = ref_load_dem(str(D3))
    return np.asarray(A.todense()), pr, O


def records(A, pr, B, seed, scale):
    rng = np.random.default_rng(seed)
    x = (rng.random((B, A.shape[1])) < pr * scale).astype(np.uint8)
    return (x @ A.T % 2).astype(np.uint8)


CONFIGS = {
    "one_gamma": dict(gammas=(0.3,), stage0_iters=8, deep_iters=40, lam=12),
    "ensemble_relay": dict(gammas=(0.2, (0.0, 0.5), 0.4), stage0_iters=8, deep_iters=32,
                           lam=10, lam3=8, relay_legs=2, layout="check", deep_dtype="bf16",
                           min_bucket=16),
}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("name", ["small", "surface_d3"])
def test_staged_matches_reference_bitwise(name, config):
    A, pr, O = dem(name)
    det = records(A, pr, 32, 1, 8.0 if name == "small" else 3.0)
    kw = dict(CONFIGS[config])
    kr, kp = dict(kw), dict(kw)
    if kw.get("deep_dtype") == "bf16":
        kr["deep_dtype"], kp["deep_dtype"] = jnp.bfloat16, torch.bfloat16
    port = pt.StagedDemDecoder(A, pr, observables=O, device="cpu", **kp)
    e, c, i, _, _ = port.batch_decode_detailed(det)
    with jax.disable_jit():
        ref = RefStaged(A, pr, observables=O, **kr)
        e_r, c_r, i_r, _, _ = ref.batch_decode_detailed(det)
    assert e.dtype == np.int8 and c.dtype == bool and i.dtype == np.int32
    assert np.array_equal(e, e_r) and np.array_equal(c, c_r) and np.array_equal(i, i_r)
    # lanes in every stage: stage 0, deep (or relay), and the host OSD
    assert (i <= port.stage0_iters).any() and (i > port.stage0_iters).any()
    assert (~c).any(), "the case needs lanes that reach the host OSD"
    assert np.array_equal((e.astype(np.int64) @ A.T) % 2, det)  # OSD lanes consistent


@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_minsum_reads_convergence_only_on_checks(check_every):
    """The loop reads the all-converged flag only after iterations that
    ran the syndrome check; the outputs are the reference's, bitwise, at
    every cadence (max_iters off the grid: the last iteration checks)."""
    A, pr, _ = _small_dem(5)
    det = records(A, pr, 32, 2, 6.0)
    g = lt.TannerGraph.from_pcm(A)
    L0 = np.log((1 - pr) / pr).astype(np.float32)
    kw = dict(damping=0.3, check_every=check_every)
    with jax.disable_jit():
        want = make_minsum_decode_fn(g, pr.mean(), 25, **kw)(jnp.asarray(det), jnp.asarray(L0))
    mod = pt.MinSumDecode(pt.TannerGraph.from_pcm(A), pr.mean(), 25, device="cpu", **kw)
    got = mod(torch.as_tensor(det), torch.as_tensor(L0))
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    iters = got[2].numpy()
    assert (iters < 25).any() and (iters == 25).any()
    # a batch that converges at once stops at the first check
    zero = mod(torch.zeros((4, A.shape[0]), dtype=torch.uint8), torch.as_tensor(L0))
    assert zero[1].all() and (zero[2] == check_every).all()


def test_single_gamma_equals_one_deep_run():
    """tests/test_staged.py:32 on the port: with gammas=(g,), the converged
    lanes equal one deep MinSumDecoder run, and every lane is
    syndrome-consistent."""
    A, pr, O = _small_dem()
    det = records(A, pr, 64, 1, 8.0)
    sd = pt.StagedDemDecoder(A, pr, observables=O, gammas=(0.3,), stage0_iters=32,
                             deep_iters=192, lam=20, check_every=8, device="cpu")
    out, conv = sd.batch_decode(det)
    ref = pt.MinSumDecoder(A, pr.mean(), 192, damping=0.3, check_every=8, device="cpu")
    eref, cref, _, _ = ref.minsum(torch.as_tensor(det), torch.as_tensor(sd._llr0))
    eref, cref = eref.numpy(), cref.numpy()
    assert np.array_equal(conv, cref)
    assert np.array_equal(out[cref], eref[cref])
    assert np.array_equal((out.astype(np.int64) @ A.T) % 2, det)


def replay_fails(sd, A, O, pr, shots, batch, seed):
    """The synchronous path over run_eval's draws."""
    rng0 = np.random.default_rng(seed)
    prior = torch.as_tensor(pr, dtype=torch.float32)
    fails = 0
    for _ in range(shots // batch):
        x = draw_mechanisms(prior, batch, int(rng0.integers(1 << 31))).numpy().astype(np.int64)
        det = (x @ A.T % 2).astype(np.uint8)
        obs_t = (x @ O.T % 2).astype(np.uint8)
        pred, _ = sd.predict_observables(det)
        fails += int((pred != obs_t).any(axis=1).sum())
    return fails


@pytest.mark.parametrize("relay", [0, 2])
def test_run_eval_matches_sync_decode_exactly(relay):
    """tests/test_staged.py:75 on the port: the pipelined evaluator
    (straggler pooling across batches, bucket padding, relay pooling, the
    OSD worker thread) reproduces the synchronous path's verdicts on the
    same torch draws."""
    A, pr, O = _small_dem(seed=5 if not relay else 9)
    gammas = (0.2, 0.4) if not relay else (0.2, (0.0, 0.5))
    sd = pt.StagedDemDecoder(A, pr, observables=O, gammas=gammas, stage0_iters=32,
                             deep_iters=96, lam=16, min_bucket=16, relay_legs=relay,
                             device="cpu")
    shots, batch = 512, 256
    st = sd.run_eval(shots, batch=batch, deep_bucket=32 if relay else 64,
                     pipeline=2 if relay else 3, seed=11 + relay)
    assert st["shots"] == shots and st["device_sampled"] is True
    assert st["fails"] == replay_fails(sd, A, O, pr, shots, batch, 11 + relay)
    prof = st["profile"]
    assert prof["deep_shots"] >= prof["osd_shots"] > 0
    assert prof["osd_consistent"] == prof["osd_shots"]  # reachable syndromes
    assert sum(prof["fails_by_stage"].values()) == st["fails"]
    if relay:
        assert prof["relay_shots"] > 0
    lo, hi = st["logical_ci95"]
    assert lo <= st["logical_rate"] <= hi


def test_draws_follow_the_priors():
    prior = torch.full((3000,), 0.02, dtype=torch.float32)
    x = draw_mechanisms(prior, 200, 5)
    assert x.dtype == torch.float32 and set(x.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(x, draw_mechanisms(prior, 200, 5))
    assert not torch.equal(x, draw_mechanisms(prior, 200, 6))
    rate = float(x.mean())  # 600,000 Bernoulli(0.02) draws: sd 1.8e-4
    assert abs(rate - 0.02) < 1e-3


def test_staged_validation_errors():
    A, pr, O = _small_dem()
    cpu = dict(device="cpu")
    with pytest.raises(ValueError, match="priors"):
        pt.StagedDemDecoder(A, pr[:-1], **cpu)
    with pytest.raises(ValueError, match="strictly"):
        pt.StagedDemDecoder(A, np.where(np.arange(300) == 0, 1.0, pr), **cpu)
    with pytest.raises(ValueError, match="gammas"):
        pt.StagedDemDecoder(A, pr, gammas=(), **cpu)
    with pytest.raises(ValueError, match="observables"):
        pt.StagedDemDecoder(A, pr, observables=O[:, :-1], **cpu)
    with pytest.raises(ValueError, match="dmem range"):
        pt.StagedDemDecoder(A, pr, gammas=((0.5, 0.2),), **cpu)
    with pytest.raises(ValueError, match="damping must be"):
        pt.StagedDemDecoder(A, pr, gammas=(1.0,), **cpu)
    with pytest.raises(ValueError, match="osd_rank"):
        pt.StagedDemDecoder(A, pr, osd_rank="bogus", **cpu)
    with pytest.raises(ValueError, match="relay_range"):
        pt.StagedDemDecoder(A, pr, relay_range=(0.5, 1.5), **cpu)
    sd = pt.StagedDemDecoder(A, pr, gammas=(0.3,), stage0_iters=15, deep_iters=32, lam=8,
                             **cpu)
    assert sd.stage0_iters == 16  # rounded up to the check_every grid
    with pytest.raises(ValueError, match="observables"):
        sd.predict_observables(np.zeros((2, A.shape[0]), np.uint8))
    with pytest.raises(ValueError, match="observables"):
        sd.run_eval(10)


def chunk_case():
    """300 records and a two-member decoder whose stage 0 takes two chunks
    under a 60 MB budget (256 lanes a decode): ``(A, pr, O, det, kw)``."""
    A, pr, O = _small_dem(2)
    kw = dict(observables=O, gammas=(0.3, (0.0, 0.4)), stage0_iters=16, deep_iters=32,
              lam=8)
    return A, pr, O, records(A, pr, 300, 3, 3.0), kw


def test_batch_and_bucket_ceilings_follow_the_memory_model(monkeypatch):
    """Inputs past the stage-0 ceiling decode in chunks with the same
    result; the ceilings come from utils/hbm.py (equal to the reference's
    under hbm_bytes=, given the port's measured headroom)."""
    from ldpcdecoders_tpu.utils import hbm as ref_hbm
    from ldpcdecoders_tpu_torch.utils import hbm

    monkeypatch.setattr(ref_hbm, "_HEADROOM", hbm._HEADROOM)
    A, pr, O, det, kw = chunk_case()
    small = pt.StagedDemDecoder(A, pr, hbm_bytes=60_000_000, device="cpu", **kw)
    ref = RefStaged(A, pr, hbm_bytes=60_000_000, **kw)
    assert (small._max_stage0_batch, small.max_bucket) == (ref._max_stage0_batch,
                                                           ref.max_bucket)
    assert small._max_stage0_batch == 256  # 300 lanes: two chunks
    big = pt.StagedDemDecoder(A, pr, hbm_bytes=80_000_000_000, device="cpu", **kw)
    for a, b in zip(small.batch_decode_detailed(det)[:3], big.batch_decode_detailed(det)[:3]):
        assert np.array_equal(a, b)


def osd_pick_oracle(sd, syn_np, bp_np, order_np, llr0_np):
    """``_host_osd_pick`` as it was before the posterior-free candidate's
    elimination was shared: every candidate through ``gf2_osd_cs_host``."""
    from ldpcdecoders_tpu_torch.native import gf2_osd_cs_host

    K, nf, _ = bp_np.shape
    prior_order = np.argsort(-np.abs(llr0_np), kind="stable").astype(np.int32)
    bp_ext = np.concatenate([bp_np, np.zeros((1, nf, sd.N), np.uint8)])
    order_ext = np.concatenate(
        [order_np, np.broadcast_to(prior_order, (1, nf, sd.N))]).astype(np.int32)
    outs = np.empty((K + 1, nf, sd.N), np.uint8)
    cons = np.empty((K + 1, nf), bool)
    for k in range(K + 1):
        outs[k], cons[k] = gf2_osd_cs_host(sd._Hcols, sd.D, sd.lam, order_ext[k], bp_ext[k],
                                           syn_np, lam3=sd.lam3)
    score = outs.astype(np.float32) @ llr0_np
    score[~cons] = np.inf
    pick = np.argmin(score, axis=0)
    pick[~cons.any(axis=0)] = 0
    return outs[pick, np.arange(nf)], cons.any(axis=0)


def osd_pick_inputs(sd, A, pr, nf, seed):
    """Stage 2's inputs for ``nf`` lanes: syndromes (the last two uniform),
    members' hard decisions and reliability orders."""
    rng = np.random.default_rng(seed)
    syn = records(A, pr, nf, seed, 20.0)
    syn[-2:] = rng.random((2, sd.D)) < 0.5
    bp = (rng.random((sd.K, nf, sd.N)) < 0.02).astype(np.uint8)
    order = np.stack([[rng.permutation(sd.N) for _ in range(nf)]
                      for _ in range(sd.K)]).astype(np.int32)
    return syn, bp, order


@pytest.mark.parametrize("gammas", [(0.3,), (0.3, 0.5)])
def test_host_osd_pick_matches_every_candidate_eliminated(gammas):
    """Stage 2 with the posterior-free candidate's elimination made once
    per channel prior: the outputs of the per-lane eliminations, bitwise,
    for the default priors and a ``per=`` override (a second order), and
    the counters split ``osd_candidates``."""
    from ldpcdecoders_tpu_torch.utils import profiling

    A, pr, O = _small_dem(3)
    sd = pt.StagedDemDecoder(A, pr, observables=O, gammas=gammas, stage0_iters=8,
                             deep_iters=16, lam=12, lam3=5, device="cpu")
    syn, bp, order = osd_pick_inputs(sd, A, pr, 10, 4)
    with profiling.recording() as rec:
        for per in (None, 0.004, None):
            llr0_np = sd._channel(per)[1]
            got = sd._host_osd_pick(syn, bp, order, llr0_np)
            want = osd_pick_oracle(sd, syn, bp, order, llr0_np)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert len(sd._osd_states) == 2
    c = rec.counters
    assert c["osd_lanes"] == 30 and c["osd_fixed_order_lanes"] == 30
    assert c["osd_full_eliminations"] == 30 * sd.K
    assert c["osd_fixed_order_lanes"] + c["osd_full_eliminations"] == c["osd_candidates"]


def test_host_osd_pick_from_worker_threads(monkeypatch):
    """run_eval calls stage 2 from a worker thread: calls there beside one
    on the main thread, all racing to build the shared elimination (more
    threads than cores, a short switch interval), give the same outputs,
    and the elimination is made once."""
    import os
    import sys
    import time
    from concurrent.futures import ThreadPoolExecutor

    from ldpcdecoders_tpu_torch import native

    prepared = []

    def slow_prepare(*a, _prepare=native.gf2_osd_cs_prepare):
        prepared.append(1)
        time.sleep(0.05)  # widens the window in which another call could build it too
        return _prepare(*a)

    monkeypatch.setattr(native, "gf2_osd_cs_prepare", slow_prepare)

    A, pr, O = _small_dem(3)
    sd = pt.StagedDemDecoder(A, pr, observables=O, gammas=(0.3, 0.5), stage0_iters=8,
                             deep_iters=16, lam=12, device="cpu")
    syn, bp, order = osd_pick_inputs(sd, A, pr, 12, 5)
    want = osd_pick_oracle(sd, syn, bp, order, sd._llr0)
    workers = (os.cpu_count() or 4) + 4
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(workers) as pool:
            futs = [pool.submit(sd._host_osd_pick, syn, bp, order, sd._llr0)
                    for _ in range(workers)]
            here = sd._host_osd_pick(syn, bp, order, sd._llr0)
            there = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(interval)
    for got in (here, *there):
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert len(prepared) == 1 and len(sd._osd_states) == 1
