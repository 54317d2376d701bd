#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ldpcdecoders_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Drives the BP+OSD and min-sum decode paths of the reference benchmark — the
(1000, 10, 9) Gallager code, max_iters 100, batch 1024 — and the
quasi-cyclic paths (the (6, 3)-regular nb=24, Z=128 code of the reference
benchmark's QC extra; the bb144 six-round space-time lift) through the
public decoder API on ``cuda:0`` and prints, in order:

  1. the card (``nvidia-smi`` name and power limit);
  2. the nvcc build of ``ldpcdecoders_tpu_torch/csrc`` and its seconds;
  3. each CUDA kernel against its plain torch version on the card at the
     main path's shape: bitwise equality, both times, and the least time
     the card could take (bytes over 3.35 TB/s, or the operations these
     inputs need over 67 TFLOP/s in float32 and a quarter of that for
     32-bit integer work, whichever is larger); the two eliminations also
     against their plain blocked forms; K3's gathered form and K4's
     iteration form (its messages in place, undamped and damped) on the lane
     tile the main path's decode keeps (``MinSumDecode`` in the variable
     layout at this batch: 128 lanes in float32, lane-major in bfloat16,
     whose messages fit L2), then lane-major; K4 also against
     ``torch.sparse.mm`` of the slot incidence (its ``library_ms``); K3's
     gathered form and K4's in-place form (damping 0.4, the freeze) at the
     bb144 R=6 DEM's shape in the variable layout, as the BP+OSD
     configuration runs them, on tiles at 2048 and 256 lanes, untiled and
     held against the plain lane-major versions, with their lane-major
     times and bounds (K4's form on tiles counted apart as
     ``minsum_var_tiled_nu``); K3/K4 also at the bb144 R=6 DEM's shape
     in the forms the staged decoder's iteration launches (K3 rebuilding,
     damping and updating in place, staged and flat; K4 with the freeze), on
     the real slots, and the same forms and K3's first iteration on lane
     tiles (the check layout's state as ``MinSumDecode`` keeps it: 128
     lanes at these batches), untiled and held against the plain
     lane-major versions, each with its lane-major time beside it; the
     eliminations with the panel width and shared
     memory the launcher reports (``ldpc_gf2_plan`` of the built library,
     which must equal ``cuda_gf2.launch_plan``), and their times at 128
     lanes and with the panel capped at 4, 2 and 1 columns; and (PR 10) the
     two eliminations' device-memory body, which takes a lane past a block
     (the launcher finds no panel), against the plain forms at the (2400, 6,
     3) code's [75, 1200] lane (256 lanes) and the bb144 R=6 DEM's
     [989, 864] (16 lanes), with its bound from the plain forms' work, and
     the cluster body (a cluster of CTAs a lane, panels of 32 columns) timed
     at each cluster size (2, 4, 8), bitwise;
  4. the main paths, each one with every launch count set to 0 just before
     it and read just after it, and failing if a kernel of that path was
     never launched: (a), (b) BP+OSD-0 at per 0.01 and 0.2, (c) BP+OSD-2 at
     per 0.01; (e), (f) min-sum in float32 and bfloat16 at per 0.01; (g),
     (h) BP+OSD with the damped min-sum inner decoder at per 0.2 (OSD-0,
     and OSD-2 on the failing lanes); (e), (g), (m), (n) launch K3/K4 on
     lane tiles (``minsum_check_tiled``, ``minsum_var_tiled_nu``).  Every OSD output is
     syndrome-consistent.  (d), (i): the card's BP and min-sum against the
     CPU's on 64 lanes.  (j) ``QCMinSumDecoder`` layered at per 0.04, 32
     sweeps; (k) ``SpaceTimeDecoder.for_bicycle("bb144", "x", 6, 0.003, 60)``
     on 2048 detector records: one launch of the whole-decode kernel per
     call, converged lanes reproduce their input; (l) both against the CPU
     on 64 lanes, bitwise; (m) BP+OSD-CS (osd_order 10, damped min-sum
     inner) at per 0.2 through K2 and the combination sweep, 64 lanes
     bitwise against the CPU; (n) the same through the native host OSD-CS;
     (o) ``DetectorGraphDecoder.from_dem(surface_d5_r5_p002.dem)`` (BP+OSD-0,
     min-sum inner, K1; 64 records bitwise against the CPU); the peak memory of a staged
     decode against utils/hbm.py's model; (p) the staged decoder's fast tier
     and (q) its flagship on the bb144 R=6 p=0.003 circuit-level DEM through
     ``run_eval`` (4096 and 2048 shots): every OSD output consistent, (p)'s
     Wilson interval overlapping the reference's 149/16,384, (q) at most 8
     failures, with the wall split between stage 0, deep, relay and the
     host OSD, K3/K4 launched on lane tiles (counted apart as
     ``minsum_check_tiled`` / ``minsum_var_tiled``, as in (r), (s)), the
     min-sum loop's compactions (``minsum_compactions`` of a recorded
     ``run_eval``, required above 0: its widths narrow mid-decode, to
     64-lane tiles and lane-major), and a
     stage-0 batch's and a flagship deep bucket's device
     time and launches per min-sum iteration (``torch.profiler``) beside
     their peak memory; then the evaluation harness (harness.py) through its
     entry points: (t) ``FERSweep`` with BP+OSD-0 on the (1000, 10, 9) code
     (batch 1024, 4 batches in flight, host sampling, seed 0) at per 0.005,
     0.01, 0.02, 0.03, 0.04 and 0.2, 8192 trials a point: every output
     syndrome-consistent, K1 launched, the five low points' Wilson intervals
     overlapping ``benchmarks/results/fer_baseline.json``'s bposd0 points, a
     sweep stopped at 4096 trials and resumed from its checkpoint giving the
     same counts, and per 0.01 over 2048 trials giving the CPU's counts;
     (u) ``benchmarks/fer_parity.py``'s five decoders (BP, BP+OSD-0,
     BP+OSD-2, bit-flip, BP-OTS T=9 C=2.0) on its (120, 6, 3) code and
     streams, 1000 trials a point, each LER and syndrome-match rate within
     tests/test_fer_parity.py's tolerance of ``fer_parity_r4.json``'s golden
     (bit-flip's as the mean over 8 tie-break streams);
     (v) ``css_logical_sweep`` on the bb144 gross code (BP+OSD-0, device
     sampling, 4096 pairs at per 0.02, 0.04, 0.08) overlapping
     ``bicycle_ler_r2.json``'s intervals, and one heralded-loss point (0.05,
     host loop, 1024 pairs); (w) ``dem_logical_sweep`` on the d=5 surface
     code's 5-round memory DEM (BP+OSD-0, 60 iterations, batch 1024, 16,384
     device-sampled shots) overlapping ``circuit_level_r3.json``'s
     ``surface_d5_R5`` 2086/65,536 at p 0.002, and at p 0.003 a
     circuit-sampled run and a DEM-sampled one overlapping each other; the
     bit-flip and BP-OTS rates on the (1000, 10, 9) code with their launches
     per iteration (``torch.profiler``); then (PR 10) the rest of the
     decoder family: (x) ``LayeredMinSumDecoder`` on the (1000, 10, 9) code at
     per 0.04 (converged >= 0.99, sweeps beside flooding min-sum's, launches
     per sweep, 64 lanes bitwise against the CPU) and the lifted layered QC
     route on (j)'s code; (y) ``SlidingWindowDecoder`` on streaming_r3.json's
     three streams (64 rounds, W=3, C=1; converged within 0.01 of the
     artifact's, every stream's correction reproducing its final syndrome,
     rounds/s); (z) ``WindowedDemDecoder`` on the bb144 R=12 p=0.003 DEM with
     demwindow_bb144_r5.jsonl's first configuration, on 512 of its 2048
     shots (Wilson interval overlapping 100/2048, window convergence within
     0.05 of 0.814); (aa) ``QuantizedMinSumDecoder`` at per 0.01 and 0.5 (64
     lanes bitwise against the CPU, edge-iterations/s and modelled message
     bytes beside float32 min-sum's) and ``BucketedDecoder`` around BP+OSD-0
     at batches 1, 37, 1000 and 5000, equal to its inner; (ab)
     ``NeuralMinSumDecoder`` trained as neural_toric_r2.json's, its logical
     failure below untrained min-sum's at the three points; (ac)
     ``ErasurePeelingDecoder`` on erasure_threshold_r2.json's (2400, 6, 3)
     code and streams (intervals overlapping, K2's device-memory body where
     stopping sets occur, launches per peeling round); (ad)
     ``mixed_fer_sweep`` on mixed_channel_r2.json's p_flip 0.002 curve
     (intervals overlapping, every output syndrome-consistent, K1's launches
     by body); (ae), (af) ``fused=True`` BP+OSD-0 on (a)'s and (b)'s
     configuration, bitwise the eager decoder, no host read inside a decode
     (torch's sync debug mode), times, launches; (ag) BP+OSD-0 and (ah)
     BP+OSD-CS on the (2400, 6, 3) code through ``batch_decode`` (the
     device-memory body), syndrome-consistent, (ah) 8 lanes card = CPU;
     then (PR 12) the command line and ``parallel/``: (ai) ``cli.main`` in
     this process, each JSON line printed: ``bench`` on (1000, 10, 9) at
     B=1024 with BP+OSD-0 at per 0.2 (K1) and min-sum at per 0.01 (K3/K4),
     ``bench --code qc:24,6,3,128 --decoder qc_minsum --schedule layered``
     (K5), and a 2048-trial ``sweep`` at per 0.01 with ``--checkpoint`` and
     ``--profile``, whose trace must name the command's annotated region;
     (aj) on a one-rank NCCL group that ``make_mesh`` sets up itself,
     ``sharded_batch_decode`` and ``decode_with_stats`` with BP+OSD-0 at per
     0.2 (K1) and ``sharded_mixed_decode`` at (ad)'s configuration (erasure
     0.38, 256 lanes: K1's device-memory body), each bitwise the unsharded
     decoder; (ak) the check-sharded min-sum (K3's check-layout iteration,
     K4) and sum-product (plain torch) at per 0.01, B=1024, 100 iterations
     (model axis 1): min-sum's flags and converged estimates equal to
     ``MinSumDecoder``'s, sum-product's converged lanes consistent and at
     least 90% converged; (al) ``make_qc_sharded_decode_fn`` at (j)'s
     decoder, one K5 launch, bitwise ``batch_decode_detailed``; (am)
     ``sharded_staged_decode`` on 2048 records of (p)'s fast tier, bitwise
     ``batch_decode``, and ``staged_local_eval`` over (p)'s 4096 shots with
     ``run_eval``'s counts on the seed it folds; (an) two ranks on this card
     under gloo (NCCL refuses two ranks on one device), started as child
     processes of this script from a ``FileStore``: ``FERSweep`` (multi-
     process, BP+OSD-0 at per 0.01 and 0.2, 2048 trials a point, the same
     global counts on both ranks, a ``max_seconds`` stop agreed by both) and
     the check-sharded min-sum on a ``(data 1, model 2)`` mesh over 256 of
     (ak)'s lanes, its flags equal to (ak)'s; a child that fails or outlives
     its deadline fails the run; then (PR 15) K5's flooding body, the QC
     decoder's default schedule: (ao) ``QCMinSumDecoder(random_qc_base_matrix(
     24, 6, 3, 128, rng=7), 128, 0.04, 32)`` with its default schedule in
     float32, bfloat16 and sum-product, B=1024, through
     ``batch_decode_detailed_async`` on a card tensor, and (ap)
     ``SpaceTimeDecoder.for_bicycle("bb144", "x", 6, 0.003, 60,
     schedule="flooding")`` on (k)'s 2048 records (multi-term blocks): one
     K5 launch each, of the body its form takes (two-min states or
     messages), every lane against ``qc_minsum_ref`` on the same inputs
     (min-sum: all four outputs bitwise; sum-product: flags and sweeps
     bitwise, LLRs within 2**13 float32 spacings), converged lanes
     reproducing their input; then (aq) the reference's six
     functional cores, the port's builders, on bench.py's own inputs (its
     ``default_rng(0)`` per-0.5 "hard" and per-0.01 "real" syndromes, B=1024,
     100 iterations): ``make_bp_decode_fn`` in float32 and bfloat16 on both,
     ``make_minsum_decode_fn`` in float32 and bfloat16 and damped (0.4, check
     layout, ``check_every`` 8) on the hard ones (K3 and K4 100 launches
     each), ``make_layered_minsum_fn`` at per 0.04, ``make_minsum_q_decode_fn``
     on the hard ones, ``make_fused_bposd_fn`` OSD-0 at per 0.2 (K1) and OSD-2
     at per 0.01 (K2), no host read: each output bitwise its decoder class's
     on the same card tensors, every OSD output syndrome-consistent;
     ``make_syndrome_fn`` on the Gallager code (dense) and the bb144 R=6 DEM
     (gather) bitwise ``(err @ H.T) % 2``; each builder on 64 lanes against
     itself with ``device="cpu"``; and bench.py's cells through the builders
     with its formulas, each line with the card's name and power limit;
  5. steady-state rates (the QC paths' whole-decode kernel, layered and
     flooding, beside the lifted backend);
  6. a JSON line with each kernel's numbers, the card line again, and last
     ``{"ok": true, "device": {...}}``.

``--profile`` adds a ``torch.profiler`` summary of one steady call of each
configuration (launches, device-busy share, largest kernels; the OSD paths
(b), (c), (g), (h), (m) among them) before 6, and a second build of the kernels
with ``-DLDPC_GF2_PHASE_CLOCKS``: block 0's SM clocks in the phases of the
two eliminations, and that build's times beside the plain build's; for the
device-memory body, lane 0's clocks by phase of its leader and first
applier CTA.

Any failed check raises, and the script exits non-zero without the last
line.  It needs a CUDA device and the package beside it.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import warnings
import subprocess
import sys
import time

from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
B = 1024
BK = 2048  # detector records of the space-time path
BDEM = 2048  # stage-0 batch of the staged decoder on the bb144 DEM
P_SHOTS, Q_SHOTS = 4096, 2048  # shots of the fast tier (p) and the flagship (q)
DEEP_BUCKET = 256  # straggler records a flagship deep decode takes (x 6 members)
MAX_ITERS = 100
DEVICE = "cuda:0"
# the evaluation harness's paths (t)-(w)
T_PERS = (0.005, 0.01, 0.02, 0.03, 0.04, 0.2)  # fer_baseline.json's bposd0 points and per 0.2
T_TRIALS, T_CPU_TRIALS = 8192, 2048  # (t) trials a point; per 0.01 on the CPU as well
U_TRIALS = 1000  # (u) trials a point: benchmarks/fer_parity.py's fer_parity_r4.json run
U_BITFLIP_SEEDS = 8  # (u) bit-flip's tie-break streams averaged (see harness_paths)
V_PERS, V_PAIRS, V_LOSS_PAIRS = (0.02, 0.04, 0.08), 4096, 1024  # (v) bicycle_ler_r2.json
W_SHOTS, W_BATCH = 16384, 1024  # (w) each DEM sweep
# the decoder family's paths (x)-(ad)
GLOBAL_B, GLOBAL_DEM_B = 256, 16  # lanes of the device-memory elimination cases
Y_STREAMS = {"toric_d3": 1024, "toric_d5": 512, "bb144": 256}  # (y) streaming_r3.json
Y_ROUNDS = 64
Z_SHOTS = 512  # (z) of demwindow_bb144_r5.jsonl's 2048 (cut for the time limit)
AB_STEPS, AB_TRIALS = 400, 4096  # (ab) neural_toric_r2.json's training steps, trials a point
AC_TRIALS = 2048  # (ac) erasure_threshold_r2.json's trials a point
AD_TRIALS = 2048  # (ad) mixed_channel_r2.json's trials a point
# the command line and parallel/, paths (ai)-(an)
AI_TRIALS = 2048  # (ai) the sweep's trials
AJ_MIXED_LANES = 256  # (aj) lanes of the sharded mixed decode
AM_RECORDS = 2048  # (am) records of the sharded staged decode
AN_PERS, AN_TRIALS, AN_LANES = (0.01, 0.2), 2048, 256  # (an) the two-rank sweep and check shards
AN_COLLECTIVE_S, AN_DEADLINE_S = 240, 300  # (an) a rank's collective timeout; both ranks' deadline
RESULTS = ROOT / "benchmarks/results"
FAMILY_MINSUM = ["minsum_check", "minsum_var"]
# published peaks of one H100 SXM: device memory rate, and the float32 rate
# outside the tensor cores.  That rate counts a fused multiply-add as two
# operations on 128 lanes per SM; 32-bit integer and logic instructions
# run on 64 of those lanes and count once each: a quarter of it.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_I32_OPS_PER_S = PEAK_F32_OPS_PER_S / 4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def load_bb144_dem():
    """The bb144 [[144,12,12]] memory-z circuit-level DEM at R=6, p=0.003
    (864 detectors, 31,648 mechanisms, 12 observables), as committed."""
    import scipy.sparse as sp

    z = np.load(ROOT / "benchmarks/results/bb144_r6_p0.003.npz")
    A = sp.csr_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
    return A, z["priors"], z["obs"]


def syndromes(H, per, rng):
    errs = rng.random((B, H.shape[1])) < per
    # float32 products of 0/1 matrices are exact here (sums <= n)
    return errs, ((errs.astype(np.float32) @ H.T.astype(np.float32)) % 2).astype(np.uint8)


def assert_consistent(H, guesses, syns, what):
    if guesses.shape != (syns.shape[0], H.shape[1]) or guesses.dtype != np.int8:
        raise AssertionError(f"{what}: guesses {guesses.shape} {guesses.dtype}")
    synhat = (guesses.astype(np.float32) @ H.T.astype(np.float32)) % 2
    bad = int((synhat != syns).any(axis=1).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} of {syns.shape[0]} outputs miss their syndrome")


def event_ms(torch, fn, reps):
    """Mean device milliseconds per call on the current stream, after one
    warm-up.  A spin kernel of about 10 ms holds the stream while the host
    enqueues the calls, so the events time the device's work and not the
    host's launch rate (which is slower than a 50 us kernel)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def wall_s(torch, fn, reps):
    """Mean host seconds per call ending in a device synchronization, after
    one warm-up; returns (seconds, last output)."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps, out


def max_abs_err(torch, got, want):
    """Largest difference of the raw bit patterns (0 means bitwise equal)."""
    def raw(t):
        if t.dtype in (torch.float32, torch.bfloat16):
            t = t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)
        return t.to(torch.int64)
    return max(int((raw(g) - raw(w)).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def slot_incidence(torch, ms):
    """The ``[n, dc*m]`` float32 CSR matrix whose row j has a 1 at each of
    variable j's check slots: ``S @ mu^T`` is K4's sum by one library call
    (another summation order), the yardstick of its ``library_ms``."""
    deg = ms.var_deg.cpu()
    n = deg.shape[0]
    v2c = ms.v2c.cpu().reshape(-1, n)  # [dv, n]
    take = torch.arange(v2c.shape[0])[:, None] < deg[None, :]  # real slots first
    cols = v2c.t()[take.t()]  # row-major over variables, then slots
    crow = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(deg, 0)])
    with warnings.catch_warnings():  # sparse CSR is "beta" in torch
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(crow, cols.to(torch.int64), torch.ones(cols.numel()),
                                       size=(n, ms.chk_mask.numel())).to(ms.var_deg.device)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, n_ops, ops_per_s, n_int_ops=0):
    """Least milliseconds the card could take, what sets it, and both terms.
    ``n_int_ops`` is 32-bit integer work done beside ``n_ops`` (index
    arithmetic): its time at the integer rate adds to the operations term."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = (n_ops / ops_per_s + n_int_ops / PEAK_I32_OPS_PER_S) * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations",
            by_bytes, by_ops)


def profile_call(torch, name, fn, iterations, calls=1):
    """torch.profiler over ``calls`` steady calls in a row (several for a
    call much shorter than the profiler's own start): wall, device busy,
    launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    iterations *= calls
    # device-side rows only: an operator's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    print(f"profile {name}: {calls} call(s), wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall_ms:.1f}%), {launches} launches "
          f"({launches / iterations:.1f} per iteration over {iterations})")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"    {ms:9.3f} ms x {count:5d}  {key[:110]}")
    return wall_ms, busy, launches, iterations


def overlap(a, b) -> bool:
    return a[0] <= b[1] and b[0] <= a[1]


def global_body_cases(torch, pt, dev, dem_graph, dem_pr):
    """Phase-3 cases of the eliminations' device-memory body (K1/K2 for a
    lane past a block): the (2400, 6, 3) code's ``[75, 1200]`` lane, the
    shape of paths (ac) and (ad), at ``GLOBAL_B`` lanes, and the bb144 R=6
    DEM's ``[989, 864]`` lane at ``GLOBAL_DEM_B``.  Each lane is the code's
    columns in the order of random reliabilities (``OSD.sort_and_pack``, as
    a device OSD sorts them), the syndrome of a sampled error, and OSD-0's
    residual of a second sampled error.  The bound counts the plain forms'
    work on these inputs (trips of m rows, two operations a row; each row
    XOR the words from the pivot's on and the syndrome bit) at the 32-bit
    integer rate, or the bytes, whichever is larger; the plain forms count
    that work on their first call.  Returns the cases and, for
    :func:`global_body_turns`, ``(kernel, label, osd0, lanes, m, call)``
    with ``call(**kw)`` the wrapper with private arguments (``_cluster``,
    ``_lib``)."""
    from ldpcdecoders_tpu_torch.models.bposd import OSD
    from ldpcdecoders_tpu_torch.ops import cuda_gf2, gf2

    src = "ldpcdecoders_tpu_torch/csrc/gf2_elim.cu"
    rng = np.random.default_rng(31)
    cases, turns = [], []
    for label, graph, lanes, per in (
            ("(2400, 6, 3)", pt.TannerGraph.from_pcm(pt.parity_check_matrix(2400, 6, 3, rng=0)),
             GLOBAL_B, 0.05),
            ("bb144 R=6 DEM", dem_graph, GLOBAL_DEM_B, dem_pr)):
        osd = OSD(graph, 0, device=dev)
        m, n = graph.m, graph.n
        logp = torch.as_tensor(rng.normal(4.0, 2.0, (lanes, n)), dtype=torch.float32, device=dev)
        errs = torch.as_tensor(rng.random((lanes, n)) < per, device=dev)
        bp_err = torch.as_tensor(rng.random((lanes, n)) < per, device=dev).to(torch.int8)
        _, Ht, bp_sorted = osd.sort_and_pack(bp_err, logp)
        syn = (errs.to(torch.float32) @ osd.H_cols_f).to(torch.int32) & 1
        hb = (bp_err.to(torch.float32) @ osd.H_cols_f).to(torch.int32) & 1
        s_int, resid = syn.contiguous(), (syn ^ hb).contiguous()
        W = Ht.shape[1]
        # the body the wrappers take: the built launcher's plan
        if any(cuda_gf2.body_of(cuda_gf2.launcher_plan(W, m, osd0=o)) != "global"
               for o in (True, False)):
            raise AssertionError(f"{label}: [{W}, {m}] fits a block")
        shape = f"B={lanes} W={W} m={m} n={n} ({label}, {4 * W * m} B a lane)"
        # the plain forms count their work on the first call (the comparison's)
        works = {}

        def plain_osd0(Ht=Ht, resid=resid, bp=bp_sorted, n=n, works=works):
            if "gf2_osd0_global" in works:
                return (cuda_gf2.gf2_osd0_ref(Ht, resid, bp, n),)
            corr, works["gf2_osd0_global"] = gf2.gf2_osd0(Ht, resid, bp, n, return_work=True)
            return (corr,)

        def plain_elim(Ht=Ht, s=s_int, n=n, works=works):
            if "gf2_eliminate_global" in works:
                return cuda_gf2.gf2_eliminate_ref(Ht, s, n)
            *out, _, works["gf2_eliminate_global"] = gf2.gf2_eliminate(Ht, s, n,
                                                                       return_work=True)
            return tuple(out[:3])

        def bounds_of(key, n_bytes, label=label, lanes=lanes, m=m, W=W, works=works):
            def bounds(_got):
                trips, row_xors, words = (int(t.sum()) for t in works[key])
                print(f"work {key} {label}: {trips / lanes:.1f} trips and {row_xors / lanes:.1f} "
                      f"row XORs per lane ({row_xors / max(trips, 1):.2f} rows per trip of {m}; "
                      f"{words / max(row_xors, 1):.2f} words a row XOR of {W + 1})")
                return bound(n_bytes, trips * m * 2 + words, PEAK_I32_OPS_PER_S)
            return bounds

        del osd
        cases += [
            (f"gf2_osd0_global {label}", src, "ldpcdecoders_tpu/ops/pallas_gf2.py:93", shape,
             lambda Ht=Ht, resid=resid, bp=bp_sorted, n=n: (
                 cuda_gf2.gf2_osd0_cuda(Ht, resid, bp, n),),
             plain_osd0,
             bounds_of("gf2_osd0_global", nbytes(Ht, resid, bp_sorted) + lanes * n * 4),
             (3, 1)),
            (f"gf2_eliminate_global {label}", src, "ldpcdecoders_tpu/ops/pallas_gf2.py:39",
             shape,
             lambda Ht=Ht, s=s_int, n=n: cuda_gf2.gf2_eliminate_cuda(Ht, s, n),
             plain_elim,
             bounds_of("gf2_eliminate_global", 2 * nbytes(Ht, s_int) + lanes * m * 4), (3, 1)),
        ]
        turns += [
            ("gf2_osd0_global", label, True, lanes, m,
             lambda Ht=Ht, resid=resid, bp=bp_sorted, n=n, **kw: (
                 cuda_gf2.gf2_osd0_cuda(Ht, resid, bp, n, **kw),)),
            ("gf2_eliminate_global", label, False, lanes, m,
             lambda Ht=Ht, s=s_int, n=n, **kw: cuda_gf2.gf2_eliminate_cuda(Ht, s, n, **kw)),
        ]
    return cases, turns


def global_body_turns(torch, cuda_gf2, turns, kernels, card, clock_lib=None):
    """The device-memory body at each cluster size (2, 4, 8 CTAs a lane),
    timed on the card (means of 3 launches each), every result bitwise the
    launcher's choice.  The times go into the kernels line as the variant's
    ``by_cluster_ms``.  With ``clock_lib``
    (the build with ``-DLDPC_GF2_PHASE_CLOCKS``; ``--profile``) lane 0's SM
    clocks by phase at the launcher's cluster: the leader's word in, trips,
    codes and waits at the cluster barrier, rank 1's pass and waits."""
    for key, label, osd0, lanes, m, call in turns:
        want = call()
        plan = cuda_gf2.cluster_plan(lanes, m, osd0=osd0)
        errs = {str(c): max_abs_err(torch, call(_cluster=c), want) for c in (2, 4, 8)}
        by_cluster = {str(c): event_ms(torch, lambda c=c: call(_cluster=c), 3) for c in (2, 4, 8)}
        print(f"kernel {key} {label} by cluster size: max_abs_err against the launcher's choice "
              f"of clusters of 2, 4, 8: {errs} (bitwise required) | the launcher's cluster: "
              f"{plan.size} CTAs of {plan.bytes} B shared memory ({plan.active} such clusters "
              f"fit the card) | by cluster size: "
              + ", ".join(f"{c}: {t:.3f} ms" for c, t in by_cluster.items())
              + f" | B={lanes} | {card}")
        if any(errs.values()):
            raise AssertionError(f"{key} {label}: the cluster sizes differ")
        entry = kernels[key]["variants"].get(label, kernels[key])  # the first case: the entry
        entry.update(cluster=plan.size, cluster_smem_bytes=plan.bytes,
                     active_clusters=plan.active, by_cluster_ms=by_cluster)
        if clock_lib is not None:
            if max_abs_err(torch, call(_lib=clock_lib), want) != 0:
                raise AssertionError(f"{key} {label}: the build with phase clocks differs")
            torch.cuda.synchronize()
            clk = (ctypes.c_longlong * 8)()
            if clock_lib.ldpc_gf2_cluster_clocks(clk) != 0:
                raise AssertionError(f"{key} {label}: the cluster clocks could not be read")
            panels = max(clk[6], 1)
            names = ("leader word in", "leader trips", "leader codes", "leader waits",
                     "rank-1 pass", "rank-1 waits")
            print(f"phases {key} {label}, lane 0, {plan.size} CTAs, {clk[6]} panels, {clk[7]} SM "
                  f"clocks: " + ", ".join(f"{nm} {clk[i] / panels:.0f}" for i, nm in enumerate(names))
                  + f" a panel | {card}")
            entry["clocks_per_panel"] = {nm: clk[i] / panels for i, nm in enumerate(names)}


def stream_detectors(pt, H, b, rounds, p, q, seed):
    """``benchmarks/streaming.py:make_stream``'s numpy draws: ``b`` streams of
    ``rounds`` noisy rounds (the last perfect) as detector records."""
    from ldpcdecoders_tpu_torch.utils.noise import sample_errors, syndromes_of

    rng = np.random.default_rng(seed)
    m, n = np.asarray(H).shape
    e = sample_errors(rng, b * rounds, n, p).reshape(b, rounds, n)
    cum = (np.cumsum(e, axis=1) & 1).astype(np.uint8)
    syn = np.stack([syndromes_of(H, cum[:, r]) for r in range(rounds)], axis=1)
    u = sample_errors(rng, b * rounds, m, q).reshape(b, rounds, m)
    u[:, -1] = 0
    syn ^= u.astype(np.uint8)
    return pt.detectors_of(syn).reshape(b, rounds, m)


def path_x(torch, pt, drive, dev, card, H, graph, qc):
    """(x) layered min-sum on the (1000, 10, 9) code at per 0.04."""
    E = graph.n_edges
    rng = np.random.default_rng(40)
    errs, syn = syndromes(H, 0.04, rng)
    lay = pt.LayeredMinSumDecoder(graph, 0.04, 50, device=dev)
    flo = pt.MinSumDecoder(graph, 0.04, MAX_ITERS, device=dev)
    g, c, it, aux, _ = drive("x", [], lambda: lay.batch_decode_detailed(syn))
    _, cf, itf, _, _ = flo.batch_decode_detailed(syn)
    assert_consistent(H, g[c], syn[c], "(x) layered (converged lanes)")
    ds = torch.as_tensor(syn, device=dev)
    sweeps = int(it.max())
    _, busy, launches, _ = profile_call(torch, "(x) layered min-sum", lambda: lay.layered(ds),
                                        sweeps)
    t, _ = wall_s(torch, lambda: lay.layered(ds), 3)
    print(f"main (x) LayeredMinSumDecoder per 0.04 (alpha 0.8, {lay.n_layers} layers): "
          f"converged {c.mean():.4f}, exact recovery "
          f"{(g.astype(bool) == errs).all(axis=1).mean():.4f}, "
          f"sweeps mean {it.mean():.3f} max {sweeps}; flooding MinSumDecoder (alpha 1) on the "
          f"same syndromes: converged {cf.mean():.4f}, iterations mean {itf.mean():.3f}; "
          f"{launches / sweeps:.1f} launches and {busy / sweeps:.3f} ms device per sweep; "
          f"{B * sweeps * E / t:.4e} edge-sweeps/s ({t * 1e3:.2f} ms/batch) | B={B} | {card}")
    if c.mean() < 0.99:
        raise AssertionError(f"(x): only {c.mean():.4f} of the lanes converged")
    cpu = pt.LayeredMinSumDecoder(graph, 0.04, 50, device="cpu").batch_decode_detailed(syn[:64])
    got = lay.batch_decode_detailed(syn[:64])
    same = [np.array_equal(a, b) for a, b in zip(got[:3], cpu[:3])]
    same.append(np.array_equal(got[3]["llrs"].view(np.uint32), cpu[3]["llrs"].view(np.uint32)))
    print(f"main (x) card against CPU, 64 lanes: err/converged/sweeps/llrs bitwise {same}")
    if not all(same):
        raise AssertionError("(x): the card's layered decode differs from the CPU's")
    base_qc, Hq, qsyn = qc
    qlay = pt.QCMinSumDecoder(base_qc, 128, 0.04, 32, backend="lifted", schedule="layered",
                              device=dev)
    gq, cq, iq, _, _ = drive("x lifted QC", [], lambda: qlay.batch_decode_detailed(qsyn))
    assert_consistent(Hq, gq[cq], qsyn[cq], "(x) lifted layered QC (converged lanes)")
    print(f"main (x) QCMinSumDecoder(backend='lifted', schedule='layered') on (j)'s code: "
          f"converged {cq.mean():.4f}, sweeps mean {iq.mean():.3f}")
    if cq.mean() < 0.99:
        raise AssertionError(f"(x) lifted QC: only {cq.mean():.4f} converged")


def path_y(torch, pt, drive, dev, card, H, graph, qc):
    """(y) sliding windows over streaming_r3.json's three streams."""
    ref_y = json.loads((RESULTS / "streaming_r3.json").read_text())
    Hbb = pt.named_bicycle_code("bb144")[0]
    for name, Hc, p in (("toric_d3", pt.toric_code_x(3), 0.01),
                        ("toric_d5", pt.toric_code_x(5), 0.01), ("bb144", Hbb, 0.003)):
        nb = Y_STREAMS[name]
        det = stream_detectors(pt, Hc, nb, Y_ROUNDS, p, p, seed=5)
        win = pt.SlidingWindowDecoder(Hc, p, 40, window=3, commit=1, device=dev)
        t0 = time.perf_counter()
        Ew, info = drive(f"y {name}", [], lambda: win.decode_detector_stream(det, seed=1))
        wall = time.perf_counter() - t0
        final = np.bitwise_xor.reduce(det, axis=1)  # the last (perfect) round's syndrome
        synE = (Ew.astype(np.int64) @ np.asarray(Hc).T.astype(np.int64)) % 2
        closes = (synE == final).all(axis=1)
        want = ref_y[name]["converged"]
        print(f"main (y) SlidingWindowDecoder {name}, {nb} streams x {Y_ROUNDS} rounds, W=3 C=1, "
              f"per {p}: {info['windows']} windows, converged {info['converged']:.4f} "
              f"(streaming_r3.json {want:.4f}), final syndrome reproduced on {closes.mean():.4f} "
              f"of the streams, {nb * Y_ROUNDS / wall:.1f} rounds/s ({wall:.2f} s, first call) "
              f"| {card}")
        if abs(info["converged"] - want) > 0.01:
            raise AssertionError(f"(y) {name}: converged {info['converged']:.4f}, artifact {want}")
        if not closes.all():
            raise AssertionError(f"(y) {name}: {int((~closes).sum())} streams miss the final "
                                 "syndrome")


def path_z(torch, pt, drive, dev, card, H, graph, qc):
    """(z) windowed DEM decoding of the bb144 R=12 p=0.003 DEM: the first
    configuration of demwindow_bb144_r5.jsonl, on the first Z_SHOTS of its
    2048 shots."""
    import scipy.sparse as sp
    from ldpcdecoders_tpu_torch.utils.metrics import wilson_interval

    ref_z = json.loads((RESULTS / "demwindow_bb144_r5.jsonl").read_text().splitlines()[0])
    cfg = ref_z["config"]
    z = np.load(RESULTS / "bb144_r12_p0.003.npz")
    A12 = sp.csr_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
    pr12, O12 = z["priors"], z["obs"]
    x12 = (np.random.default_rng(17).random((ref_z["shots"], A12.shape[1]))
           < pr12[None, :])[:Z_SHOTS].astype(np.uint8)
    det12 = (np.asarray((A12 @ x12.T.astype(np.int32)).T) % 2).astype(np.uint8)
    obs12 = (x12.astype(np.int32) @ O12.T.astype(np.int32)) % 2
    gammas = (0.4,) + tuple((-0.24, 0.66) for _ in range(cfg["members"] - 1))
    wd = pt.WindowedDemDecoder(
        A12, pr12, detectors_per_round=ref_z["dem"]["detectors_per_round"],
        window=cfg["window"], commit=cfg["commit"], observables=O12, decoder="staged",
        max_iters=cfg["deep_iters"], gammas=gammas, stage0_iters=cfg["stage0_iters"],
        lam=cfg["lam"], lam3=cfg["lam3"], check_every=8, relay_legs=cfg["relay_legs"],
        deep_dtype=torch.bfloat16, layout="check", device=dev)
    t0 = time.perf_counter()
    flips, info = drive("z", FAMILY_MINSUM, lambda: wd.predict_observables(det12, seed=17))
    wall = time.perf_counter() - t0
    fails = int((flips != obs12).any(axis=1).sum())
    ci = wilson_interval(fails, Z_SHOTS)
    ref_ci = wilson_interval(ref_z["windowed"]["fails"], ref_z["shots"])
    want = ref_z["windowed"]["window_converged"]
    print(f"main (z) WindowedDemDecoder bb144 R=12 p=0.003, W={cfg['window']} C={cfg['commit']}, "
          f"{cfg['members']} members, {cfg['relay_legs']} relay legs, {Z_SHOTS} shots: "
          f"{info['windows']} windows, {fails} fails, LER {fails / Z_SHOTS:.4e} (Wilson 95% "
          f"{ci[0]:.4e}-{ci[1]:.4e}; the artifact's {ref_z['windowed']['fails']}/"
          f"{ref_z['shots']}: {ref_ci[0]:.4e}-{ref_ci[1]:.4e}), window convergence "
          f"{info['converged']:.4f} (artifact {want}), {Z_SHOTS / wall:.2f} shots/s, "
          f"{Z_SHOTS * 12 / wall:.1f} rounds/s ({wall:.1f} s) | {card}")
    if not overlap(ci, ref_ci):
        raise AssertionError("(z): the LER interval misses the artifact's")
    if abs(info["converged"] - want) > 0.05:
        raise AssertionError(f"(z): window convergence {info['converged']:.4f}, artifact {want}")
    del wd, A12, x12


def path_aa(torch, pt, drive, dev, card, H, graph, qc):
    """(aa) int8 min-sum at per 0.01 and 0.5 beside float32 min-sum, and bucketing."""
    E = graph.n_edges
    rng = np.random.default_rng(41)
    q8 = pt.QuantizedMinSumDecoder(graph, 0.01, MAX_ITERS, device=dev)
    q8_cpu = pt.QuantizedMinSumDecoder(graph, 0.01, MAX_ITERS, device="cpu")
    f32 = pt.MinSumDecoder(graph, 0.01, MAX_ITERS, device=dev)
    dv, dc = graph.max_dv, graph.max_dc
    for per in (0.01, 0.5):
        errs, syn = syndromes(H, per, rng)
        g, c, it, aux, _ = drive(f"aa {per}", [], lambda: q8.batch_decode_detailed(syn))
        cpu = q8_cpu.batch_decode_detailed(syn[:64])
        same = [np.array_equal(a[:64], b) for a, b in zip((g, c, it, aux["llr_q"]),
                                                           (*cpu[:3], cpu[3]["llr_q"]))]
        ds = torch.as_tensor(syn, device=dev)
        t8, out8 = wall_s(torch, lambda: q8.minsum_q(ds), 3)
        t32, out32 = wall_s(torch, lambda: f32.minsum(ds), 3)
        i8, i32 = int(out8[2].max()) or MAX_ITERS, int(out32[2].max()) or MAX_ITERS
        _, busy, launches, _ = profile_call(torch, f"(aa) int8 min-sum per {per}",
                                            lambda: q8.minsum_q(ds), i8)
        # bytes an iteration's message passes move (model): the check update
        # gathers [B, dv*n] through c2v and writes [B, dc, m]; the variable
        # update gathers [B, dc*m] through v2c, writes nu and the int32 totals
        b8 = B * (2 * dv * graph.n + 2 * dc * graph.m) + 4 * B * graph.n
        b32 = 4 * B * (2 * dv * graph.n + 2 * dc * graph.m) + 4 * B * graph.n
        print(f"main (aa) QuantizedMinSumDecoder (scale 4, beta_q 1) per {per}: converged "
              f"{c.mean():.4f}, exact recovery {(g.astype(bool) == errs).all(axis=1).mean():.4f}, "
              f"iterations mean {it.mean():.2f}; 64 lanes against the CPU bitwise {same}; "
              f"int8 {B * i8 * E / t8:.4e} edge-iterations/s ({t8 * 1e3:.2f} ms, {i8} "
              f"iterations), float32 min-sum (path (e)'s decoder) {B * i32 * E / t32:.4e} "
              f"({t32 * 1e3:.2f} ms, {i32}); {launches / i8:.1f} launches and "
              f"{busy / i8:.3f} ms device per int8 iteration; message bytes per iteration "
              f"(model) int8 {b8 / 1e6:.1f} MB, float32 {b32 / 1e6:.1f} MB | B={B} | {card}")
        if not all(same):
            raise AssertionError(f"(aa) per {per}: the card's int8 decode differs from the CPU's")
    inner = pt.BeliefPropagationOSDDecoder(graph, 0.01, MAX_ITERS, device=dev)
    bk = pt.BucketedDecoder(inner)
    errs5 = np.random.default_rng(42).random((5000, graph.n)) < 0.02
    syn5 = ((errs5.astype(np.float32) @ H.T.astype(np.float32)) % 2).astype(np.uint8)
    for nb in (1, 37, 1000, 5000):
        gb, cb = drive(f"aa bucketed {nb}", [], lambda nb=nb: bk.batch_decode(syn5[:nb]))
        gi, ci_ = inner.batch_decode(syn5[:nb])
        if not (np.array_equal(gb, gi) and np.array_equal(cb, ci_)):
            raise AssertionError(f"(aa) BucketedDecoder at batch {nb} differs from its inner")
        assert_consistent(H, gb, syn5[:nb], f"(aa) bucketed BP+OSD-0 batch {nb}")
    print(f"main (aa) BucketedDecoder(BP+OSD-0) at batches 1, 37, 1000, 5000 per 0.02: equal to "
          f"the inner decoder, every output syndrome-consistent")


def path_ab(torch, pt, drive, dev, card, H, graph, qc):
    """(ab) neural min-sum: neural_toric_r2.json's configuration."""
    from ldpcdecoders_tpu_torch.utils.metrics import gf2_rowspan_reducer
    ref_ab = json.loads((RESULTS / "neural_toric_r2.json").read_text())
    Hx, Hz = pt.toric_code_x(6), pt.toric_code_z(6)
    T = ref_ab["decoder_iters"]
    neural = pt.NeuralMinSumDecoder(Hx, ref_ab["train"]["per"], T, param_scope="edge",
                                    device=dev)
    t0 = time.perf_counter()
    hist = neural.train(steps=AB_STEPS, batch=ref_ab["train"]["batch"], seed=0)
    train_s = time.perf_counter() - t0
    plain = pt.MinSumDecoder(Hx, ref_ab["train"]["per"], T, device=dev)
    span = gf2_rowspan_reducer(Hz)
    rows = []
    for per_s in ref_ab["points"]:
        per = float(per_s)
        e = np.random.default_rng(int(per * 1e4)).random((AB_TRIALS, Hx.shape[1])) < per
        syn = ((e @ Hx.T) % 2).astype(np.int8)

        def logical_fail(out):
            smatch = (((out.astype(np.int64) @ Hx.T) % 2) == syn).all(axis=1)
            return float((~span(e.astype(np.uint8) ^ out.astype(np.uint8)) | ~smatch).mean())

        out_n, _ = drive(f"ab {per_s}", FAMILY_MINSUM,
                         lambda per=per, syn=syn: neural.batch_decode(syn, per=per))
        out_p, _ = plain.batch_decode(syn, per=per)
        fn, fp = logical_fail(out_n), logical_fail(out_p)
        rows.append((per_s, fn, fp))
        if not fn < fp:
            raise AssertionError(f"(ab) per {per_s}: neural {fn:.4f} not below plain {fp:.4f}")
    print(f"main (ab) NeuralMinSumDecoder toric d=6, T={T}, per-edge weights, trained "
          f"{AB_STEPS} steps x {ref_ab['train']['batch']} at per {ref_ab['train']['per']} "
          f"({train_s:.1f} s, loss {hist['losses'][0]:.4f} -> {hist['losses'][-1]:.4f}); "
          f"logical failure over {AB_TRIALS} trials, neural / untrained min-sum / artifact's "
          "neural: "
          + ", ".join(f"per {p}: {fn:.4f} / {fp:.4f} / "
                      f"{ref_ab['points'][p]['neural_edge']['logical_fail']:.4f}"
                      for p, fn, fp in rows) + f" | {card}")


def path_ac(torch, pt, drive, dev, card, H, graph, qc):
    """(ac) erasure peeling on erasure_threshold_r2.json's (2400, 6, 3) code and streams."""
    from ldpcdecoders_tpu_torch.utils.metrics import wilson_interval
    ref_ac = json.loads((RESULTS / "erasure_threshold_r2.json").read_text())
    H24 = pt.parity_check_matrix(2400, 6, 3, rng=0)
    ml = pt.ErasurePeelingDecoder(H24, device=dev)
    pl = pt.ErasurePeelingDecoder(H24, on_stuck="fail", device=dev)
    rng = np.random.default_rng(0)
    n24 = H24.shape[1]
    for rate_s, want in ref_ac["points"].items():
        rate = float(rate_s)
        eps = rng.random((AC_TRIALS, n24)) < rate
        e = eps & (rng.random((AC_TRIALS, n24)) < 0.5)
        syn = ((e @ H24.T) % 2).astype(np.int8)
        _, ok_pl = drive(f"ac {rate_s} peeling", [], lambda: pl.batch_decode(syn, eps))
        rounds = pl.peeling.peel.rounds_run
        stuck = not ok_pl.all()
        err_ml, ok_ml = drive(f"ac {rate_s}", ["gf2_eliminate_global"] if stuck else [],
                              lambda: ml.batch_decode(syn, eps))
        exact = (err_ml.astype(bool) == e).all(axis=1)
        got_ci = [wilson_interval(int(v.sum()), AC_TRIALS) for v in (ok_pl, exact)]
        want_ci = [wilson_interval(round(want[k] * want["trials"]), want["trials"])
                   for k in ("peeling_success", "ml_exact")]
        print(f"main (ac) ErasurePeelingDecoder erasure {rate}: peeling success "
              f"{ok_pl.mean():.4f} (artifact {want['peeling_success']:.4f}), ML solvable "
              f"{ok_ml.mean():.4f}, ML exact {exact.mean():.4f} (artifact {want['ml_exact']:.4f}), "
              f"{rounds} peeling rounds, {ml.peeling.gf2_lanes} lanes through the elimination "
              f"({'its device-memory body' if stuck else 'none stuck'})")
        if not all(overlap(a, b) for a, b in zip(got_ci, want_ci)):
            raise AssertionError(f"(ac) erasure {rate}: intervals miss the artifact's")
    eps = np.random.default_rng(5).random((AC_TRIALS, n24)) < 0.42
    d_syn = torch.as_tensor(((eps & (np.random.default_rng(6).random(eps.shape) < 0.5)) @ H24.T)
                            % 2, device=dev)
    d_eps = torch.as_tensor(eps, device=dev)
    pl.peeling(d_syn, d_eps)
    its = pl.peeling.peel.rounds_run
    profile_call(torch, f"(ac) peeling per round, erasure 0.42, B={AC_TRIALS}",
                 lambda: pl.peeling(d_syn, d_eps), its)


def path_ad(torch, pt, drive, dev, card, H, graph, qc):
    """(ad) the mixed channel: mixed_channel_r2.json's p_flip 0.002 curve."""
    from ldpcdecoders_tpu_torch.harness import mixed_fer_sweep
    ref_ad = json.loads((RESULTS / "mixed_channel_r2.json").read_text())["curves_by_p_flip"]
    ref_ad = ref_ad["0.002"]
    H24 = pt.parity_check_matrix(2400, 6, 3, rng=0)
    t0 = time.perf_counter()
    res = drive("ad", ["gf2_osd0_global"] + FAMILY_MINSUM,
                lambda: mixed_fer_sweep(H24, 0.002, [float(k) for k in ref_ad],
                                        trials_per_point=AD_TRIALS, batch=256, seed=0,
                                        osd_order=0, device=dev))
    wall = time.perf_counter() - t0
    for k, want in ref_ad.items():
        r = res[float(k)]
        print(f"main (ad) mixed_fer_sweep (2400, 6, 3), p_flip 0.002, erasure {k}: exact failure "
              f"{r['exact_failure_rate']:.4f} {r['exact_failure_ci95']} (artifact "
              f"{want['exact_failure_rate']:.4f} {want['exact_failure_ci95']}), syndrome "
              f"mismatch {r['syndrome_mismatch_rate']:.4f}, BP engaged {r['bp_engaged_steps']}/"
              f"{r['steps']} steps, mean peel rounds {r['mean_peel_rounds']:.3f}")
        if not overlap(r["exact_failure_ci95"], want["exact_failure_ci95"]):
            raise AssertionError(f"(ad) erasure {k}: the interval misses the artifact's")
        if r["syndrome_mismatch_rate"] != 0:
            raise AssertionError(f"(ad) erasure {k}: outputs miss their syndrome")
    print(f"main (ad) {len(ref_ad)} points x {AD_TRIALS} trials in {wall:.1f} s; K1's launches "
          f"by body on this path: {drive.last_routes} | {card}")


def family_paths(torch, pt, drive, dev, card, H, qc):
    """Paths (x)-(ad): the rest of the decoder family through its entry
    points.  ``qc``: path (j)'s code and syndromes ``(base, Hq, qsyn)``."""
    graph = pt.TannerGraph.from_pcm(H)
    for path in (path_x, path_y, path_z, path_aa, path_ab, path_ac, path_ad):
        path(torch, pt, drive, dev, card, H, graph, qc)


def host_reads(torch, fn):
    """``fn()`` under torch's sync debug mode: its output and the number of
    synchronizing calls it made (each a host read of the card's work)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def fused_paths(torch, pt, drive, dev, card, H, graph, syn01, syn20):
    """(ae), (af): ``fused=True`` BP+OSD-0 on path (a)'s and (b)'s
    configuration ((1000, 10, 9), 100 iterations, B=1024, per 0.01 and 0.2,
    the same syndromes), syndromes on the card: every output bitwise the
    eager decoder's, no host read inside the fused decode (torch's sync
    debug mode), K1 launched; times of both, launches and device busy of
    the fused call (``torch.profiler``)."""
    for path, per, syn in (("ae", 0.01, syn01), ("af", 0.2, syn20)):
        eager = pt.BeliefPropagationOSDDecoder(graph, per, MAX_ITERS, device=dev)
        fused = pt.BeliefPropagationOSDDecoder(graph, per, MAX_ITERS, fused=True, device=dev)
        d = torch.as_tensor(syn, device=dev)
        want, reads_e = host_reads(torch, lambda: eager.batch_decode_detailed_async(d))
        fused.batch_decode_detailed_async(d)
        torch.cuda.synchronize()
        got, reads_f = drive(path, ["gf2_osd0"], lambda: host_reads(
            torch, lambda: fused.batch_decode_detailed_async(d)))
        torch.cuda.synchronize()
        err = max_abs_err(torch, [*got[:3], got[3]["log_probabs"]],
                          [*want[:3], want[3]["log_probabs"]])
        t_e, _ = wall_s(torch, lambda: eager.batch_decode_detailed_async(d), 3)
        t_f, _ = wall_s(torch, lambda: fused.batch_decode_detailed_async(d), 3)
        wall_ms, busy, launches, _ = profile_call(
            torch, f"({path}) fused BP+OSD-0 per {per}", lambda: fused.batch_decode_detailed_async(d),
            MAX_ITERS)
        g = got[0].cpu().numpy()
        assert_consistent(H, g, syn, f"({path}) fused BP+OSD-0 per {per}")
        conv = got[1].float().mean().item()
        print(f"main ({path}) fused BP+OSD-0 per {per}: max_abs_err against the eager decode "
              f"{err} on err/converged/iters/logp (bitwise required), host reads in a decode: "
              f"fused {reads_f}, eager {reads_e}; converged {conv:.4f}, mean iterations of the "
              f"eager decode {want[2].float().mean().item():.2f} (the fused one runs "
              f"{MAX_ITERS}); fused {t_f * 1e3:.2f} ms, eager {t_e * 1e3:.2f} ms a batch "
              f"({B / t_f:.1f} / {B / t_e:.1f} syndromes/s); fused call: {launches} launches, "
              f"device busy {busy:.2f} of {wall_ms:.2f} ms | B={B} | {card}")
        if err != 0 or reads_f != 0:
            raise AssertionError(f"({path}): the fused decode differs ({err}) or reads the "
                                 f"host ({reads_f} times)")


def past_a_block_paths(torch, pt, drive, dev, card):
    """(ag) BP+OSD-0 and (ah) BP+OSD-CS (osd_order 10, min-sum inner damping
    0.4) on the (2400, 6, 3) code at full width through ``batch_decode``, 256
    syndromes at per 0.08: the failing lanes' OSD takes K1's / K2's
    device-memory body; every output syndrome-consistent, (ah) 8 lanes
    bitwise the CPU's."""
    H24 = pt.parity_check_matrix(2400, 6, 3, rng=0)
    errs = np.random.default_rng(24).random((256, H24.shape[1])) < 0.08
    syn = ((errs.astype(np.float32) @ H24.T.astype(np.float32)) % 2).astype(np.uint8)
    cs_kw = dict(inner="minsum", damping=0.4, osd_method="combination_sweep", osd_order=10)
    for path, kernel, kw in (("ag", "gf2_osd0_global", {}), ("ah", "gf2_eliminate_global", cs_kw)):
        dec = pt.BeliefPropagationOSDDecoder(H24, 0.08, 50, device=dev, **kw)
        t0 = time.perf_counter()
        g, c = drive(path, [kernel], lambda dec=dec: dec.batch_decode(syn))
        wall = time.perf_counter() - t0
        assert_consistent(H24, g, syn, f"({path}) (2400, 6, 3)")
        same = None
        if kw:
            g_c, c_c = pt.BeliefPropagationOSDDecoder(H24, 0.08, 50, device="cpu",
                                                      **kw).batch_decode(syn[:8])
            same = np.array_equal(g_c, g[:8]) and np.array_equal(c_c, c[:8])
        print(f"main ({path}) BeliefPropagationOSDDecoder (2400, 6, 3) {kw or 'OSD-0'}, per 0.08, "
              f"256 syndromes: converged {c.mean():.4f}, exact recovery "
              f"{(g.astype(bool) == errs).all(axis=1).mean():.4f}, all syndrome-consistent, "
              f"{wall:.2f} s (first call), launches by body {drive.last_routes}"
              + ("" if same is None else f"; 8 lanes card = CPU bitwise {same}") + f" | {card}")
        if same is False:
            raise AssertionError(f"({path}): the card differs from the CPU")


def cli_json(cli, argv):
    """``cli.main(argv)`` in this process; its JSON output, printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"ldpcdecoders_tpu_torch {' '.join(argv)} returned {rc}")
    return json.loads(buf.getvalue())


def path_ai(torch, pt, drive, dev, card):
    """(ai) the command line in this process (``cli.main``): ``bench`` with
    BP+OSD-0 at per 0.2 (K1), min-sum at per 0.01 (K3/K4) and the QC decoder
    layered at per 0.04 (K5), and a ``sweep`` with ``--checkpoint`` and
    ``--profile`` whose trace must name the command's annotated region."""
    import os
    import tempfile

    from ldpcdecoders_tpu_torch import cli

    on = ["--batch", str(B), "--device", str(dev)]
    gal = ["--code", "gallager:1000,10,9"] + on
    for tag, argv, expect in (
            ("ai bposd", ["bench", *gal, "--decoder", "bposd", "--per", "0.2"], ["gf2_osd0"]),
            ("ai minsum", ["bench", *gal, "--decoder", "minsum", "--per", "0.01"],
             FAMILY_MINSUM),
            ("ai qc", ["bench", "--code", "qc:24,6,3,128", *on, "--decoder", "qc_minsum",
                       "--schedule", "layered", "--per", "0.04"], ["qc_minsum"])):
        out = drive(tag, expect, lambda argv=argv: cli_json(cli, argv))
        print(f"main ({tag}) python -m ldpcdecoders_tpu_torch {' '.join(argv)}: "
              f"{json.dumps(out)} | {card}")
        if not out["syndromes_per_s"] > 0 or out["reps"] != 5:
            raise AssertionError(f"({tag}): {out}")
    with tempfile.TemporaryDirectory() as tmp:
        ck, prof = os.path.join(tmp, "ck.json"), os.path.join(tmp, "prof")
        argv = ["sweep", *gal, "--pers", "0.01", "--trials", str(AI_TRIALS), "--checkpoint", ck,
                "--profile", prof]
        t0 = time.perf_counter()
        out = drive("ai sweep", [], lambda: cli_json(cli, argv))
        wall = time.perf_counter() - t0
        traces = os.listdir(prof)
        text = "".join(Path(prof, t).read_text() for t in traces)
        saved = json.loads(Path(ck).read_text())["points"][0]["trials"]
        pt_ = out["0.01"]
        print(f"main (ai sweep) python -m ldpcdecoders_tpu_torch {' '.join(argv)}: {pt_['trials']} "
              f"trials, LER {pt_['ler']:.4e} {pt_['ler_ci95']}, syndrome match "
              f"{pt_['syndrome_match_rate']}, {pt_['throughput_syndromes_per_s']:.1f} syndromes/s "
              f"under the profiler, {wall:.2f} s; checkpoint {saved} trials; trace files {traces} "
              f"({len(text)} B) | {card}")
        if (pt_["trials"] != AI_TRIALS or saved != AI_TRIALS or pt_["syndrome_match_rate"] != 1.0
                or "ldpcdecoders_tpu_torch.sweep" not in text):
            raise AssertionError("(ai sweep): counts, checkpoint or trace wrong")


def path_aj(torch, pt, drive, dev, card, graph, syn20):
    """(aj) the batch-sharded decodes on a one-rank NCCL group that
    ``make_mesh()`` sets up itself: BP+OSD-0 on (1000, 10, 9) at per 0.2
    through ``sharded_batch_decode`` and ``decode_with_stats`` (K1), and
    ``sharded_mixed_decode`` at path (ad)'s configuration (erasure 0.38,
    where BP fails and OSD-0 takes K1's device-memory body); each bitwise the
    unsharded decoder on the card.  Returns the mesh."""
    import torch.distributed as dist

    from ldpcdecoders_tpu_torch import parallel as par
    from ldpcdecoders_tpu_torch.utils.noise import sample_mixed_channel

    mesh = par.make_mesh(device=dev)
    if mesh.device_type != dev.type or dist.get_backend() != {"cuda": "nccl"}.get(dev.type, "gloo"):
        raise AssertionError(f"(aj): mesh {mesh} on {dist.get_backend()}")
    dec = pt.BeliefPropagationOSDDecoder(graph, 0.2, MAX_ITERS, device=dev)
    want = dec.batch_decode(syn20)
    for tag, fn in (("aj batch", lambda: par.sharded_batch_decode(dec, syn20, mesh)),
                    ("aj stats", lambda: par.decode_with_stats(dec, syn20, mesh))):
        t0 = time.perf_counter()
        got = drive(tag, ["gf2_osd0"], fn)
        wall = time.perf_counter() - t0
        same = all(np.array_equal(g, w) for g, w in zip(got[:2], want))
        print(f"main ({tag}) {mesh}, BP+OSD-0 per 0.2: bitwise the unsharded decode {same}, "
              f"{wall * 1e3:.1f} ms ({B / wall:.1f} syndromes/s)"
              + (f", stats {got[2]}" if len(got) == 3 else "") + f" | B={B} | {card}")
        if not same or (len(got) == 3 and got[2]["converged_fraction"] != want[1].mean()):
            raise AssertionError(f"({tag}): differs from the unsharded decode")
    H24 = pt.parity_check_matrix(2400, 6, 3, rng=0)
    mdec = pt.MixedChannelDecoder(H24, 0.002, 60, osd_order=0, device=dev)
    eps, e = sample_mixed_channel(np.random.default_rng(38), AJ_MIXED_LANES, 2400, 0.002, 0.38)
    syn = ((e.astype(np.float32) @ H24.T.astype(np.float32)) % 2).astype(np.uint8)
    want = mdec.batch_decode(syn, eps)
    t0 = time.perf_counter()
    got = drive("aj mixed", ["gf2_osd0_global"] + FAMILY_MINSUM,
                lambda: par.sharded_mixed_decode(mdec, syn, eps, mesh))
    wall = time.perf_counter() - t0
    same = all(np.array_equal(g, w) for g, w in zip(got, want))
    print(f"main (aj mixed) sharded_mixed_decode (2400, 6, 3), p_flip 0.002, erasure 0.38: ok "
          f"{got[1].mean():.4f}, bitwise the unsharded decode {same}, {wall * 1e3:.1f} ms "
          f"({AJ_MIXED_LANES / wall:.1f} decodes/s), K1's launches by body {drive.last_routes} | "
          f"B={AJ_MIXED_LANES} | {card}")
    if not same:
        raise AssertionError("(aj mixed): differs from the unsharded decode")
    return mesh


def path_ak(torch, pt, drive, dev, card, H, graph, syn01):
    """(ak) the check-sharded decodes on the one-rank group (model axis 1)
    on (1000, 10, 9) at per 0.01, B=1024, 100 iterations: min-sum through
    K3's check-layout iteration and K4, its flags equal to ``MinSumDecoder``'s
    and its estimates on converged lanes; sum-product (plain torch): every
    converged lane reproduces its syndrome, at least 90% converge.  Returns
    min-sum's outputs."""
    from ldpcdecoders_tpu_torch import parallel as par

    mesh = par.make_mesh(axis_names=("data", "model"), device=dev)
    e0, c0, i0, _, _ = pt.MinSumDecoder(H, 0.01, MAX_ITERS, device=dev).batch_decode_detailed(
        syn01)
    out = {}
    for form, expect in (("minsum", FAMILY_MINSUM), ("sumproduct", [])):
        make = getattr(par, f"make_check_sharded_{form}_fn")
        fn = make(graph, 0.01, MAX_ITERS, mesh)
        fn(syn01[:64])  # warm-up
        t0 = time.perf_counter()
        e, c, i = drive(f"ak {form}", expect, lambda fn=fn: fn(syn01))
        wall = time.perf_counter() - t0
        assert_consistent(H, e[c], syn01[c], f"(ak) {form} converged lanes")
        same = np.array_equal(c, c0) and np.array_equal(e[c], e0[c0])
        held = (f"flags and converged estimates equal to MinSumDecoder's {same} (iterations "
                f"equal {np.array_equal(i, i0)})" if form == "minsum" else
                "converged lanes syndrome-consistent")
        print(f"main (ak {form}) make_check_sharded_{form}_fn {mesh}, per 0.01: converged "
              f"{c.mean():.4f}, mean iterations {i.mean():.2f}, {held}, "
              f"{wall * 1e3:.1f} ms ({B / wall:.1f} syndromes/s, "
              f"{B * int(i.max()) * graph.n_edges / wall:.4e} edge-iterations/s) | B={B} | {card}")
        if (form == "minsum" and not same) or c.mean() < 0.9:
            raise AssertionError(f"(ak {form}): flags differ or too few lanes converge")
        out[form] = (e, c, i)
    return out["minsum"]


def path_al(torch, pt, drive, dev, card, qdec, qsyn, mesh, path_launches):
    """(al) ``make_qc_sharded_decode_fn`` at path (j)'s decoder, B=1024: one
    K5 launch a call, bitwise ``batch_decode_detailed``."""
    from ldpcdecoders_tpu_torch import parallel as par

    fn = par.make_qc_sharded_decode_fn(qdec, mesh)
    want = qdec.batch_decode_detailed(qsyn)
    fn(qsyn)
    t0 = time.perf_counter()
    got = drive("al", ["qc_minsum"], lambda: fn(qsyn))
    wall = time.perf_counter() - t0
    same = all(np.array_equal(g, w) for g, w in zip(got, (*want[:3], want[3]["llrs"])))
    print(f"main (al) make_qc_sharded_decode_fn, (j)'s decoder: bitwise batch_decode_detailed "
          f"{same} (err, converged, iters, llrs), {path_launches['al']['qc_minsum']} K5 launch, "
          f"{wall * 1e3:.3f} ms from and to numpy ({B / wall:.1f} syndromes/s) | B={B} | {card}")
    if not same or path_launches["al"]["qc_minsum"] != 1:
        raise AssertionError("(al): differs from the unsharded decode or not one launch")


def path_am(torch, pt, drive, dev, card, fast, dem_det, mesh):
    """(am) ``sharded_staged_decode`` on 2048 records of path (p)'s fast
    tier, bitwise ``StagedDemDecoder.batch_decode``; ``staged_local_eval``
    at world size 1 over (p)'s shots, its counts equal to ``run_eval``'s on
    the seed it folds (``seed * 1000003 + rank``, seed 0)."""
    from ldpcdecoders_tpu_torch import parallel as par

    det = dem_det[:AM_RECORDS].to(torch.uint8).cpu().numpy()
    want = fast.batch_decode(det)
    t0 = time.perf_counter()
    got = drive("am decode", FAMILY_MINSUM, lambda: par.sharded_staged_decode(fast, det, mesh))
    wall = time.perf_counter() - t0
    same = all(np.array_equal(g, w) for g, w in zip(got, want))
    print(f"main (am decode) sharded_staged_decode, (p)'s fast tier: solved {got[1].mean():.4f}, "
          f"bitwise batch_decode {same}, {wall:.3f} s ({AM_RECORDS / wall:.1f} records/s) | "
          f"B={AM_RECORDS} | {card}")
    ev = fast.run_eval(P_SHOTS, seed=0, batch=BDEM)
    t0 = time.perf_counter()
    loc = drive("am eval", FAMILY_MINSUM,
                lambda: par.staged_local_eval(fast, P_SHOTS, mesh, seed=0, batch=BDEM))
    wall = time.perf_counter() - t0
    keys = ("shots", "fails", "deep_shots", "osd_shots")
    got_c = tuple(loc[k] for k in keys)
    want_c = (ev["shots"], ev["fails"], ev["profile"]["deep_shots"], ev["profile"]["osd_shots"])
    print(f"main (am eval) staged_local_eval, (p)'s fast tier, world 1: {dict(zip(keys, got_c))} "
          f"(run_eval {dict(zip(keys, want_c))}), LER {loc['logical_rate']:.4e} "
          f"{loc['logical_ci95']}, processes {loc['processes']}, {wall:.3f} s "
          f"({loc['shots'] / wall:.1f} shots/s) | {card}")
    if not same or got_c != want_c or loc["processes"] != 1:
        raise AssertionError("(am): differs from the single-device staged decoder")


def an_child(rank: int, tmp: str) -> int:
    """One of (an)'s two ranks on ``cuda:0`` under gloo (NCCL refuses two
    ranks on one card), meeting at a ``FileStore`` in ``tmp``: the
    multi-process ``FERSweep`` (BP+OSD-0 on (1000, 10, 9) at per 0.01 and
    0.2, then a stop vote with rank 1's time budget spent at once) and the
    check-sharded min-sum on a ``(data 1, model 2)`` mesh over (ak)'s first
    lanes.  Its configuration is the parent's, in ``tmp/config.json``;
    it writes its outputs and launch counts into ``tmp``."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    import ldpcdecoders_tpu_torch as pt
    from ldpcdecoders_tpu_torch import parallel as par
    from ldpcdecoders_tpu_torch.harness import FERSweep

    cfg = json.loads(Path(tmp, "config.json").read_text())
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=AN_COLLECTIVE_S))
    dev = torch.device(cfg["device"])
    batch, pers, trials, iters = cfg["batch"], cfg["pers"], cfg["trials"], cfg["max_iters"]
    H = pt.parity_check_matrix(1000, 10, 9, rng=42)
    wrappers, routed = launch_wrappers()
    out = {"rank": rank}

    def factory(per):
        return pt.BeliefPropagationOSDDecoder(H, per, iters, device=dev)

    zero_counts(wrappers, routed)
    t0 = time.perf_counter()
    sweep = FERSweep(H, factory, pers, batch=batch, seed=0)
    res = sweep.run(trials_per_point=trials)
    out["sweep_s"] = time.perf_counter() - t0
    out["multihost"] = sweep.multihost
    out["sweep"] = {str(p): {k: v for k, v in r.items() if k != "throughput_syndromes_per_s"}
                    for p, r in res.items()}
    out["sweep_launches"] = read_counts(wrappers, routed)
    stop = FERSweep(H, factory, pers, batch=batch, seed=0).run(
        trials_per_point=trials, max_seconds=1e9 if rank == 0 else 0.0)
    out["stopped_trials"] = [r["trials"] for r in stop.values()]
    mesh = par.make_mesh(axis_names=("data", "model"), shape=(1, 2), device=dev)
    fn = par.make_check_sharded_minsum_fn(pt.TannerGraph.from_pcm(H), 0.01, iters, mesh)
    syn = np.load(os.path.join(tmp, "syn.npy"))
    zero_counts(wrappers, routed)
    t0 = time.perf_counter()
    e, c, i = fn(syn)
    out["check_s"] = time.perf_counter() - t0
    out["check_launches"] = read_counts(wrappers, routed)
    np.savez(os.path.join(tmp, f"out{rank}.npz"), err=e, conv=c, iters=i)
    Path(tmp, f"out{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def path_an(torch, card, syn01, ak, path_launches):
    """(an) two ranks on the one card (``an_child``), started here and
    waited for with a deadline: both must report the same global counts and
    stop together, and the check-sharded flags on ``(data 1, model 2)``
    must equal (ak)'s on those lanes.  A child that fails or outlives the
    deadline fails the run (both are stopped)."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "syn.npy"), syn01[:AN_LANES])
        Path(tmp, "config.json").write_text(json.dumps(
            {"device": DEVICE, "batch": B, "pers": AN_PERS, "trials": AN_TRIALS,
             "max_iters": MAX_ITERS}))
        logs = [open(os.path.join(tmp, f"log{r}.txt"), "w") for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--an-rank",
                                   str(r), tmp], stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(2)]
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.perf_counter() - t0 > AN_DEADLINE_S:
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        wall = time.perf_counter() - t0
        if any(p.returncode != 0 for p in procs):
            for r in range(2):
                print(f"(an) rank {r} exit {procs[r].returncode}:\n"
                      + Path(tmp, f"log{r}.txt").read_text()[-4000:], file=sys.stderr)
            raise AssertionError("(an): a rank failed or outlived its deadline")
        outs = [json.loads(Path(tmp, f"out{r}.json").read_text()) for r in range(2)]
        flags = [dict(np.load(os.path.join(tmp, f"out{r}.npz"))) for r in range(2)]
    counts = {k: sum(o[part][k] for o in outs for part in ("sweep_launches", "check_launches"))
              for k in outs[0]["sweep_launches"]}
    path_launches["an"] = counts
    print(f"main (an) launches (both ranks): {counts}")
    # two shards sum a variable's messages in another order than one: the
    # flags and the converged estimates agree, an iteration count may not
    e, c, i = (a[:AN_LANES] for a in ak)
    same_flags = all(np.array_equal(f["conv"], c) and np.array_equal(f["err"][c], e[c])
                     for f in flags)
    same_iters = all(np.array_equal(f["iters"], i) for f in flags)
    for o in outs:
        for p, r in o["sweep"].items():
            print(f"main (an) rank {o['rank']} FERSweep(multihost={o['multihost']}) BP+OSD-0 per "
                  f"{p}: {r['trials']} trials, LER {r['ler']:.4e} {r['ler_ci95']}, syndrome match "
                  f"{r['syndrome_match_rate']}, converged {r['converged_fraction']:.4f}")
        print(f"main (an) rank {o['rank']}: sweep {o['sweep_s']:.2f} s "
              f"({len(AN_PERS) * AN_TRIALS / o['sweep_s']:.1f} syndromes/s over both ranks), "
              f"stopped sweep's trials {o['stopped_trials']}, check-sharded min-sum (data 1, "
              f"model 2) on {AN_LANES} lanes {o['check_s'] * 1e3:.1f} ms | {card}")
    print(f"main (an) two ranks on one card under gloo: {wall:.1f} s with the children's start; "
          f"counts equal on both ranks {outs[0]['sweep'] == outs[1]['sweep']}, check-sharded "
          f"flags and converged estimates equal to (ak)'s {same_flags} (iteration counts "
          f"{same_iters})")
    if outs[0]["sweep"] != outs[1]["sweep"] or not all(o["multihost"] for o in outs):
        raise AssertionError("(an): the ranks' global counts differ")
    if any(r["trials"] != AN_TRIALS or r["syndrome_match_rate"] != 1.0
           for r in outs[0]["sweep"].values()):
        raise AssertionError("(an): a point's trials or syndromes are wrong")
    if outs[0]["stopped_trials"] != outs[1]["stopped_trials"] or any(outs[0]["stopped_trials"]):
        raise AssertionError("(an): the max_seconds stop was not agreed")
    if not same_flags:
        raise AssertionError("(an): the check-sharded flags differ from (ak)'s")
    for k in ("gf2_osd0", "minsum_check", "minsum_var"):
        if counts[k] == 0:
            raise AssertionError(f"main (an) never launched {k}")


def parallel_paths(torch, pt, drive, dev, card, H, graph, syn01, syn20, qdec, qsyn, fast,
                   dem_det, path_launches):
    """Paths (ai)-(an): the command line, and parallel/ on one card."""
    import torch.distributed as dist

    path_ai(torch, pt, drive, dev, card)
    mesh = path_aj(torch, pt, drive, dev, card, graph, syn20)
    ak = path_ak(torch, pt, drive, dev, card, H, graph, syn01)
    path_al(torch, pt, drive, dev, card, qdec, qsyn, mesh, path_launches)
    path_am(torch, pt, drive, dev, card, fast, dem_det, mesh)
    dist.destroy_process_group()
    path_an(torch, card, syn01, ak, path_launches)


def flooding_paths(torch, pt, drive, dev, card, qc, st_data):
    """Paths (ao), (ap): K5's flooding body, the QC decoder's default
    schedule, through the public API on card tensors at full width; each
    lane bitwise against ``qc_minsum_ref`` on the same inputs (sum-product:
    flags and sweeps bitwise, LLRs within 2**13 float32 spacings).  Returns
    the two float32 decoders for the rates."""
    from ldpcdecoders_tpu_torch.ops.qc_minsum import qc_minsum_ref

    base_qc, Hq, qsyn = qc
    st_det, st_pri = st_data

    def against_plain(path, inner, d, got, priors, llrs):
        t = inner.qc_terms
        kw = dict(alpha=inner.alpha, beta=inner.beta, schedule=inner.schedule,
                  algorithm=inner.algorithm, dtype=inner.dtype, priors=priors)
        want = qc_minsum_ref(d, t, inner.L0, inner.max_iters, **kw)
        torch.cuda.synchronize()
        flags = max_abs_err(torch, got, want[:3])
        spacings = max_abs_err(torch, [llrs], want[3:])
        sumprod = inner.algorithm == "sumproduct"
        allowed = "2**13 allowed: tanhf/log1pf at the clamp" if sumprod else "bitwise required"
        body = "flooding_messages" if sumprod else "flooding_two_min"
        n = drive.counts_of(path)
        print(f"main ({path}) against qc_minsum_ref on all {d.shape[0]} lanes: err/converged/"
              f"iters max_abs_err {flags} (bitwise required), llrs {spacings} float32 spacings "
              f"apart ({allowed}); {n['qc_minsum']} K5 launch, body {body} "
              f"{n[f'qc_minsum_{body}']} | {card}")
        if flags or spacings > (2**13 if sumprod else 0):
            raise AssertionError(f"({path}): the flooding body differs from qc_minsum_ref")
        if n["qc_minsum"] != 1 or n[f"qc_minsum_{body}"] != 1:
            raise AssertionError(f"({path}): {n} (one launch of the {body} body expected)")

    # (ao) QCMinSumDecoder with its default schedule (flooding), float32,
    # bfloat16 and sum-product, B=1024 through batch_decode_detailed_async
    dq = torch.as_tensor(qsyn, device=dev)
    decs = {}
    for what, kw in (("f32", {}), ("bf16", dict(dtype=torch.bfloat16)),
                     ("sumproduct", dict(algorithm="sumproduct"))):
        path = f"ao {what}"
        dec = pt.QCMinSumDecoder(base_qc, 128, 0.04, 32, device=dev, **kw)
        if dec.schedule != "flooding":
            raise AssertionError(f"({path}): the default schedule is {dec.schedule}")
        e, c, i, aux = drive(path, ["qc_minsum"],
                             lambda dec=dec: dec.batch_decode_detailed_async(dq))
        torch.cuda.synchronize()
        e_np, c_np = e.cpu().numpy(), c.cpu().numpy()
        assert_consistent(Hq, e_np[c_np], qsyn[c_np], f"({path}) converged lanes")
        print(f"main ({path}) QCMinSumDecoder flooding per 0.04, 32 sweeps, B={B}: converged "
              f"{c_np.mean():.4f}, sweeps mean {i.float().mean():.2f} max {int(i.max())} | {card}")
        against_plain(path, dec, dq, [e, c, i], None, aux["llrs"])
        decs[what] = dec

    # (ap) the bb144 six-round space-time decoder, flooding, on (k)'s 2048
    # records: the multi-term flooding case
    st = pt.SpaceTimeDecoder.for_bicycle("bb144", "x", 6, 0.003, 60, schedule="flooding",
                                         device=dev)
    dk = torch.as_tensor(st_det, device=dev)
    cum, c, i, aux = drive("ap", ["qc_minsum"], lambda: st.batch_decode_detailed_async(dk))
    torch.cuda.synchronize()
    bk = dk.shape[0]
    full = torch.cat([aux["data_rounds"].reshape(bk, -1), aux["meas"].reshape(bk, -1)], dim=1)
    full_np, c_np = full.cpu().numpy(), c.cpu().numpy()
    rec = np.asarray((st.A.astype(np.int32) @ full_np.T.astype(np.int32)).T % 2, np.uint8)
    if not (rec[c_np] == st_det[c_np]).all():
        raise AssertionError("(ap): converged lanes do not reproduce their detector record")
    print(f"main (ap) SpaceTimeDecoder.for_bicycle bb144 x R=6 per 0.003, 60 sweeps, flooding, "
          f"{bk} records: converged {c_np.mean():.4f}, sweeps mean {i.float().mean():.2f} max "
          f"{int(i.max())} | {card}")
    if c_np.mean() < 0.99:
        raise AssertionError(f"(ap): converged {c_np.mean():.4f}")
    against_plain("ap", st.inner, dk, [full, c, i], st_pri, aux["inner"]["llrs"])
    return decs["f32"], st


def builder_paths(torch, pt, drive, dev, card, H, graph, syn20, dem):
    """Path (aq): the reference's six functional cores (the port's builders)
    through the entry points ``bench.py`` calls, on the card at the main
    path's full width: the (1000, 10, 9) code, 100 iterations, B=1024, on
    bench.py's own draws (``default_rng(0)``: per-0.5 "hard" syndromes, then
    per-0.01 "real" ones), (b)'s per-0.2 syndromes and (x)'s per-0.04 ones.
    Each builder's outputs bitwise its decoder class's on the same card
    tensors, each case under ``drive`` (its own launch counts): the min-sum
    builder launches K3 and K4 once each an iteration, the fused builder K1
    (OSD-0) or K2 (OSD-2) with no host read (sync debug mode "error"); BP,
    layered, int8 and the syndrome launch none of K1-K5.  The syndrome
    builder on both routes: the dense matmul on the Gallager code, the
    O(edges) gather on the bb144 R=6 DEM ``dem = (graph, A, errors)``.  Then
    each builder on 64 lanes against the same builder with ``device="cpu"``,
    and bench.py's cells through the builders with its formulas, each with
    the card's name and power limit."""
    from ldpcdecoders_tpu_torch.models.bp import make_bp_decode_fn
    from ldpcdecoders_tpu_torch.models.bposd import make_fused_bposd_fn
    from ldpcdecoders_tpu_torch.models.layered import make_layered_minsum_fn
    from ldpcdecoders_tpu_torch.models.minsum import make_minsum_decode_fn
    from ldpcdecoders_tpu_torch.models.minsum_q import make_minsum_q_decode_fn
    from ldpcdecoders_tpu_torch.ops.syndrome import SyndromeCheck, make_syndrome_fn

    E = graph.n_edges
    rng = np.random.default_rng(0)  # bench.py:41-49's draws, in its order
    _, hard = syndromes(H, 0.5, rng)
    _, real = syndromes(H, 0.01, rng)
    _, syn04 = syndromes(H, 0.04, np.random.default_rng(40))  # (x)'s
    host = {"hard": hard, "real": real, "per 0.2": syn20, "per 0.04": syn04}
    on_card = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    lanes = {k: v[:64] for k, v in host.items()}
    plain = ["gf2_osd0", "gf2_eliminate", "minsum_check", "minsum_var", "qc_minsum"]
    f32, bf16 = torch.float32, torch.bfloat16
    bp_kw = {"f32": (0.01, MAX_ITERS, f32), "bf16": (0.01, MAX_ITERS, bf16)}
    ms_kw = {"f32": dict(dtype=f32), "bf16": dict(dtype=bf16),
             "damped": dict(damping=0.4, layout="check", check_every=8)}
    fused_kw = {"osd0": (0.2, MAX_ITERS, 0), "osd2": (0.01, MAX_ITERS, 2)}
    # (case, builder, its arguments, the decoder class's call, syndromes,
    # kernels it must launch, and how many times each)
    cases = []
    for what, (per, its, dt) in bp_kw.items():
        dec = pt.BeliefPropagationDecoder(graph, per, its, dtype=dt, device=dev)
        for which in ("hard", "real"):
            cases.append((f"bp {what} {which}", make_bp_decode_fn, (graph, per, its, dt), {},
                          dec.batch_decode_detailed_async, which, {}))
    for what, kw in ms_kw.items():
        if what == "damped":  # no decoder class takes check_every: the module
            mod = pt.MinSumDecode(graph, 0.01, MAX_ITERS, device=dev, **kw)

            def call(d, mod=mod):
                e, c, i, llrs = mod(d)
                return e, c, i, {"llrs": llrs}
        else:
            call = pt.MinSumDecoder(graph, 0.01, MAX_ITERS, device=dev,
                                    **kw).batch_decode_detailed_async
        cases.append((f"minsum {what} hard", make_minsum_decode_fn, (graph, 0.01, MAX_ITERS), kw,
                      call, "hard", dict.fromkeys(FAMILY_MINSUM, MAX_ITERS)))
    lay = pt.LayeredMinSumDecoder(graph, 0.04, MAX_ITERS, alpha=1.0, device=dev)
    cases.append(("layered per 0.04", make_layered_minsum_fn, (graph, 0.04, MAX_ITERS), {},
                  lay.batch_decode_detailed_async, "per 0.04", {}))
    q8 = pt.QuantizedMinSumDecoder(graph, 0.01, MAX_ITERS, device=dev)
    cases.append(("int8 hard", make_minsum_q_decode_fn, (graph, 0.01, MAX_ITERS), {},
                  q8.batch_decode_detailed_async, "hard", {}))
    for what, (per, its, order) in fused_kw.items():
        dec = pt.BeliefPropagationOSDDecoder(graph, per, its, osd_order=order, fused=True,
                                             device=dev)
        kernel = "gf2_osd0" if order == 0 else "gf2_eliminate"
        cases.append((f"fused {what}", make_fused_bposd_fn, (graph, per, its, order), {},
                      dec.batch_decode_detailed_async, "per 0.2" if order == 0 else "real",
                      {kernel: None}))

    built = {}
    for case, builder, args, kw, call, which, launches in cases:
        path = f"aq {case}"
        fn = builder(*args, device=dev, **kw)
        built[case] = (builder, args, kw, which)
        d = on_card[which]
        fused = case.startswith("fused")
        if fused:  # a synchronizing call inside the decode raises
            fn(d)
            torch.cuda.synchronize()
            got = drive(path, list(launches), lambda: without_host_reads(torch, lambda: fn(d)))
        else:
            got = drive(path, list(launches), lambda: fn(d))
        torch.cuda.synchronize()
        counts = drive.counts_of(path)
        want = call(d)
        err = max_abs_err(torch, got, [*want[:3], *want[3].values()])
        e, c, i = (t.cpu().numpy() for t in got[:3])
        if fused:
            assert_consistent(H, e, host[which], f"(aq) {case}")
        else:
            assert_consistent(H, e[c], host[which][c], f"(aq) {case} (converged lanes)")
        print(f"main ({path}) {builder.__name__}{args[1:]}{' ' + str(kw) if kw else ''} on "
              f"the {which} syndromes: max_abs_err against the decoder class {err} on all four "
              f"outputs (bitwise required); converged {c.mean():.4f}, iterations mean "
              f"{i.mean():.2f} max {i.max()}"
              + (", no host read in the decode (sync debug mode 'error')" if fused else "")
              + f" | B={B} | {card}")
        if err:
            raise AssertionError(f"({path}): the builder differs from its decoder class")
        # None: at least once (drive checked it); the Gallager lanes fit a
        # block, so the device-memory body runs for none of them
        for k in plain:
            want_n = launches.get(k, 0)
            if (want_n is not None and counts[k] != want_n) or counts.get(f"{k}_global", 0):
                raise AssertionError(f"({path}): {k} launched {counts[k]} times, {want_n} "
                                     f"expected")

    # the syndrome builder: the dense route on the Gallager code, the gather
    # route on the bb144 DEM (27.3M entries, past the 16M-entry cutoff)
    dem_graph, dem_A, dem_x = dem
    errs = (np.random.default_rng(43).random((B, graph.n)) < 0.5).astype(np.float32)
    for what, g, x, A in (("Gallager (1000, 10, 9)", graph, errs, H),
                          ("bb144 R=6 DEM", dem_graph, dem_x[:B], dem_A)):
        route = "dense" if SyndromeCheck(g, torch.device("cpu")).dense else "gather"
        path = f"aq syndrome {route}"
        fn = make_syndrome_fn(g, device=dev)
        dx = torch.as_tensor(x, device=dev)
        got = drive(path, [], lambda: fn(dx)).cpu().numpy()
        want = (np.asarray(A @ x.T.astype(np.float64)).T % 2).astype(np.float32)
        cpu = make_syndrome_fn(g, device="cpu")(x[:64]).numpy()
        same = np.array_equal(got, want) and np.array_equal(cpu, want[:64])
        t = event_ms(torch, lambda: fn(dx), 20)
        print(f"main ({path}) make_syndrome_fn on the {what} ({g.m} x {g.n}, {route} route), "
              f"{x.shape[0]} error patterns: bitwise (err @ H.T) % 2 {same}, 64 lanes of the "
              f"CPU builder bitwise; {t:.3f} ms a call | {card}")
        if not same or any(drive.counts_of(path)[k] for k in plain):
            raise AssertionError(f"({path}): the syndrome differs or a kernel was launched")
        if route != ("dense" if g is graph else "gather"):
            raise AssertionError(f"({path}): the {what} took the {route} route")

    # each builder on 64 lanes against the same builder on the CPU: BP's
    # err / converged / iters bitwise and logp within rtol 1e-5, atol 1e-6
    # (float32 log may differ by an ulp; in bfloat16 that ulp rounds to at
    # most one bfloat16 spacing, rtol 2**-7); min-sum, layered and int8
    # bitwise, but that any NaN matches any NaN: layered min-sum at alpha 1
    # (the builder's default) overflows on lanes that never converge, and
    # inf - inf is a NaN of another sign on the host's CPU than on the card;
    # the fused decode bitwise on the lanes whose reliability order agrees
    # (exp may differ by an ulp), at least 3/4 of them
    for case, (builder, args, kw, which) in built.items():
        want = builder(*args, device="cpu", **kw)(lanes[which])
        got = builder(*args, device=dev, **kw)(torch.as_tensor(lanes[which], device=dev))
        got = [t.cpu() for t in got]
        flags = all(torch.equal(a, b) for a, b in zip(got[1:3], want[1:3]))
        if case.startswith("bp") or case.startswith("fused"):
            tol = dict(rtol=2.0**-7 if "bf16" in case else 1e-5, atol=1e-6)
            soft = torch.allclose(got[3].float(), want[3].float(), **tol)
            agree = torch.ones(got[0].shape[0], dtype=torch.bool)
            if case.startswith("fused"):
                agree = (reliability_order(torch, got[3])
                         == reliability_order(torch, want[3])).all(dim=1)
            flags = flags and torch.equal(got[0][agree], want[0][agree])
            ok = flags and soft and agree.float().mean() >= 0.75
            note = (f"err/converged/iters bitwise {flags}, logp within {tol}: {soft}"
                    + (f" (err on the {int(agree.sum())} lanes whose reliability order agrees)"
                       if case.startswith("fused") else ""))
        else:
            ok = flags and torch.equal(got[0], want[0]) and bitwise_but_nan(torch, got[3], want[3])
            nan = int(got[3].isnan().sum()) if got[3].is_floating_point() else 0
            note = (f"err/converged/iters/llrs bitwise {ok}"
                    + (f" ({nan} NaN LLRs on both, any NaN matching any NaN)" if nan else ""))
        print(f"main (aq {case}) card against the CPU builder, 64 lanes of the {which} "
              f"syndromes: {note}")
        if not ok:
            raise AssertionError(f"(aq {case}): the card differs from the CPU")

    # bench.py's cells through the builders, with its formulas: each behind
    # torch.cuda.synchronize(), each with the card's name and power limit
    def edge_rate(what, fn, d):
        t, out = wall_s(torch, lambda: fn(d), 3)
        iters = int(out[2].max()) or MAX_ITERS
        print(f"rate (aq) {what}: {B * iters * E / t:.4e} edge-iterations/s ({iters} "
              f"iterations, {t * 1e3:.2f} ms/batch) | B={B} | {card_line()}")

    def pipelined(what, fn, d, k=8):
        fn(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [fn(d) for _ in range(k)]
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        print(f"rate (aq) {what}, {k} batches in flight: {k * B / t:.1f} syndromes/s "
              f"(converged {outs[-1][1].float().mean():.4f}) | B={B} | {card_line()}")

    bp32 = make_bp_decode_fn(graph, 0.01, MAX_ITERS, device=dev)
    edge_rate("make_bp_decode_fn float32 per 0.5", bp32, on_card["hard"])
    t, out = wall_s(torch, lambda: bp32(on_card["real"]), 3)
    print(f"rate (aq) make_bp_decode_fn float32 per 0.01: {B / t:.1f} syndromes/s "
          f"({t * 1e3:.2f} ms/batch, converged {out[1].float().mean():.4f}) | B={B} | "
          f"{card_line()}")
    pipelined("make_bp_decode_fn float32 per 0.01", bp32, on_card["real"])
    edge_rate("make_minsum_q_decode_fn int8 per 0.5",
              make_minsum_q_decode_fn(graph, 0.01, MAX_ITERS, device=dev), on_card["hard"])
    edge_rate("make_minsum_decode_fn bfloat16 per 0.5",
              make_minsum_decode_fn(graph, 0.01, MAX_ITERS, dtype=bf16, device=dev),
              on_card["hard"])
    edge_rate("make_bp_decode_fn bfloat16 per 0.5",
              make_bp_decode_fn(graph, 0.01, MAX_ITERS, bf16, device=dev), on_card["hard"])
    pipelined("make_fused_bposd_fn OSD-0 per 0.01",
              make_fused_bposd_fn(graph, 0.01, MAX_ITERS, 0, device=dev), on_card["real"])


def bitwise_but_nan(torch, a, b):
    """``a`` and ``b`` bit for bit, but that a NaN matches any NaN (at the
    same places)."""
    if a.is_floating_point():
        nan = a.isnan()
        if not torch.equal(nan, b.isnan()):
            return False
        a, b = a[~nan], b[~nan]
    return max_abs_err(torch, [a], [b]) == 0


def without_host_reads(torch, fn):
    """``fn()`` under torch's sync debug mode "error": a synchronizing call
    (a host read of the card's work) raises.  (The "warn" mode of
    :func:`host_reads` also counts one call at its first use in a process
    that "error" does not raise on.)"""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def reliability_order(torch, logp):
    """The OSD's column order of each lane: ``max(p, 1 - p)``, ``p =
    exp(logp)``, stable descending."""
    p = torch.exp(logp.float())
    return torch.argsort(-torch.maximum(p, 1 - p), dim=1, stable=True)


def var_layout_rows(torch, pt, dev, card, kernels, dem_graph, dem_det, dem_llr):
    """K3's gathered form and K4's in-place form at the bb144 R=6 DEM's shape
    as the BP+OSD configuration's variable layout launches them (float32,
    damping 0.4, the freeze on every iteration, every second lane done), at
    a stage's 2048 lanes and at 256, the configuration's tail of failing
    lanes: on the batch's tile (``MinSumDecode(layout="var")._tile``),
    untiled and held bitwise against the plain lane-major versions at the
    real slots, each with the lane-major form's time beside it.  The inputs
    are the second iteration's (``nu`` after one damped update).  Bounds, the
    least the functions need: K3 reads ``nu`` and writes ``mu`` at the real
    slots (K4 reads no padded slot of ``mu``) and reads the syndrome and the
    table, 14 operations an edge; K4 gathers ``mu`` and reads and writes
    ``nu`` at the real slots (3 x E x 4 B), reads ``L0`` and writes the
    active lanes' ``err`` / ``llrs``, 5 operations an edge.  K4's launches
    on tiles are counted apart, under the wrapper's ``lane_tiled_nu`` route;
    the row fails if that count misses one of its launches."""
    from ldpcdecoders_tpu_torch.ops import cuda_minsum
    from ldpcdecoders_tpu_torch.ops import minsum as plain_minsum

    src = "ldpcdecoders_tpu_torch/csrc/minsum.cu"
    dv, n, m, dc = dem_graph.max_dv, dem_graph.n, dem_graph.m, dem_graph.max_dc
    for lanes in (BDEM, DEEP_BUCKET):
        ms = pt.MinSumDecode(dem_graph, 0.01, 2, device=dev, damping=0.4)
        T, real_c, real_v = ms._tile(lanes, dev), ms.chk_mask.reshape(-1), ms.var_mask.reshape(-1)
        E, size = int(ms.var_mask.sum()), 4
        kw3, kw4 = dict(chk_deg=ms.chk_deg), dict(var_deg=ms.var_deg)
        L0 = torch.broadcast_to(dem_llr.to(torch.float32), (lanes, n)).contiguous()
        flip = dem_det[:lanes].contiguous()
        done = torch.arange(lanes, device=dev) % 2 == 1
        nu1 = L0[:, None, :].expand(lanes, dv, n).contiguous()
        mu0 = cuda_minsum.minsum_check_cuda(nu1.reshape(lanes, -1), ms.c2v, flip, ms.chk_mask,
                                            ms.alpha, 0.0, **kw3)
        cuda_minsum.minsum_var_iter_cuda(mu0.reshape(lanes, -1), ms.v2c, ms.var_mask, L0,
                                         nu=nu1, gamma=ms.gam, **kw4)
        mu1 = cuda_minsum.minsum_check_cuda(nu1.reshape(lanes, -1), ms.c2v, flip, ms.chk_mask,
                                            ms.alpha, 0.0, **kw3).reshape(lanes, -1)
        del mu0

        def tile(t, T=T):
            return t if t.ndim == 0 else plain_minsum.tile_lanes(t, T)

        def untile(t, T=T, lanes=lanes):
            return plain_minsum.untile_lanes(t, T)[:lanes]

        shape = (f"B={lanes} dc={dc} m={m} dv={dv} n={n} (bb144 R=6 DEM, variable layout, "
                 f"float32, gamma 0.4, lane tile {T})")
        # K3 gathered from nu
        x_t, flip_t = tile(nu1.reshape(lanes, -1)), tile(flip)
        k3t = (lambda x_t=x_t, flip_t=flip_t, ms=ms, kw3=kw3, T=T: cuda_minsum.minsum_check_cuda(
            x_t, ms.c2v, flip_t, ms.chk_mask, ms.alpha, 0.0, **kw3, lane_tile=T))
        k3 = (lambda nu1=nu1, flip=flip, ms=ms, kw3=kw3, lanes=lanes:
              cuda_minsum.minsum_check_cuda(nu1.reshape(lanes, -1), ms.c2v, flip, ms.chk_mask,
                                            ms.alpha, 0.0, **kw3))
        p3 = (lambda nu1=nu1, flip=flip, ms=ms, lanes=lanes: plain_minsum.check_update_ref(
            nu1.reshape(lanes, -1), ms.c2v, flip, ms.chk_mask, ms.alpha, 0.0))
        want = p3().reshape(lanes, -1)[:, real_c]
        err3 = max_abs_err(torch, [untile(k3t()).reshape(lanes, -1)[:, real_c],
                                   k3().reshape(lanes, -1)[:, real_c]], [want, want])
        del want, x_t
        row3 = {"ms": event_ms(torch, k3t, 10), "lane_major_ms": event_ms(torch, k3, 10),
                "plain_ms": event_ms(torch, p3, 1),
                **dict(zip(("bound_ms", "bound_by"), bound(
                    lanes * (2 * E * size + m) + E * 4, 14 * lanes * E, PEAK_F32_OPS_PER_S)[:2])),
                "max_abs_err": err3}
        # K4 in place with the freeze: kernel on tiles, kernel lane-major and
        # plain lane-major, each on its own copy of the state
        state = {}
        for where in ("tiled", "lane-major", "plain"):
            t = tile if where == "tiled" else (lambda x: x)
            nu, err_s = t(nu1.clone()), t(torch.zeros((lanes, n), device=dev))
            mu_s, L0_s, done_s, llrs = t(mu1), t(L0), t(done), t(L0.clone())
            if where == "plain":
                call = (lambda mu_s=mu_s, L0_s=L0_s, nu=nu, done_s=done_s, err_s=err_s,
                        llrs=llrs, ms=ms: plain_minsum.var_iter_ref(
                            mu_s, ms.v2c, ms.var_mask, L0_s, nu=nu, gamma=ms.gam, done=done_s,
                            err=err_s, llrs=llrs))
            else:
                call = (lambda mu_s=mu_s, L0_s=L0_s, nu=nu, done_s=done_s, err_s=err_s,
                        llrs=llrs, ms=ms, kw4=kw4, T=(T if where == "tiled" else 1):
                        cuda_minsum.minsum_var_iter_cuda(
                            mu_s, ms.v2c, ms.var_mask, L0_s, nu=nu, gamma=ms.gam, done=done_s,
                            err=err_s, llrs=llrs, **kw4, lane_tile=T))
            call()
            torch.cuda.synchronize()
            u = untile if where == "tiled" else (lambda x: x)
            state[where] = ([u(nu).reshape(lanes, -1)[:, real_v], u(err_s), u(llrs)], call)
        want = state["plain"][0]
        err4 = max(max_abs_err(torch, state[w][0], want) for w in ("tiled", "lane-major"))
        before = cuda_minsum.minsum_var_iter_cuda.routes["lane_tiled_nu"]
        ms4 = event_ms(torch, state["tiled"][1], 10)
        counted = cuda_minsum.minsum_var_iter_cuda.routes["lane_tiled_nu"] - before
        if counted != 11:
            raise AssertionError(f"minsum_var_tiled_nu: 11 launches counted {counted} times")
        active = int((~done).sum())
        row4 = {"ms": ms4, "lane_major_ms": event_ms(torch, state["lane-major"][1], 10),
                "plain_ms": event_ms(torch, state["plain"][1], 1),
                **dict(zip(("bound_ms", "bound_by"), bound(
                    lanes * (3 * E * size + n * size) + E * 4 + nbytes(done, ms.var_deg)
                    + active * n * (4 + size), 5 * lanes * E, PEAK_F32_OPS_PER_S)[:2])),
                "max_abs_err": err4}
        del state, want, mu1, nu1
        for name, what, row in (("minsum_check_tiled", "gathered from nu", row3),
                                ("minsum_var_tiled_nu", "in place, damping 0.4, freeze", row4)):
            row.update(lane_tile=T, us_per_lane_iter=row["ms"] * 1e3 / lanes,
                       bound_us_per_lane_iter=row["bound_ms"] * 1e3 / lanes)
            print(f"kernel {name} bb144 var layout f32 B={lanes} {what}: max_abs_err "
                  f"{row['max_abs_err']} (bitwise required: untiled, and the lane-major kernel, "
                  f"against the plain lane-major version at the real slots) | kernel "
                  f"{row['ms']:.3f} ms, {row['us_per_lane_iter']:.3f} us a lane-iteration "
                  f"(lane-major {row['lane_major_ms']:.3f} ms) | plain torch "
                  f"{row['plain_ms']:.3f} ms | bound {row['bound_ms']:.4f} ms by "
                  f"{row['bound_by']} ({row['bound_us_per_lane_iter']:.3f} us a lane-iteration) "
                  f"| library call: none | {shape} | {card}")
            if row["max_abs_err"] != 0:
                raise AssertionError(f"{name} bb144 var layout B={lanes}: kernel differs from "
                                     "its plain version")
            if name not in kernels:  # the first batch's row is the entry's
                kernels[name] = {"name": name, "route": "cuda", "source": src,
                                 "replaces": kernels["minsum_var"]["replaces"],
                                 "max_abs_err": 0, "library_ms": None, "variants": {},
                                 **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                        "lane_major_ms")},
                                 "shape": f"bb144 var layout f32 B={lanes}"}
            kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], row["max_abs_err"])
            kernels[name]["variants"][f"bb144 var layout f32 B={lanes} {what}"] = row
        torch.cuda.empty_cache()


def launch_wrappers():
    """``(wrappers, routed)``: each kernel's wrappers (K3 and K4 have two
    forms each), and K1/K2's, which count their launches by body: the
    shared-memory kernels under their own names, the device-memory body
    (lanes past a block) apart."""
    from ldpcdecoders_tpu_torch.ops import cuda_gf2, cuda_minsum, cuda_qc

    wrappers = {"gf2_osd0": [cuda_gf2.gf2_osd0_cuda],
                "gf2_eliminate": [cuda_gf2.gf2_eliminate_cuda],
                "minsum_check": [cuda_minsum.minsum_check_cuda,
                                 cuda_minsum.minsum_check_iter_cuda],
                "minsum_var": [cuda_minsum.minsum_var_cuda, cuda_minsum.minsum_var_iter_cuda],
                "qc_minsum": [cuda_qc.qc_minsum_cuda]}
    routed = {"gf2_osd0": cuda_gf2.gf2_osd0_cuda, "gf2_eliminate": cuda_gf2.gf2_eliminate_cuda}
    return wrappers, routed


def zero_counts(wrappers, routed):
    for ws in wrappers.values():
        for w in ws:
            w.launches = 0
            w.routes.update(dict.fromkeys(w.routes, 0))


def read_counts(wrappers, routed):
    """Each kernel's launches since :func:`zero_counts`; K1/K2 and K5 also
    by body, K3/K4 also those on lane tiles (``<kernel>_tiled``; K4's
    variable-layout form on tiles apart, ``minsum_var_tiled_nu``)."""
    counts = {k: sum(w.launches for w in ws) for k, ws in wrappers.items()}
    for k in FAMILY_MINSUM:
        counts[f"{k}_tiled"] = sum(w.routes["lane_tiled"] for w in wrappers[k])
    counts["minsum_var_tiled_nu"] = wrappers["minsum_var"][1].routes["lane_tiled_nu"]
    for k, w in routed.items():
        counts[k] = w.routes["shared"]
        counts[f"{k}_global"] = w.routes["global"]
    for body, n in wrappers["qc_minsum"][0].routes.items():
        counts[f"qc_minsum_{body}"] = n
    return counts


def harness_paths(torch, pt, drive, dev, card, H):
    """Paths (t)-(w): the evaluation harness through its public entry
    points, each under ``drive`` (its own launch counts), with the checks
    of its docstring entry."""
    import tempfile

    from ldpcdecoders_tpu_torch.harness import FERSweep, css_logical_sweep, dem_logical_sweep
    from ldpcdecoders_tpu_torch.utils.metrics import wilson_interval

    def strip(summary):
        return {p: {k: v for k, v in pt_.items() if k != "throughput_syndromes_per_s"}
                for p, pt_ in summary.items()}

    # (t) FERSweep: BP+OSD-0 on the (1000, 10, 9) code, host sampling, 4
    # batches in flight, counts reduced on the card
    def bposd0(per):
        return pt.BeliefPropagationOSDDecoder(H, per, MAX_ITERS, device=dev)

    sweep_kw = dict(batch=B, seed=0, pipeline=4)
    fer = drive("t", ["gf2_osd0"], lambda: FERSweep(H, bposd0, T_PERS, **sweep_kw).run(
        trials_per_point=T_TRIALS))
    base = json.loads((ROOT / "benchmarks/results/fer_baseline.json").read_text())
    base = base["results"]["bposd0"]
    for per, s in fer.items():
        ref = base.get(str(per))
        lo, hi = s["ler_ci95"]
        print(f"main (t) FERSweep BP+OSD-0 (1000, 10, 9) per {per}: {s['trials']} trials, LER "
              f"{s['ler']:.4e} (Wilson 95% {lo:.4e}-{hi:.4e}), syndrome match "
              f"{s['syndrome_match_rate']:.4f}, converged {s['converged_fraction']:.4f}, mean "
              f"iterations {s['mean_iters']:.3f}, {s['throughput_syndromes_per_s']:.1f} "
              f"syndromes/s"
              + (f"; fer_baseline.json {ref['ler']:.4e} ({ref['ler_ci95'][0]:.4e}-"
                 f"{ref['ler_ci95'][1]:.4e}), overlap {overlap(s['ler_ci95'], ref['ler_ci95'])}"
                 if ref else "") + f" | B={B} | {card}")
        if s["syndrome_match_rate"] != 1.0:
            raise AssertionError(f"(t) per {per}: OSD outputs miss their syndrome")
        if ref and not overlap(s["ler_ci95"], ref["ler_ci95"]):
            raise AssertionError(f"(t) per {per}: the LER interval misses fer_baseline.json's")
    if sum(str(per) in base for per in fer) != 5:
        raise AssertionError("(t): fer_baseline.json lacks the five low points")
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "fer.json")
        FERSweep(H, bposd0, T_PERS, checkpoint_path=ck, **sweep_kw).run(
            trials_per_point=T_TRIALS // 2)
        resumed = FERSweep(H, bposd0, T_PERS, checkpoint_path=ck, **sweep_kw)
        half = {p: s.trials for p, s in resumed.points.items()}
        again = resumed.run(trials_per_point=T_TRIALS)
    same = strip(again) == strip(fer)
    print(f"main (t) a sweep stopped at {T_TRIALS // 2} trials a point ({half}) and resumed from "
          f"its checkpoint to {T_TRIALS}: counts equal to the uninterrupted sweep's {same}")
    if not same:
        raise AssertionError("(t): the resumed sweep's counts differ from the uninterrupted one")
    on_cpu, on_card = (strip(FERSweep(H, lambda p, d=d: pt.BeliefPropagationOSDDecoder(
        H, p, MAX_ITERS, device=d), [0.01], **sweep_kw).run(trials_per_point=T_CPU_TRIALS))
        for d in ("cpu", dev))
    print(f"main (t) per 0.01, {T_CPU_TRIALS} trials, the card against the CPU: counts equal "
          f"{on_cpu == on_card} ({on_card[0.01]})")
    if on_cpu != on_card:
        raise AssertionError("(t): the card's sweep counts differ from the CPU's")

    # (u) FER parity: benchmarks/fer_parity.py's five decoders on its code
    # and streams, against the committed goldens of fer_parity_r4.json
    art = json.loads((ROOT / "benchmarks/results/fer_parity_r4.json").read_text())
    Hu = pt.parity_check_matrix(120, 6, 3, rng=61)
    tolerance = {"bp": 0.002, "bposd0": 0.002, "bposd2": 0.002, "bitflip": 0.01, "bpots": 0.01}
    factories = {
        "bp": lambda per: pt.BeliefPropagationDecoder(Hu, per, MAX_ITERS, device=dev),
        "bposd0": lambda per: pt.BeliefPropagationOSDDecoder(Hu, per, MAX_ITERS, device=dev),
        "bposd2": lambda per: pt.BeliefPropagationOSDDecoder(Hu, per, MAX_ITERS, osd_order=2,
                                                             device=dev),
        "bitflip": lambda per: pt.BitFlipDecoder(Hu, per, MAX_ITERS, device=dev),
        "bpots": lambda per: pt.BPOTSDecoder(Hu, per, MAX_ITERS, T=9, C=2.0, device=dev),
    }

    # Bit-flip's outcome depends on its tie-break stream: one stream's LER at
    # per 0.05 spreads over 0.481-0.521 in the JAX package itself (16 decode
    # seeds on these syndromes), so the golden, itself one stream, is held
    # against the mean over U_BITFLIP_SEEDS of the port's streams
    def parity():
        rows = {}
        for name, factory in factories.items():
            for point in art["decoders"][name]:
                per = point["per"]
                rng = np.random.default_rng((0, int(per * 1e9), 7))
                errs = rng.random((U_TRIALS, Hu.shape[1])) < per
                syns = (errs @ Hu.T) % 2
                dec = factory(per)
                lers, smrs, dts = [], [], []
                for seed in range(U_BITFLIP_SEEDS if name == "bitflip" else 1):
                    t0 = time.perf_counter()
                    guesses, _ = dec.batch_decode(syns, seed=seed)
                    dts.append(time.perf_counter() - t0)
                    lers.append(1.0 - (guesses.astype(bool) == errs).all(axis=1).mean())
                    smrs.append(((guesses.astype(np.int64) @ Hu.T) % 2 == syns).all(axis=1).mean())
                rows[(name, per)] = (lers, smrs, dts, point)
        return rows

    rows = drive("u", ["gf2_osd0", "gf2_eliminate"], parity)
    for (name, per), (lers, smrs, dts, point) in rows.items():
        ler, smr = float(np.mean(lers)), float(np.mean(smrs))
        d_ler, d_smr = abs(ler - point["ler_golden"]), abs(smr - point["syndrome_match_golden"])
        ok = d_ler <= tolerance[name] and d_smr <= tolerance[name]
        streams = (f" (mean of {len(lers)} tie-break streams, each "
                   f"{', '.join(f'{x:.4f}' for x in lers)})" if len(lers) > 1 else "")
        print(f"main (u) {name} per {per}: LER {ler:.4f}{streams} (golden "
              f"{point['ler_golden']:.4f}, |delta| {d_ler:.4f}), syndrome match {smr:.4f} "
              f"(golden {point['syndrome_match_golden']:.4f}, |delta| {d_smr:.4f}), tolerance "
              f"{tolerance[name]}: {ok}; {U_TRIALS / dts[0]:.1f} syndromes/s (first call), "
              f"{U_TRIALS / min(dts):.1f} (best) | {card}")
        if not ok:
            raise AssertionError(f"(u) {name} per {per}: off fer_parity_r4.json's golden")

    # (v) css_logical_sweep on the bb144 gross code: the loss-free points
    # through the device route, one heralded-loss point through the host loop
    bb = json.loads((ROOT / "benchmarks/results/bicycle_ler_r2.json").read_text())["points"]
    Hx, Hz, _ = pt.named_bicycle_code("bb144")
    css = drive("v", ["gf2_osd0"], lambda: css_logical_sweep(
        Hx, Hz, V_PERS, trials_per_point=V_PAIRS, batch=B, seed=0, device=dev))
    for per, s in css.items():
        ref = bb[str(per)]
        ok = overlap(s["any_logical_ci95"], ref["any_logical_ci95"])
        print(f"main (v) css_logical_sweep bb144 BP+OSD-0 per {per}: {s['trials']} pairs "
              f"(device-sampled {s['device_sampled']}), any-logical rate "
              f"{s['any_logical_rate']:.4e} (Wilson 95% {s['any_logical_ci95'][0]:.4e}-"
              f"{s['any_logical_ci95'][1]:.4e}); bicycle_ler_r2.json {ref['any_logical_rate']:.4e} "
              f"({ref['any_logical_ci95'][0]:.4e}-{ref['any_logical_ci95'][1]:.4e}), overlap {ok}; "
              f"converged z {s['z_converged']:.4f} x {s['x_converged']:.4f}, "
              f"{s['throughput_pairs_per_s']:.1f} pairs/s | B={B} | {card}")
        if not (ok and s["device_sampled"] and s["trials"] == V_PAIRS and ref["any_logical_rate"]):
            raise AssertionError(f"(v) per {per}: the interval misses bicycle_ler_r2.json's")
    loss = drive("v_loss", [], lambda: css_logical_sweep(
        Hx, Hz, [0.02], trials_per_point=V_LOSS_PAIRS, batch=B, seed=0, loss_rate=0.05,
        device=dev))[0.02]
    print(f"main (v) heralded loss 0.05 at per 0.02 (host loop, erasures= priors): "
          f"{loss['trials']} pairs, any-logical rate {loss['any_logical_rate']:.4e}, converged z "
          f"{loss['z_converged']:.4f} x {loss['x_converged']:.4f}, "
          f"{loss['throughput_pairs_per_s']:.1f} pairs/s | {card}")
    if loss["trials"] != V_LOSS_PAIRS or not 0.0 <= loss["any_logical_rate"] < 1.0:
        raise AssertionError("(v): the heralded-loss point did not run through")

    # (w) dem_logical_sweep on the surface d=5, 5-round memory circuit's DEM:
    # BP+OSD-0 (K1 where BP fails), 60 iterations, device-sampled at p 0.002
    # against circuit_level_r3.json; at p 0.003 circuit-sampled (host
    # Pauli frames) against DEM-sampled
    sx, sz = pt.surface_code_x(5), pt.surface_code_z(5)
    c2 = pt.css_memory_circuit(sx, sz, 5, p=0.002)
    dem_kw = dict(shots=W_SHOTS, batch=W_BATCH, max_iters=60, rounds=5, device=dev)
    w2 = drive("w", ["gf2_osd0"], lambda: dem_logical_sweep(pt.circuit_dem(c2), seed=17,
                                                            **dem_kw))
    ref = json.loads((ROOT / "benchmarks/results/circuit_level_r3.json").read_text())
    ref = ref["surface_d5_R5"]["0.002"]
    ok = overlap(w2["logical_ci95"], wilson_interval(ref["fails"], ref["shots"]))
    print(f"main (w) dem_logical_sweep surface d=5 R=5 p=0.002, DEM-sampled: {w2['shots']} shots, "
          f"{w2['fails']} fails, LER {w2['logical_rate']:.4e} (Wilson 95% "
          f"{w2['logical_ci95'][0]:.4e}-{w2['logical_ci95'][1]:.4e}), per round "
          f"{w2['per_round_rate']:.4e}; circuit_level_r3.json {ref['fails']}/{ref['shots']}, "
          f"overlap {ok}; converged {w2['converged']:.4f}, {w2['throughput_shots_per_s']:.1f} "
          f"shots/s | batch {W_BATCH} | {card}")
    if not (ok and w2["device_sampled"]):
        raise AssertionError("(w): the DEM-sampled interval misses circuit_level_r3.json's")
    c3 = pt.css_memory_circuit(sx, sz, 5, p=0.003)
    dem3 = pt.circuit_dem(c3)
    w3 = drive("w_circuit", ["gf2_osd0"], lambda: (
        dem_logical_sweep(dem3, seed=23, circuit=c3, **dem_kw),
        dem_logical_sweep(dem3, seed=17, **dem_kw)))
    ok = overlap(w3[0]["logical_ci95"], w3[1]["logical_ci95"])
    for what, r in zip(("circuit-sampled (host sample_circuit)", "DEM-sampled"), w3):
        print(f"main (w) p=0.003 {what}: {r['shots']} shots, {r['fails']} fails, LER "
              f"{r['logical_rate']:.4e} (Wilson 95% {r['logical_ci95'][0]:.4e}-"
              f"{r['logical_ci95'][1]:.4e}), converged {r['converged']:.4f}, "
              f"{r['throughput_shots_per_s']:.1f} shots/s | {card}")
    print(f"main (w) p=0.003 circuit-sampled and DEM-sampled intervals overlap {ok}")
    if not ok or w3[0]["device_sampled"]:
        raise AssertionError("(w): circuit-sampled and DEM-sampled rates disagree")

    # bit-flip and BP-OTS on the (1000, 10, 9) code at B=1024: rates and
    # launches per iteration (both loop in plain torch with a host read an
    # iteration)
    rng = np.random.default_rng(31)
    for per in (0.01, 0.03):
        syn = torch.as_tensor(syndromes(H, per, rng)[1], device=dev)
        for name, dec, fn in (
                ("bit-flip", pt.BitFlipDecoder(H, per, MAX_ITERS, device=dev),
                 lambda d, s: d.bitflip(s, 0)),
                ("BP-OTS", pt.BPOTSDecoder(H, per, MAX_ITERS, device=dev),
                 lambda d, s: d.bpots(s))):
            t, out = wall_s(torch, lambda: fn(dec, syn), 3)
            its = int(out[2].max())
            wall_ms, busy, launches, _ = profile_call(torch, f"{name} per {per}",
                                                      lambda: fn(dec, syn), its)
            print(f"rate {name} per {per}: {B / t:.1f} syndromes/s ({t * 1e3:.1f} ms/batch), "
                  f"converged {out[1].float().mean():.4f}, iterations mean "
                  f"{out[2].float().mean():.2f} max {its}; {launches / its:.1f} launches per "
                  f"iteration, device busy {100 * busy / wall_ms:.1f}% | B={B} | {card}")


def main() -> int:
    import torch

    want_profile = "--profile" in sys.argv[1:]

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    import ldpcdecoders_tpu_torch as pt
    from ldpcdecoders_tpu_torch import _build
    from ldpcdecoders_tpu_torch.models.minsum import lane_tile_for
    from ldpcdecoders_tpu_torch.models.priors import per_to_llr
    from ldpcdecoders_tpu_torch.ops import cuda_gf2, cuda_minsum, cuda_qc, gf2
    from ldpcdecoders_tpu_torch.ops import minsum as plain_minsum
    from ldpcdecoders_tpu_torch.ops.qc_minsum import (qc_flooding_state, qc_launch_shape,
                                                      qc_minsum_ref, qc_smem_bytes)

    # float32 products here are 0/1 sums; keep them in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"device: {kind} | torch {torch.__version__} | cuda {torch.version.cuda}")

    # 2. build
    path, build_s, log = _build.build_library()
    print(f"build: nvcc {build_s:.2f} s -> {path.name}")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")

    H = pt.parity_check_matrix(1000, 10, 9, rng=42)
    graph = pt.TannerGraph.from_pcm(H)
    m, n = graph.m, graph.n
    rng = np.random.default_rng(0)
    errs01, syn01 = syndromes(H, 0.01, rng)
    errs20, syn20 = syndromes(H, 0.2, rng)
    _, syn50 = syndromes(H, 0.5, rng)
    _, syn05 = syndromes(H, 0.05, rng)

    # 3. kernels against their plain versions at the main path's shape:
    # the sorted, packed systems of a per-0.2 batch (every lane fails BP)
    dec0 = pt.BeliefPropagationOSDDecoder(graph, 0.01, MAX_ITERS, device=dev)
    s20 = torch.as_tensor(syn20, device=dev)
    bp_err, _, _, logp = dec0.bp(s20, dec0.bp.as_prior(0.2))
    perm, Ht, bp_sorted = dec0.osd.sort_and_pack(bp_err, logp)
    hb = bp_err.to(torch.float32) @ dec0.osd.H_cols_f
    resid = (s20.to(torch.int32) ^ (hb.to(torch.int32) & 1)).contiguous()
    s_int = s20.to(torch.int32).contiguous()
    print(f"kernel inputs: Ht {tuple(Ht.shape)} int32, lanes with a nonzero residual "
          f"{int((resid != 0).any(dim=1).sum())} of {B}")

    # the eliminations' operations depend on the data.  The plain versions
    # count, per lane, the column trips made before the lane stops (OSD-0:
    # no residual left outside the pivot space; elimination: full rank) and
    # the rows each pivot is XORed into.  A trip tests bit j of all m rows
    # (a shift and a mask each); a row XOR needs the words from the pivot's
    # on (the pivot row is zero before it) and the syndrome bit.
    W = Ht.shape[1]

    def elim_ops(work, what):
        trips, row_xors, words = (int(t.sum()) for t in work)
        print(f"work {what}: {trips / B:.1f} trips and {row_xors / B:.1f} row XORs per lane "
              f"({row_xors / max(trips, 1):.2f} rows per trip of {m}; "
              f"{words / max(row_xors, 1):.2f} words a row XOR of {W + 1})")
        return trips * m * 2 + words

    osd0_ops = elim_ops(gf2.gf2_osd0(Ht, resid, bp_sorted, n, return_work=True)[1], "gf2_osd0")
    full_ops = elim_ops(gf2.gf2_eliminate(Ht, s_int, n, return_work=True)[4], "gf2_eliminate")
    gf2_src = "ldpcdecoders_tpu_torch/csrc/gf2_elim.cu"
    shape_gf2 = f"B={B} W={Ht.shape[1]} m={m} n={n}"
    corr_bytes, piv_bytes = B * n * 4, B * m * 4
    cases = [
        ("gf2_osd0", gf2_src, "ldpcdecoders_tpu/ops/pallas_gf2.py:93", shape_gf2,
         lambda: (cuda_gf2.gf2_osd0_cuda(Ht, resid, bp_sorted, n),),
         lambda: (cuda_gf2.gf2_osd0_ref(Ht, resid, bp_sorted, n),),
         bound(nbytes(Ht, resid, bp_sorted) + corr_bytes, osd0_ops, PEAK_I32_OPS_PER_S)),
        ("gf2_eliminate", gf2_src, "ldpcdecoders_tpu/ops/pallas_gf2.py:39", shape_gf2,
         lambda: cuda_gf2.gf2_eliminate_cuda(Ht, s_int, n),
         lambda: cuda_gf2.gf2_eliminate_ref(Ht, s_int, n),
         bound(2 * nbytes(Ht, s_int) + piv_bytes, full_ops, PEAK_I32_OPS_PER_S)),
    ]

    # min-sum kernels: the messages entering the second iteration of a
    # per-0.05 batch (mixed magnitudes and signs), float32 and bfloat16, read
    # through the index table (the main path) and directly; K4 also in its
    # iteration form (the damped leave-one-out messages in place, as the
    # damped inner of (g), (h), (m) launches it)
    s05 = torch.as_tensor(syn05, device=dev)
    flip05 = s05.to(torch.bool)
    minsum_src = "ldpcdecoders_tpu_torch/csrc/minsum.cu"
    dc, dv = graph.max_dc, graph.max_dv
    library = {}  # library_ms of a kernel's first case: torch.sparse.mm for K4's totals
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        ms = pt.MinSumDecode(graph, 0.05, MAX_ITERS, device=dev, dtype=dtype, alpha=0.8)
        deg = dict(chk_deg=ms.chk_deg)
        vdeg = dict(var_deg=ms.var_deg)
        L0 = torch.broadcast_to(ms.default_L0, (B, n)).contiguous()
        nu0 = torch.broadcast_to(L0[:, None, :], (B, dv, n)).reshape(B, dv * n).contiguous()
        mu1 = cuda_minsum.minsum_check_cuda(nu0, ms.c2v, flip05, ms.chk_mask, ms.alpha, 0.0,
                                            **deg)
        nu1, _ = cuda_minsum.minsum_var_cuda(mu1.reshape(B, dc * m), ms.v2c, ms.var_mask, L0,
                                             **vdeg)
        nu1 = nu1.reshape(B, dv * n)
        Ng1 = nu1.index_select(1, ms.c2v).reshape(B, dc, m).contiguous()
        mu2 = cuda_minsum.minsum_check_cuda(nu1, ms.c2v, flip05, ms.chk_mask, ms.alpha, 0.0,
                                            **deg)
        mu2 = mu2.reshape(B, dc * m)
        chk_ops, var_ops = 14 * B * dc * m, 4 * B * dv * n
        out_chk, out_var = nbytes(mu2), nbytes(nu1, L0)
        if dtype == torch.float32:
            S = slot_incidence(torch, ms)
            library["minsum_var"] = event_ms(torch, lambda S=S, mu2=mu2: torch.sparse.mm(
                S, mu2.t()), 10)
        # the in-place forms: kernel and plain version each on its own copy
        # of the previous messages (this code has no padded slot).  Path (e)
        # launches K3's gathered form and K4's iteration form on the batch's
        # lane tile (MinSumDecode's rule in the variable layout): those rows
        # come first, the kernel's outputs tiled and the plain lane-major
        # version's tiled after it (its time includes that copy); the
        # lane-major forms follow as variants
        gam = torch.tensor(0.4).to(dtype).to(dev)
        Te = ms._tile(B, dev)

        def tl(t, Te=Te):
            return t if t.ndim == 0 else plain_minsum.tile_lanes(t, Te)

        def fresh():  # a copy of the previous messages for one case's kernel or plain version
            return nu1.reshape(B, dv, n).clone()

        tot_k, tot_p = torch.empty_like(L0), torch.empty_like(L0)
        tot_kt, mu2_t, L0_t, nu1_t, flip05_t = tl(tot_k), tl(mu2), tl(L0), tl(nu1), tl(flip05)
        kt = dict(lane_tile=Te)

        def chk(x, idx, ms=ms, deg=deg, flip=flip05, kw=None):
            return lambda: (cuda_minsum.minsum_check_cuda(x, idx, flip, ms.chk_mask,
                                                          ms.alpha, 0.0, **deg, **(kw or {})),)

        def chk_plain(x, idx, ms=ms, out=lambda t: t):
            if idx is None:
                return lambda: (plain_minsum.check_core_ref(x, flip05, ms.chk_mask,
                                                            ms.alpha, 0.0),)
            return lambda: (out(plain_minsum.check_update_ref(x, idx, flip05, ms.chk_mask,
                                                              ms.alpha, 0.0)),)

        def var_kern(nu, tot, gamma=None, mu=mu2, L0=L0, ms=ms, vdeg=vdeg, kw=None):
            return lambda: (nu, cuda_minsum.minsum_var_iter_cuda(
                mu, ms.v2c, ms.var_mask, L0, nu=nu, gamma=gamma, total=tot, **vdeg,
                **(kw or {})))

        def var_plain(nu, tot, gamma=None, out=lambda t: t, ms=ms, L0=L0, mu2=mu2):
            def run():
                total = plain_minsum.var_iter_ref(mu2, ms.v2c, ms.var_mask, L0, nu=nu,
                                                  gamma=gamma, total=tot)
                return out(nu), out(total)
            return run

        b_chk = bound(nbytes(nu1, ms.c2v, flip05, ms.chk_mask) + out_chk, chk_ops,
                      PEAK_F32_OPS_PER_S)
        b_var = bound(nbytes(mu2, ms.v2c, ms.var_mask, L0) + out_var + nbytes(nu1), var_ops,
                      PEAK_F32_OPS_PER_S)
        # 4 operations a slot more for the mix
        b_mix = bound(nbytes(mu2, ms.v2c, ms.var_mask, L0) + out_var + nbytes(nu1),
                      var_ops * 2, PEAK_F32_OPS_PER_S)
        shape_c, shape_v = f"B={B} dc={dc} m={m}", f"B={B} dv={dv} n={n}"
        cases += [
            (f"minsum_check {tag} gathered, lane tile {Te}", minsum_src,
             "ldpcdecoders_tpu/ops/pallas_minsum.py:53", shape_c,
             chk(nu1_t, ms.c2v, flip=flip05_t, kw=kt), chk_plain(nu1, ms.c2v, out=tl), b_chk),
            (f"minsum_check {tag} gathered lane-major", minsum_src,
             "ldpcdecoders_tpu/ops/pallas_minsum.py:53", shape_c,
             chk(nu1, ms.c2v), chk_plain(nu1, ms.c2v), b_chk),
            (f"minsum_check {tag} direct", minsum_src,
             "ldpcdecoders_tpu/ops/pallas_minsum.py:53", shape_c,
             chk(Ng1, None), chk_plain(Ng1, None),
             bound(nbytes(Ng1, flip05, ms.chk_mask) + out_chk, chk_ops,
                   PEAK_F32_OPS_PER_S)),
            # path (e)'s undamped update in place, then the damped one of
            # (g), (h), (m)
            (f"minsum_var {tag} iteration form, lane tile {Te}", minsum_src,
             "ldpcdecoders_tpu/ops/pallas_minsum.py:91", shape_v,
             var_kern(tl(fresh()), tot_kt, mu=mu2_t, L0=L0_t, kw=kt),
             var_plain(fresh(), tot_p, out=tl), b_var),
            (f"minsum_var {tag} iteration form, damped in place, lane tile {Te}", minsum_src,
             "ldpcdecoders_tpu/ops/pallas_minsum.py:91", f"{shape_v} gamma 0.4",
             var_kern(tl(fresh()), tot_kt, gam, mu=mu2_t, L0=L0_t, kw=kt),
             var_plain(fresh(), tot_p, gam, out=tl), b_mix, (10, 2)),
            # the same forms lane-major
            (f"minsum_var {tag} iteration form lane-major", minsum_src,
             "ldpcdecoders_tpu/ops/pallas_minsum.py:91", shape_v,
             var_kern(fresh(), tot_k), var_plain(fresh(), tot_p), b_var),
            (f"minsum_var {tag} iteration form, damped in place lane-major", minsum_src,
             "ldpcdecoders_tpu/ops/pallas_minsum.py:91", f"{shape_v} gamma 0.4",
             var_kern(fresh(), tot_k, gam), var_plain(fresh(), tot_p, gam), b_mix, (10, 2)),
            # the TPU kernel's interface: fresh leave-one-out messages
            (f"minsum_var {tag} fresh", minsum_src,
             "ldpcdecoders_tpu/ops/pallas_minsum.py:91", f"B={B} dv={dv} n={n}",
             lambda mu2=mu2, ms=ms, L0=L0, vdeg=vdeg: cuda_minsum.minsum_var_cuda(
                 mu2, ms.v2c, ms.var_mask, L0, **vdeg),
             lambda mu2=mu2, ms=ms, L0=L0: plain_minsum.var_update_ref(
                 mu2, ms.v2c, ms.var_mask, L0),
             bound(nbytes(mu2, ms.v2c, ms.var_mask, L0) + out_var, var_ops,
                   PEAK_F32_OPS_PER_S)),
        ]

    # the whole-decode group-circulant kernel: the reference benchmark's QC
    # code (mb=12, nb=24, 72 terms, Z=128) at per 0.04, 32 sweeps, and the
    # bb144 six-round space-time lift (Z=72, 6-8 terms a row, 60 sweeps)
    base_qc = pt.random_qc_base_matrix(24, 6, 3, 128, rng=7)
    Hq = pt.qc_lift(base_qc, 128)
    rng_qc = np.random.default_rng(0)
    qerrs, qsyn = syndromes(Hq, 0.04, rng_qc)
    # erased bits (prior 0.5, LLR 0) on 8% of the positions, per lane
    erased = rng_qc.random(qerrs.shape) < 0.08
    qerrs_e = np.where(erased, rng_qc.random(qerrs.shape) < 0.5, qerrs)
    qsyn_e = ((qerrs_e.astype(np.float32) @ Hq.T.astype(np.float32)) % 2).astype(np.uint8)
    pri_e = torch.as_tensor(per_to_llr(np.where(erased, 0.5, 0.04), Hq.shape[1]),
                            dtype=torch.float32, device=dev)

    def qc_dec(**kw):
        return pt.QCMinSumDecoder(base_qc, 128, 0.04, 32, device=dev, **kw)

    qdec = qc_dec(schedule="layered")
    st = pt.SpaceTimeDecoder.for_bicycle("bb144", "x", 6, 0.003, 60, device=dev)
    rng_st = np.random.default_rng(9)
    st_x = (rng_st.random((BK, st.n_cols)) < st._prior[None, :]).astype(np.uint8)
    st_det = np.asarray((st.A.astype(np.int32) @ st_x.T.astype(np.int32)).T % 2, np.uint8)
    st_pri = torch.as_tensor(per_to_llr(st._prior, st.n_cols), dtype=torch.float32, device=dev)
    qc_src = "ldpcdecoders_tpu_torch/csrc/qc_minsum.cu"
    st_flood = pt.SpaceTimeDecoder.for_bicycle("bb144", "x", 6, 0.003, 60, schedule="flooding",
                                               device=dev)
    base_wide = pt.random_qc_base_matrix(60, 30, 3, 128, rng=7)
    wide_dec = pt.QCMinSumDecoder(base_wide, 128, 0.003, 32, device=dev)
    _, wide_syn = syndromes(pt.qc_lift(base_wide, 128), 0.003, np.random.default_rng(4))

    # operations per edge position and sweep that the function needs, counted
    # from the decode's body.  Check rule: min-sum 14 (as the min-sum check
    # kernel: abs, sign, compare, min, three selects, parity; then select,
    # multiply, subtract, max, two XORs); sum-product 17 with tanh and each
    # log1p counted as ONE operation (no published rate exists for them, so
    # the bound stays a lower one): halve, tanh, clamp 2, suffix and prefix
    # product 2, their product 1, clamp 2, two log1p, subtract, clamp 2,
    # negate and select by the syndrome 2.  Around it: layered 3 (total
    # minus old message; new minus old, plus total) and 2 for the syndrome
    # check (decision and XOR); flooding 2 (sum and leave-one-out
    # difference) and 1.  Index arithmetic, at the integer rate: ONE shifted
    # position per edge position and sweep (per cyclic factor larger than 1
    # an add, a compare and a subtract; with two factors a multiply and an
    # add to join them) and two address adds (the message's, the total's).
    def qc_int_ops(t):
        factors = (t.l > 1) + (t.m > 1)
        return 3 * factors + (2 if factors == 2 else 0) + 2

    def qc_case(label, dec, syn_np, priors, shape):
        syn_t = torch.as_tensor(syn_np, device=dev)
        kw = dict(alpha=dec.alpha, beta=dec.beta, schedule=dec.schedule,
                  algorithm=dec.algorithm, dtype=dec.dtype, priors=priors)
        t = dec.qc_terms
        layered, sumprod = dec.schedule == "layered", dec.algorithm == "sumproduct"
        f_ops = (17 if sumprod else 14) + (5 if layered else 3)
        i_ops = qc_int_ops(t)
        size = 4 if dec.dtype == torch.float32 else 2
        threads, smem = qc_launch_shape(t, size, layered, sumprod, prior=priors is not None)
        # the layered sweep's rows: one phase where the row's block columns
        # are distinct, two (through the float32 row buffer) where one repeats
        two = sum(t.two_phase_rows)
        state = qc_flooding_state(t, sumprod)
        on_chip = (not layered and priors is not None
                   and smem > qc_smem_bytes(t, threads, size, False, sumprod))
        phases = (f"{t.mb - two} rows in one phase, {two} in two" if layered else
                  f"flooding: {state}, prior {'on chip' if on_chip else 'not on chip'}")
        # shared-memory bytes per lane and sweep.  Layered, over the rows'
        # edge positions: a one-phase row reads the total and the message
        # once, writes each once, and the syndrome check reads the total
        # again (5 stored values; fewer where a violated check ends the
        # check early); a two-phase row adds the row buffer's float32 write
        # and read and reads the total and message again (7 stored values
        # and 8 bytes).  Flooding: the check pass reads each edge's float32
        # total, and a check position's syndrome byte; two-min states are
        # read and written once a check position (2 magnitudes and a word)
        # and read again an edge by the variable pass, messages read and
        # written an edge and read again by the variable pass; the variable
        # pass writes each float32 total and reads its prior from shared
        # memory where it is on chip
        Ec, Mc, Nc = t.Eb * t.Z, t.mb * t.Z, t.nb * t.Z
        if layered:
            traffic = sum(len(r) * t.Z * (7 * size + 8 if rep else 5 * size)
                          for r, rep in zip(t.row_edges, t.two_phase_rows))
        elif state == "two_min":
            traffic = (4 * Ec + Mc * (1 + 2 * (2 * size + 4)) + Ec * (2 * size + 4)
                       + Nc * (4 + 4 * on_chip))
        else:
            traffic = 4 * Ec + Mc + 3 * size * Ec + Nc * (4 + 4 * on_chip)

        def bounds(got):
            # this batch's work: each lane's own sweeps
            edge_sweeps = int(got[2].sum()) * t.Eb * t.Z
            out = bound(nbytes(syn_t, priors, dec.table, *got), edge_sweeps * f_ops,
                        PEAK_F32_OPS_PER_S, edge_sweeps * i_ops)
            print(f"work {label}: sweeps per lane mean {got[2].float().mean():.2f} max "
                  f"{int(got[2].max())}, converged {got[1].float().mean():.4f}, "
                  f"{f_ops} float32-rate + {i_ops} integer operations per edge position "
                  f"and sweep, {edge_sweeps:.4e} edge-sweeps | one lane per block of "
                  f"{threads} threads, {smem} B shared memory, {phases}, "
                  f"{traffic} B shared-memory traffic per lane and sweep")
            return out

        return (f"qc_minsum {label}", qc_src, "ldpcdecoders_tpu/ops/pallas_qc.py:202", shape,
                lambda: cuda_qc.qc_minsum_cuda(syn_t, t, dec.table, dec.L0, dec.max_iters, **kw),
                lambda: qc_minsum_ref(syn_t, t, dec.L0, dec.max_iters, **kw), bounds,
                (3, 1), sumprod)

    shape_qc = f"B={B} mb=12 nb=24 Eb=72 Z=128 sweeps<=32"
    cases += [
        qc_case("layered f32", qdec, qsyn, None, shape_qc),
        qc_case("flooding f32", qc_dec(), qsyn, None, shape_qc),
        qc_case("layered bf16", qc_dec(schedule="layered", dtype=torch.bfloat16), qsyn, None,
                shape_qc),
        qc_case("layered f32 per-lane priors", qdec, qsyn_e, pri_e, shape_qc),
        qc_case("flooding f32 sumproduct", qc_dec(algorithm="sumproduct"), qsyn, None, shape_qc),
        qc_case("bb144 R=6 layered f32 prior vector", st.inner, st_det, st_pri,
                f"B={BK} mb=6 nb=17 Eb=46 Z=72 (12x6) sweeps<=60"),
        # the flooding body (PR 15): the default schedule's other forms, the
        # multi-term case, and rows past the two-min word's 27 signs (a
        # (30, 3)-regular nb=60 code: every message kept)
        qc_case("flooding bf16", qc_dec(dtype=torch.bfloat16), qsyn, None, shape_qc),
        qc_case("flooding f32 per-lane priors", qc_dec(), qsyn_e, pri_e, shape_qc),
        qc_case("bb144 R=6 flooding f32 prior vector", st_flood.inner, st_det, st_pri,
                f"B={BK} mb=6 nb=17 Eb=46 Z=72 (12x6) sweeps<=60"),
        qc_case("flooding f32 rows of 30", wide_dec, wide_syn, None,
                f"B={B} mb=6 nb=60 Eb=180 Z=128 sweeps<=32 per 0.003"),
    ]

    # the bb144 R=6 circuit-level DEM (864 checks x 31,648 mechanisms, check
    # degree up to 294, variable degree up to 12): K3/K4 at its shape below
    dem_A, dem_pr, dem_O = load_bb144_dem()
    dem_graph = pt.TannerGraph.from_pcm(np.asarray(dem_A.todense()))
    dem_x = (np.random.default_rng(21).random((max(BDEM, 6 * DEEP_BUCKET), dem_graph.n))
             < dem_pr).astype(np.float32)
    dem_det = torch.as_tensor((dem_x @ dem_A.T.toarray().astype(np.float32)) % 2 == 1,
                              device=dev)
    dem_llr = torch.as_tensor(np.log((1 - dem_pr) / dem_pr), device=dev)

    # step 0: K1/K2's device-memory body at the lanes past a block
    global_cases, global_turns = global_body_cases(torch, pt, dev, dem_graph, dem_pr)
    cases += global_cases

    # one entry per kernel in the summary: the first case of each name is
    # the main path's (float32; gathered; layered with the baked prior); the
    # others add their times
    kernels = {}
    for name, source, replaces, shape, kern, plain, bounds, *rest in cases:
        (reps_k, reps_p), loose = (rest + [False])[:2] if rest else ((10, 2), False)
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        if callable(bounds):
            bounds = bounds(got)
        bound_ms, bound_by, by_bytes, by_ops = bounds
        # sum-product: the flags bitwise; the LLRs in float32 spacings (raw
        # bit distance).  tanhf and log1pf are the same library functions in
        # the kernel and in torch's kernels, but one spacing of a tanh
        # product near the clamp moves a message by 2/(1 - 0.99999^2) = 1e5
        # times as much: up to 2^13 spacings of an LLR are allowed
        err = max_abs_err(torch, got[:3] if loose else got, want[:3] if loose else want)
        need = "bitwise required"
        if loose:
            spacings = max_abs_err(torch, got[3:], want[3:])
            need = (f"err/converged/iters bitwise required; llrs {spacings} float32 spacings "
                    f"apart, {2**13} allowed (tanhf/log1pf at the clamp)")
            if spacings > 2**13:
                raise AssertionError(f"{name}: LLRs {spacings} float32 spacings apart")
        ms_k = event_ms(torch, kern, reps_k)
        plain_ms = event_ms(torch, plain, reps_p)
        key, _, variant = name.partition(" ")
        lib_ms = library.get(key) if key not in kernels else None
        print(f"kernel {name}: max_abs_err {err} ({need}) | kernel {ms_k:.3f} ms | "
              f"plain torch {plain_ms:.3f} ms | bound {bound_ms:.4f} ms by {bound_by} "
              f"(bytes {by_bytes:.4f}, operations {by_ops:.4f}) | library call: "
              + ("none" if lib_ms is None else f"torch.sparse.mm {lib_ms:.3f} ms")
              + f" | {shape} | {card}")
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version")
        if key not in kernels:
            kernels[key] = {"name": key, "route": "cuda", "source": source,
                            "replaces": replaces, "max_abs_err": err, "ms": ms_k,
                            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": lib_ms, "variants": {}}
        else:
            kernels[key]["max_abs_err"] = max(kernels[key]["max_abs_err"], err)
            kernels[key]["variants"][variant] = {"ms": ms_k, "plain_ms": plain_ms,
                                                 "bound_ms": bound_ms}
            if loose:
                kernels[key]["variants"][variant]["llr_spacings"] = spacings

    clock_lib = _build.load_library(("LDPC_GF2_PHASE_CLOCKS",)) if want_profile else None
    global_body_turns(torch, cuda_gf2, global_turns, kernels, card, clock_lib)

    # K3/K4 at the bb144 DEM's shape in the forms the staged decoder's
    # iteration launches (check layout): K3's iteration form (the rebuild
    # total[var] - mu, the damping mix and the check update, in place over mu
    # and nu; staged and flat) and K4's totals with the freeze of err / llrs
    # (on the check iterations; the totals alone on the others).  Inputs: the
    # state after the first iteration of a stage-0 batch (path (p): float32,
    # 2048 records, damping 0.4) and of a flagship deep bucket (path (q):
    # bfloat16, 6 members x 256 records, per-variable gammas in
    # [-0.24, 0.66)), every second lane done.  Kernel and plain version each
    # update their own copy of the state; the kernels leave a padded slot
    # alone, so the real slots are compared.  The bounds count the work of
    # the DEM's 203,444 edges: K3 reads and writes each edge's mu and nu and
    # reads the totals (and per-variable gammas) once, 19 float32 operations
    # an edge (the check update's 14, the rebuild's subtraction, the mix's
    # two products, its sum and 1 - g; one more per edge for per-variable
    # gammas); K4 reads mu once and writes the totals (and the active lanes'
    # err / llrs), an add per edge
    for tag, dtype, lanes, per_var in (("(p) stage-0 batch f32", torch.float32, BDEM, False),
                                       ("(q) deep bucket bf16", torch.bfloat16,
                                        6 * DEEP_BUCKET, True)):
        ms = pt.MinSumDecode(dem_graph, float(dem_pr.mean()), 2, device=dev, dtype=dtype,
                             layout="check")
        dc_d, m_d, dv_d, n_d = dem_graph.max_dc, dem_graph.m, dem_graph.max_dv, dem_graph.n
        flip = (dem_det[:DEEP_BUCKET].repeat(6, 1) if per_var else dem_det[:lanes]).contiguous()
        L0 = torch.broadcast_to(dem_llr.to(dtype), (lanes, n_d)).contiguous()
        gam = (torch.as_tensor(np.random.default_rng(3).uniform(-0.24, 0.66, (lanes, n_d)),
                               device=dev).to(dtype) if per_var
               else torch.tensor(0.4, device=dev).to(dtype))
        cvi, kw3, kw4 = ms.chk_varidx, dict(chk_deg=ms.chk_deg), dict(var_deg=ms.var_deg)
        mu0 = cuda_minsum.minsum_check_cuda(L0, cvi, flip, ms.chk_mask, ms.alpha, 0.0, **kw3)
        total0 = cuda_minsum.minsum_var_iter_cuda(mu0.reshape(lanes, -1), ms.v2c, ms.var_mask,
                                                  L0, total=torch.empty_like(L0), **kw4)
        nu0 = L0.index_select(1, cvi).reshape(lanes, dc_d, m_d)
        real = ms.chk_mask.reshape(-1)
        E, size = int(real.sum()), L0.element_size()
        shape_d = (f"B={lanes} dc={dc_d} m={m_d} dv={dv_d} n={n_d} (bb144 R=6 DEM, check "
                   f"layout, {'[B, n] gammas' if per_var else 'gamma 0.4'})")

        def k3(state, stage=None, ms=ms, flip=flip, gam=gam, total0=total0, kw3=kw3):
            return cuda_minsum.minsum_check_iter_cuda(
                state[0], total0, ms.chk_varidx, flip, ms.chk_mask, ms.alpha, 0.0, gamma=gam,
                nu=state[1], _stage=stage, **kw3)

        plain_state = [mu0.clone(), nu0.clone()]
        plain_minsum.check_iter_ref(plain_state[0], total0, cvi, flip, ms.chk_mask, ms.alpha, 0.0,
                                    gam, plain_state[1])
        want = [t.reshape(lanes, -1)[:, real] for t in plain_state]
        times, errs3 = {}, []
        for stage in (None, True, False):
            state = [mu0.clone(), nu0.clone()]
            k3(state, stage)
            torch.cuda.synchronize()
            errs3.append(max_abs_err(torch, [t.reshape(lanes, -1)[:, real] for t in state], want))
            times[stage] = event_ms(torch, lambda state=state, stage=stage: k3(state, stage), 5)
            del state
        plain_ms = event_ms(torch, lambda: plain_minsum.check_iter_ref(
            plain_state[0], total0, cvi, flip, ms.chk_mask, ms.alpha, 0.0, gam, plain_state[1]), 1)
        del plain_state, want
        threads, smem = cuda_minsum.stage_plan(n_d * size, m_d, dc_d)
        choice = "staged" if cuda_minsum.stages_by_default(n_d * size, m_d, dc_d) else "flat"
        b3 = bound(4 * lanes * E * size + nbytes(total0, flip, ms.chk_deg)
                   + (nbytes(gam) if per_var else 0) + E * 4,
                   (20 if per_var else 19) * lanes * E, PEAK_F32_OPS_PER_S)
        err3 = max(errs3)
        print(f"kernel minsum_check bb144 {tag} iteration form: max_abs_err {err3} on the real "
              f"slots of mu and nu (bitwise required; launcher's choice, staged, flat: "
              f"{errs3}) | kernel {times[None]:.3f} ms, the launcher's choice: {choice} (staged: "
              f"{threads} threads, {smem} B "
              f"shared memory, {times[True]:.3f} ms; flat {times[False]:.3f} ms) | plain torch "
              f"{plain_ms:.3f} ms | bound {b3[0]:.4f} ms by {b3[1]} (bytes {b3[2]:.4f}, "
              f"operations {b3[3]:.4f}) | library call: none | {shape_d} | {card}")
        if err3 != 0:
            raise AssertionError(f"minsum_check bb144 {tag}: kernel differs from its plain version")
        kernels["minsum_check"]["max_abs_err"] = max(kernels["minsum_check"]["max_abs_err"], err3)
        kernels["minsum_check"]["variants"][f"bb144 {tag} iteration form"] = {
            "ms": times[None], "form": choice, "staged_ms": times[True], "flat_ms": times[False],
            "plain_ms": plain_ms, "bound_ms": b3[0], "bound_by": b3[1]}

        # K4: totals and the freeze, every second lane done
        done = torch.arange(lanes, device=dev) % 2 == 1
        outs = {}
        for where in ("kernel", "plain"):
            tot, llrs = torch.empty_like(L0), L0.clone()
            err_t = torch.zeros((lanes, n_d), device=dev)
            fn = (cuda_minsum.minsum_var_iter_cuda if where == "kernel"
                  else plain_minsum.var_iter_ref)
            call = (lambda fn=fn, tot=tot, err_t=err_t, llrs=llrs, ms=ms, L0=L0, done=done,
                    mu0=mu0, lanes=lanes, kw=(kw4 if where == "kernel" else {}): fn(
                        mu0.reshape(lanes, -1), ms.v2c, ms.var_mask, L0, total=tot, done=done,
                        err=err_t, llrs=llrs, **kw))
            call()
            torch.cuda.synchronize()
            outs[where] = ((tot.clone(), err_t.clone(), llrs.clone()), call)
        err4 = max_abs_err(torch, outs["kernel"][0], outs["plain"][0])
        ms4 = event_ms(torch, outs["kernel"][1], 10)
        plain4 = event_ms(torch, outs["plain"][1], 2)
        ms4_totals = event_ms(torch, lambda ms=ms, L0=L0, mu0=mu0, lanes=lanes, kw4=kw4, tot=total0:
                              cuda_minsum.minsum_var_iter_cuda(mu0.reshape(lanes, -1), ms.v2c,
                                                               ms.var_mask, L0, total=tot, **kw4),
                              10)
        lib4 = None
        if dtype == torch.float32:
            S = slot_incidence(torch, ms)
            lib4 = event_ms(torch, lambda S=S, mu0=mu0, lanes=lanes: torch.sparse.mm(
                S, mu0.reshape(lanes, -1).t()), 3)
            del S
        active = int((~done).sum())
        b4 = bound(lanes * E * size + E * 4 + nbytes(L0, done, ms.var_deg) + lanes * n_d * size
                   + active * n_d * (4 + size), lanes * E + active * n_d, PEAK_F32_OPS_PER_S)
        print(f"kernel minsum_var bb144 {tag} totals and freeze: max_abs_err {err4} on the totals, "
              f"err and llrs (bitwise required) | kernel {ms4:.3f} ms (the totals alone "
              f"{ms4_totals:.3f} ms) | plain torch {plain4:.3f} ms | bound {b4[0]:.4f} ms by "
              f"{b4[1]} (bytes {b4[2]:.4f}, operations {b4[3]:.4f}) | library call: "
              + ("none" if lib4 is None else f"torch.sparse.mm {lib4:.3f} ms")
              + f" | {shape_d} | {card}")
        if err4 != 0:
            raise AssertionError(f"minsum_var bb144 {tag}: kernel differs from its plain version")
        kernels["minsum_var"]["max_abs_err"] = max(kernels["minsum_var"]["max_abs_err"], err4)
        kernels["minsum_var"]["variants"][f"bb144 {tag} totals and freeze"] = {
            "ms": ms4, "totals_only_ms": ms4_totals, "plain_ms": plain4, "bound_ms": b4[0],
            "bound_by": b4[1], "library_ms": lib4}

        # the same forms on lane tiles, the state as MinSumDecode keeps
        # it in the check layout (the batch's tile, lane_tile_for): K3's first
        # iteration (gathered from L0), its iteration form and K4's totals
        # with the freeze, each untiled and held against the plain lane-major
        # version; the same work, so the same bounds (the first iteration: L0
        # read once, every slot of mu written, 14 operations an edge)
        T = lane_tile_for(lanes)

        def tile(t, T=T):
            return t if t.ndim == 0 else plain_minsum.tile_lanes(t, T)

        def untile(t, T=T, lanes=lanes):
            return plain_minsum.untile_lanes(t, T)[:lanes]

        kt = dict(lane_tile=T)
        flip_t, L0_t, gam_t, total0_t = tile(flip), tile(L0), tile(gam), tile(total0)
        first = (lambda L0_t=L0_t, flip_t=flip_t, ms=ms, kw3=kw3:
                 cuda_minsum.minsum_check_cuda(L0_t, ms.chk_varidx, flip_t, ms.chk_mask,
                                               ms.alpha, 0.0, **kw3, **kt))
        first_plain = (lambda L0=L0, flip=flip, ms=ms: plain_minsum.check_update_ref(
            L0, ms.chk_varidx, flip, ms.chk_mask, ms.alpha, 0.0))
        err1 = max_abs_err(torch, [untile(first())], [first_plain()])
        b1 = bound(nbytes(L0, flip, ms.chk_varidx, ms.chk_deg, mu0), 14 * lanes * E,
                   PEAK_F32_OPS_PER_S)
        row1 = {"ms": event_ms(torch, first, 10), "plain_ms": event_ms(torch, first_plain, 2),
                "bound_ms": b1[0], "bound_by": b1[1], "max_abs_err": err1}
        state = [mu0.clone(), nu0.clone()]
        plain_minsum.check_iter_ref(state[0], total0, cvi, flip, ms.chk_mask, ms.alpha, 0.0, gam,
                                    state[1])
        want = [t.reshape(lanes, -1)[:, real] for t in state]
        state = [tile(mu0), tile(nu0)]
        k3t = (lambda state=state, ms=ms, flip_t=flip_t, gam_t=gam_t, total0_t=total0_t,
               kw3=kw3: cuda_minsum.minsum_check_iter_cuda(
                   state[0], total0_t, ms.chk_varidx, flip_t, ms.chk_mask, ms.alpha, 0.0,
                   gamma=gam_t, nu=state[1], **kw3, **kt))
        k3t()
        err3t = max_abs_err(torch, [untile(t).reshape(lanes, -1)[:, real] for t in state], want)
        del want
        row3 = {"ms": event_ms(torch, k3t, 5), "lane_major_ms": times[None],
                "plain_ms": plain_ms, "bound_ms": b3[0], "bound_by": b3[1], "max_abs_err": err3t}
        del state
        done_t = tile(done)
        tot_t = tile(torch.empty_like(L0))
        err_tt = tile(torch.zeros_like(L0, dtype=torch.float32))
        llrs_t = tile(L0)
        mu0_t = tile(mu0.reshape(lanes, -1))
        k4t = (lambda mu0_t=mu0_t, L0_t=L0_t, tot_t=tot_t, done_t=done_t, err_tt=err_tt,
               llrs_t=llrs_t, ms=ms, kw4=kw4: cuda_minsum.minsum_var_iter_cuda(
                   mu0_t, ms.v2c, ms.var_mask, L0_t, total=tot_t, done=done_t, err=err_tt,
                   llrs=llrs_t, **kw4, **kt))
        k4t()
        err4t = max_abs_err(torch, [untile(t) for t in (tot_t, err_tt, llrs_t)],
                            outs["plain"][0])
        row4 = {"ms": event_ms(torch, k4t, 10), "lane_major_ms": ms4,
                "totals_only_ms": event_ms(torch, lambda mu0_t=mu0_t, L0_t=L0_t, tot_t=tot_t,
                                           ms=ms, kw4=kw4: cuda_minsum.minsum_var_iter_cuda(
                                               mu0_t, ms.v2c, ms.var_mask, L0_t, total=tot_t,
                                               **kw4, **kt), 10),
                "plain_ms": plain4, "bound_ms": b4[0], "bound_by": b4[1], "library_ms": lib4,
                "max_abs_err": err4t}
        del mu0_t, tot_t, err_tt, llrs_t
        for name, what, row, lib in (
                ("minsum_check", "first iteration (gathered from L0)", row1, None),
                ("minsum_check", "iteration form", row3, None),
                ("minsum_var", "totals and freeze", row4, lib4)):
            print(f"kernel {name} bb144 {tag} lane-tiled T={T} {what}: max_abs_err "
                  f"{row['max_abs_err']} (bitwise required, untiled against the plain lane-major "
                  f"version) | kernel {row['ms']:.3f} ms"
                  + (f" (lane-major {row['lane_major_ms']:.3f} ms)" if "lane_major_ms" in row
                     else "")
                  + (f" (the totals alone {row['totals_only_ms']:.3f} ms)"
                     if "totals_only_ms" in row else "")
                  + f" | plain torch {row['plain_ms']:.3f} ms | bound {row['bound_ms']:.4f} ms by "
                  f"{row['bound_by']} | library call: "
                  + ("none" if lib is None else f"torch.sparse.mm {lib:.3f} ms")
                  + f" | {shape_d} | {card}")
            if row["max_abs_err"] != 0:
                raise AssertionError(f"{name} bb144 {tag} lane-tiled {what}: kernel differs from "
                                     "its plain version")
            key = f"{name}_tiled"
            if key not in kernels:  # the first shape's main form is the entry's
                kernels[key] = {"name": key, "route": "cuda", "source": minsum_src,
                                "replaces": kernels[name]["replaces"], "max_abs_err": 0,
                                "library_ms": None, "variants": {}}
            if "ms" not in kernels[key] and what != "first iteration (gathered from L0)":
                kernels[key].update({k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                                         "bound_by")},
                                    library_ms=lib, shape=f"bb144 {tag}")
            kernels[key]["max_abs_err"] = max(kernels[key]["max_abs_err"], row["max_abs_err"])
            kernels[key]["variants"][f"bb144 {tag} {what}"] = dict(row, lane_tile=T)
        del outs, mu0, total0, nu0, L0_t, flip_t, gam_t, total0_t
        torch.cuda.empty_cache()

    # the same DEM in the variable layout, as the BP+OSD configuration runs it
    var_layout_rows(torch, pt, dev, card, kernels, dem_graph, dem_det, dem_llr)

    # the two eliminations once more: against the plain BLOCKED forms (the
    # kernel's own algorithm in torch), with the launcher's plan, at the 128
    # lanes of path (h), and with the panel capped at 4, 2 and 1 columns
    b128 = slice(0, 128)
    gf2_extra = (
        ("gf2_osd0", True,
         lambda sl=slice(None), **kw: (cuda_gf2.gf2_osd0_cuda(
             Ht[sl], resid[sl], bp_sorted[sl], n, **kw),),
         lambda P: (gf2.gf2_osd0_blocked(Ht, resid, bp_sorted, n, P),)),
        ("gf2_eliminate", False,
         lambda sl=slice(None), **kw: cuda_gf2.gf2_eliminate_cuda(Ht[sl], s_int[sl], n, **kw),
         lambda P: gf2.gf2_eliminate_blocked(Ht, s_int, n, P)[:3]),
    )
    for key, osd0, kern, blocked in gf2_extra:
        plan = cuda_gf2.launcher_plan(W, m, osd0=osd0)  # what the launcher takes
        if plan != cuda_gf2.launch_plan(W, m, osd0=osd0) or plan.panel == 0:
            raise AssertionError(f"{key}: the launcher plans {plan}, cuda_gf2.launch_plan "
                                 f"{cuda_gf2.launch_plan(W, m, osd0=osd0)}")
        err_b = max_abs_err(torch, kern(), blocked(plan.panel))
        ms128 = event_ms(torch, lambda: kern(b128), 10)
        by_panel = {}
        for P in (8, 4, 2, 1):
            if max_abs_err(torch, kern(_max_panel=P), kern()) != 0:
                raise AssertionError(f"{key}: panel {P} differs from panel {plan.panel}")
            by_panel[str(P)] = event_ms(torch, lambda: kern(_max_panel=P), 3)
        if clock_lib is not None:
            if max_abs_err(torch, kern(_lib=clock_lib), kern()) != 0:
                raise AssertionError(f"{key}: the build with phase clocks differs")
            torch.cuda.synchronize()
            clk = (ctypes.c_longlong * 5)()
            if clock_lib.ldpc_gf2_phase_clocks(clk) != 0:
                raise AssertionError(f"{key}: the phase clocks could not be read")
            trips_c, serial_c, overlap_c, all_c, panels = clk
            ms_clk = event_ms(torch, lambda: kern(_lib=clock_lib), 10)
            ms_plain = event_ms(torch, kern, 10)
            print(f"phases {key}, block 0: {all_c} SM clocks in the elimination; warp 0 in its "
                  f"trips {trips_c} ({100 * trips_c / all_c:.1f}%), stretches behind barriers (Q "
                  f"rows, codes, slices, table) {serial_c} ({100 * serial_c / all_c:.1f}%), "
                  f"overlapped stretches (trips beside the apply pass) {overlap_c} "
                  f"({100 * overlap_c / all_c:.1f}%); {panels} panels with a pivot: "
                  f"{trips_c / panels:.0f} / {serial_c / panels:.0f} / {overlap_c / panels:.0f} "
                  f"clocks a panel | the build with the clocks {ms_clk:.3f} ms, without "
                  f"{ms_plain:.3f} ms")
        print(f"kernel {key} blocked: panel {plan.panel} columns, {plan.bytes} B shared memory "
              f"(row stride {cuda_gf2.row_stride(m, plan.pad)} words), max_abs_err {err_b} "
              f"against the plain blocked form (bitwise required) | B=128 {ms128:.3f} ms | "
              f"panel capped at "
              + ", ".join(f"{P}: {t:.3f} ms" for P, t in by_panel.items())
              + f" at B={B} | {card}")
        if err_b != 0:
            raise AssertionError(f"{key}: kernel differs from its plain blocked form")
        kernels[key]["max_abs_err"] = max(kernels[key]["max_abs_err"], err_b)
        kernels[key]["max_abs_err_blocked"] = err_b
        kernels[key]["panel"] = plan.panel
        kernels[key]["smem_bytes"] = plan.bytes
        kernels[key]["variants"]["B=128"] = {"ms": ms128}
        kernels[key]["variants"]["by_panel_ms"] = by_panel

    wrappers, routed = launch_wrappers()
    path_launches = {}

    def drive(path, expect, fn):
        """Run one main path with every count set to 0 just before it and
        read just after it; a kernel of ``expect`` never launched fails."""
        zero_counts(wrappers, routed)
        out = fn()
        counts = read_counts(wrappers, routed)
        drive.last_routes = {k: dict(w.routes) for k, w in routed.items()}
        for k in expect:
            if counts[k] == 0:
                raise AssertionError(f"main ({path}) never launched {k}")
        if "qc_minsum" not in expect and counts["qc_minsum"]:
            raise AssertionError(f"main ({path}) launched qc_minsum")
        path_launches[path] = counts
        print(f"main ({path}) launches: {counts}")
        return out

    drive.counts_of = path_launches.__getitem__

    # 4. the main paths, through the public API, each with its own counts
    dec2 = pt.BeliefPropagationOSDDecoder(graph, 0.01, MAX_ITERS, osd_order=2, device=dev)
    # (a) launches a kernel only if some lane fails BP: none is required
    g01, c01 = drive("a", [], lambda: dec0.batch_decode(syn01))
    assert_consistent(H, g01, syn01, "BP+OSD-0 per 0.01")
    print(f"main (a) BP+OSD-0 per 0.01: converged {c01.mean():.4f}, exact recovery "
          f"{(g01.astype(bool) == errs01).all(axis=1).mean():.4f}, all syndrome-consistent")
    g20, c20 = drive("b", ["gf2_osd0"], lambda: dec0.batch_decode(syn20, per=0.2))
    assert_consistent(H, g20, syn20, "BP+OSD-0 per 0.2")
    print(f"main (b) BP+OSD-0 per 0.2: converged {c20.mean():.4f}, exact recovery "
          f"{(g20.astype(bool) == errs20).all(axis=1).mean():.4f}, all syndrome-consistent")
    g2, c2 = drive("c", ["gf2_eliminate"], lambda: dec2.batch_decode(syn01))
    assert_consistent(H, g2, syn01, "BP+OSD-2 per 0.01")
    print(f"main (c) BP+OSD-2 per 0.01: converged {c2.mean():.4f}, exact recovery "
          f"{(g2.astype(bool) == errs01).all(axis=1).mean():.4f}, all syndrome-consistent")

    # (d) the card's BP against the CPU's on 64 lanes (32 at per 0.01, 32 at
    # per 0.2): err, converged and iters must agree bitwise; logp is
    # compared with rtol 1e-5, atol 1e-6 (log may differ by an ulp)
    lanes = np.concatenate([syn01[:32], syn20[:32]])
    bp_cpu = pt.BeliefPropagationDecoder(graph, 0.01, MAX_ITERS, device="cpu")
    bp_gpu = pt.BeliefPropagationDecoder(graph, 0.01, MAX_ITERS, device=dev)
    e_c, c_c, i_c, a_c, _ = bp_cpu.batch_decode_detailed(lanes)
    e_g, c_g, i_g, a_g, _ = bp_gpu.batch_decode_detailed(lanes)
    same = (np.array_equal(e_c, e_g), np.array_equal(c_c, c_g), np.array_equal(i_c, i_g))
    lp_c, lp_g = a_c["log_probabs"], a_g["log_probabs"]
    finite = np.isfinite(lp_c) & np.isfinite(lp_g)
    print(f"main (d) BP cuda vs cpu, 64 lanes: err/converged/iters equal {same}, "
          f"finite logp max abs diff {np.abs(lp_c[finite] - lp_g[finite]).max():.3e}, "
          f"bitwise share {(lp_c == lp_g).mean():.4f}")
    if not all(same):
        raise AssertionError("BP on the card disagrees with BP on the CPU")
    np.testing.assert_allclose(lp_g, lp_c, rtol=1e-5, atol=1e-6)

    # the min-sum paths (e)-(h)
    ms32 = pt.MinSumDecoder(graph, 0.01, MAX_ITERS, device=dev)
    ms16 = pt.MinSumDecoder(graph, 0.01, MAX_ITERS, dtype=torch.bfloat16, device=dev)
    osd_ms = pt.BeliefPropagationOSDDecoder(graph, 0.2, MAX_ITERS, inner="minsum",
                                            damping=0.4, device=dev)
    osd2_ms = pt.BeliefPropagationOSDDecoder(graph, 0.2, MAX_ITERS, inner="minsum", damping=0.4,
                                             osd_order=2, osd_scope="failed", device=dev)
    minsum_kernels = ["minsum_check", "minsum_var"]
    # the float32 decodes of 1024 lanes, (e), (g), (m), (n), run the
    # variable layout on lane tiles (their messages outgrow L2): K3's
    # gathered form and K4's in-place form on tiles
    var_tiled = ["minsum_check_tiled", "minsum_var_tiled_nu"]
    # the check layout's decodes, (p)-(s), run K3/K4 on lane tiles
    tiled_kernels = ["minsum_check_tiled", "minsum_var_tiled"]
    for path, what, dec in (("e", "min-sum float32", ms32), ("f", "min-sum bfloat16", ms16)):
        g, c, iters, aux, _ = drive(path, minsum_kernels + (var_tiled if path == "e" else []),
                                    lambda dec=dec: dec.batch_decode_detailed(syn01))
        if g.shape != (B, n) or g.dtype != np.int8 or not np.isfinite(aux["llrs"]).all():
            raise AssertionError(f"({path}) {what}: output {g.shape} {g.dtype} or non-finite LLRs")
        assert_consistent(H, g[c], syn01[c], f"({path}) {what} (converged lanes)")
        print(f"main ({path}) {what} per 0.01: converged {c.mean():.4f}, exact recovery "
              f"{(g.astype(bool) == errs01).all(axis=1).mean():.4f}, "
              f"iterations mean {iters.mean():.2f} max {iters.max()}")
        if c.mean() < 0.99:
            raise AssertionError(f"({path}) {what}: only {c.mean():.4f} of the lanes converged")
    gm, cm = drive("g", minsum_kernels + var_tiled + ["gf2_osd0"],
                   lambda: osd_ms.batch_decode(syn20))
    assert_consistent(H, gm, syn20, "min-sum+OSD-0 per 0.2")
    print(f"main (g) BP+OSD-0, inner min-sum damping 0.4, per 0.2: converged {cm.mean():.4f}, "
          f"exact recovery {(gm.astype(bool) == errs20).all(axis=1).mean():.4f}, "
          "all syndrome-consistent")
    gm2, cm2 = drive("h", minsum_kernels + ["gf2_eliminate"],
                     lambda: osd2_ms.batch_decode(syn20[:128]))
    assert_consistent(H, gm2, syn20[:128], "min-sum+OSD-2 failed scope per 0.2")
    print(f"main (h) BP+OSD-2 on failing lanes, inner min-sum damping 0.4, per 0.2, 128 lanes: "
          f"converged {cm2.mean():.4f}, all syndrome-consistent")
    # (j) the QC decoder, layered, through the public API: one launch
    e_j, c_j, i_j, a_j, _ = drive("j", ["qc_minsum"],
                                  lambda: qdec.batch_decode_detailed(qsyn))
    if (e_j.shape != (B, Hq.shape[1]) or e_j.dtype != np.int8 or i_j.dtype != np.int32
            or a_j["llrs"].dtype != np.float32 or not np.isfinite(a_j["llrs"]).all()):
        raise AssertionError(f"(j) output {e_j.shape} {e_j.dtype} or non-finite LLRs")
    assert_consistent(Hq, e_j[c_j], qsyn[c_j], "(j) QC layered (converged lanes)")
    print(f"main (j) QCMinSumDecoder layered per 0.04, 32 sweeps: converged {c_j.mean():.4f}, "
          f"exact recovery {(e_j.astype(bool) == qerrs).all(axis=1).mean():.4f}, "
          f"sweeps mean {i_j.mean():.2f} max {i_j.max()}")
    if path_launches["j"]["qc_minsum"] != 1 or c_j.mean() < 0.99:
        raise AssertionError(f"(j): {path_launches['j']['qc_minsum']} launches, "
                             f"converged {c_j.mean():.4f}")

    # (k) the bb144 six-round space-time decoder on 2048 detector records
    e_k, c_k, i_k, a_k, _ = drive("k", ["qc_minsum"],
                                  lambda: st.batch_decode_detailed(st_det))
    full = np.concatenate([a_k["data_rounds"].reshape(BK, -1), a_k["meas"].reshape(BK, -1)],
                          axis=1)
    rec = np.asarray((st.A.astype(np.int32) @ full.T.astype(np.int32)).T % 2, np.uint8)
    if e_k.shape != (BK, st.n) or e_k.dtype != np.int8 or not (rec[c_k] == st_det[c_k]).all():
        raise AssertionError("(k): converged lanes do not reproduce their detector record")
    true_cum = st_x[:, : st.rounds * st.block_n].reshape(BK, st.rounds, st.block_n).sum(1) % 2
    print(f"main (k) SpaceTimeDecoder.for_bicycle bb144 x R=6 per 0.003, 60 sweeps, {BK} "
          f"records: converged {c_k.mean():.4f}, cumulative correction equal to the true one "
          f"{(e_k == true_cum).all(axis=1).mean():.4f}, sweeps mean {i_k.mean():.2f} "
          f"max {i_k.max()}")
    if path_launches["k"]["qc_minsum"] != 1 or c_k.mean() < 0.99:
        raise AssertionError(f"(k): {path_launches['k']['qc_minsum']} launches, "
                             f"converged {c_k.mean():.4f}")

    # (i) the card's min-sum against the CPU's on the same 64 lanes, float32:
    # err, converged, iters and LLRs must agree bitwise
    ms_cpu = pt.MinSumDecoder(graph, 0.01, MAX_ITERS, device="cpu")
    e_c, c_c, i_c, a_c, _ = ms_cpu.batch_decode_detailed(lanes)
    e_g, c_g, i_g, a_g, _ = ms32.batch_decode_detailed(lanes)
    same = (np.array_equal(e_c, e_g), np.array_equal(c_c, c_g), np.array_equal(i_c, i_g),
            np.array_equal(a_c["llrs"].view(np.uint32), a_g["llrs"].view(np.uint32)))
    print(f"main (i) min-sum cuda vs cpu, 64 lanes: err/converged/iters/llrs bitwise {same}")
    if not all(same):
        raise AssertionError("min-sum on the card disagrees with min-sum on the CPU")

    # (l) the card against the CPU through the public API on 64 lanes of (j)
    # and of (k): every output bitwise
    qdec_cpu = pt.QCMinSumDecoder(base_qc, 128, 0.04, 32, schedule="layered", device="cpu")
    st_cpu = pt.SpaceTimeDecoder.for_bicycle("bb144", "x", 6, 0.003, 60, device="cpu")
    for what, cpu, gpu, rows, llr_of in (
            ("QC layered", qdec_cpu, qdec, qsyn[:64], lambda a: a["llrs"]),
            ("bb144 space-time", st_cpu, st, st_det[:64], lambda a: a["inner"]["llrs"])):
        w_e, w_c, w_i, w_a, _ = cpu.batch_decode_detailed(rows)
        g_e, g_c, g_i, g_a, _ = gpu.batch_decode_detailed(rows)
        same = (np.array_equal(w_e, g_e), np.array_equal(w_c, g_c), np.array_equal(w_i, g_i),
                np.array_equal(llr_of(w_a).view(np.uint32), llr_of(g_a).view(np.uint32)))
        print(f"main (l) {what} cuda vs cpu, 64 lanes: err/converged/iters/llrs bitwise {same}")
        if not all(same):
            raise AssertionError(f"{what} on the card disagrees with the CPU")

    # (m) BP+OSD-CS (pairs within the first 10 non-pivot columns) at per
    # 0.2, every lane through K2 and the combination sweep.  The inner is the
    # damped min-sum of (g): its LLRs are bitwise on the card and the CPU (path
    # (i)), where BP's logp differs by an ulp (path (d)) and may reorder OSD
    # columns
    cs_kw = dict(inner="minsum", damping=0.4, osd_method="combination_sweep", osd_order=10)
    dec_cs = pt.BeliefPropagationOSDDecoder(graph, 0.2, MAX_ITERS, device=dev, **cs_kw)
    g_m, c_m = drive("m", minsum_kernels + var_tiled + ["gf2_eliminate"],
                     lambda: dec_cs.batch_decode(syn20))
    assert_consistent(H, g_m, syn20, "(m) BP+OSD-CS per 0.2")
    cs_cpu = pt.BeliefPropagationOSDDecoder(graph, 0.2, MAX_ITERS, device="cpu", **cs_kw)
    g_mc, c_mc = cs_cpu.batch_decode(syn20[:64])
    same = (np.array_equal(g_mc, g_m[:64]), np.array_equal(c_mc, c_m[:64]))
    print(f"main (m) BP+OSD-CS (osd_order 10), inner min-sum damping 0.4, per 0.2: converged "
          f"{c_m.mean():.4f}, exact recovery "
          f"{(g_m.astype(bool) == errs20).all(axis=1).mean():.4f}, "
          f"all syndrome-consistent, OSD on the card (K2); cuda vs cpu on 64 lanes: "
          f"err/converged bitwise {same}")
    if not all(same):
        raise AssertionError("(m): BP+OSD-CS on the card disagrees with the CPU")

    # (n) the same through the native host OSD-CS
    dec_host = pt.BeliefPropagationOSDDecoder(graph, 0.2, MAX_ITERS, device=dev,
                                              osd_impl="host", **cs_kw)
    g_n, c_n = drive("n", minsum_kernels + var_tiled, lambda: dec_host.batch_decode(syn20))
    assert_consistent(H, g_n, syn20, "(n) BP+host OSD-CS per 0.2")
    if path_launches["n"]["gf2_eliminate"] or path_launches["n"]["gf2_osd0"]:
        raise AssertionError("(n): the host OSD launched an elimination kernel")
    print(f"main (n) BP+OSD-CS on the host (osd_impl='host'), per 0.2: converged "
          f"{c_n.mean():.4f}, all syndrome-consistent, lanes equal to (m) "
          f"{(g_n == g_m).all(axis=1).mean():.4f}, OSD on the host")

    # (o) a circuit-level DEM through DetectorGraphDecoder: BP+OSD-0 with
    # the min-sum inner on surface_d5_r5_p002.dem (120 detectors, 1,589
    # mechanisms), records drawn at 3x the DEM's priors so that lanes fail;
    # its lane fits a block of K1 (the device OSD).  The first 64 records
    # are held bitwise against the same decoder on the CPU
    d5_path = str(ROOT / "tests/fixtures/surface_d5_r5_p002.dem")
    d5_A, d5_pr, d5_O = pt.load_dem(d5_path)
    rng_d5 = np.random.default_rng(13)
    d5_x = (rng_d5.random((BK, d5_A.shape[1])) < 3 * d5_pr).astype(np.uint8)
    d5_det = ((d5_A @ d5_x.T).T % 2).astype(np.uint8)
    d5_dec = pt.DetectorGraphDecoder.from_dem(d5_path, 50, inner="minsum", device=dev)
    g_o, c_o = drive("o", minsum_kernels + ["gf2_osd0"], lambda: d5_dec.batch_decode(d5_det))
    assert_consistent(d5_A.toarray(), g_o, d5_det, "(o) DetectorGraphDecoder d5")
    f_o, _ = d5_dec.predict_observables(d5_det)
    d5_cpu = pt.DetectorGraphDecoder.from_dem(d5_path, 50, inner="minsum", device="cpu")
    g_oc, c_oc = d5_cpu.batch_decode(d5_det[:64])
    same = (np.array_equal(g_oc, g_o[:64]), np.array_equal(c_oc, c_o[:64]))
    print(f"main (o) DetectorGraphDecoder surface_d5_r5_p002.dem, {BK} records at 3x the priors: "
          f"OSD on the card (K1; a lane takes "
          f"{cuda_gf2.smem_bytes((d5_A.shape[1] + 31) // 32, d5_A.shape[0], osd0=True)} B of "
          f"shared memory), converged {c_o.mean():.4f}, all syndrome-consistent, observables "
          f"right {(f_o == (d5_x @ d5_O.T) % 2).all(axis=1).mean():.4f}; cuda vs cpu on 64 "
          f"records: err/converged bitwise {same}, {int((~c_oc).sum())} of them through OSD")
    if not all(same):
        raise AssertionError("(o): DetectorGraphDecoder on the card disagrees with the CPU")
    if c_oc.all():
        raise AssertionError("(o): none of the 64 records compared reached the OSD")

    # (r), (s): MinSumDecode on the bb144 DEM in the staged decoder's two inner
    # configurations (check layout, checked every 8 iterations): stage 0
    # (float32, damping 0.4) and deep (bfloat16, per-variable gammas in
    # [-0.24, 0.66), track_best), 64 records with the DEM's priors as L0, at
    # 24 iterations (the CPU's plain versions set the depth): err, converged,
    # iters and LLRs bitwise on the card (K3/K4 on lane tiles) and the CPU (the
    # plain versions on the lane-major state)
    dem_cpu = pt.TannerGraph.from_pcm(np.asarray(dem_A.todense()))
    rec = dem_det[:64].to(torch.uint8)
    gam64 = np.random.default_rng(5).uniform(-0.24, 0.66, (rec.shape[0], dem_graph.n))
    gam64 = gam64.astype(np.float32)
    for path, what, kw, gamma in (
            ("r", "stage-0 configuration (float32, damping 0.4)",
             dict(damping=0.4), None),
            ("s", "deep configuration (bfloat16, [B, n] gammas, track_best)",
             dict(dtype=torch.bfloat16, lane_damping=True, track_best=True), gam64)):
        kw = dict(kw, layout="check", check_every=8)
        gpu = pt.MinSumDecode(dem_graph, float(dem_pr.mean()), 24, device=dev, **kw)
        cpu = pt.MinSumDecode(dem_cpu, float(dem_pr.mean()), 24, device="cpu", **kw)
        g_arg = None if gamma is None else torch.as_tensor(gamma)
        got = drive(path, minsum_kernels + tiled_kernels, lambda gpu=gpu, g_arg=g_arg: gpu(
            rec, dem_llr.to(torch.float32), None if g_arg is None else g_arg.to(dev)))
        want = cpu(rec.cpu(), dem_llr.cpu().to(torch.float32), g_arg)
        same = [max_abs_err(torch, [a.cpu()], [b]) == 0 for a, b in zip(got, want)]
        print(f"main ({path}) MinSumDecode bb144 R=6 DEM {what}, check layout, check_every 8, 24 "
              f"iterations, 64 records: cuda vs cpu err/converged/iters/llrs bitwise {same}, "
              f"converged {want[1].float().mean():.4f}, iterations mean "
              f"{want[2].float().mean():.2f} | {card}")
        if not all(same):
            raise AssertionError(f"({path}) {what}: MinSumDecode on the card disagrees with "
                                 "the CPU")

    # (p), (q): the staged production decoder on the bb144 R=6 p=0.003
    # circuit-level DEM, through run_eval (device sampling, deep ensemble,
    # host OSD-CS on a worker thread).  (p) the fast tier, (q) the flagship
    # (benchmarks/circuit_level_bb144_r5.py; circuit_level_bb144_r5.json)
    from ldpcdecoders_tpu_torch.utils import hbm, profiling
    from ldpcdecoders_tpu_torch.utils.hbm import minsum_bytes_per_lane
    from ldpcdecoders_tpu_torch.utils.metrics import wilson_interval

    fast = pt.StagedDemDecoder(dem_A, dem_pr, observables=dem_O, gammas=(0.4,),
                               stage0_iters=96, deep_iters=1000, lam=40, check_every=8,
                               layout="check", device=dev)
    flagship = pt.StagedDemDecoder(
        dem_A, dem_pr, observables=dem_O, gammas=(0.4,) + ((-0.24, 0.66),) * 5,
        stage0_iters=96, deep_iters=500, deep_dtype=torch.bfloat16, relay_legs=8, lam=60,
        lam3=40, layout="check", check_every=8, device=dev)

    # the memory model (utils/hbm.py) against the peak a decode allocates
    def peak_bytes(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    L0_dem = fast.L0_default
    memory = {}
    for what, dec, lanes, fn in (
            ("stage-0 batch, float32, check layout", fast, BDEM,
             lambda: fast.stage0(dem_det[:BDEM], L0_dem)),
            (f"flagship deep bucket, 6 members x {DEEP_BUCKET}, bfloat16, check layout", flagship,
             6 * DEEP_BUCKET, lambda: flagship._deep_step(dem_det[:DEEP_BUCKET], L0_dem, L0_dem,
                                                           flagship.gamma_arg))):
        dtype_bytes = 2 if "bfloat16" in what else 4
        modeled = minsum_bytes_per_lane(dec.graph, dtype_bytes) * lanes
        measured = peak_bytes(fn)
        memory[what] = {"measured_bytes": measured, "modeled_bytes": modeled,
                        "ratio": measured / modeled}
        print(f"memory {what}: {lanes} lanes, peak allocated {measured / 1e9:.3f} GB, model "
              f"{modeled / 1e9:.3f} GB (utils/hbm.py, headroom {hbm._HEADROOM}), measured/model "
              f"{measured / modeled:.3f} | {card}")

    dem_lane = cuda_gf2.smem_bytes((dem_graph.n + 31) // 32, dem_graph.m, osd0=False)
    print(f"main (p), (q) OSD route: host (the native OSD-CS, on a worker thread, as the "
          f"reference's staged decoder): one lane of the bb144 DEM takes {dem_lane} B of shared "
          f"memory in the elimination kernels, a block holds {cuda_gf2.MAX_SMEM_BYTES}, so a "
          f"device OSD would take their device-memory body")
    if dem_lane <= cuda_gf2.MAX_SMEM_BYTES:
        raise AssertionError("(p): the DEM's lane fits a block of the elimination kernels")
    ref_lo, ref_hi = wilson_interval(149, 16384)
    staged = {}
    for path, what, dec, shots, kw in (
            ("p", "fast tier", fast, P_SHOTS, dict(batch=BDEM)),
            ("q", "flagship", flagship, Q_SHOTS, dict(batch=BDEM // 2, deep_bucket=DEEP_BUCKET))):
        def recorded_eval(dec=dec, shots=shots, kw=kw):
            with profiling.recording() as rec:
                ev = dec.run_eval(shots, seed=11, **kw)
            return ev, {k: rec.totals().get(k, 0) + rec.counters.get(k, 0)
                        for k in ("minsum_compactions", "minsum_compact_bytes",
                                  "minsum_lane_iters_launched")}

        ev, counted = drive(path, minsum_kernels + tiled_kernels, recorded_eval)
        prof = ev["profile"]
        lo, hi = ev["logical_ci95"]
        staged[path] = ev
        print(f"main ({path}) StagedDemDecoder bb144 R=6 p=0.003 {what}: {ev['shots']} shots, "
              f"{ev['fails']} fails, LER {ev['logical_rate']:.4e} (Wilson 95% {lo:.4e}-{hi:.4e}), "
              f"stage0_conv {prof['stage0_conv']:.4f}, deep shots {prof['deep_shots']} (solved "
              f"{prof['deep_solved']}), relay shots {prof['relay_shots']} (solved "
              f"{prof['relay_solved']}), OSD shots {prof['osd_shots']} (consistent "
              f"{prof['osd_consistent']}), fails by stage {prof['fails_by_stage']}, "
              f"{ev['throughput_shots_per_s']:.2f} shots/s | {card}")
        print(f"split ({path}): wall {prof['wall_s']:.3f} s; stage 0 "
              f"{prof['stage0_wall_s']:.3f} s, "
              f"deep drains {prof['deep_drain_wall_s']:.3f} s, relay drains "
              f"{prof['relay_drain_wall_s']:.3f} s, host OSD thread {prof['osd_thread_s']:.3f} s "
              f"(overlapped) | {card}")
        if prof["osd_consistent"] != prof["osd_shots"]:
            raise AssertionError(f"({path}): {prof['osd_shots'] - prof['osd_consistent']} OSD "
                                 "outputs miss their detector record")
        print(f"compaction ({path}): the min-sum loop narrowed its lanes "
              f"{counted['minsum_compactions']} times, gathering "
              f"{counted['minsum_compact_bytes'] / 1e9:.3f} GB of state; "
              f"{counted['minsum_lane_iters_launched']} lane-iterations launched | {card}")
        if not counted["minsum_compactions"]:
            raise AssertionError(f"({path}): the min-sum loop never narrowed its lanes")
    lo, hi = staged["p"]["logical_ci95"]
    print(f"main (p) against the reference's fast tier, 149/16,384 = 9.09e-3 (Wilson 95% "
          f"{ref_lo:.4e}-{ref_hi:.4e}): intervals overlap {lo <= ref_hi and ref_lo <= hi}")
    if not (lo <= ref_hi and ref_lo <= hi):
        raise AssertionError("(p): the fast tier's LER interval misses the reference's")
    if staged["q"]["fails"] > 8:
        raise AssertionError(f"(q): {staged['q']['fails']} failures in 2048 shots (the "
                             "reference's 3.76e-4 predicts 0.8)")

    # (p), (q) per iteration: a stage-0 batch and a flagship deep bucket (the
    # calls whose peak memory is above) under torch.profiler: device time and
    # launches per min-sum iteration, the iterations counted by K4's launches
    # (one an iteration; the profiler runs the call twice)
    mem_keys = list(memory)
    for path, name, fn, mem_key in (
            ("p", f"bb144 stage-0 batch of {BDEM}, float32, check layout, damping 0.4",
             lambda: fast.stage0(dem_det[:BDEM], L0_dem), mem_keys[0]),
            ("q", f"bb144 flagship deep bucket, 6 x {DEEP_BUCKET}, bfloat16, check layout",
             lambda: flagship._deep_step(dem_det[:DEEP_BUCKET], L0_dem, L0_dem,
                                         flagship.gamma_arg), mem_keys[1])):
        before = cuda_minsum.minsum_var_iter_cuda.launches
        wall_ms, busy, launches, _ = profile_call(torch, f"({path}) {name}", fn, 1)
        its = (cuda_minsum.minsum_var_iter_cuda.launches - before) // 2
        print(f"iteration ({path}) {name}: device {busy / its:.3f} ms per min-sum iteration, "
              f"{launches / its:.2f} launches per iteration over {its} iterations (profiled "
              f"wall {wall_ms:.2f} ms, device busy {100 * busy / wall_ms:.1f}%), peak memory "
              f"{memory[mem_key]['measured_bytes'] / 1e9:.3f} GB | {card}")
        memory[mem_key].update(iteration_ms=busy / its, launches_per_iteration=launches / its)

    harness_paths(torch, pt, drive, dev, card, H)
    family_paths(torch, pt, drive, dev, card, H, (base_qc, Hq, qsyn))
    fused_paths(torch, pt, drive, dev, card, H, graph, syn01, syn20)
    past_a_block_paths(torch, pt, drive, dev, card)
    parallel_paths(torch, pt, drive, dev, card, H, graph, syn01, syn20, qdec, qsyn, fast, dem_det,
                   path_launches)
    qflood, st_flood = flooding_paths(torch, pt, drive, dev, card, (base_qc, Hq, qsyn),
                                      (st_det, st_pri))
    builder_paths(torch, pt, drive, dev, card, H, graph, syn20, (dem_graph, dem_A, dem_x))

    # in the summary, ``launches`` is the count of the first path that must
    # launch the kernel; ``launches_by_path`` has every path's own count
    own_path = {"gf2_osd0": "b", "gf2_eliminate": "c", "minsum_check": "e", "minsum_var": "e",
                "qc_minsum": "j", "gf2_osd0_global": "ad", "gf2_eliminate_global": "ac 0.5",
                "minsum_check_tiled": "p", "minsum_var_tiled": "p", "minsum_var_tiled_nu": "e"}
    for k, path in own_path.items():
        kernels[k]["launches"] = path_launches[path][k]
        kernels[k]["launches_path"] = path
        kernels[k]["launches_by_path"] = {p: c[k] for p, c in path_launches.items()}
    # K5's other forms that a main path runs: that path's launches
    for variant, path in (("bb144 R=6 layered f32 prior vector", "k"),
                          ("flooding f32", "ao f32"), ("flooding bf16", "ao bf16"),
                          ("flooding f32 sumproduct", "ao sumproduct"),
                          ("bb144 R=6 flooding f32 prior vector", "ap")):
        kernels["qc_minsum"]["variants"][variant].update(
            launches=path_launches[path]["qc_minsum"], launches_path=path)

    # 5. steady-state rates (host clock around calls that end in a sync)
    tag = f"| B={B} | {card}"
    d01, d20, d50 = (torch.as_tensor(s, device=dev) for s in (syn01, syn20, syn50))
    t, out = wall_s(torch, lambda: bp_gpu.bp(d50), 3)
    iters = int(out[2].max()) or MAX_ITERS
    print(f"rate BP per 0.5: {B * iters * graph.n_edges / t:.4e} edge-iterations/s "
          f"({iters} iterations, {t * 1e3:.1f} ms/batch) {tag}")
    t, _ = wall_s(torch, lambda: dec0.batch_decode_async(d01), 3)
    print(f"rate BP+OSD-0 per 0.01: {B / t:.1f} syndromes/s ({t * 1e3:.1f} ms/batch) {tag}")
    t, _ = wall_s(torch, lambda: dec0.batch_decode_async(d20, per=0.2), 3)
    print(f"rate BP+OSD-0 per 0.2 (every lane through OSD-0): {B / t:.1f} syndromes/s "
          f"({t * 1e3:.1f} ms/batch) {tag}")
    t, _ = wall_s(torch, lambda: dec2.batch_decode_async(d01), 3)
    print(f"rate BP+OSD-2 per 0.01: {B / t:.1f} syndromes/s ({t * 1e3:.1f} ms/batch) {tag}")

    for what, dec in (("float32", ms32), ("bfloat16", ms16)):
        t, out = wall_s(torch, lambda: dec.minsum(d50), 3)
        iters = int(out[2].max()) or MAX_ITERS
        print(f"rate min-sum {what} per 0.5: {B * iters * graph.n_edges / t:.4e} "
              f"edge-iterations/s ({iters} iterations, {t * 1e3:.1f} ms/batch) {tag}")
    t, _ = wall_s(torch, lambda: ms32.batch_decode_async(d01), 3)
    print(f"rate min-sum float32 per 0.01: {B / t:.1f} syndromes/s ({t * 1e3:.1f} ms/batch) "
          f"{tag}")
    t, _ = wall_s(torch, lambda: osd_ms.batch_decode_async(d20), 3)
    print(f"rate BP+OSD-0 inner min-sum damping 0.4 per 0.2: {B / t:.1f} syndromes/s "
          f"({t * 1e3:.1f} ms/batch) {tag}")

    # the QC paths, device-resident (a CUDA tensor in, tensors out: one
    # launch, no host sync inside), and the same syndromes through the
    # lifted backend in flooding float32 (the min-sum kernels, a host sync
    # per iteration)
    q_lift = qc_dec(backend="lifted")
    st_lift = pt.SpaceTimeDecoder.for_bicycle("bb144", "x", 6, 0.003, 60, schedule="flooding",
                                              backend="lifted", device=dev)
    dq, dk = torch.as_tensor(qsyn, device=dev), torch.as_tensor(st_det, device=dev)
    for what, fused, lifted, d in (("(j) QC per 0.04", qdec, q_lift, dq),
                                   ("(ao) QC per 0.04", qflood, q_lift, dq),
                                   ("(k) bb144 R=6 per 0.003", st, st_lift, dk),
                                   ("(ap) bb144 R=6 per 0.003", st_flood, st_lift, dk)):
        inner = getattr(fused, "inner", fused)
        for how, dec in ((f"{inner.schedule} whole-decode kernel", fused),
                         ("lifted backend, flooding float32", lifted)):
            ts = [wall_s(torch, lambda dec=dec: dec.batch_decode_detailed_async(d), 3)
                  for _ in range(3)]
            t, out = sum(r[0] for r in ts) / 3, ts[-1][1]  # all 9 calls over all their time
            sweeps = int(out[2].sum())
            print(f"rate {what}, {how}: {d.shape[0] / t:.1f} syndromes/s, "
                  f"{sweeps * inner.qc_terms.Eb * inner.Z / t:.4e} edge-sweeps/s "
                  f"({t * 1e3:.3f} ms/batch, mean of 9 calls; the three means of 3: "
                  f"{', '.join(f'{r[0] * 1e3:.3f}' for r in ts)}; converged "
                  f"{out[1].float().mean():.4f}, sweeps mean {sweeps / d.shape[0]:.2f}) "
                  f"| B={d.shape[0]} | {card}")
    t, _ = wall_s(torch, lambda: qdec.batch_decode_detailed(qsyn), 3)
    print(f"rate (j) QC per 0.04 from and to numpy (batch_decode_detailed): {B / t:.1f} "
          f"syndromes/s ({t * 1e3:.3f} ms/batch) {tag}")

    if want_profile:
        # the one-launch decodes take a fraction of a millisecond: 50 calls
        # in one window, so that the profiler's start does not fill it
        for name, fn, its in (
            ("(j) QC layered whole-decode kernel", lambda: qdec.batch_decode_detailed_async(dq),
             int(i_j.max())),
            ("(k) bb144 R=6 whole-decode kernel", lambda: st.batch_decode_detailed_async(dk),
             int(i_k.max())),
        ):
            profile_call(torch, name, fn, its, calls=50)
        for name, fn, its in (
            ("(j) QC lifted backend flooding float32",
             lambda: q_lift.batch_decode_detailed_async(dq), 32),
            ("BP per 0.5", lambda: bp_gpu.bp(d50), MAX_ITERS),
            ("min-sum float32 per 0.5", lambda: ms32.minsum(d50), MAX_ITERS),
            ("min-sum bfloat16 per 0.5", lambda: ms16.minsum(d50), MAX_ITERS),
            ("min-sum damping 0.4 per 0.5", lambda: osd_ms.bp(d50), MAX_ITERS),
            ("BP+OSD-0 inner min-sum per 0.2", lambda: osd_ms.batch_decode_async(d20),
             MAX_ITERS),
            ("(b) BP+OSD-0 per 0.2", lambda: dec0.batch_decode_async(d20, per=0.2), MAX_ITERS),
            ("(c) BP+OSD-2 per 0.01", lambda: dec2.batch_decode_async(d01), MAX_ITERS),
            ("(h) BP+OSD-2 on failing lanes, inner min-sum, per 0.2, 128 lanes",
             lambda: osd2_ms.batch_decode_async(d20[:128]), MAX_ITERS),
            ("(m) BP+OSD-CS, inner min-sum, per 0.2", lambda: dec_cs.batch_decode_async(d20),
             MAX_ITERS),
        ):
            profile_call(torch, name, fn, its)

    # 6. summary lines; the last line is the result
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--an-rank"]:
        sys.exit(an_child(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
