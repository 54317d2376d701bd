"""The port's tracing (utils/profiling.py): spans and counters of the decode
path, recorded inside ``recording()`` and under a ``torch.profiler``
session, and nothing otherwise.

The staged decoder runs the small random DEM of tests/test_torch_staged.py
with lanes in every stage (stage 0, a deep bucket, the host OSD); the
outputs are bitwise the same with recording on and off.  The benchmark's
readers of these records (portbench/metrics) are held to a recorded run
here too.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small_dem(seed=5, D=40, N=300, k=3):
    rng = np.random.default_rng(seed)
    A = (rng.random((D, N)) < 0.08).astype(np.uint8)
    A[:, A.sum(axis=0) == 0] = 1
    pr = np.clip(rng.random(N) * 0.01, 1e-4, 0.01)
    O = (rng.random((k, N)) < 0.1).astype(np.uint8)
    return A, pr, O


def _records(A, pr, B, seed, scale):
    rng = np.random.default_rng(seed)
    x = (rng.random((B, A.shape[1])) < pr * scale).astype(np.uint8)
    return (x @ A.T % 2).astype(np.uint8)


@pytest.fixture(scope="module")
def staged():
    A, pr, O = _small_dem()
    dec = pt.StagedDemDecoder(A, pr, observables=O, gammas=(0.3,), stage0_iters=8,
                              deep_iters=40, lam=12, layout="check", device="cpu")
    return dec, _records(A, pr, 32, 1, 8.0)


@pytest.fixture(scope="module")
def recorded(staged):
    dec, det = staged
    with profiling.recording() as rec:
        out = dec.batch_decode_detailed(det)
    return rec, out


def depth(rec, s):
    d, p = 0, s.parent
    while p is not None:
        d, p = d + 1, rec.spans[p].parent
    return d


def test_off_records_nothing_and_changes_no_output(staged, recorded):
    dec, det = staged
    assert profiling.span("ldpc.a") is profiling.span("ldpc.b") is profiling.call_span()
    before = profiling.profiled()
    off = dec.batch_decode_detailed(det)
    assert profiling.profiled() is before
    rec, on = recorded
    assert len(rec.calls) == 1
    for a, b in zip(off[:3], on[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    conv, iters = off[1], off[2]
    # lanes in every stage: stage 0, deep, and the host OSD
    assert (iters <= dec.stage0_iters).any() and (iters > dec.stage0_iters).any()
    assert (~conv).any()


def test_span_tree_under_one_call(recorded):
    rec, _ = recorded
    (call,) = rec.calls
    tree = [(depth(rec, s), s.name) for s in call.spans]
    assert tree[0] == (0, "ldpc.call") and all(d > 0 for d, _ in tree[1:])
    assert [n for d, n in tree if d == 1] == ["ldpc.to_device", "ldpc.decode", "ldpc.to_host"]
    assert [n for d, n in tree if d == 2] == [
        "ldpc.staged.stage0", "ldpc.staged.stage0", "ldpc.staged.deep", "ldpc.staged.gather",
        "ldpc.staged.osd", "ldpc.to_device"]
    parents = {}
    for s in call.spans[1:]:
        parents.setdefault(s.name, []).append(rec.spans[s.parent].name)
    assert parents["ldpc.minsum.decode"] == ["ldpc.staged.stage0", "ldpc.staged.deep"]
    assert set(parents["ldpc.minsum.iters"]) == set(parents["ldpc.minsum.check"]) == {
        "ldpc.minsum.decode"}
    for s in call.spans:
        assert s.call == 0 and s.end_ns >= s.start_ns
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_staged_counters(staged, recorded):
    dec, det = staged
    rec, (err, conv, iters, _, _) = recorded
    c = rec.totals()
    assert c["osd_lanes"] == int((~conv).sum()) and c["osd_candidates"] == 2 * c["osd_lanes"]
    deep = int((iters > dec.stage0_iters).sum())
    assert c["deep_lanes"] == deep and c["deep_lanes_padded"] >= deep
    assert c["minsum_lane_iters_launched"] >= int(iters.sum())
    # the contract's syndromes in, the staged results back onto the device
    assert c["h2d_bytes"] >= det.nbytes + err.nbytes
    assert c["d2h_bytes"] >= 2 * err.nbytes  # stage 0's errors, the contract's output
    assert dict(rec.counters) == {}


def minsum_checks(its_run, max_iters, check_every):
    return sum(1 for t in range(1, its_run + 1) if t % check_every == 0 or t >= max_iters)


def lane_iters_launched(spans, conv, iters, max_iters, check_every):
    """The lane-major loop's lane-iterations, segment by segment: each
    ``ldpc.minsum.compact`` span after a check narrows the width to the
    lanes not done there (not converged by that check's iteration)."""
    grid = [t for t in range(1, max_iters + 1) if t % check_every == 0 or t >= max_iters]
    width, start, k, t, total = len(iters), 0, 0, 0, 0
    for name in spans:
        if name == "ldpc.minsum.check":
            t, k = grid[k], k + 1
        elif name == "ldpc.minsum.compact":
            total += width * (t - start)
            width, start = int((~(conv & (iters <= t))).sum()), t
    return total + width * (t - start)


@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_minsum_host_reads_are_its_checks_and_outputs(check_every):
    A, pr, _ = _small_dem()
    det = _records(A, pr, 32, 2, 6.0)
    dec = pt.MinSumDecoder(A, pr.mean(), 25, damping=0.3, check_every=check_every,
                           device="cpu")
    with profiling.recording() as rec:
        err, conv, iters, aux, _ = dec.batch_decode_detailed(det)
    (call,) = rec.calls
    its_run = int(iters.max())
    checks = minsum_checks(its_run, 25, check_every)
    assert [s.name for s in call.spans].count("ldpc.minsum.check") == checks
    assert call.counters["host_reads"] == checks + 4  # errors, flags, iterations, LLRs
    names = [s.name for s in call.spans]
    assert call.counters.get("minsum_compactions", 0) == names.count("ldpc.minsum.compact")
    launched = lane_iters_launched(names, conv, iters, 25, check_every)
    assert call.counters["minsum_lane_iters_launched"] == launched >= int(iters.sum())
    assert call.counters["h2d_bytes"] == det.nbytes
    # each check reads the count of lanes not done, an int64
    assert call.counters["d2h_bytes"] == (err.nbytes + conv.nbytes + iters.nbytes
                                          + aux["llrs"].nbytes + 8 * checks)


def test_worker_thread_spans_carry_no_call():
    A, pr, O = _small_dem()
    dec = pt.StagedDemDecoder(A, pr, observables=O, gammas=(0.2, 0.4), stage0_iters=32,
                              deep_iters=96, lam=16, min_bucket=16, device="cpu")
    with profiling.recording() as rec:
        # tests/test_torch_staged.py's case with shots for the OSD worker
        st = dec.run_eval(512, batch=256, deep_bucket=64, pipeline=3, seed=11)

        def worker():
            with profiling.span("ldpc.worker"):
                pass

        with profiling.call_span():
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    osd = [s for s in rec.spans if s.name == "ldpc.staged.osd"]
    assert st["profile"]["osd_shots"] > 0 and osd
    assert all(s.call is None and s.parent is None for s in osd)
    assert rec.counters["osd_lanes"] == st["profile"]["osd_shots"]
    (worker,) = [s for s in rec.spans if s.name == "ldpc.worker"]
    assert worker.call is None and worker.parent is None and len(rec.calls) == 1


def test_threads_lose_no_count():
    """More threads than cores, a short switch interval: every count lands."""
    n_threads, per_thread = (os.cpu_count() or 1) + 4, 100
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            def work():
                for _ in range(per_thread):
                    with profiling.span("ldpc.t"):
                        profiling.count("n")
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert rec.counters["n"] == n_threads * per_thread == len(rec.spans)
    assert all(s.parent is None for s in rec.spans)


def test_profiler_session_is_recorded(staged):
    dec, det = staged
    dec.batch_decode(det)  # no profiler: nothing kept
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        dec.batch_decode(det)
        dec.batch_decode(det)
    rec = profiling.profiled()
    assert len(rec.calls) == 2
    dec.batch_decode(det)  # after the session: the record stays as it was
    assert profiling.profiled() is rec and len(rec.calls) == 2
    names = {e.name for e in prof.events()}
    assert {"ldpc.call", "ldpc.staged.osd", "ldpc.minsum.check"} <= names
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        dec.batch_decode(det)
    assert profiling.profiled() is not rec and len(profiling.profiled().calls) == 1


def test_trace_writes_spans_and_counters(tmp_path):
    A, pr, _ = _small_dem()
    dec = pt.MinSumDecoder(A, pr.mean(), 12, check_every=4, device="cpu")
    det = _records(A, pr, 8, 3, 4.0)
    with profiling.trace(str(tmp_path)):
        dec.batch_decode(det)
    files = sorted(os.listdir(tmp_path))
    (chrome,) = [f for f in files if f.endswith(".pt.trace.json")]
    (counters,) = [f for f in files if f.endswith(".counters.json")]
    events = json.loads((tmp_path / chrome).read_text())["traceEvents"]
    assert {"ldpc.call", "ldpc.decode", "ldpc.minsum.check"} <= {e.get("name") for e in events}
    (call,) = json.loads((tmp_path / counters).read_text())["calls"]
    assert call["counters"]["h2d_bytes"] == det.nbytes and call["end_ns"] > call["start_ns"]


# -- BP+OSD and the device OSD --------------------------------------------------


@pytest.fixture(scope="module")
def bposd_recorded():
    """BP+OSD-CS on the small DEM: a damped min-sum inner that leaves some
    lanes unconverged, the device OSD (its plain versions) on those."""
    A, pr, O = _small_dem()
    dec = pt.DetectorGraphDecoder(A, pr, 30, observables=O, decoder="bposd", inner="minsum",
                                  damping=0.4, osd_order=8, osd_method="combination_sweep",
                                  osd_scope="failed", device="cpu")
    det = _records(A, pr, 40, 2, 8.0)
    with profiling.recording() as rec:
        out = dec.batch_decode_detailed(det)
    return dec, det, rec, out


def test_bposd_spans_nest_and_change_no_output(bposd_recorded):
    dec, det, rec, on = bposd_recorded
    off = dec.batch_decode_detailed(det)
    for a, b in zip(off[:3], on[:3]):
        assert np.array_equal(a, b)
    (call,) = rec.calls
    tree = [(depth(rec, s), s.name) for s in call.spans]
    assert [n for d, n in tree if d == 1] == ["ldpc.to_device", "ldpc.decode", "ldpc.to_host"]
    assert [n for d, n in tree if d == 2] == ["ldpc.bposd.inner", "ldpc.bposd.osd"]
    parents = {}
    for s in call.spans[1:]:
        parents.setdefault(s.name, []).append(rec.spans[s.parent].name)
    assert parents["ldpc.minsum.decode"] == ["ldpc.bposd.inner"]
    assert set(parents["ldpc.minsum.check"]) == {"ldpc.minsum.decode"}
    for name in ("ldpc.osd.pack", "ldpc.osd.eliminate", "ldpc.osd.sweep"):
        assert parents[name] == ["ldpc.bposd.osd"]
    for s in call.spans[1:]:
        p = rec.spans[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_bposd_counters_and_host_reads(bposd_recorded):
    from ldpcdecoders_tpu_torch.models.priors import next_pow2

    _, det, rec, (err, conv, iters, aux, _) = bposd_recorded
    c = rec.totals()
    failing = int((~conv).sum())
    assert failing > 0 and next_pow2(failing) > failing  # the bucket pads
    assert c["osd_dev_lanes"] == failing
    assert c["osd_dev_lanes_padded"] == next_pow2(failing)
    checks = [s.name for s in rec.calls[0].spans].count("ldpc.minsum.check")
    assert checks == int(iters.max())
    # a read a check, the converged flags, the contract's four outputs
    assert c["host_reads"] == checks + 1 + 4
    assert c["d2h_bytes"] == (8 * checks + conv.nbytes + err.nbytes + conv.nbytes + iters.nbytes
                              + aux["log_probabs"].nbytes)


def test_bposd_host_osd_reads_are_counted():
    A, pr, O = _small_dem()
    dec = pt.DetectorGraphDecoder(A, pr, 20, observables=O, decoder="bposd", inner="minsum",
                                  damping=0.4, osd_order=8, osd_method="combination_sweep",
                                  osd_scope="failed", osd_impl="host", device="cpu")
    det = _records(A, pr, 24, 3, 8.0)
    with profiling.recording() as rec:
        err, conv, iters, _, _ = dec.batch_decode_detailed(det)
    c = rec.totals()
    assert (~conv).any() and "osd_dev_lanes" not in c
    checks = [s.name for s in rec.calls[0].spans].count("ldpc.minsum.check")
    # the checks, the converged flags, the OSD's three inputs, the four outputs
    assert c["host_reads"] == checks + 1 + 3 + 4
    assert c["h2d_bytes"] == det.nbytes + int((~conv).sum()) * err.shape[1]


# -- the benchmark's readers of the record --------------------------------------

READERS = ["copy_share.dem", "deep_share.dem", "osd_ms_per_lane.dem",
           "minsum_useful_share.dem", "host_reads_per_call.dem"]


def reader(name):
    sys.path.insert(0, ROOT)
    try:
        from portbench import spec
    finally:
        sys.path.remove(ROOT)
    return spec.reader(name)


@pytest.fixture(scope="module")
def profiled_ctx(staged):
    dec, det = staged
    dec.batch_decode(det)  # a call without a profiler ends the last session's record
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        outs = [dec.batch_decode_detailed(det) for _ in range(2)]
    rec = profiling.profiled()
    lane_iters = sum(int(o[2].sum()) for o in outs)
    span = [rec.calls[0].spans[0].start_ns, rec.calls[-1].spans[0].end_ns]
    return {"trace": {"window_s": (span[1] - span[0]) * 1e-9, "calls": 2,
                      "lane_iters": lane_iters}}, rec, outs


@pytest.mark.parametrize("name", READERS)
def test_reader_of_a_recorded_run(profiled_ctx, name):
    ctx, rec, outs = profiled_ctx
    value = reader(name)(ctx)
    c = rec.totals()
    want = {"host_reads_per_call.dem": c["host_reads"] / 2,
            "minsum_useful_share.dem": 100 * ctx["trace"]["lane_iters"]
            / c["minsum_lane_iters_launched"]}
    if name in want:
        assert value == pytest.approx(want[name])
    elif name == "osd_ms_per_lane.dem":
        assert 0 < value < 1e3 * ctx["trace"]["window_s"]
    else:
        assert 0 < value < 100


@pytest.mark.parametrize("name", READERS)
def test_reader_without_its_inputs(profiled_ctx, name):
    ctx, _, _ = profiled_ctx
    assert reader(name)({"trace": None}) is None
    assert reader(name)({"trace": dict(ctx["trace"], calls=3)}) is None


# -- the staged flagship: relay legs and the ensemble's work ---------------------


def _flagship_dem(seed=3, D=48, N=260):
    """Column weights 1-3 (every variable sums its messages one slot at a
    time, as the benchmark's reference does) and priors of four levels."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    A = np.zeros((D, N), np.uint8)
    for j in range(N):
        A[rng.choice(D, rng.integers(1, 4), replace=False), j] = 1
    return sp.csr_matrix(A), np.array([0.004, 0.01, 0.02, 0.03])[rng.integers(0, 4, N)]


FLAGSHIP = dict(gammas=[0.4] + [[-0.24, 0.66]] * 5, stage0_iters=16, deep_iters=24,
                relay_iters=24, relay_legs=3, relay_range=[-0.24, 0.66], lam=10, lam3=8,
                check_every=8, layout="check", deep_dtype=torch.bfloat16)


@pytest.fixture(scope="module")
def flagship():
    A, priors = _flagship_dem()
    dec = pt.StagedDemDecoder(A, priors, min_bucket=4, hbm_bytes=8 << 30, device="cpu",
                              **FLAGSHIP)
    x = (np.random.default_rng(4).random((64, A.shape[1])) < 3.0 * priors).astype(np.uint8)
    det = (x @ A.T.toarray() % 2).astype(np.uint8)
    with profiling.recording() as rec:
        out = dec.batch_decode_detailed(det)
    return dec, A, priors, det, rec, out


def test_flagship_counts_relay_legs_and_the_ensemble_work(flagship):
    dec, A, priors, det, rec, (err, conv, iters, _, _) = flagship
    sys.path.insert(0, ROOT)
    try:
        from portbench.reference import relay as ref_relay
    finally:
        sys.path.remove(ROOT)
    stated = dict(FLAGSHIP, deep_dtype="bfloat16", dtype="float32", alpha=1.0,
                  osd_rank="abs_llr", dmem_seed=0xD3E, relay_seed=0xE1A9)
    ref = ref_relay.decode_stated(A, priors, stated, det, "cpu")
    assert np.array_equal(iters, ref["iters"])
    c = rec.totals()
    names = [s.name for s in rec.calls[0].spans]
    legs = names.count("ldpc.staged.relay")
    assert 1 <= legs <= FLAGSHIP["relay_legs"] and ((iters > 16 + 24) & conv).any()
    assert 0 < c["relay_lanes"] <= c["relay_lanes_padded"]
    assert c["relay_lanes_padded"] >= 4 * legs  # each leg's bucket is at least min_bucket
    # each shot's own stage-0 iterations: its count where stage 0 converged, the cap else
    assert c["stage0_lane_iters"] == int(np.minimum(iters, dec.stage0_iters).sum())
    # each real member lane's own iterations, deep and relay, padding left out
    assert c["member_lane_iters"] == int(ref["member_iters"].sum())
    assert c["member_lane_iters"] < c["minsum_lane_iters_launched"]


def test_flagship_reads_its_counters_only_while_recording(flagship, monkeypatch):
    """Off, the path makes the reads it made before the counters; on, one
    more a ``count_sum``: stage 0's, and one a deep bucket and relay leg."""
    dec, _, _, det, rec, on = flagship
    reads = {"n": 0}
    for name in ("__int__", "__bool__", "item", "numpy", "tolist"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            reads["n"] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)

    def run(record):
        reads["n"] = 0
        if record:
            with profiling.recording() as r:
                out = dec.batch_decode_detailed(det)
        else:
            r, out = None, dec.batch_decode_detailed(det)
        return reads["n"], r, out

    n_off, _, off = run(False)
    n_on, r, _ = run(True)
    names = [s.name for s in r.calls[0].spans]
    sums = 1 + names.count("ldpc.staged.deep") + names.count("ldpc.staged.relay")
    assert n_on - n_off == sums
    assert r.totals()["host_reads"] == rec.totals()["host_reads"]
    for a, b in zip(off[:3], on[:3]):
        assert np.array_equal(a, b)


def test_count_sum_touches_nothing_when_off():
    class Untouchable:
        def sum(self, *a, **k):
            raise AssertionError("read while recording is off")

    profiling.count_sum("x", Untouchable())
    with profiling.recording() as rec:
        profiling.count_sum("x", torch.tensor([2, 3], dtype=torch.int32))
    assert rec.counters["x"] == 5


# -- the windowed decoder: one span a window around its inner's ------------------


def _round_dem(seed=7, R=6, r=12, per_round=40):
    """A DEM of ``R`` rounds of ``r`` detectors: a single-detector mechanism
    on each detector, and ``per_round`` mechanisms a round of 1-3 detectors
    over that round and the next (column weights 1-3)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    cols = [[d] for d in range(R * r)]
    for t in range(R):
        for _ in range(per_round):
            rounds = min(int(rng.integers(1, 3)), R - t)
            pool = np.arange(t * r, (t + rounds) * r)
            first = int(rng.integers(t * r, (t + 1) * r))
            rest = rng.choice(pool[pool != first], int(rng.integers(0, 3)), replace=False)
            cols.append([first, *rest.tolist()])
    A = np.zeros((R * r, len(cols)), np.uint8)
    for j, rows in enumerate(cols):
        A[rows, j] = 1
    priors = np.array([0.004, 0.01, 0.02, 0.03])[rng.integers(0, 4, len(cols))]
    return sp.csr_matrix(A), priors


@pytest.fixture(scope="module")
def windowed():
    A, priors = _round_dem()
    dec = pt.WindowedDemDecoder(A, priors, detectors_per_round=12, window=3, commit=1,
                                max_iters=24, min_bucket=4, hbm_bytes=8 << 30, device="cpu",
                                **{k: v for k, v in FLAGSHIP.items()
                                   if k not in ("deep_iters", "relay_iters")})
    x = (np.random.default_rng(9).random((48, A.shape[1])) < 3.0 * priors).astype(np.uint8)
    det = (x @ A.T.toarray() % 2).astype(np.uint8)
    off = dec.batch_decode_detailed(det)
    with profiling.recording() as rec:
        on = dec.batch_decode_detailed(det)
    return dec, det, rec, off, on


def test_windowed_spans_one_a_window_around_the_inner(windowed):
    dec, _, rec, off, on = windowed
    for a, b in zip(off[:3], on[:3]):
        assert np.array_equal(a, b)
    (call,) = rec.calls
    tree = [(depth(rec, s), s.name) for s in call.spans]
    assert [n for d, n in tree if d == 1] == ["ldpc.to_device", "ldpc.decode", "ldpc.to_host"]
    windows = [s for d, s in zip((d for d, _ in tree), call.spans) if d == 2]
    assert [s.name for s in windows] == ["ldpc.window"] * len(dec._plan) == ["ldpc.window"] * 4
    index = {id(s): i for i, s in enumerate(rec.spans)}
    for w in windows:
        kids = [s.name for s in call.spans if s.parent == index[id(w)]]
        assert kids[0] == "ldpc.staged.stage0" and kids[-1] == "ldpc.window.commit"
        assert kids.count("ldpc.window.commit") == 1
    # the windows' inners reached their deep ensembles and relay legs
    names = [s.name for s in call.spans]
    assert "ldpc.staged.deep" in names and "ldpc.staged.relay" in names


def test_windowed_counters_per_window_sum_to_the_inner_counters(windowed):
    dec, _, rec, _, (err, conv, iters, aux, _) = windowed
    c = rec.totals()
    W = len(dec._plan)
    assert c["windows"] == W and c["window_commit_cols"] == dec.N
    assert c["window_lanes_unconverged"] == int((~aux["window_converged"]).sum()) > 0
    for name in ("stage0_lane_iters", "member_lane_iters"):
        assert sum(c[f"{name}.w{k}"] for k in range(W)) == c[name] > 0
    assert not (conv & (iters == 0)).any() and np.array_equal(conv,
                                                              aux["window_converged"].all(1))
