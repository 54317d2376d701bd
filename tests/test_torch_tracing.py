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
    assert call.counters["minsum_lane_iters_launched"] == 32 * its_run >= int(iters.sum())
    assert call.counters["h2d_bytes"] == det.nbytes
    assert call.counters["d2h_bytes"] == (err.nbytes + conv.nbytes + iters.nbytes
                                          + aux["llrs"].nbytes + checks)


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
