#!/usr/bin/env python3
"""The decoder's own spans against the profiler's ranges, and a traced split
of a benchmark cell's calls by span.

    python3 tools/span_clock_check.py --workload bb144_r6.p003 --seed 5 [--calls 4]
        [--out DIR]

Builds the cell's decoder on its traffic (``portbench``: the pool drawn from
``--seed``), makes one warm-up call, then ``--calls`` calls of
``batch_decode_detailed`` inside ``utils.profiling.recording()`` under
``torch.profiler`` (CPU and CUDA), and reads the Chrome trace back:

* the clock: each recorded span against the profiler range of its name
  (the k-th span of a name against the k-th range), at entry and exit,
  ``(t_ns - baseTimeNanoseconds) / 1000 - ts`` in microseconds;
* per span name, the seconds of the calls inside it (the union of its
  ranges) and the device's idle time named by the innermost ``ldpc.*``
  range running at each idle stretch's middle;
* the counters of each call;
* per span name, how long the device ran on after the span closed the
  work launched inside it: the latest end of a device operation whose
  launch (matched by the trace's correlation ids) lies in the span, less
  the span's end, in microseconds (at most 0: the span holds its device
  work, not only its launches).

One JSON line goes to standard output; with ``--out`` the Chrome trace is
kept there.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def innermost_idle(tr, lo, hi, tracing):
    """Device idle in ``[lo, hi]`` by the innermost ``ldpc.*`` range at each
    idle stretch's middle (``none`` outside every one), in seconds."""
    ranges = sorted((s, e, n) for n, iv in tr.spans.items() if n.startswith("ldpc.")
                    for s, e in iv)
    by = defaultdict(float)
    for gs, ge in tracing.gaps(tr.busy, lo, hi):
        mid = (gs + ge) / 2
        inner = [r for r in ranges if r[0] <= mid < r[1]]
        name = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "none"
        by[name] += (ge - gs) * 1e-6
    return dict(sorted(by.items(), key=lambda x: -x[1]))


def device_lag(path, tr) -> dict:
    """Per ``ldpc.*`` range name, ``max(end of a device operation launched
    inside the range) - the range's end`` over its ranges, in
    microseconds (the median and the largest; ranges that launched nothing
    are left out)."""
    from portbench import tracing

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch, done = {}, {}
    for ev in events:
        corr = (ev.get("args") or {}).get("correlation")
        if ev.get("ph") != "X" or corr is None:
            continue
        if ev.get("cat") == "cuda_runtime":
            launch[corr] = float(ev["ts"])
        elif ev.get("cat") in tracing.DEVICE_CATS:
            done[corr] = float(ev["ts"]) + float(ev["dur"])
    pairs = sorted((launch[c], done[c]) for c in done if c in launch)
    starts = [t for t, _ in pairs]
    out = {}
    for name, ranges in tr.spans.items():
        if not name.startswith("ldpc."):
            continue
        lags = []
        for s, e in ranges:
            lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(starts, e)
            if hi > lo:
                lags.append(max(end for _, end in pairs[lo:hi]) - e)
        if lags:
            out[name] = {"median": statistics.median(lags), "max": max(lags), "n": len(lags)}
    return out


def split(dec, pool, calls: int, out_dir: str | None, tag: str) -> dict:
    """A warm-up call on ``pool[0]``, then ``calls`` traced and recorded
    calls on the next batches; the clock offsets, the split and the
    counters."""
    import torch

    from ldpcdecoders_tpu_torch.utils import profiling
    from portbench import tracing

    dec.batch_decode_detailed(pool[0])
    if dec.device.type == "cuda":
        torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with profiling.recording() as rec, torch.profiler.profile(activities=acts) as prof:
        for i in range(calls):
            dec.batch_decode_detailed(pool[1 + i])
    keep = out_dir is not None
    out_dir = out_dir or tempfile.mkdtemp()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{tag}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        base = int(json.load(f)["baseTimeNanoseconds"])
    tr = tracing.Trace(path)
    lag = device_lag(path, tr)
    if not keep:
        os.unlink(path)

    offsets = {"entry": [], "exit": []}
    mine = defaultdict(list)
    for s in rec.spans:
        mine[s.name].append(s)
    unmatched = {}
    for name, spans in mine.items():
        ranges = sorted(tr.spans.get(name, []))
        if len(ranges) != len(spans):
            unmatched[name] = [len(spans), len(ranges)]
            continue
        for s, (rs, re_) in zip(sorted(spans, key=lambda s: s.start_ns), ranges):
            offsets["entry"].append((s.start_ns - base) / 1e3 - rs)
            offsets["exit"].append((s.end_ns - base) / 1e3 - re_)
    spans = sorted(tr.spans["ldpc.call"])
    lo, hi = spans[0][0], spans[-1][1]
    window = [(lo, hi)]
    return {
        "calls": calls,
        "clock_us": {k: {"median": statistics.median(v), "min": min(v), "max": max(v),
                         "max_abs": max(abs(x) for x in v), "n": len(v)}
                     for k, v in offsets.items() if v},
        "unmatched": unmatched,
        "window_s": (hi - lo) * 1e-6,
        "busy_s": tracing.overlap(tr.busy, window) * 1e-6,
        "span_s": {n: tracing.overlap(tracing.union(iv), window) * 1e-6
                   for n, iv in sorted(tr.spans.items()) if n.startswith("ldpc.")},
        "idle_by_span_s": innermost_idle(tr, lo, hi, tracing),
        "counters": [dict(c.counters) for c in rec.calls],
        "device_lag_us": lag,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    import torch

    from portbench import harness, inputs, spec

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = spec.resolve(a.workload)
    code = inputs.load_code(cell.config, cell.bench_dir)
    channel = inputs.load_channel(cell.traffic, code, cell.bench_dir)
    B = int(cell.traffic["batch"])
    pool = inputs.draw_pool(code, channel, B, a.calls + 1, a.seed, device)

    import ldpcdecoders_tpu_torch as port

    dec = harness.build_decoder(port, cell, code, channel, device, False)
    result = {"workload": a.workload, "seed": a.seed, "card": torch.cuda.get_device_name(device),
              "torch": torch.__version__,
              **split(dec, pool, a.calls, a.out, f"{a.workload}.{a.seed}")}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
