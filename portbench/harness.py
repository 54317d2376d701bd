"""One run of one cell: set-up, the measured window, the check, the result line.

Set-up (counted in ``setup_s``, from the first line of ``run.py`` to the
first timed call): the code and channel, a pool of syndrome batches drawn on
the card from the seed, the import of ``ldpcdecoders_tpu_torch`` with its
kernel library (built by nvcc into its own ``_kernels/`` at the first run of
a checkout), the decoder, and one warm-up call on the cell's batch.

The window: one client in a closed loop calls
``decoder.batch_decode_detailed(batch)`` (numpy in, numpy out) on the pool's
batches in turn, each call issued when the last has returned, until
``--seconds`` have passed; the window ends when the last call returns.  A
call is kept for the check with the traffic's ``keep_share`` (drawn from the
seed; the first call always), with ``check_rows_per_call`` of its shots sampled
for the reference.
With ``--trace 1`` the first ``trace_calls`` calls run under
``torch.profiler``, each inside a ``portbench.call`` range and the
configuration's ``host_spans`` (methods of the decoder) inside
``portbench.<label>`` ranges; the per-layer metrics are read from that
trace.

After the window: the peak device memory, then the program's state is
freed and :mod:`portbench.check` compares the kept answers with the plain
reference.  The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import check, inputs, spec, tracing

__all__ = ["main", "FORBIDDEN"]

#: top-level modules no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "ldpcdecoders_tpu")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the configuration's lower-precision control in the program's "
                         "place (not part of a benchmark run)")
    return ap.parse_args(argv)


def forbidden_loaded() -> list[str]:
    """The forbidden top-level names among the loaded modules, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def build_decoder(port, cell, code, channel, device, control: bool):
    d = cell.config["decoder"]
    kwargs = dict(d.get("kwargs", {}))
    if control:
        kwargs.update(cell.config["control"])
    kwargs = {k: _DTYPES[v] if k.endswith("dtype") else v for k, v in kwargs.items()}
    if code.kind == "dem":
        matrix, kwargs["observables"] = code.M, code.O
    else:
        matrix = code.M.toarray()
    return getattr(port, d["class"])(matrix, channel.arg, device=device, **kwargs)


def wrap_spans(decoder, spans: dict):
    """Put each named method of the decoder instance inside a profiler range."""
    for label, attr in spans.items():
        fn = getattr(decoder, attr)

        def wrapped(*a, _fn=fn, _name=f"portbench.{label}", **k):
            with torch.profiler.record_function(_name):
                return _fn(*a, **k)

        setattr(decoder, attr, wrapped)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def window(decode, pool, traffic, seconds, seed, trace_calls):
    """The closed loop.  Returns the host record, the kept calls and the
    profiler (or None)."""
    B = pool[0].shape[0]
    share = float(traffic["keep_share"])
    per_call = int(traffic["check_rows_per_call"])
    keep_u = np.random.default_rng([seed, 1]).random(1 << 18)
    prof = None
    if trace_calls:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    lat, kept = [], []
    calls = lane_iters = 0
    t_begin = time.perf_counter()
    t_end = t_begin
    while t_end - t_begin < seconds:
        idx = calls % len(pool)
        t = time.perf_counter()
        if prof is not None:
            with torch.profiler.record_function("portbench.call"):
                out = decode(pool[idx])
        else:
            out = decode(pool[idx])
        t_end = time.perf_counter()
        lat.append(t_end - t)
        err, conv, iters, aux = out[:4]
        if prof is not None:
            lane_iters += int(iters.sum(dtype=np.int64))
            if calls + 1 == trace_calls:
                prof.stop()
                traced = (calls + 1, lane_iters)
                prof_done, prof = prof, None
        if calls == 0 or keep_u[calls % keep_u.size] < share:
            rows = np.sort(np.random.default_rng([seed, 2, calls]).choice(B, per_call,
                                                                         replace=False))
            llrs = aux.get("llrs")
            kept.append((idx, rows, err, conv, iters[rows].copy(),
                         None if llrs is None else llrs[rows].copy()))
        calls += 1
    if prof is not None:  # the window ended before trace_calls calls
        prof.stop()
        traced = (calls, lane_iters)
        prof_done = prof
    host = {"window_s": t_end - t_begin, "calls": calls, "shots": calls * B,
            "latencies_s": lat, "pool_batches": len(pool), "cycled": calls > len(pool)}
    if not trace_calls:
        return host, kept, None
    return host, kept, (prof_done, *traced)


def read_trace(prof, traced_calls, lane_iters, batch, spans):
    """The trace of the traced calls, reduced for the metric readers."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tr = tracing.Trace(path)
    finally:
        os.unlink(path)
    call_spans = tracing.union(tr.spans.get("portbench.call", []))
    if not call_spans:
        return None
    lo, hi = call_spans[0][0], call_spans[-1][1]
    win = [(lo, hi)]
    tid = next(t for s, e, n, t in tr.host if n == "portbench.call")
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": tracing.overlap(tr.busy, win) * 1e-6,
        "busy_in_calls_s": tracing.overlap(tr.busy, call_spans) * 1e-6,
        "launches": tr.launches(lo, hi),
        "calls": traced_calls,
        "shots": traced_calls * batch,
        "lane_iters": lane_iters,
        "spans_s": {label: tracing.overlap(tracing.union(tr.spans.get(f"portbench.{label}", [])),
                                           win) * 1e-6 for label in spans},
        "breakdown": {"device_ops": tr.top_ops(lo, hi), "idle_gaps": tr.idle_by_host(lo, hi, tid)},
    }


def main(argv=None, *, t_start=None, allow_cpu=False, fault=None, bench_dir=spec.BENCH_DIR):
    """Run one cell; returns the exit code.  ``allow_cpu`` and ``fault``
    (a function of a call's outputs and its batch, returning altered
    outputs) serve the benchmark's own tests only."""
    t0 = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cell = spec.resolve(args.workload, bench_dir)
    if allow_cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"needs {cell.chips} CUDA card(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf, traffic = cell.config, cell.traffic
    code = inputs.load_code(conf, cell.bench_dir)
    channel = inputs.load_channel(traffic, code, cell.bench_dir)
    B = int(traffic["batch"])
    pool = inputs.draw_pool(code, channel, B, int(traffic["pool_batches"]), args.seed, device)

    import ldpcdecoders_tpu_torch as port

    decoder = build_decoder(port, cell, code, channel, device, args.control)
    if args.trace:
        wrap_spans(decoder, conf.get("host_spans", {}))
    decode = decoder.batch_decode_detailed
    if fault is not None:
        def decode(batch, _decode=decode):
            return fault(_decode(batch), batch)
    decode(pool[0])
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    trace_calls = int(traffic["trace_calls"]) if args.trace else 0
    host, kept, traced = window(decode, pool, traffic, args.seconds, args.seed, trace_calls)

    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    del decoder, decode
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx = {"cell": cell.name, "config": conf, "traffic": traffic,
           "code": {"m": code.m, "n": code.n, "edges": code.edges},
           "setup_s": setup_s, **host, "trace": None}
    if traced is not None:
        ctx["trace"] = read_trace(traced[0], traced[1], traced[2], B, conf.get("host_spans", {}))
    t_check = time.perf_counter()
    checks = check.compare(cell, code, channel, pool, kept, device)
    check_s = time.perf_counter() - t_check
    info = checks.pop("_info")
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.reader(m["name"], cell.bench_dir)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": correct, "attempted": host["shots"],
              "failed": checks["inconsistent"]["value"], "metrics": metrics, "device": dev}
    if args.trace and ctx["trace"] is not None:
        dev["busy_s"] = ctx["trace"]["busy_s"]
        dev["window_s"] = ctx["trace"]["window_s"]
        result["breakdown"] = ctx["trace"]["breakdown"]
    result["checks"] = checks

    loaded = forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4
    print(f"window: {host['calls']} calls, {host['shots']} shots in {host['window_s']:.3f} s; "
          f"pool of {host['pool_batches']} batches, cycled: {host['cycled']}; setup "
          f"{setup_s:.3f} s; checked {info['kept_shots']} shots kept, {info['sampled']} "
          f"sampled, {info['ties']} ties, in {check_s:.3f} s", file=sys.stderr)
    q = np.quantile(np.asarray(host["latencies_s"]) * 1e3, [0, 0.25, 0.5, 0.75, 1])
    print("call ms: min %.3f, quartiles %.3f %.3f %.3f, max %.3f" % tuple(q), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
