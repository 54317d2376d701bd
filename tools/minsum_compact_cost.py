#!/usr/bin/env python3
"""Measure the min-sum loop's compaction on a card: what an iteration costs
by the width it launches, what the gather that narrows the state costs, and
whole decodes with the compaction on and off.

    python3 tools/minsum_compact_cost.py [--out FILE] [--skip-decodes]

On the bb144 R=6 DEM (``portbench``'s cell ``bb144_r6.p001``: its code, its
priors and a pool drawn from seed 21):

  1. ``width``: one iteration of stage 0's ``MinSumDecode`` (check layout,
     float32, damping 0.4, checked every 8) launched over ``w`` lanes on
     the tile :func:`lane_tile_for` gives, as the time of 24 iterations less
     that of 8, over 16 (``early_exit=False``; CUDA events behind a spin
     kernel, 3 calls after a warm-up), and per lane.
  2. ``gather``: the loop's own compaction at the first check of a decode
     of 2048 lanes on 128-lane tiles (stage 0's settings, and the deep
     bucket's: ``[B, n]`` gammas and ``track_best``) down to ``live`` lanes
     (the others' records empty, the ``live`` lanes' drawn at 50 times the
     priors, never converging), the rule's costs set to 0 so that it
     narrows: the ``ldpc.minsum.compact`` span's wall time with the device
     drained at entry and exit (host and device), and its device time alone
     (CUDA events); the median of 3 decodes.  Over part 1's 2048-wide
     lane-iteration and the width kept, the cost the rule's constants
     ``models/minsum.py`` ``_GATHER_LANE_ITERS`` and
     ``_GATHER_FIXED_BYTES`` weigh.
  3. ``decodes``: the cell's ``StagedDemDecoder`` on 2048 records of each
     of p = 0.001 and 0.003, and ``MinSumDecoder`` on the (1000, 10, 9)
     Gallager code (per 0.01, 100 iterations) at 1024 and 8192 lanes, with
     the compaction on and off (``_GATHER_LANE_ITERS`` infinite) in turns
     (on, off, off, on); wall time per call, the counters of one recorded
     call each way, and whether every output is bitwise the same.

Prints the card's name and power limit first; writes the numbers as JSON
to ``--out`` (default ``chiprun_out/minsum_compact_cost.json``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import ldpcdecoders_tpu_torch as pt  # noqa: E402
from ldpcdecoders_tpu_torch.models import minsum as minsum_module  # noqa: E402
from ldpcdecoders_tpu_torch.models.minsum import lane_tile_for  # noqa: E402
from ldpcdecoders_tpu_torch.utils import profiling  # noqa: E402
from portbench import harness, inputs, spec  # noqa: E402

WIDTHS = (2048, 1536, 1024, 512, 256, 192, 128, 64, 48, 32, 16, 8, 4, 1)
LIVES = (1920, 1536, 1024, 512, 256, 192, 128, 64, 48, 32, 16, 8, 1)


def event_ms(fn, reps=3):
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


def cell_inputs(name, dev, B=2048, seed=21, scale=1.0):
    cell = spec.resolve(name)
    code = inputs.load_code(cell.config, cell.bench_dir)
    channel = inputs.load_channel(cell.traffic, code, cell.bench_dir)
    drawn = inputs.Channel(np.minimum(channel.priors * scale, 0.5), channel.arg)
    pool = inputs.draw_pool(code, drawn, B, 1, seed, dev)
    return cell, code, channel, pool[0]


def widths(g, syn, dev):
    """Part 1: an iteration's time by launched width."""
    short, long = (pt.MinSumDecode(g, 0.001, k, device=dev, damping=0.4, check_every=8,
                                   layout="check") for k in (8, 24))
    rows = []
    for w in WIDTHS:
        s = syn[:w]
        t8 = event_ms(lambda: short(s, early_exit=False))
        t24 = event_ms(lambda: long(s, early_exit=False))
        it = (t24 - t8) / 16
        rows.append(dict(width=w, tile=lane_tile_for(w), iter_ms=it, lane_iter_us=it / w * 1e3))
        print(f"width {w:5d} tile {lane_tile_for(w):3d}: iteration {it:.4f} ms, "
              f"{it / w * 1e3:.4f} us a lane", flush=True)
    return rows


def gathers(g, syn_hi, dev, unit_us):
    """Part 2: the loop's compaction at its first check, from 2048 lanes on
    128-lane tiles to ``live``: the other lanes' records are empty (done
    there), the ``live`` lanes' never converge; the rule's costs set to 0 so
    that it narrows.  The span is timed with the device drained at entry (as
    after the check's host read) and at exit: host and device together, and
    the device alone (CUDA events)."""
    times = {}
    real_span = minsum_module.span

    class Timed:
        def __init__(self, name):
            self.name, self.inner = name, real_span(name)

        def __enter__(self):
            if self.name == "ldpc.minsum.compact":
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()
                self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                self.ev[0].record()
            return self.inner.__enter__()

        def __exit__(self, *exc):
            self.inner.__exit__(*exc)
            if self.name == "ldpc.minsum.compact":
                self.ev[1].record()
                torch.cuda.synchronize()
                times.setdefault("wall", []).append((time.perf_counter() - self.t0) * 1e3)
                times.setdefault("device", []).append(self.ev[0].elapsed_time(self.ev[1]))
            return False

    out = []
    saved = (minsum_module._GATHER_LANE_ITERS, minsum_module._GATHER_FIXED_BYTES,
             minsum_module.span)
    minsum_module._GATHER_LANE_ITERS = minsum_module._GATHER_FIXED_BYTES = 0.0
    minsum_module.span = Timed
    try:
        for kind in ("stage0", "deep"):
            kw = (dict(damping=0.4) if kind == "stage0" else
                  dict(lane_damping=True, track_best=True))
            ms = pt.MinSumDecode(g, 0.001, 16, device=dev, check_every=8, layout="check", **kw)
            gamma = (None if kind == "stage0" else
                     torch.rand((2048, g.n), generator=torch.Generator(dev).manual_seed(1),
                                device=dev) * 0.9 - 0.24)
            for live in LIVES:
                syn = torch.zeros((2048, g.m), dtype=torch.uint8, device=dev)
                syn[:live] = syn_hi[:live]
                with profiling.recording() as rec:
                    ms(syn, None, gamma)  # warm-up
                times.clear()
                for _ in range(3):
                    res = ms(syn, None, gamma)
                stray = int(res[1][:live].sum()) + int((~res[1][live:]).sum())
                width = -(-live // lane_tile_for(live)) * lane_tile_for(live)
                wall, device = float(np.median(times["wall"])), float(np.median(times["device"]))
                state_b = rec.counters["minsum_compact_bytes"]
                out.append(dict(kind=kind, live=live, width=width, wall_ms=wall,
                                device_ms=device, gathered_bytes=state_b, stray_lanes=stray,
                                wall_lane_iters_per_lane=wall * 1e3 / unit_us / width))
                print(f"compaction {kind} 2048 -> {live:5d} (width {width:5d}): wall {wall:.4f} "
                      f"ms, device {device:.4f} ms, {state_b / 1e6:.1f} MB gathered, "
                      f"{wall * 1e3 / unit_us / width:.3f} lane-iterations a lane; {stray} lanes off "
                      f"the plan", flush=True)
            del ms, gamma
            torch.cuda.empty_cache()
    finally:
        (minsum_module._GATHER_LANE_ITERS, minsum_module._GATHER_FIXED_BYTES,
         minsum_module.span) = saved
    return out


def turns(label, call, reps):
    """``call()`` with the compaction on and off in turns; wall ms per call,
    a recorded call's counters each way, and whether the outputs agree."""
    keep = minsum_module._GATHER_LANE_ITERS
    res = {}
    times = {"on": [], "off": []}
    try:
        for way in ("on", "off", "off", "on"):
            minsum_module._GATHER_LANE_ITERS = keep if way == "on" else float("inf")
            if way not in res:
                with profiling.recording() as rec:
                    res[way] = call()
                res[way + "_counters"] = rec.totals()
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                times[way].append((time.perf_counter() - t0) * 1e3)
    finally:
        minsum_module._GATHER_LANE_ITERS = keep

    def flat(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        if isinstance(x, (tuple, list)):
            return [v for y in x for v in flat(y)]
        return [np.asarray(x)]

    same = all(a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(flat(res["on"]), flat(res["off"])))
    row = dict(case=label, bitwise=same, on_ms=times["on"], off_ms=times["off"],
               on_median_ms=float(np.median(times["on"])),
               off_median_ms=float(np.median(times["off"])),
               on_counters=res["on_counters"], off_counters=res["off_counters"])
    c_on, c_off = res["on_counters"], res["off_counters"]
    print(f"{label}: bitwise {same}; on {row['on_median_ms']:.2f} ms, off "
          f"{row['off_median_ms']:.2f} ms; lane-iterations {c_on.get('minsum_lane_iters_launched')}"
          f" / {c_off.get('minsum_lane_iters_launched')}, compactions "
          f"{c_on.get('minsum_compactions', 0)}, {c_on.get('minsum_compact_bytes', 0)} B",
          flush=True)
    return row


def decodes(dev):
    """Part 3: whole decodes with the compaction on and off."""
    rows = []
    for name in ("bb144_r6.p001", "bb144_r6.p003"):
        cell, code, channel, syn = cell_inputs(name, dev)
        dec = harness.build_decoder(pt, cell, code, channel, dev, False)
        rows.append(turns(name + " staged", lambda: dec.batch_decode_detailed(syn), 2))
        del dec
        torch.cuda.empty_cache()
    H = inputs.gallager_pcm(1000, 10, 9, 42)
    dec = pt.MinSumDecoder(H, 0.01, 100, device=dev)
    rng = np.random.default_rng(5)
    for B in (1024, 8192):
        e = rng.random((B, H.shape[1])) < 0.01
        syn = ((e.astype(np.int64) @ H.T) % 2).astype(np.uint8)
        rows.append(turns(f"gallager B={B}", lambda: dec.batch_decode_detailed(syn), 10))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "minsum_compact_cost.json"))
    ap.add_argument("--skip-decodes", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print("card:", card, "| torch", torch.__version__, torch.version.cuda, flush=True)
    print("_GATHER_LANE_ITERS =", minsum_module._GATHER_LANE_ITERS, "_GATHER_FIXED_BYTES =",
          minsum_module._GATHER_FIXED_BYTES, flush=True)
    cell, code, channel, syn = cell_inputs("bb144_r6.p001", dev)
    dec = harness.build_decoder(pt, cell, code, channel, dev, False)
    g = dec.graph
    del dec
    result = dict(card=card, gather_lane_iters=minsum_module._GATHER_LANE_ITERS,
                  gather_fixed_bytes=minsum_module._GATHER_FIXED_BYTES)
    result["width"] = widths(g, torch.as_tensor(syn, device=dev), dev)
    unit_us = result["width"][0]["lane_iter_us"]
    # records that never converge: mechanisms drawn at 50 times the priors
    syn_hi = cell_inputs("bb144_r6.p001", dev, seed=22, scale=50.0)[3]
    torch.cuda.empty_cache()
    result["gather"] = gathers(g, torch.as_tensor(syn_hi, device=dev), dev, unit_us)
    if not args.skip_decodes:
        result["decodes"] = decodes(dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
