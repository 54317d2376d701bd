#!/usr/bin/env python3
"""The work the device OSD's elimination needs on a BP+OSD cell's own failing
lanes: the operations of ``portbench/work_osd.py``'s yardstick, counted.

    python3 tools/osd_elim_work.py --workload bb144_r6_bposd.p003 --seed 5
        [--batches 2] [--lanes 32]

Builds the cell's decoder on its traffic (``portbench``: the pool drawn from
``--seed``), runs its inner decode on ``--batches`` batches of the pool,
takes up to ``--lanes`` failing lanes of each, orders and packs their
systems as the device OSD does (``OSD.sort_and_pack``), and eliminates them
with the plain Gauss-Jordan form (``ops/gf2.py`` ``gf2_eliminate`` with
``return_work``): its column trips, the rows its pivots were XORed into and
the words those XORs need, from the pivot's word on.  A lane's operations
are ``trips * m * 2 + words``, the count ``chip_smoke.py`` bounds K1/K2 by;
at 16.75e12 32-bit integer operations a second they give the yardstick's
operations time.  The plain form's outputs are checked against K2's
(``gf2_eliminate_cuda``), and K2 is timed on the same lanes by CUDA events
(one warm-up launch, then ``--reps``).

One JSON line goes to standard output.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PEAK_I32_OPS_PER_S = 16.75e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="bb144_r6_bposd.p003")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import ldpcdecoders_tpu_torch as port
    from ldpcdecoders_tpu_torch.ops import gf2
    from ldpcdecoders_tpu_torch.ops.cuda_gf2 import gf2_eliminate_cuda
    from portbench import harness, inputs, spec
    from portbench.work_osd import gf2_elim_lane

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.resolve(args.workload)
    code = inputs.load_code(cell.config, cell.bench_dir)
    channel = inputs.load_channel(cell.traffic, code, cell.bench_dir)
    B = int(cell.traffic["batch"])
    pool = inputs.draw_pool(code, channel, B, args.batches, args.seed, dev)
    dec = harness.build_decoder(port, cell, code, channel, dev, False)
    inner = getattr(dec, "inner", dec)
    osd, n, m = inner.osd, code.n, code.m
    prior = inner.bp.as_prior(dec._prior)

    per_lane = {"trips": [], "row_xors": [], "words": [], "ops": []}
    k2_s_per_lane, failing = [], []
    for batch in pool:
        syn = torch.as_tensor(batch, device=dev)
        with torch.no_grad():
            bp_err, conv, _, logp = inner.bp(syn, prior)
        fail = torch.nonzero(~conv)[:, 0]
        failing.append(int(fail.numel()))
        f = fail[: args.lanes]
        if not f.numel():
            continue
        _, Ht, _ = osd.sort_and_pack(bp_err[f], logp[f])
        s = syn[f].to(torch.int32).contiguous()
        Hp, sp_, piv, _, (trips, row_xors, words) = gf2.gf2_eliminate(Ht, s, n, return_work=True)
        Hc, sc, pc = gf2_eliminate_cuda(Ht, s, n)
        if not (torch.equal(Hp, Hc) and torch.equal(sp_, sc) and torch.equal(piv, pc)):
            print("K2 differs from the plain elimination", file=sys.stderr)
            return 1
        for key, v in (("trips", trips), ("row_xors", row_xors), ("words", words),
                       ("ops", trips * m * 2 + words)):
            per_lane[key] += v.tolist()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(args.reps):
            start.record()
            gf2_eliminate_cuda(Ht, s, n)
            end.record()
            torch.cuda.synchronize()
            k2_s_per_lane.append(start.elapsed_time(end) * 1e-3 / f.numel())

    W = -(-n // 32)
    nbytes, ops_now, least = gf2_elim_lane(W, m)
    ops = statistics.fmean(per_lane["ops"])
    out = {
        "workload": args.workload, "seed": args.seed, "W": W, "m": m, "failing": failing,
        "lanes_counted": len(per_lane["ops"]),
        **{f"{k}_per_lane": {"mean": statistics.fmean(v), "min": min(v), "max": max(v)}
           for k, v in per_lane.items()},
        "ops_s_per_lane": ops / PEAK_I32_OPS_PER_S,
        "bytes_per_lane": nbytes, "bytes_s_per_lane": nbytes / 3.35e12,
        "work_osd_ops_per_lane": ops_now, "work_osd_least_s": least,
        "k2_s_per_lane": k2_s_per_lane, "k2_s_per_lane_median": statistics.median(k2_s_per_lane),
        "device": torch.cuda.get_device_name(dev),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
