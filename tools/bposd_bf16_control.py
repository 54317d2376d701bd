#!/usr/bin/env python3
"""The BP+OSD cell's plain reference with its inner min-sum in bfloat16,
against the same reference in float32: the lower-precision reading that the
cell's limits (``differ`` 0, ``inconsistent`` 0) are set against.

    python3 tools/bposd_bf16_control.py --seed 5 [--rows 384]
        [--workload bb144_r6_bposd.p003]

Draws one batch of the cell's traffic from ``--seed`` (``portbench``'s pool),
samples ``--rows`` of its records, and decodes them twice with the
configuration's stated settings through ``portbench/reference/bposd.py``:
as the harness's check runs it, and with its inner min-sum in bfloat16
(``inner_dtype``).  ``differ`` counts the records whose
estimate, converged flag or iterations differ between the two;
``inconsistent`` the bfloat16 estimates that miss their record.

The harness's ``--control`` cannot run this: it swaps the configuration's
``control`` keywords into the program's decoder, and the port's BP+OSD
takes no dtype for its inner decoder, so that configuration's control is
``osd_order`` 0 (OSD-0), another decoder rather than a lower precision.

One JSON line goes to standard output.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BLOCK = 512  # records a reference call takes, as the harness's check


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="bb144_r6_bposd.p003")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rows", type=int, default=384)
    args = ap.parse_args(argv)

    from portbench import inputs, spec
    from portbench.reference import bposd

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.resolve(args.workload)
    code = inputs.load_code(cell.config, cell.bench_dir)
    channel = inputs.load_channel(cell.traffic, code, cell.bench_dir)
    s = cell.config["stated"]
    B = int(cell.traffic["batch"])
    pool = inputs.draw_pool(code, channel, B, 1, args.seed, dev)
    rows = np.sort(np.random.default_rng(args.seed).choice(B, args.rows, replace=False))
    syn = pool[0][rows]

    def decode(dtype):
        out = {k: [] for k in ("err", "converged", "iters")}
        for lo in range(0, args.rows, BLOCK):
            r = bposd.decode_stated(code.M, channel.priors, s, syn[lo:lo + BLOCK], dev,
                                    inner_dtype=dtype)
            for k in out:
                out[k].append(r[k])
        return {k: np.concatenate(v) for k, v in out.items()}

    t = time.perf_counter()
    ref = decode(torch.float32)
    ref_s = time.perf_counter() - t
    low = decode(torch.bfloat16)

    same_err = (low["err"] == ref["err"]).all(axis=1)
    same = same_err & (low["converged"] == ref["converged"]) & (low["iters"] == ref["iters"])
    Mt = code.M.T.toarray().astype(np.int64)
    inconsistent = int(((low["err"].astype(np.int64) @ Mt) % 2 != syn).any(axis=1).sum())
    print(json.dumps({"workload": args.workload, "seed": args.seed, "rows": args.rows,
                      "differ": int((~same).sum()), "differ_estimate": int((~same_err).sum()),
                      "inconsistent": inconsistent,
                      "failing_float32": int((~ref["converged"]).sum()),
                      "failing_bfloat16": int((~low["converged"]).sum()),
                      "reference_s": ref_s, "device": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
