#!/usr/bin/env python3
"""Time the command line's ``bench`` against the same decode through the API.

    python3 tools/cli_bench_compare.py [--turns 2]

BP+OSD-0 on the (1000, 10, 9) code at per 0.2, B=1024, 100 iterations (the
``bench`` of ``chip_smoke.py`` path (ai), where every lane runs all 100 BP
iterations and OSD-0), on ``cuda:0``, in turns in one fresh process: the
command line's ``bench`` (its JSON median, min and max of 5 reps), then one
decoder's ``batch_decode_detailed`` and ``batch_decode`` from and to numpy,
``batch_decode_async`` on card tensors and its BP stage alone.  Each API
line gives the median, min and max of 5 calls, each behind
``torch.cuda.synchronize()``, after a warm-up.

Needs a CUDA card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=2)
    a = ap.parse_args()

    import torch

    import chip_smoke
    import ldpcdecoders_tpu_torch as pt
    from ldpcdecoders_tpu_torch import _build, cli

    if not torch.cuda.is_available():
        print("cli_bench_compare: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build_library()
    print(chip_smoke.card_line())
    dev = torch.device("cuda:0")
    H = pt.parity_check_matrix(1000, 10, 9, rng=42)
    errs = np.random.default_rng(0).random((1024, 1000)) < 0.2
    syn = ((errs.astype(np.float32) @ H.T.astype(np.float32)) % 2).astype(np.uint8)
    d = torch.as_tensor(syn, device=dev)
    dec = pt.BeliefPropagationOSDDecoder(H, 0.2, 100, device=dev)

    def ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        return f"median {times[len(times) // 2]:.3f}, min {times[0]:.3f}, max {times[-1]:.3f}"

    argv = ["bench", "--code", "gallager:1000,10,9", "--batch", "1024", "--decoder", "bposd",
            "--per", "0.2"]
    for turn in range(a.turns):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        b = json.loads(buf.getvalue())
        print(f"turn {turn}: cli bench median {b['time_median_ms']}, min {b['time_min_ms']}, "
              f"max {b['time_max_ms']} ms")
        print(f"turn {turn}: batch_decode_detailed (numpy) {ms(lambda: dec.batch_decode_detailed(syn))} ms")
        print(f"turn {turn}: batch_decode (numpy) {ms(lambda: dec.batch_decode(syn))} ms")
        print(f"turn {turn}: batch_decode_async (card) {ms(lambda: dec.batch_decode_async(d))} ms")
        print(f"turn {turn}: BP alone (card) {ms(lambda: dec.bp(d, dec.bp.as_prior(0.2)))} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
