#!/usr/bin/env python3
"""Time the port's two GF(2) elimination kernels against another revision's.

    python3 tools/gf2_kernel_compare.py OTHER/gf2_elim.cu [--lanes 264]

``OTHER/gf2_elim.cu`` is a revision of ``ldpcdecoders_tpu_torch/csrc/
gf2_elim.cu`` with the column-by-column interface
(``ldpc_gf2_eliminate(ht, s, ht_out, s_out, piv, B, W, m, n, stream)``,
``ldpc_gf2_osd0(ht, resid, bp, corr, B, W, m, n, stream)``), for example
from ``git show REV:ldpcdecoders_tpu_torch/csrc/gf2_elim.cu``.  It is built
with nvcc beside itself.  For each shape below, on random systems of density
0.01 made on the card from a seed, both revisions run on the same tensors
on ``cuda:0`` in the order other, tree, tree, other; the outputs must be
bitwise equal, and a line gives the plan the tree's launcher takes and the four times
(CUDA events, mean of 3 launches after a warm-up).  The shapes are those
the tree's second kernel body serves (more than 1024 rows; a table of 16 or
4 rows; no table), and the main path's with the panel capped.

Needs a CUDA card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from ldpcdecoders_tpu_torch import _build  # noqa: E402
from ldpcdecoders_tpu_torch.ops import cuda_gf2  # noqa: E402

# (rows, columns, cap on the panel width, lanes or None for --lanes)
SHAPES = [
    (900, 1000, 8, 1024),  # the main path's lane: pipelined kernel, P = 8
    (900, 1000, 1, 1024),  # the same lane without a table
    (1100, 1300, 8, None),  # more than 1024 rows, P = 8
    (1400, 1120, 8, None),  # room for a table of 16 rows: P = 4
    (1013, 1728, 8, None),  # room for a table of 4 rows: P = 2
    (893, 1984, 8, None),  # no room for a table: P = 1
    (461, 3936, 8, None),  # OSD-0: the bare lane (no padding), P = 1
]


def build_other(src: Path) -> ctypes.CDLL:
    so = src.with_suffix(".so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-shared", "-o", str(so), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise SystemExit(f"nvcc failed: {' '.join(cmd)}\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ldpc_gf2_eliminate.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.ldpc_gf2_osd0.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    return lib


def event_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def inputs(B, m, n, W, dev):
    """Packed transposed systems ``Ht [B, W, m]``, syndromes, a residual
    inside the row space (OSD-0 stops where its support is covered) and BP
    hard decisions, all int32, made on ``dev`` from a seed."""
    gen = torch.Generator(device=dev).manual_seed(m + n)
    H = torch.rand((B, m, W * 32), device=dev, generator=gen) < 0.01
    H[:, :, n:] = False
    shifts = torch.arange(32, device=dev)
    words = (H.view(B, m, W, 32).to(torch.int64) << shifts).sum(dim=3)  # < 2**32
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    Ht = words.transpose(1, 2).contiguous()
    s = (torch.rand((B, m), device=dev, generator=gen) < 0.5).to(torch.int32)
    e = torch.rand((B, W * 32), device=dev, generator=gen) < 0.05
    resid = ((H & e[:, None, :]).sum(dim=2) & 1).to(torch.int32)
    bp = (torch.rand((B, n), device=dev, generator=gen) < 0.2).to(torch.int32)
    return Ht, s, resid, bp


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--lanes", type=int, default=264)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    other = build_other(args.other)
    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for m, n, cap, lanes in SHAPES:
        B, W = lanes or args.lanes, (n + 31) // 32
        Ht, s, resid, bp = inputs(B, m, n, W, dev)

        def other_elim():
            Ht2, s2, piv = torch.empty_like(Ht), torch.empty_like(s), torch.empty_like(s)
            rc = other.ldpc_gf2_eliminate(Ht.data_ptr(), s.data_ptr(), Ht2.data_ptr(),
                                          s2.data_ptr(), piv.data_ptr(), B, W, m, n, stream)
            assert rc == 0, rc
            return Ht2, s2, piv

        def other_osd0():
            corr = torch.empty_like(bp)
            rc = other.ldpc_gf2_osd0(Ht.data_ptr(), resid.data_ptr(), bp.data_ptr(),
                                     corr.data_ptr(), B, W, m, n, stream)
            assert rc == 0, rc
            return (corr,)

        for what, osd0, old, new in (
            ("gf2_eliminate", False, other_elim,
             lambda: cuda_gf2.gf2_eliminate_cuda(Ht, s, n, _max_panel=cap)),
            ("gf2_osd0", True, other_osd0,
             lambda: (cuda_gf2.gf2_osd0_cuda(Ht, resid, bp, n, _max_panel=cap),)),
        ):
            plan = cuda_gf2.launcher_plan(W, m, osd0=osd0, panel=cap)
            kernel = "pipelined" if plan.panel > 1 and m <= 1024 else "panel"
            t = [event_ms(f) for f in (old, new, new, old)]
            same = all(torch.equal(a, b) for a, b in zip(t[0][1], t[1][1]))
            print(f"{what} m={m} n={n} W={W} B={B}: {kernel} kernel, P={plan.panel}, "
                  f"{'padded' if plan.pad else 'bare'}, {plan.bytes} B | other {t[0][0]:.3f} ms, "
                  f"tree {t[1][0]:.3f} ms, tree {t[2][0]:.3f} ms, other {t[3][0]:.3f} ms | "
                  f"tree / other {(t[1][0] + t[2][0]) / (t[0][0] + t[3][0]):.3f} | "
                  f"bitwise equal: {same}")
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
