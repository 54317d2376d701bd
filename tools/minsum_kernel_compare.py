#!/usr/bin/env python3
"""Time the port's min-sum kernels (K3, K4) against other revisions'.

    python3 tools/minsum_kernel_compare.py OTHER/minsum.cu [MORE/minsum.cu ...]

Each ``OTHER/minsum.cu`` is a revision of ``ldpcdecoders_tpu_torch/csrc/
minsum.cu`` with the tree's launcher interface (``ldpc_minsum_check``,
``ldpc_minsum_var``), for example from ``git show REV:ldpcdecoders_tpu_torch/
csrc/minsum.cu``.  Each is built with nvcc beside itself, and its ptxas
register counts are printed.  The cases are ``chip_smoke.py``'s shapes: the
(1000, 10, 9) Gallager code at B=1024 (K4 with the leave-one-out messages,
K3 gathered) and the bb144 R=6 p=0.003 DEM in the check layout (K4 totals
only, K3 direct) at a float32 stage-0 batch of 2048 and a bfloat16 deep
bucket of 6 x 256, with the DEM's K4 also with its messages (the variable
layout's form).  The messages are seeded random numbers.  Per case every
revision runs on the same tensors on ``cuda:0``, in the order others, tree,
tree, others reversed; the outputs must be bitwise equal to the tree's, and a
line gives each time (CUDA events behind a spin kernel, mean of 10 launches
after a warm-up) and each revision's time over the tree's.

Needs a CUDA card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import ldpcdecoders_tpu_torch as pt  # noqa: E402
from ldpcdecoders_tpu_torch import _build  # noqa: E402
from ldpcdecoders_tpu_torch.ops import cuda_minsum  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def build_other(src: Path):
    """Another revision's library, and its ptxas register lines."""
    so = src.with_suffix(".so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise SystemExit(f"nvcc failed: {' '.join(cmd)}\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.ldpc_minsum_check.argtypes = [ptr] * 5 + [i32] * 3 + [i64] + [f32] * 3 + [i32, ptr]
    lib.ldpc_minsum_var.argtypes = [ptr] * 7 + [i32] * 3 + [i64, i32, ptr]
    return lib, registers(done.stdout + done.stderr)


def registers(ptxas: str) -> str:
    """``kernel: N registers`` for each min-sum kernel of a ptxas -v log."""
    found, name = [], None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "minsum" in name:
            kind = ("var" if "var" in name else "check") + ("/bf16" if "bf16" in name or
                                                              "13__nv_bfloat16" in name else "")
            found.append(f"{kind} {m.group(1)}")
            name = None
    return ", ".join(found)


def launch_var(lib, mu, v2c, mask, L0, want_nu):
    B, (dv, n) = mu.shape[0], mask.shape
    nu = torch.empty((B, dv, n), dtype=mu.dtype, device=mu.device) if want_nu else None
    total = torch.empty((B, n), dtype=mu.dtype, device=mu.device)
    rc = lib.ldpc_minsum_var(mu.data_ptr(), v2c.data_ptr(), mask.data_ptr(), L0.data_ptr(),
                             None, None if nu is None else nu.data_ptr(), total.data_ptr(), B,
                             n, dv, mu.shape[1], int(mu.dtype == torch.bfloat16),
                             torch.cuda.current_stream(mu.device).cuda_stream)
    if rc != 0:
        raise SystemExit(f"the other revision's K4 launch failed: {rc}")
    return (total,) if nu is None else (nu, total)


def launch_check(lib, x, idx, flip, mask, alpha):
    B, (dc, m) = x.shape[0], mask.shape
    mu = torch.empty((B, dc, m), dtype=x.dtype, device=x.device)
    rc = lib.ldpc_minsum_check(x.data_ptr(), None if idx is None else idx.data_ptr(),
                               flip.data_ptr(), mask.data_ptr(), mu.data_ptr(), B, m, dc,
                               x.numel() // B, float(alpha), 0.0,
                               cuda_minsum._BIG[x.dtype], int(x.dtype == torch.bfloat16),
                               torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise SystemExit(f"the other revision's K3 launch failed: {rc}")
    return (mu,)


def event_ms(fn, reps=10):
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


def cases(dev):
    """(label, tree's call, another library's call) on fixed tensors."""
    import scipy.sparse as sp

    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    gal = pt.TannerGraph.from_pcm(pt.parity_check_matrix(1000, 10, 9, rng=42))
    z = np.load(ROOT / "benchmarks/results/bb144_r6_p0.003.npz")
    dem = pt.TannerGraph.from_pcm(np.asarray(sp.csr_matrix(
        (z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"])).todense()))
    for tag, graph, B, dtype, layout in (
            ("Gallager B=1024 f32", gal, 1024, torch.float32, "var"),
            ("Gallager B=1024 bf16", gal, 1024, torch.bfloat16, "var"),
            ("bb144 DEM f32 stage-0 batch", dem, 2048, torch.float32, "check"),
            ("bb144 DEM bf16 deep bucket", dem, 1536, torch.bfloat16, "check")):
        ms = pt.MinSumDecode(graph, 0.01, 2, device=dev, dtype=dtype, layout=layout)
        dc, m, dv, n = graph.max_dc, graph.m, graph.max_dv, graph.n
        mu = torch.randn((B, dc * m), generator=gen, device=dev).to(dtype)
        L0 = (torch.rand((B, n), generator=gen, device=dev) * 8).to(dtype)
        flip = torch.rand((B, m), generator=gen, device=dev) < 0.1
        for want_nu in ((True,) if layout == "var" else (False, True)):
            out.append((f"K4 {tag}" + (" with nu" if want_nu else " totals"),
                        lambda mu=mu, ms=ms, L0=L0, w=want_nu: tuple(
                            t for t in cuda_minsum.minsum_var_cuda(mu, ms.v2c, ms.var_mask, L0,
                                                                   want_nu=w) if t is not None),
                        lambda lib, mu=mu, ms=ms, L0=L0, w=want_nu: launch_var(
                            lib, mu, ms.v2c, ms.var_mask, L0, w)))
        if layout == "var":  # gathered through the check-to-variable table
            x = torch.randn((B, dv * n), generator=gen, device=dev).to(dtype)
            idx = ms.c2v
        else:  # direct reads of the check-slot state
            x = torch.randn((B, dc, m), generator=gen, device=dev).to(dtype)
            idx = None
        out.append((f"K3 {tag}",
                    lambda x=x, idx=idx, flip=flip, ms=ms: (cuda_minsum.minsum_check_cuda(
                        x, idx, flip, ms.chk_mask, ms.alpha, 0.0),),
                    lambda lib, x=x, idx=idx, flip=flip, ms=ms: launch_check(
                        lib, x, idx, flip, ms.chk_mask, ms.alpha)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", type=Path, nargs="+")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    _, _, tree_log = _build.build_library()
    print(f"tree: registers {registers(tree_log) or 'not in the log (a cached build)'}")
    others = [(str(p), *build_other(p)) for p in args.others]
    for name, _, regs in others:
        print(f"{name}: registers {regs}")
    dev = torch.device("cuda:0")
    for label, tree, other in cases(dev):
        runs = [(name, lambda lib=lib: other(lib)) for name, lib, _ in others]
        want = tree()
        same = [all(torch.equal(a, b) for a, b in zip(fn(), want)) for _, fn in runs]
        before = [event_ms(fn) for _, fn in runs]
        mine = [event_ms(tree), event_ms(tree)]
        after = [event_ms(fn) for _, fn in reversed(runs)][::-1]
        tree_ms = sum(mine) / 2
        print(f"{label}: tree {mine[0]:.4f} / {mine[1]:.4f} ms | "
              + " | ".join(f"{name} {b:.4f} / {a:.4f} ms ({(a + b) / 2 / tree_ms:.3f}x the "
                           f"tree's), bitwise equal: {ok}"
                           for (name, _), b, a, ok in zip(runs, before, after, same)))
        if not all(same):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
