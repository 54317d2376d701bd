#!/usr/bin/env python3
"""Time the port's whole-decode QC kernel (K5) against other revisions'.

    python3 tools/qc_kernel_compare.py [--scaling] OTHER/qc_minsum.cu [MORE/qc_minsum.cu ...]

Each ``OTHER/qc_minsum.cu`` is a revision of ``ldpcdecoders_tpu_torch/csrc/
qc_minsum.cu``, for example from ``git show REV:ldpcdecoders_tpu_torch/csrc/
qc_minsum.cu``, with either launcher interface: the first one
(``ldpc_qc_minsum(..., Eb, max_rw, max_iters, threads, ...)``, shared memory
as that revision sized it) or the tree's (``..., max_rw, buf_rw, max_iters,
...``; shared memory from the revision's own ``ldpc_qc_smem_bytes`` where it
exports one, else as the layout of commits 4afb3dd-1bbb21c sized it).  Each
is built with nvcc beside itself.  The cases are ``chip_smoke.py``'s on the
same inputs: path (j)'s code (the (6, 3)-regular nb=24 base matrix at Z=128,
per 0.04, B=1024) layered float32 / bfloat16, with per-lane priors, flooding
(the decoder's default) float32 / bfloat16 / with per-lane priors, flooding
sum-product, and path (k)'s bb144 six-round space-time lift (B=2048) layered
and flooding.  Per case every revision runs on the same tensors on
``cuda:0``, in the order others, tree, tree, others reversed; the four
outputs must be bitwise equal to the tree's, and a line gives each time
(CUDA events behind a spin kernel, mean of 5 launches after a warm-up) and
each revision's time over the tree's.  ``--scaling`` first times flooding
float32 with every lane sweeping all 32 sweeps at 1 to 16 lanes an SM: a
sweep's latency alone and its throughput when lanes share an SM.

Needs a CUDA card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import ldpcdecoders_tpu_torch as pt  # noqa: E402
from ldpcdecoders_tpu_torch import _build  # noqa: E402
from ldpcdecoders_tpu_torch.models.priors import per_to_llr  # noqa: E402
from ldpcdecoders_tpu_torch.ops import cuda_qc  # noqa: E402
from ldpcdecoders_tpu_torch.ops.qc_minsum import (  # noqa: E402
    HELD_EDGES, SMEM_LIMIT, qc_launch_shape)


def build_other(src: Path):
    """The library of another revision and whether it takes ``buf_rw``."""
    so = src.with_suffix(".so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-shared", "-o", str(so), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise SystemExit(f"nvcc failed: {' '.join(cmd)}\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    buf = "int buf_rw" in src.read_text()
    lib.ldpc_qc_minsum.argtypes = ([ptr] * 7 + [i32] * (13 if buf else 12) + [f32] * 3
                                   + [i64, i32, ptr])
    if hasattr(lib, "ldpc_qc_smem_bytes"):
        lib.ldpc_qc_smem_bytes.argtypes = [i32] * 12
        lib.ldpc_qc_smem_bytes.restype = i64
    return lib, buf


def first_smem_bytes(t, threads, itemsize, layered, sumprod):
    """Shared memory as a revision with the first interface sized it (the
    kernel of commit 343829d: a row buffer of the largest row weight and a
    flag word)."""
    Z, rw = t.Z, t.max_row_weight
    ints = 4 * t.Eb + t.mb + t.nb + 3
    floats = (rw * Z if layered else 0) + (rw * threads if sumprod else 0)
    stored = (t.Eb + (t.nb if layered else t.Eb)) * Z
    return 4 * ints + 4 * floats + itemsize * stored + (t.mb + (0 if layered else t.nb)) * Z


def messages_smem_bytes(t, threads, itemsize, layered, sumprod):
    """Shared memory as the revisions of commits 4afb3dd-1bbb21c sized it
    (flooding with both message directions and a decision byte per
    variable position)."""
    Z = t.Z
    ints = 5 * t.Eb + 2 * t.mb + t.nb + 4
    tail = max(t.max_row_weight - HELD_EDGES, 0)
    floats = (t.buffered_row_weight * Z if layered else 0) + (tail * threads if sumprod else 0)
    stored = (t.Eb + (t.nb if layered else t.Eb)) * Z
    return 4 * ints + 4 * floats + itemsize * stored + (t.mb + (0 if layered else t.nb)) * Z


def launch_other(lib, buf, syn, t, table, dec, priors):
    """``qc_minsum_cuda``'s launch through another revision's library."""
    layered, sumprod = dec.schedule == "layered", dec.algorithm == "sumproduct"
    size = 4 if dec.dtype == torch.float32 else 2
    threads, _ = qc_launch_shape(t, size, layered, sumprod)
    if not hasattr(lib, "ldpc_qc_smem_bytes"):
        threads = min(t.Z, 1024)  # one thread a position: the older layouts' launch
    if not buf:
        smem = first_smem_bytes(t, threads, size, layered, sumprod)
    elif hasattr(lib, "ldpc_qc_smem_bytes"):
        sizes = (t.l, t.m, t.mb, t.nb, t.Eb, t.max_row_weight, t.buffered_row_weight, threads,
                 size, int(layered), int(sumprod))
        smem = lib.ldpc_qc_smem_bytes(*sizes, 0)
        with_prior = lib.ldpc_qc_smem_bytes(*sizes, 1)
        if priors is not None and not layered and with_prior <= SMEM_LIMIT:
            smem = with_prior
    else:
        smem = messages_smem_bytes(t, threads, size, layered, sumprod)
    B, n = syn.shape[0], t.nb * t.Z
    err = torch.empty((B, n), dtype=torch.int8, device=syn.device)
    llr = torch.empty((B, n), dtype=torch.float32, device=syn.device)
    conv = torch.empty((B,), dtype=torch.bool, device=syn.device)
    iters = torch.empty((B,), dtype=torch.int32, device=syn.device)
    sizes = [t.Eb, t.max_row_weight] + ([t.buffered_row_weight] if buf else [])
    rc = lib.ldpc_qc_minsum(
        syn.data_ptr(), None if priors is None else priors.data_ptr(), table.data_ptr(),
        err.data_ptr(), llr.data_ptr(), conv.data_ptr(), iters.data_ptr(), B, t.l, t.m, t.mb,
        t.nb, *sizes, dec.max_iters, threads, int(layered), int(sumprod),
        int(dec.dtype == torch.bfloat16), dec.alpha, dec.beta, dec.L0,
        0 if priors is None or priors.ndim == 1 else n, smem,
        torch.cuda.current_stream(syn.device).cuda_stream)
    if rc != 0:
        raise SystemExit(f"the other revision's launch failed: {rc}")
    return err, conv, iters, llr


def event_ms(fn, reps=5):
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
    """chip_smoke.py's K5 cases: (label, decoder, syndromes, priors)."""
    base = pt.random_qc_base_matrix(24, 6, 3, 128, rng=7)
    Hq = pt.qc_lift(base, 128)
    rng = np.random.default_rng(0)
    errs = rng.random((1024, Hq.shape[1])) < 0.04
    syn = (errs.astype(np.float32) @ Hq.T.astype(np.float32)) % 2
    erased = rng.random(errs.shape) < 0.08
    errs_e = np.where(erased, rng.random(errs.shape) < 0.5, errs)
    syn_e = (errs_e.astype(np.float32) @ Hq.T.astype(np.float32)) % 2
    pri_e = torch.as_tensor(per_to_llr(np.where(erased, 0.5, 0.04), Hq.shape[1]),
                            dtype=torch.float32, device=dev)

    def qc(**kw):
        return pt.QCMinSumDecoder(base, 128, 0.04, 32, device=dev, **kw)

    st = pt.SpaceTimeDecoder.for_bicycle("bb144", "x", 6, 0.003, 60, device=dev)
    st_flood = pt.SpaceTimeDecoder.for_bicycle("bb144", "x", 6, 0.003, 60, schedule="flooding",
                                               device=dev)
    rng_st = np.random.default_rng(9)
    st_x = (rng_st.random((2048, st.n_cols)) < st._prior[None, :]).astype(np.uint8)
    st_det = (st.A.astype(np.int32) @ st_x.T.astype(np.int32)).T % 2
    st_pri = torch.as_tensor(per_to_llr(st._prior, st.n_cols), dtype=torch.float32, device=dev)

    def as_dev(a):
        # the kernels read [B, mb*Z] bytes in row order (the detector records
        # come out of numpy transposed)
        return (torch.as_tensor(np.asarray(a, np.uint8), device=dev) != 0).contiguous()

    return [
        ("layered f32", qc(schedule="layered"), as_dev(syn), None),
        ("flooding f32", qc(), as_dev(syn), None),
        ("layered bf16", qc(schedule="layered", dtype=torch.bfloat16), as_dev(syn), None),
        ("layered f32 per-lane priors", qc(schedule="layered"), as_dev(syn_e), pri_e),
        ("flooding f32 sumproduct", qc(algorithm="sumproduct"), as_dev(syn), None),
        ("bb144 R=6 layered f32 prior vector", st.inner, as_dev(st_det), st_pri),
        ("flooding bf16", qc(dtype=torch.bfloat16), as_dev(syn), None),
        ("flooding f32 per-lane priors", qc(), as_dev(syn_e), pri_e),
        ("bb144 R=6 flooding f32 prior vector", st_flood.inner, as_dev(st_det), st_pri),
    ]


def scaling(dev, others):
    """Flooding float32 at path (j)'s code on random syndromes that no lane
    meets in 32 sweeps (every lane sweeps all 32), at 1, 2, 4, 6, 8 and 16
    lanes an SM: the time a sweep takes with that many lanes on each SM, and
    lane-sweeps per microsecond, for the tree and each other revision in
    turns."""
    base = pt.random_qc_base_matrix(24, 6, 3, 128, rng=7)
    dec = pt.QCMinSumDecoder(base, 128, 0.04, 32, device=dev)
    t = dec.qc_terms
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(1)
    for per_sm in (1, 2, 4, 6, 8, 16):
        B = per_sm * sms
        syn = (torch.as_tensor(rng.random((B, t.mb * t.Z)) < 0.5, device=dev)).contiguous()
        tree = lambda: cuda_qc.qc_minsum_cuda(syn, t, dec.table, dec.L0, 32)  # noqa: E731
        sweeps = float(tree()[2].float().mean())
        runs = [(name, lambda lib=lib, buf=buf: launch_other(lib, buf, syn, t, dec.table, dec,
                                                             None))
                for name, lib, buf in others]
        before = [event_ms(fn) for _, fn in runs]
        mine = (event_ms(tree) + event_ms(tree)) / 2
        after = [event_ms(fn) for _, fn in reversed(runs)][::-1]

        def line(name, ms):
            return (f"{name} {ms:.4f} ms, {1000 * ms / 32:.2f} us a sweep, "
                    f"{B * sweeps / ms / 1000:.2f} lane-sweeps/us")
        print(f"scaling flooding f32, {per_sm} lanes an SM (B={B}, mean sweeps {sweeps:.2f}): "
              + " | ".join([line("tree", mine)] + [line(name, (b + a) / 2) for (name, _, _), b, a
                                                   in zip(others, before, after)]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", type=Path, nargs="*")
    ap.add_argument("--scaling", action="store_true",
                    help="also time flooding float32 at 1-16 lanes an SM, every lane sweeping "
                         "all 32 sweeps")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    others = [(str(p), *build_other(p)) for p in args.others]
    dev = torch.device("cuda:0")
    if args.scaling:
        scaling(dev, others)
    for label, dec, syn, priors in cases(dev):
        t = dec.qc_terms
        tree = lambda: cuda_qc.qc_minsum_cuda(  # noqa: E731
            syn, t, dec.table, dec.L0, dec.max_iters, alpha=dec.alpha, beta=dec.beta,
            schedule=dec.schedule, algorithm=dec.algorithm, dtype=dec.dtype, priors=priors)
        runs = [(name, lambda lib=lib, buf=buf: launch_other(lib, buf, syn, t, dec.table, dec,
                                                             priors))
                for name, lib, buf in others]
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
