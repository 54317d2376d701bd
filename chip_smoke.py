#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ldpcdecoders_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the BP+OSD decode path of the reference benchmark — the (1000, 10, 9)
Gallager code, max_iters 100, batch 1024 — through the public decoder API on
``cuda:0`` and prints, in order:

  1. the card (``nvidia-smi`` name and power limit);
  2. the nvcc build of ``ldpcdecoders_tpu_torch/csrc`` and its seconds;
  3. each CUDA kernel against its plain torch version on the card at the
     main path's shape: bitwise equality and both times;
  4. the main path: BP+OSD-0 at per 0.01 and 0.2 and BP+OSD-2 at per 0.01,
     every output syndrome-consistent, the kernels' launch counts from
     that run, and the card's BP against the CPU's on 64 lanes;
  5. steady-state rates;
  6. a JSON line with each kernel's numbers, the card line again, and last
     ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line.  It needs a CUDA device and the package beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

B = 1024
MAX_ITERS = 100
DEVICE = "cuda:0"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def syndromes(H, per, rng):
    errs = rng.random((B, H.shape[1])) < per
    # float32 products of 0/1 matrices are exact here (sums <= n)
    return errs, ((errs.astype(np.float32) @ H.T.astype(np.float32)) % 2).astype(np.uint8)


def assert_consistent(H, guesses, syns, what):
    if guesses.shape != (syns.shape[0], H.shape[1]) or guesses.dtype != np.int8:
        raise AssertionError(f"{what}: guesses {guesses.shape} {guesses.dtype}")
    synhat = (guesses.astype(np.float32) @ H.T.astype(np.float32)) % 2
    bad = int((synhat != syns).any(axis=1).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} of {syns.shape[0]} outputs miss their syndrome")


def event_ms(torch, fn, reps):
    """Mean milliseconds per call on the current stream, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def wall_s(torch, fn, reps):
    """Mean host seconds per call ending in a device synchronization, after
    one warm-up; returns (seconds, last output)."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps, out


def max_abs_err(torch, got, want):
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    import ldpcdecoders_tpu_torch as pt
    from ldpcdecoders_tpu_torch import _build
    from ldpcdecoders_tpu_torch.ops import cuda_gf2

    # float32 products here are 0/1 sums; keep them in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"device: {kind} | torch {torch.__version__} | cuda {torch.version.cuda}")

    # 2. build
    path, build_s, log = _build.build_library()
    print(f"build: nvcc {build_s:.2f} s -> {path.name}")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")

    H = pt.parity_check_matrix(1000, 10, 9, rng=42)
    graph = pt.TannerGraph.from_pcm(H)
    m, n = graph.m, graph.n
    rng = np.random.default_rng(0)
    errs01, syn01 = syndromes(H, 0.01, rng)
    errs20, syn20 = syndromes(H, 0.2, rng)
    _, syn50 = syndromes(H, 0.5, rng)

    # 3. kernels against their plain versions at the main path's shape:
    # the sorted, packed systems of a per-0.2 batch (every lane fails BP)
    dec0 = pt.BeliefPropagationOSDDecoder(graph, 0.01, MAX_ITERS, device=dev)
    s20 = torch.as_tensor(syn20, device=dev)
    bp_err, _, _, logp = dec0.bp(s20, dec0.bp.as_ratio(0.2))
    perm, Ht, bp_sorted = dec0.osd.sort_and_pack(bp_err, logp)
    hb = bp_err.to(torch.float32) @ dec0.osd.H_cols_f
    resid = (s20.to(torch.int32) ^ (hb.to(torch.int32) & 1)).contiguous()
    s_int = s20.to(torch.int32).contiguous()
    print(f"kernel inputs: Ht {tuple(Ht.shape)} int32, lanes with a nonzero residual "
          f"{int((resid != 0).any(dim=1).sum())} of {B}")

    kernels = []
    cases = [
        ("gf2_osd0", "ldpcdecoders_tpu/ops/pallas_gf2.py:93",
         lambda: (cuda_gf2.gf2_osd0_cuda(Ht, resid, bp_sorted, n),),
         lambda: (cuda_gf2.gf2_osd0_ref(Ht, resid, bp_sorted, n),)),
        ("gf2_eliminate", "ldpcdecoders_tpu/ops/pallas_gf2.py:39",
         lambda: cuda_gf2.gf2_eliminate_cuda(Ht, s_int, n),
         lambda: cuda_gf2.gf2_eliminate_ref(Ht, s_int, n)),
    ]
    for name, replaces, kern, plain in cases:
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        ms = event_ms(torch, kern, 10)
        plain_ms = event_ms(torch, plain, 2)
        print(f"kernel {name}: max_abs_err {err} (bitwise required) | kernel {ms:.3f} ms | "
              f"plain torch {plain_ms:.3f} ms | B={B} W={Ht.shape[1]} m={m} n={n} | {card}")
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version")
        kernels.append({"name": name, "route": "cuda",
                        "source": "ldpcdecoders_tpu_torch/csrc/gf2_elim.cu",
                        "replaces": replaces, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms})

    # 4. the main path, through the public API; count kernel launches
    dec2 = pt.BeliefPropagationOSDDecoder(graph, 0.01, MAX_ITERS, osd_order=2, device=dev)
    cuda_gf2.gf2_osd0_cuda.launches = 0
    cuda_gf2.gf2_eliminate_cuda.launches = 0
    g01, c01 = dec0.batch_decode(syn01)
    assert_consistent(H, g01, syn01, "BP+OSD-0 per 0.01")
    print(f"main (a) BP+OSD-0 per 0.01: converged {c01.mean():.4f}, exact recovery "
          f"{(g01.astype(bool) == errs01).all(axis=1).mean():.4f}, all syndrome-consistent")
    before = cuda_gf2.gf2_osd0_cuda.launches
    g20, c20 = dec0.batch_decode(syn20, per=0.2)
    assert_consistent(H, g20, syn20, "BP+OSD-0 per 0.2")
    if cuda_gf2.gf2_osd0_cuda.launches <= before:
        raise AssertionError("BP+OSD-0 at per 0.2 did not launch the OSD-0 kernel")
    print(f"main (b) BP+OSD-0 per 0.2: converged {c20.mean():.4f}, exact recovery "
          f"{(g20.astype(bool) == errs20).all(axis=1).mean():.4f}, all syndrome-consistent")
    g2, c2 = dec2.batch_decode(syn01)
    assert_consistent(H, g2, syn01, "BP+OSD-2 per 0.01")
    print(f"main (c) BP+OSD-2 per 0.01: converged {c2.mean():.4f}, exact recovery "
          f"{(g2.astype(bool) == errs01).all(axis=1).mean():.4f}, all syndrome-consistent")
    launches = {"gf2_osd0": cuda_gf2.gf2_osd0_cuda.launches,
                "gf2_eliminate": cuda_gf2.gf2_eliminate_cuda.launches}
    print(f"main launches: {launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            raise AssertionError(f"the main path never launched {k['name']}")

    # (d) the card's BP against the CPU's on 64 lanes (32 at per 0.01, 32 at
    # per 0.2): err, converged and iters must agree bitwise; logp is
    # compared with rtol 1e-5, atol 1e-6 (log may differ by an ulp)
    lanes = np.concatenate([syn01[:32], syn20[:32]])
    bp_cpu = pt.BeliefPropagationDecoder(graph, 0.01, MAX_ITERS, device="cpu")
    bp_gpu = pt.BeliefPropagationDecoder(graph, 0.01, MAX_ITERS, device=dev)
    e_c, c_c, i_c, a_c, _ = bp_cpu.batch_decode_detailed(lanes)
    e_g, c_g, i_g, a_g, _ = bp_gpu.batch_decode_detailed(lanes)
    same = (np.array_equal(e_c, e_g), np.array_equal(c_c, c_g), np.array_equal(i_c, i_g))
    lp_c, lp_g = a_c["log_probabs"], a_g["log_probabs"]
    finite = np.isfinite(lp_c) & np.isfinite(lp_g)
    print(f"main (d) BP cuda vs cpu, 64 lanes: err/converged/iters equal {same}, "
          f"finite logp max abs diff {np.abs(lp_c[finite] - lp_g[finite]).max():.3e}, "
          f"bitwise share {(lp_c == lp_g).mean():.4f}")
    if not all(same):
        raise AssertionError("BP on the card disagrees with BP on the CPU")
    np.testing.assert_allclose(lp_g, lp_c, rtol=1e-5, atol=1e-6)

    # 5. steady-state rates (host clock around calls that end in a sync)
    tag = f"| B={B} | {card}"
    d01, d20, d50 = (torch.as_tensor(s, device=dev) for s in (syn01, syn20, syn50))
    t, out = wall_s(torch, lambda: bp_gpu.bp(d50), 3)
    iters = int(out[2].max()) or MAX_ITERS
    print(f"rate BP per 0.5: {B * iters * graph.n_edges / t:.4e} edge-iterations/s "
          f"({iters} iterations, {t * 1e3:.1f} ms/batch) {tag}")
    t, _ = wall_s(torch, lambda: dec0.batch_decode_async(d01), 3)
    print(f"rate BP+OSD-0 per 0.01: {B / t:.1f} syndromes/s ({t * 1e3:.1f} ms/batch) {tag}")
    t, _ = wall_s(torch, lambda: dec0.batch_decode_async(d20, per=0.2), 3)
    print(f"rate BP+OSD-0 per 0.2 (every lane through OSD-0): {B / t:.1f} syndromes/s "
          f"({t * 1e3:.1f} ms/batch) {tag}")
    t, _ = wall_s(torch, lambda: dec2.batch_decode_async(d01), 3)
    print(f"rate BP+OSD-2 per 0.01: {B / t:.1f} syndromes/s ({t * 1e3:.1f} ms/batch) {tag}")

    # 6. summary lines; the last line is the result
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
