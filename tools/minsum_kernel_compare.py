#!/usr/bin/env python3
"""Time the port's min-sum kernels (K3, K4) on lane tiles against a parent
revision's source and against other builds of the tree's.

    python3 tools/minsum_kernel_compare.py --parent OTHER/minsum.cu
        [--tiles 128,64] [--variant NAME=VALUE ...] [--out FILE]
    python3 tools/minsum_kernel_compare.py --layout var [--tiles 128,64]
        [--batches 2048,256,48] [--code dem|gallager] [--out FILE]

``--layout var`` times the variable layout instead (no ``--parent``
needed; one is timed lane-major beside the tree where given): at the bb144
R=6 DEM's shape in float32, as the BP+OSD configuration runs it (damping
0.4, the freeze every iteration), K3's gathered form from ``nu`` and K4's
in-place form (leave-one-out messages, the damping mix, the freeze), each
on lane tiles against the tree's own lane-major form in turns, and
``MinSumDecode(layout="var")`` over 24 iterations checked every one; at
the batches of ``--batches`` (by default 2048 lanes, 256, the
configuration's tail of failing lanes, and 48, below the check layout's
smallest tile); ``--code gallager`` the same on the (1000, 10, 9) Gallager
code at per 0.05, whose rows fit in L2 lane-major.  Each
line gives the kernel's bound (bytes at 3.35 TB/s against operations at
67e12/s) and the time per lane-iteration.

``--parent`` takes a ``csrc/minsum.cu`` whose launchers have the tree's
interface, with or without the trailing ``lane_tile`` argument.  With it
(a revision with lane tiles, for example ``git show
3f5b209:ldpcdecoders_tpu_torch/csrc/minsum.cu``) the parent runs through the
tree's wrappers at each tile the tree is timed at; without it (a lane-major
revision, for example ``git show 62e9a51:...``) with ``lane_tile=1``, the
only layout it has.  ``--match REGEX`` keeps the cases whose label it
finds.  The iteration form's lines give its bound of bytes (``mu`` read and
written at the real slots, with damping ``nu`` too, the totals and a
``[B, n]`` gamma read once, the syndrome) and the time per lane-iteration;
the tree's packed bfloat16 check body (``minsum_check_packed_kernel``)
prints its block, registers and blocks an SM (``cuda_minsum.packed_plan``)
for every build.  Each ``--variant NAME=VALUE[,NAME=VALUE]`` builds the tree's source once
more with those ``-D`` definitions (the knobs at the top of
``csrc/minsum.cu``: ``LDPC_MINSUM_FLAT_UNROLL_F32`` / ``_BF16``,
``LDPC_MINSUM_STAGED_UNROLL``, ``LDPC_MINSUM_VAR_CAP``,
``LDPC_MINSUM_PACKED_UNROLL`` / ``_THREADS`` / ``_ASYNC``), timed at the
first tile.  Every build prints its ptxas register counts.

The shapes are ``chip_smoke.py``'s, on the bb144 R=6 p=0.003 DEM in the
check layout: path (p)'s stage-0 batch (float32, 2048 lanes, damping 0.4)
and path (q)'s deep bucket (bfloat16, 6 x 256 lanes, per-variable gammas in
[-0.24, 0.66)), from the state after one iteration from the DEM's priors on
seeded records, and batches that the tile rule sizes down (the (q) relay
legs' buckets of 6 x 32, 6 x 64 and 6 x 128 lanes; below a tile, where the rule keeps
them lane-major: float32 batches of 24 and 48, a bfloat16 batch of 48 with
per-variable gammas); and the (1000, 10, 9) Gallager
code at B=1024 in the variable layout (K3 gathered, K4 damped in place,
lane-major: the parent's forms, which must be unchanged).  The forms: K3's first
iteration (gathered from L0), K3's iteration form (the launcher's choice,
staged or flat, for the lane-major layout), K4's totals, K4's totals with
the freeze (every second lane done), and ``MinSumDecode`` in the staged
decoder's configurations, 24 iterations checked every 8
(``early_exit=False``; per iteration: the call over 24).  Per case every
variant runs on the same inputs on ``cuda:0`` in the order others, tree,
tree, others reversed: the tree's first tile against the parent, the
tree's own lane-major layout and the other tiles; outputs, untiled, must be
bitwise the parent's (the real slots of the messages).  A line gives each
mean time (CUDA events behind a spin kernel, 10 calls after a warm-up; the
decodes 3) and its ratio to the tree's.

Needs a CUDA card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
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
from ldpcdecoders_tpu_torch.ops.minsum import tile_lanes, untile_lanes  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
OUT_DIR = ROOT / "_scratch"
ITERS, CHECK_EVERY = 24, 8


def nvcc_build(src: Path, so: Path, defines=()):
    """Build one min-sum source into ``so``; returns (library, register line)."""
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-shared", "-o",
           str(so), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise SystemExit(f"nvcc failed: {' '.join(cmd)}\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(so)), registers(done.stdout + done.stderr)


def registers(ptxas: str) -> str:
    """``kernel: N registers`` for each min-sum kernel of a ptxas -v log."""
    found, name = [], None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "minsum" in name:
            found.append(f"{demangle(name)} {m.group(1)}")
            name = None
    return ", ".join(found)


def demangle(name: str) -> str:
    kind = ("var" if "var" in name else "check_staged" if "staged" in name
            else "check_packed" if "packed" in name else "check")
    return kind + ("/bf16" if "bfloat16" in name else "") + "<" + ",".join(
        re.findall(r"Li(\d+)E", name)) + ">"


@contextlib.contextmanager
def launching_into(lib, parent: bool):
    """Make ops/cuda_minsum.py's wrappers launch into ``lib``: another build
    of the tree's source, or (``parent``) a source without ``lane_tile``,
    which only lane-major calls may reach."""
    if lib is None:
        yield
        return
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    tile = [] if parent else [i32]
    lib.ldpc_minsum_check.argtypes = ([ptr] * 5 + [i32] * 3 + [i64] + [f32] * 3
                                      + [i32, *tile, i32, ptr])
    lib.ldpc_minsum_check_iter.argtypes = ([ptr] * 7 + [i32, i64] + [i32] * 4 + [f32] * 3
                                           + [i32, *tile, i32, ptr])
    lib.ldpc_minsum_var.argtypes = ([ptr] * 6 + [i32, ptr, i32, i64] + [ptr] * 4 + [i32] * 3
                                    + [i64, *tile, i32, ptr])
    saved = cuda_minsum._launch

    def launch(fn, what, x, *args):
        if parent:
            if args[-1] != 1:
                raise SystemExit(f"{what}: the parent revision has no lane tiles")
            args = args[:-1]
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn)(*args, int(x.dtype == torch.bfloat16), stream)
        if rc != 0:
            raise SystemExit(f"{what} launch into another build failed: {rc}")

    cuda_minsum._launch = launch
    try:
        yield
    finally:
        cuda_minsum._launch = saved


def packed_plans(lib, tiles):
    """The packed bfloat16 check body's block in ``lib`` at the bb144 DEM's
    check degree (294), for each tile: the iteration form with per-variable
    gammas and the gathered form."""
    i32 = ctypes.c_int
    lib.ldpc_minsum_packed_plan.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
    lib.ldpc_minsum_packed_plan.restype = i32
    parts = []
    for T in tiles:
        for form, gamma_kind, what in ((2, 2, "iteration, [B, n] gammas"), (1, 0, "gathered")):
            out = (i32 * 4)()
            rc = lib.ldpc_minsum_packed_plan(294, T, form, gamma_kind, out)
            parts.append(f"packed T={T} {what}: " + (
                f"{out[0]} threads, {out[1]} B shared, {out[2]} registers, {out[3]} blocks an SM"
                if rc == 0 else f"plan failed ({rc})"))
    return "; ".join(parts)


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


class Setting:
    """One shape: a check-layout decode module, its inputs, and the state
    after one iteration from the priors (mu, the totals, nu), lane-major."""

    def __init__(self, label, graph, B, dtype, gamma, flip, L0, dev):
        self.label, self.graph, self.B, self.dtype = label, graph, B, dtype
        per_var = gamma is not None
        self.kw = (dict(lane_damping=True, track_best=True) if per_var else dict(damping=0.4))
        self.ms = pt.MinSumDecode(graph, 0.01, 2, device=dev, dtype=dtype, layout="check",
                                  **self.kw)
        ms = self.ms
        self.gamma = gamma if per_var else ms.gam
        self.flip, self.L0 = flip, L0
        self.dc, self.m, self.n = graph.max_dc, graph.m, graph.n
        self.nu0 = L0.index_select(1, ms.chk_varidx).reshape(B, self.dc, self.m)
        self.mu0 = cuda_minsum.minsum_check_cuda(L0, ms.chk_varidx, flip, ms.chk_mask, ms.alpha,
                                                 0.0, chk_deg=ms.chk_deg)
        self.total0 = cuda_minsum.minsum_var_iter_cuda(
            self.mu0.reshape(B, -1), ms.v2c, ms.var_mask, L0, total=torch.empty_like(L0),
            var_deg=ms.var_deg)
        self.done = torch.arange(B, device=dev) % 2 == 1
        self.real = ms.chk_mask.reshape(-1)

    def tiled(self, T, t):
        return t if t.ndim == 0 else tile_lanes(t, T)


def forms(s: Setting):
    """(label, make(T)) of the kernel forms at one setting: ``make(T)``
    returns a call on fresh copies of the state it updates in place (the
    timing repeats one call, whose work does not depend on the values),
    whose results are tensors in the layout of tile T."""
    ms = s.ms

    def k3_first(T):
        L0, flip = s.tiled(T, s.L0), s.tiled(T, s.flip)
        return lambda: (cuda_minsum.minsum_check_cuda(L0, ms.chk_varidx, flip, ms.chk_mask,
                                                      ms.alpha, 0.0, chk_deg=ms.chk_deg,
                                                      lane_tile=T),)

    def k3(T):
        mu, nu = s.tiled(T, s.mu0.clone()), s.tiled(T, s.nu0.clone())
        total, flip, gam = (s.tiled(T, t) for t in (s.total0, s.flip, s.gamma))
        return lambda: (cuda_minsum.minsum_check_iter_cuda(
            mu, total, ms.chk_varidx, flip, ms.chk_mask, ms.alpha, 0.0, gamma=gam, nu=nu,
            chk_deg=ms.chk_deg, lane_tile=T), nu)

    def k4(T, freeze):
        mu, L0 = s.tiled(T, s.mu0).reshape(-1, s.dc * s.m, *((T,) if T > 1 else ())), \
            s.tiled(T, s.L0)
        total = torch.empty_like(L0)
        kw = {}
        if freeze:
            kw = dict(done=tile_lanes(s.done, T, True),
                      err=s.tiled(T, torch.zeros((s.B, s.n), device=L0.device)),
                      llrs=L0.clone())
        return lambda: (cuda_minsum.minsum_var_iter_cuda(
            mu, ms.v2c, ms.var_mask, L0, total=total, var_deg=ms.var_deg, lane_tile=T,
            **kw), *kw.values())

    return [("K3 first iteration (gathered from L0)", k3_first),
            ("K3 iteration form", k3, k3_bound(s)),
            ("K4 totals", lambda T: k4(T, False)),
            ("K4 totals and freeze", lambda T: k4(T, True))]


def k3_bound(s: Setting):
    """(note, lane-iterations) of K3's iteration form at ``s``: the least
    bytes it moves (mu in and out at the real slots, with damping nu too,
    the totals and a ``[B, n]`` gamma read once, the syndrome) over 3.35 TB/s."""
    size = s.total0.element_size()
    E = int(s.ms.chk_mask.sum())
    per_var = s.gamma.ndim == 2
    nb = s.B * (4 * E * size + s.n * size * (1 + per_var) + s.m)
    return (f"bound {nb / PEAK_BYTES_PER_S * 1e3:.4f} ms ({nb / s.B / 1e6:.3f} MB a "
            f"lane-iteration, bytes)", s.B)


def decoder(s: Setting):
    """``MinSumDecode`` in the setting's staged configuration, 24
    iterations checked every 8, every iteration run."""
    gam = s.gamma if s.gamma.ndim else None

    def make(T):
        dec = pt.MinSumDecode(s.graph, 0.01, ITERS, device=s.L0.device, dtype=s.dtype,
                              layout="check", check_every=CHECK_EVERY, _lane_tile=T, **s.kw)
        return lambda: dec(s.flip, s.L0, gam, early_exit=False)

    return f"MinSumDecode, {ITERS} iterations, check every {CHECK_EVERY}", make


def dem_inputs(dev):
    """The bb144 R=6 p=0.003 DEM's graph, 2048 seeded records' detection
    events and its prior LLRs, on ``dev``."""
    import scipy.sparse as sp

    z = np.load(ROOT / "benchmarks/results/bb144_r6_p0.003.npz")
    A = sp.csr_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
    dem = pt.TannerGraph.from_pcm(np.asarray(A.todense()))
    pr = z["priors"]
    x = (np.random.default_rng(21).random((2048, dem.n)) < pr).astype(np.float32)
    det = torch.as_tensor((x @ A.T.toarray().astype(np.float32)) % 2 == 1, device=dev)
    return dem, det, torch.as_tensor(np.log((1 - pr) / pr), device=dev)


PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S = 3.35e12, 67e12


def var_inputs(dev, code):
    """The graph, 2048 seeded records' syndromes and the prior LLRs of
    ``code``: the bb144 R=6 p=0.003 DEM, or the (1000, 10, 9) Gallager code
    at per 0.05."""
    if code == "dem":
        return dem_inputs(dev)
    gal = pt.TannerGraph.from_pcm(pt.parity_check_matrix(1000, 10, 9, rng=42))
    errs = np.random.default_rng(0).random((2048, gal.n)) < 0.05
    flip = torch.as_tensor(((errs.astype(np.float32) @ gal.H.T.astype(np.float32)) % 2) == 1,
                           device=dev)
    return gal, flip, torch.full((gal.n,), float(np.log(0.95 / 0.05)), device=dev)


def var_layout_cases(dev, batches, code="dem"):
    """(label, make(T), lanes, bound line, lane-iterations) of the variable
    layout at ``code`` (:func:`var_inputs`) in float32, damping 0.4, at each
    batch of ``batches``: K3 gathered from nu, K4 in place with the freeze
    (every second lane done), and the decode; ``make(T)`` as in
    :func:`forms`."""
    dem, det, llr = var_inputs(dev, code)
    m, dv, n = dem.m, dem.max_dv, dem.n
    name = "bb144 DEM" if code == "dem" else "Gallager (1000, 10, 9)"
    for B in batches:
        ms = pt.MinSumDecode(dem, 0.01, 2, device=dev, damping=0.4)
        E, size = int(ms.var_mask.sum()), 4
        L0 = torch.broadcast_to(llr.to(torch.float32), (B, n)).contiguous()
        flip = det[:B].contiguous()
        nu0 = L0[:, None, :].expand(B, dv, n).contiguous()
        mu0 = cuda_minsum.minsum_check_cuda(nu0.reshape(B, -1), ms.c2v, flip, ms.chk_mask,
                                            ms.alpha, 0.0, chk_deg=ms.chk_deg)
        done = torch.arange(B, device=dev) % 2 == 1

        def tile(t, T):
            return t if t.ndim == 0 else tile_lanes(t, T)

        def k3(T, nu0=nu0, flip=flip, ms=ms, B=B):
            x, f = tile(nu0, T).reshape(-1, dv * n, *((T,) if T > 1 else ())), tile(flip, T)
            return lambda: (cuda_minsum.minsum_check_cuda(x, ms.c2v, f, ms.chk_mask, ms.alpha,
                                                          0.0, chk_deg=ms.chk_deg, lane_tile=T),)

        def k4(T, nu0=nu0, mu0=mu0, L0=L0, done=done, ms=ms, B=B):
            mu = tile(mu0.reshape(B, -1), T)
            nu, L0t = tile(nu0.clone(), T), tile(L0, T)
            err, llrs = tile(torch.zeros((B, n), device=dev), T), L0t.clone()
            done_t = tile(done, T)
            return lambda: (cuda_minsum.minsum_var_iter_cuda(
                mu, ms.v2c, ms.var_mask, L0t, nu=nu, gamma=ms.gam, done=done_t, err=err,
                llrs=llrs, var_deg=ms.var_deg, lane_tile=T), nu, err, llrs)

        def decode(T, flip=flip, L0=L0):
            dec = pt.MinSumDecode(dem, 0.01, ITERS, device=dev, damping=0.4, _lane_tile=T)
            return lambda: dec(flip, L0, early_exit=False)

        # the least the functions need: K3 reads nu and writes mu at the
        # real slots (K4 reads no padded slot of mu) and reads the syndrome,
        # 14 operations an edge; K4 gathers mu, reads and writes nu at the
        # real slots, reads L0 and writes the active lanes' err / llrs, 5
        # operations an edge (the sum, the difference, the mix's two
        # products and its sum)
        active = int((~done).sum())
        b3 = (B * (2 * E * size + m), 14 * B * E)
        b4 = (B * (3 * E * size + n * size + 1) + active * n * (4 + size), 5 * B * E)
        for label, make, (nb, ops), per_iter in (
                (f"B={B} K3 gathered from nu", k3, b3, 1),
                (f"B={B} K4 in place, damping 0.4, freeze", k4, b4, 1),
                (f"B={B} MinSumDecode(layout='var'), {ITERS} iterations", decode,
                 (ITERS * (b3[0] + b4[0]), ITERS * (b3[1] + b4[1])), ITERS)):
            least = max(nb / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S) * 1e3
            note = (f"bound {least:.4f} ms ({nb / B / per_iter / 1e6:.3f} MB a lane-iteration, "
                    f"{'bytes' if nb / PEAK_BYTES_PER_S >= ops / PEAK_F32_OPS_PER_S else 'ops'})")
            yield f"{name} var layout f32 {label}", make, B, note, B * per_iter


def settings(dev):
    dem, det, llr = dem_inputs(dev)
    L0 = torch.broadcast_to(llr.to(torch.float32), (2048, dem.n)).contiguous()
    yield Setting("bb144 DEM (p) stage-0 batch f32 B=2048, damping 0.4", dem, 2048,
                  torch.float32, None, det, L0, dev)
    B = 1536
    L0 = torch.broadcast_to(llr.to(torch.bfloat16), (B, dem.n)).contiguous()
    gam = torch.as_tensor(np.random.default_rng(3).uniform(-0.24, 0.66, (B, dem.n)),
                          device=dev).to(torch.bfloat16)
    yield Setting("bb144 DEM (q) deep bucket bf16 B=6x256, [B, n] gammas", dem, B,
                  torch.bfloat16, gam, det[:256].repeat(6, 1).contiguous(), L0, dev)
    # batches the tile rule (models/minsum.py lane_tile_for) sizes down: a
    # flagship relay leg of the smallest bucket (6 x 32 lanes: 64-lane tiles,
    # not 128) and batches below a tile (lane-major)
    for B, dtype, label in ((192, torch.bfloat16, "(q) relay leg bf16 B=6x32, [B, n] gammas"),
                            (384, torch.bfloat16, "(q) relay leg bf16 B=6x64, [B, n] gammas"),
                            (768, torch.bfloat16, "(q) relay leg bf16 B=6x128, [B, n] gammas"),
                            (24, torch.float32, "f32 B=24, damping 0.4"),
                            (48, torch.float32, "f32 B=48, damping 0.4"),
                            (48, torch.bfloat16, "bf16 B=48, [B, n] gammas")):
        L0 = torch.broadcast_to(llr.to(dtype), (B, dem.n)).contiguous()
        gam = (torch.as_tensor(np.random.default_rng(3).uniform(-0.24, 0.66, (B, dem.n)),
                               device=dev).to(dtype) if dtype == torch.bfloat16 else None)
        yield Setting(f"bb144 DEM {label}", dem, B, dtype, gam,
                      det[:B // 6].repeat(6, 1).contiguous() if B >= 192 else det[:B], L0, dev)


def gallager_cases(dev):
    """The variable layout's lane-major forms at the Gallager code: K3
    gathered and K4 damped in place, float32 and bfloat16."""
    gal = pt.TannerGraph.from_pcm(pt.parity_check_matrix(1000, 10, 9, rng=42))
    errs = np.random.default_rng(0).random((1024, 1000)) < 0.05
    flip = torch.as_tensor(((errs.astype(np.float32) @ gal.H.T.astype(np.float32)) % 2) == 1,
                           device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        ms = pt.MinSumDecode(gal, 0.05, 2, device=dev, dtype=dtype, damping=0.4, alpha=0.8)
        L0 = torch.full((1024, 1000), float(np.log(0.95 / 0.05)), device=dev).to(dtype)
        nu0 = torch.broadcast_to(L0[:, None, :], (1024, gal.max_dv, 1000)).contiguous()
        mu = cuda_minsum.minsum_check_cuda(nu0.reshape(1024, -1), ms.c2v, flip, ms.chk_mask,
                                           ms.alpha, 0.0)
        tag = "f32" if dtype == torch.float32 else "bf16"

        def k3(ms=ms, nu0=nu0):
            return lambda: (cuda_minsum.minsum_check_cuda(
                nu0.reshape(1024, -1), ms.c2v, flip, ms.chk_mask, ms.alpha, 0.0,
                chk_deg=ms.chk_deg),)

        def k4(ms=ms, nu0=nu0, mu=mu, L0=L0):
            nu, total = nu0.clone(), torch.empty_like(L0)
            return lambda: (nu, cuda_minsum.minsum_var_iter_cuda(
                mu.reshape(1024, -1), ms.v2c, ms.var_mask, L0, nu=nu, gamma=ms.gam,
                total=total, var_deg=ms.var_deg))

        yield f"Gallager B=1024 {tag} var layout: K3 gathered", k3, ms.chk_mask.reshape(-1)
        yield f"Gallager B=1024 {tag} var layout: K4 damped in place", k4, None


def same(a, b, real=None):
    if a is None or b is None:
        return a is b
    if real is not None and a.ndim == 3:
        a, b = a.reshape(a.shape[0], -1)[:, real], b.reshape(b.shape[0], -1)[:, real]
    return torch.equal(a, b)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="a minsum.cu whose launchers lack the trailing lane_tile")
    ap.add_argument("--layout", choices=("check", "var"), default="check",
                    help="the check layout's cases (needs --parent) or the variable layout's")
    ap.add_argument("--batches", default="2048,256,48",
                    help="--layout var: the batches, in lanes")
    ap.add_argument("--code", choices=("dem", "gallager"), default="dem",
                    help="--layout var: the bb144 R=6 DEM or the (1000, 10, 9) Gallager code")
    ap.add_argument("--tiles", default="128,64", help="lane tiles to time, the first as the tree's")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: the tree's source built with -DNAME=VALUE")
    ap.add_argument("--out", type=Path, help="write the results as JSON here")
    ap.add_argument("--match", default="", help="time only the cases whose label this finds")
    args = ap.parse_args()
    tiles = [int(t) for t in args.tiles.split(",")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip()
    print(card)
    OUT_DIR.mkdir(exist_ok=True)
    _, _, tree_log = _build.build_library()
    print(f"tree: registers {registers(tree_log) or 'not in the log (a cached build)'}")
    if args.parent is None and args.layout == "check":
        ap.error("the check layout's cases take --parent")
    parent, parent_tiled = None, False
    if args.parent is not None:
        parent, regs = nvcc_build(args.parent, OUT_DIR / "minsum_parent.so")
        parent_tiled = bool(re.search(r"ldpc_minsum_check\([^)]*lane_tile",
                                      args.parent.read_text()))
        print(f"parent {args.parent} ({'lane tiles' if parent_tiled else 'lane-major'}): "
              f"registers {regs}")
    src = ROOT / "ldpcdecoders_tpu_torch/csrc/minsum.cu"
    print(f"tree: {packed_plans(_build.load_library(), tiles)}")
    builds = []
    for i, v in enumerate(args.variant):
        lib, regs = nvcc_build(src, OUT_DIR / f"minsum_variant{i}.so", tuple(v.split(",")))
        builds.append((v, lib))
        print(f"{v}: registers {regs}; {packed_plans(lib, tiles)}")
    dev = torch.device("cuda:0")
    results = []

    def run_in(lib, is_parent, make):
        def wrapped():
            fn = make()

            def run():
                with launching_into(lib, is_parent):
                    return fn()
            return run
        return wrapped

    def compare(label, variants, real=None, B=None, reps=10, note=None, lane_iters=None):
        """``variants``: (name, make, T), the tree's first; each ``make()``
        returns a call on fresh state whose tensors are in tile T's layout:
        untiled, they are compared with the first variant's, then every
        call is timed in turns."""
        def view(outs, T):
            return [t if t is None or T == 1 else untile_lanes(t, T)[:B] for t in outs]

        (_, tree_make, tree_T), others = variants[0], variants[1:]
        want = view(tree_make()(), tree_T)
        ok = [all(same(a, b, real) for a, b in zip(view(make()(), T), want))
              for _, make, T in others]
        tree_fn, fns = tree_make(), [make() for _, make, _ in others]
        before = [event_ms(fn, reps) for fn in fns]
        mine = [event_ms(tree_fn, reps), event_ms(tree_fn, reps)]
        after = [event_ms(fn, reps) for fn in reversed(fns)][::-1]
        tree_ms = sum(mine) / 2
        per = (f" ({tree_ms * 1e3 / lane_iters:.3f} us a lane-iteration)" if lane_iters
               else "")
        print(" | ".join([f"{label}: {variants[0][0]} {mine[0]:.4f} / {mine[1]:.4f} ms{per}"]
                         + [f"{name} {b:.4f} / {a:.4f} ms ({(a + b) / 2 / tree_ms:.3f}x), "
                            f"bitwise equal: {k}"
                            for (name, _, _), b, a, k in zip(others, before, after, ok)]
                         + ([note] if note else []) + [card]), flush=True)
        results.append({"case": label, "tree": variants[0][0], "tree_ms": mine, "note": note,
                        "lane_iters": lane_iters,
                        "others": {name: {"ms": [b, a], "bitwise": k}
                                   for (name, _, _), b, a, k in zip(others, before, after, ok)}})
        return all(ok)

    if args.layout == "var":
        good = True
        for label, make, B, note, lane_iters in var_layout_cases(
                dev, [int(b) for b in args.batches.split(",")], args.code):
            decode = "MinSumDecode" in label

            def out(T, decode=decode):
                return 1 if decode else T

            variants = [(f"tree T={tiles[0]}", lambda make=make: make(tiles[0]), out(tiles[0])),
                        ("tree T=1", lambda make=make: make(1), 1)]
            variants += [(f"tree T={T}", lambda make=make, T=T: make(T), out(T))
                         for T in tiles[1:]]
            if parent is not None:
                variants.append(("parent", run_in(parent, not parent_tiled,
                                                  lambda make=make: make(1)), 1))
            good &= compare(label, variants, None, B, 3 if decode else 10, note, lane_iters)
            torch.cuda.empty_cache()
        if args.out:
            args.out.write_text(json.dumps({"card": card, "results": results}, indent=1))
        print(f"all bitwise: {good}")
        return 0 if good else 1

    good = True
    for s in settings(dev):
        for label, make, *bound in forms(s) + [decoder(s)]:
            if not re.search(args.match, f"{s.label}: {label}"):
                continue
            decode = label.startswith("MinSumDecode")

            def out(T, decode=decode):  # the layout of the results: a decode's are untiled
                return 1 if decode else T

            variants = [(f"tree T={tiles[0]}", lambda make=make: make(tiles[0]), out(tiles[0]))]
            if parent_tiled:
                variants += [(f"parent T={T}", run_in(parent, False, lambda make=make, T=T: make(T)),
                              out(T)) for T in tiles]
            else:
                variants.append(("parent", run_in(parent, True, lambda make=make: make(1)), 1))
            variants.append(("tree T=1", lambda make=make: make(1), 1))
            variants += [(f"tree T={T}", lambda make=make, T=T: make(T), out(T))
                         for T in tiles[1:]]
            variants += [(f"{v} T={tiles[0]}", run_in(lib, False, lambda make=make: make(tiles[0])),
                          out(tiles[0])) for v, lib in builds]
            note, lane_iters = bound[0] if bound else (None, None)
            good &= compare(f"{s.label}: {label}", variants, None if decode else s.real, s.B,
                            3 if decode else 10, note, lane_iters)
        del s
        torch.cuda.empty_cache()
    for label, make, real in gallager_cases(dev):
        if not re.search(args.match, label):
            continue
        good &= compare(label, [("tree", make, 1),
                                ("parent", run_in(parent, not parent_tiled, make), 1)]
                        + [(v, run_in(lib, False, make), 1) for v, lib in builds], real)
    if args.out:
        args.out.write_text(json.dumps({"card": card, "results": results}, indent=1))
    print(f"all bitwise: {good}")
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
