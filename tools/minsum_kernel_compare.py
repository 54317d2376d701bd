#!/usr/bin/env python3
"""Time the port's min-sum kernels (K3, K4) and its min-sum iteration against
other builds and against an older revision's iteration.

    python3 tools/minsum_kernel_compare.py [--older OLD/minsum.cu]
        [--variant NAME=VALUE ...] [--out FILE]

Each ``--variant NAME=VALUE`` builds the tree's ``csrc/minsum.cu`` once more
with ``-DNAME=VALUE`` (``LDPC_MINSUM_FLAT_UNROLL_F32``, ``LDPC_MINSUM_FLAT_UNROLL_BF16``,
``LDPC_MINSUM_STAGED_UNROLL``, ``LDPC_MINSUM_VAR_CAP``)
and times it beside the tree's build through the same wrappers.  ``--older``
takes a revision with the earlier launcher interface (``ldpc_minsum_check`` with a
mask, ``ldpc_minsum_var`` with a fresh ``nu``), for example from ``git show
66640e8:ldpcdecoders_tpu_torch/csrc/minsum.cu``: its kernels and the plain
torch passes around them (the check-layout rebuild ``total[var] - mu``, the
damping mix, the freeze by ``torch.where`` every iteration) are the other
revision of one min-sum iteration, and its K3 (gathered) and K4 (the
totals) time beside the tree's where they compute the same function.  Every
build prints its ptxas register counts.

The shapes are ``chip_smoke.py``'s: the (1000, 10, 9) Gallager code at
B=1024 in the variable layout (damping 0.4, float32 and bfloat16) and the
bb144 R=6 p=0.003 DEM in the check layout at path (p)'s stage-0 batch
(float32, 2048 lanes, damping 0.4) and deep bucket (float32, 256 lanes, one
gamma 0.4 per lane) and path (q)'s deep bucket (bfloat16, 6 x 256 lanes,
per-variable gammas in [-0.24, 0.66)).  Messages are the
state after one iteration from the DEM's priors on seeded syndromes.  Per
case every build runs on the same tensors on ``cuda:0`` in the order others,
tree, tree, others reversed; outputs must be bitwise equal to the tree's on
the real slots (the iteration: the totals of two iterations from one state),
and a line gives each mean time (CUDA events behind a spin kernel, 10 calls
after a warm-up) and its ratio to the tree's.  An iteration is timed as one
off the syndrome check (7 of 8 at ``check_every=8``) and one on it (freeze,
syndrome check, ``iters`` / ``done``).

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

ROOT = Path(__file__).resolve().parent.parent
OUT_DIR = ROOT / "_scratch"


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
    kind = ("var" if "var" in name else "check_staged" if "staged" in name else "check")
    return kind + ("/bf16" if "bfloat16" in name else "") + "<" + ",".join(
        re.findall(r"Li(\d+)E", name)) + ">"


@contextlib.contextmanager
def launching_into(lib):
    """Make ops/cuda_minsum.py's wrappers launch into ``lib`` (another build
    of csrc/minsum.cu with the same interface)."""
    if lib is None:
        yield
        return
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.ldpc_minsum_check.argtypes = ([ptr] * 5 + [i32] * 3 + [i64] + [f32] * 3
                                      + [i32, i32, ptr])
    lib.ldpc_minsum_check_iter.argtypes = ([ptr] * 7 + [i32, i64] + [i32] * 4 + [f32] * 3
                                           + [i32, i32, ptr])
    lib.ldpc_minsum_var.argtypes = ([ptr] * 6 + [i32, ptr, i32, i64] + [ptr] * 4 + [i32] * 3
                                    + [i64, i32, ptr])
    saved = cuda_minsum._launch

    def launch(fn, what, x, *args):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn)(*args, int(x.dtype == torch.bfloat16), stream)
        if rc != 0:
            raise SystemExit(f"{what} launch into another build failed: {rc}")

    cuda_minsum._launch = launch
    try:
        yield
    finally:
        cuda_minsum._launch = saved


class Older:
    """The earlier launcher interface: K3 over masked slots, K4 with a fresh nu."""

    def __init__(self, lib):
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.ldpc_minsum_check.argtypes = [ptr] * 5 + [i32] * 3 + [i64] + [f32] * 3 + [i32, ptr]
        lib.ldpc_minsum_var.argtypes = [ptr] * 7 + [i32] * 3 + [i64, i32, ptr]
        self.lib = lib

    def check(self, x, idx, flip, mask, alpha):
        B, (dc, m) = x.shape[0], mask.shape
        mu = torch.empty((B, dc, m), dtype=x.dtype, device=x.device)
        rc = self.lib.ldpc_minsum_check(
            x.data_ptr(), None if idx is None else idx.data_ptr(), flip.data_ptr(),
            mask.data_ptr(), mu.data_ptr(), B, m, dc, x.numel() // B, float(alpha), 0.0,
            cuda_minsum._BIG[x.dtype], int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise SystemExit(f"the older K3 launch failed: {rc}")
        return mu

    def var(self, mu, v2c, mask, L0, want_nu):
        B, (dv, n) = mu.shape[0], mask.shape
        nu = torch.empty((B, dv, n), dtype=mu.dtype, device=mu.device) if want_nu else None
        total = torch.empty((B, n), dtype=mu.dtype, device=mu.device)
        rc = self.lib.ldpc_minsum_var(
            mu.data_ptr(), v2c.data_ptr(), mask.data_ptr(), L0.data_ptr(), None,
            None if nu is None else nu.data_ptr(), total.data_ptr(), B, n, dv, mu.shape[1],
            int(mu.dtype == torch.bfloat16), torch.cuda.current_stream(mu.device).cuda_stream)
        if rc != 0:
            raise SystemExit(f"the older K4 launch failed: {rc}")
        return nu, total


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
    """One shape: a decode module, its inputs, and the state after one
    iteration from the priors (mu, the totals, nu; the older revision keeps
    the next, damped nu instead)."""

    def __init__(self, label, graph, B, dtype, layout, gamma, flip, L0, dev):
        self.label, self.B, self.dtype, self.layout = label, B, dtype, layout
        self.ms = pt.MinSumDecode(graph, 0.01, 2, device=dev, dtype=dtype, layout=layout,
                                  alpha=0.8, lane_damping=gamma is not None and gamma.ndim > 0,
                                  damping=0.0 if gamma is not None and gamma.ndim > 0 else 0.4)
        self.gamma = self.ms.gam if gamma is None else gamma
        self.flip, self.L0 = flip, L0
        ms = self.ms
        self.dc, self.m, self.dv, self.n = graph.max_dc, graph.m, graph.max_dv, graph.n
        if layout == "check":
            self.nu0 = L0.index_select(1, ms.chk_varidx).reshape(B, self.dc, self.m)
            self.mu0 = cuda_minsum.minsum_check_cuda(L0, ms.chk_varidx, flip, ms.chk_mask,
                                                     ms.alpha, 0.0, chk_deg=ms.chk_deg)
            self.total0 = cuda_minsum.minsum_var_cuda(self.mu0.reshape(B, -1), ms.v2c,
                                                      ms.var_mask, L0, want_nu=False,
                                                      var_deg=ms.var_deg)[1]
        else:
            self.nu0 = torch.broadcast_to(L0[:, None, :], (B, self.dv, self.n)).contiguous()
        self.real = ms.chk_mask.reshape(-1) if layout == "check" else ms.var_mask.reshape(-1)

    def g_at_checks(self):
        g = self.gamma
        if g.ndim == 2:
            return g.index_select(1, self.ms.chk_varidx).reshape(self.B, self.dc, self.m)
        return g.reshape(self.B, 1, 1) if g.ndim == 1 else g


def tree_iteration(s: Setting, checked: bool):
    """The tree's iteration on its own state; returns (step, totals of it)."""
    ms, B = s.ms, s.B
    st = {"mu": s.mu0.clone() if s.layout == "check" else None, "nu": s.nu0.clone(),
          "total": s.total0.clone() if s.layout == "check" else None,
          "err": torch.zeros((B, s.n), device=s.L0.device), "llrs": s.L0.clone(),
          "done": torch.zeros((B,), dtype=torch.bool, device=s.L0.device)}
    syn_f = s.flip.to(torch.float32)

    def step():
        freeze = dict(done=st["done"], err=st["err"], llrs=st["llrs"]) if checked else {}
        if s.layout == "check":
            cuda_minsum.minsum_check_iter_cuda(st["mu"], st["total"], ms.chk_varidx, s.flip,
                                               ms.chk_mask, ms.alpha, 0.0, gamma=s.gamma,
                                               nu=st["nu"], chk_deg=ms.chk_deg)
            total = cuda_minsum.minsum_var_iter_cuda(
                st["mu"].reshape(B, -1), ms.v2c, ms.var_mask, s.L0, total=st["total"],
                var_deg=ms.var_deg, **freeze)
        else:
            mu = cuda_minsum.minsum_check_cuda(st["nu"].reshape(B, -1), ms.c2v, s.flip,
                                               ms.chk_mask, ms.alpha, 0.0, chk_deg=ms.chk_deg)
            total = torch.empty((B, s.n), dtype=s.dtype, device=s.L0.device)
            cuda_minsum.minsum_var_iter_cuda(mu.reshape(B, -1), ms.v2c, ms.var_mask, s.L0,
                                             nu=st["nu"], gamma=s.gamma, total=total,
                                             var_deg=ms.var_deg, **freeze)
        if checked:
            active = ~st["done"]
            ok = (ms.syndrome_from(st["err"]) != syn_f).sum(dim=-1).to(torch.int32) == 0
            st["iters"] = torch.where(ok & active, 1, 0)
            st["done"] = st["done"] | ok
        return (total,)

    return step


def older_iteration(s: Setting, older: Older, checked: bool):
    """The older revision's iteration (its kernels and its plain torch
    passes) on its own state, which starts one damping mix ahead of the
    tree's."""
    ms, B = s.ms, s.B
    if s.layout == "check":
        new = s.total0.index_select(1, ms.chk_varidx).reshape(B, s.dc, s.m) - s.mu0
        g = s.g_at_checks()
        nu = g * s.nu0 + (1.0 - g) * new
    else:
        nu = s.nu0.clone()
    st = {"nu": nu, "err": torch.zeros((B, s.n), device=s.L0.device), "llrs": s.L0,
          "done": torch.zeros((B,), dtype=torch.bool, device=s.L0.device)}
    syn_f = s.flip.to(torch.float32)
    big = torch.full((B,), 1 << 30, dtype=torch.int32, device=s.L0.device)
    # the older revision expanded [B, n] gammas to the check slots once a decode
    g_chk = s.g_at_checks() if s.layout == "check" else None

    def step():
        nu = st["nu"]
        if s.layout == "check":
            g = g_chk
            mu = older.check(nu, None, s.flip, ms.chk_mask, ms.alpha)
            _, total = older.var(mu.reshape(B, -1), ms.v2c, ms.var_mask, s.L0, False)
            new = total.index_select(1, ms.chk_varidx).reshape(B, s.dc, s.m) - mu
        else:
            g = s.gamma.reshape(B, 1, s.n) if s.gamma.ndim == 2 else s.gamma
            mu = older.check(nu.reshape(B, -1), ms.c2v, s.flip, ms.chk_mask, ms.alpha)
            new, total = older.var(mu.reshape(B, -1), ms.v2c, ms.var_mask, s.L0, True)
        new = g * nu + (1.0 - g) * new
        errn = (total < 0).to(torch.float32)
        active = ~st["done"]
        st["err"] = torch.where(active[:, None], errn, st["err"])
        st["llrs"] = torch.where(active[:, None], total, st["llrs"])
        if checked:
            mis = (ms.syndrome_from(st["err"]) != syn_f).sum(dim=-1).to(torch.int32)
        else:
            mis = big
        ok = mis == 0
        st["iters"] = torch.where(ok & active, 1, 0)
        st["done"] = st["done"] | ok
        st["nu"] = new
        return (total,)

    return step


def settings(dev):
    import scipy.sparse as sp

    out = []
    gal = pt.TannerGraph.from_pcm(pt.parity_check_matrix(1000, 10, 9, rng=42))
    rng = np.random.default_rng(0)
    errs = rng.random((1024, 1000)) < 0.05
    flip = torch.as_tensor(((errs.astype(np.float32) @ gal.H.T.astype(np.float32)) % 2) == 1,
                           device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        L0 = torch.full((1024, 1000), float(np.log(0.95 / 0.05)), device=dev).to(dtype)
        out.append(Setting(f"Gallager B=1024 {'f32' if dtype == torch.float32 else 'bf16'} "
                           "var layout, damping 0.4", gal, 1024, dtype, "var", None, flip, L0,
                           dev))
    z = np.load(ROOT / "benchmarks/results/bb144_r6_p0.003.npz")
    A = sp.csr_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
    dem = pt.TannerGraph.from_pcm(np.asarray(A.todense()))
    pr = z["priors"]
    x = (np.random.default_rng(21).random((2048, dem.n)) < pr).astype(np.float32)
    det = torch.as_tensor((x @ A.T.toarray().astype(np.float32)) % 2 == 1, device=dev)
    llr = torch.as_tensor(np.log((1 - pr) / pr), device=dev)
    L0 = torch.broadcast_to(llr.to(torch.float32), (2048, dem.n)).contiguous()
    out.append(Setting("bb144 DEM (p) stage-0 batch f32 B=2048 check layout, damping 0.4", dem,
                       2048, torch.float32, "check", None, det, L0, dev))
    out.append(Setting("bb144 DEM (p) deep bucket f32 B=256 check layout, [B] gammas 0.4", dem,
                       256, torch.float32, "check", torch.full((256,), 0.4, device=dev), det[:256],
                       L0[:256], dev))
    B = 1536
    L0 = torch.broadcast_to(llr.to(torch.bfloat16), (B, dem.n)).contiguous()
    gam = torch.as_tensor(np.random.default_rng(3).uniform(-0.24, 0.66, (B, dem.n)),
                          device=dev).to(torch.bfloat16)
    out.append(Setting("bb144 DEM (q) deep bucket bf16 B=6x256 check layout, [B, n] gammas",
                       dem, B, torch.bfloat16, "check", gam, det[:256].repeat(6, 1), L0, dev))
    return out


def kernel_cases(s: Setting, older=None):
    """(label, make, the older revision's make or None) of the tree's kernel
    forms at one setting: ``make()`` returns a call on fresh copies of the state it
    updates in place (the timing repeats one call, whose work does not
    depend on the values).  The older kernels compute two of the same
    functions: K3 gathered, and K4's totals."""
    ms, B = s.ms, s.B
    if s.layout == "var":
        nu_flat = s.nu0.reshape(B, -1)
        mu = cuda_minsum.minsum_check_cuda(nu_flat, ms.c2v, s.flip, ms.chk_mask, ms.alpha, 0.0)

        def k4_damped():
            nu, total = s.nu0.clone(), torch.empty_like(s.L0)
            return lambda: (nu, cuda_minsum.minsum_var_iter_cuda(
                mu.reshape(B, -1), ms.v2c, ms.var_mask, s.L0, nu=nu, gamma=s.gamma,
                total=total, var_deg=ms.var_deg))

        names = {None: "launcher's choice", True: "staged", False: "flat"}
        old = None if older is None else (
            lambda: lambda: (older.check(nu_flat, ms.c2v, s.flip, ms.chk_mask, ms.alpha),))
        return [(f"K3 gathered, {names[stage]}",
                 lambda stage=stage: lambda: (cuda_minsum.minsum_check_cuda(
                     nu_flat, ms.c2v, s.flip, ms.chk_mask, ms.alpha, 0.0, chk_deg=ms.chk_deg,
                     _stage=stage),), old if stage is None else None)
                for stage in (None, True, False)] + [("K4 nu in place, damped", k4_damped,
                                                      None)]

    def k3(stage):
        mu, nu = s.mu0.clone(), s.nu0.clone()
        return lambda: (cuda_minsum.minsum_check_iter_cuda(
            mu, s.total0, ms.chk_varidx, s.flip, ms.chk_mask, ms.alpha, 0.0, gamma=s.gamma,
            nu=nu, chk_deg=ms.chk_deg, _stage=stage), nu)

    def k4(freeze):
        total = torch.empty_like(s.L0)
        kw = {}
        if freeze:
            kw = dict(done=torch.zeros((B,), dtype=torch.bool, device=s.L0.device),
                      err=torch.zeros((B, s.n), device=s.L0.device), llrs=s.L0.clone())
        return lambda: (cuda_minsum.minsum_var_iter_cuda(
            s.mu0.reshape(B, -1), ms.v2c, ms.var_mask, s.L0, total=total, var_deg=ms.var_deg,
            **kw), *kw.values())

    names = {None: "launcher's choice", True: "staged", False: "flat"}
    old = None if older is None else (lambda: lambda: older.var(
        s.mu0.reshape(B, -1), ms.v2c, ms.var_mask, s.L0, False)[1:])
    return ([(f"K3 iteration form, {names[stage]}", lambda stage=stage: k3(stage), None)
             for stage in (None, True, False)]
            + [("K4 totals", lambda: k4(False), old),
               ("K4 totals and freeze", lambda: k4(True), None)])


def same(a, b, real=None):
    if a is None or b is None:
        return a is b
    if real is not None and a.ndim == 3:
        a, b = a.reshape(a.shape[0], -1)[:, real], b.reshape(b.shape[0], -1)[:, real]
    return torch.equal(a, b)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--older", type=Path,
                    help="a minsum.cu with the earlier launcher interface")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE: the tree's source built with -DNAME=VALUE")
    ap.add_argument("--out", type=Path, help="write the results as JSON here")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip()
    print(card)
    OUT_DIR.mkdir(exist_ok=True)
    _, _, tree_log = _build.build_library()
    print(f"tree: registers {registers(tree_log) or 'not in the log (a cached build)'}")
    src = ROOT / "ldpcdecoders_tpu_torch/csrc/minsum.cu"
    builds = []
    for i, v in enumerate(args.variant):
        lib, regs = nvcc_build(src, OUT_DIR / f"minsum_variant{i}.so", (v,))
        builds.append((v, lib))
        print(f"{v}: registers {regs}")
    older = None
    if args.older:
        lib, regs = nvcc_build(args.older, args.older.with_suffix(".so"))
        older = Older(lib)
        print(f"{args.older} (the earlier interface): registers {regs}")
    dev = torch.device("cuda:0")
    results = []

    def compare(label, tree_make, others, real=None):
        """``tree_make`` and each other's ``make`` return a call on fresh
        state: its first result is compared, the calls are then timed."""
        want = tree_make()()
        ok = [all(same(a, b, real) for a, b in zip(make()(), want)) for _, make in others]
        tree_fn, fns = tree_make(), [make() for _, make in others]
        before = [event_ms(fn) for fn in fns]
        mine = [event_ms(tree_fn), event_ms(tree_fn)]
        after = [event_ms(fn) for fn in reversed(fns)][::-1]
        tree_ms = sum(mine) / 2
        print(" | ".join([f"{label}: tree {mine[0]:.4f} / {mine[1]:.4f} ms"]
                         + [f"{name} {b:.4f} / {a:.4f} ms ({(a + b) / 2 / tree_ms:.3f}x the "
                            f"tree's), bitwise equal: {k}"
                            for (name, _), b, a, k in zip(others, before, after, ok)]
                         + [card]))
        results.append({"case": label, "tree_ms": mine,
                        "others": {name: {"ms": [b, a], "bitwise": k}
                                   for (name, _), b, a, k in zip(others, before, after, ok)}})
        return all(ok)

    good = True
    for s in settings(dev):
        for label, make, old_make in kernel_cases(s, older):
            others = [] if old_make is None else [("the older kernel", old_make)]
            for name, lib in builds:
                def other_make(make=make, lib=lib):
                    fn = make()

                    def run():
                        with launching_into(lib):
                            return fn()
                    return run
                others.append((name, other_make))
            good &= compare(f"{s.label}: {label}", make, others, s.real)
        for checked in (False, True):
            what = "iteration on the check" if checked else "iteration off the check"
            if older is not None:
                # bitwise: the totals of two iterations from the same state
                t_step, p_step = tree_iteration(s, checked), older_iteration(s, older, checked)
                match = all(torch.equal(t_step()[0], p_step()[0]) for _ in range(2))
                print(f"{s.label}: {what}: the tree's totals equal the older revision's over "
                      f"two iterations: "
                      f"{match}")
                good &= match
            others = [] if older is None else [
                ("older", lambda: older_iteration(s, older, checked))]
            good &= compare(f"{s.label}: {what}", lambda: tree_iteration(s, checked), others)
        del s
        torch.cuda.empty_cache()
    if args.out:
        args.out.write_text(json.dumps({"card": card, "results": results}, indent=1))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
