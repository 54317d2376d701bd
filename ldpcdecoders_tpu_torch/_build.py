"""Build the CUDA kernels in ``csrc/`` with nvcc at first use, load with ctypes.

The sources compile into one shared library with a plain C interface
(no PyTorch headers, so the build takes seconds): one nvcc per source, all
started together, then one link.  The library lands in
``_kernels/`` beside this file (listed in ``.gitignore``) under a name that
hashes the sources and flags, so an edited source is rebuilt and a build
from an older checkout is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["build_library", "load_library"]

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found under {home}/bin or on PATH")
    return found


def build_library(defines: tuple[str, ...] = ()) -> tuple[Path, float, str]:
    """Compile ``csrc/*.cu`` unless an identical build exists.

    ``defines`` are preprocessor names for a build of its own beside the
    plain one (``LDPC_GF2_PHASE_CLOCKS``: the eliminations count the SM
    clocks of their phases).  Returns ``(library path, build seconds,
    compiler output)``; seconds is 0 and the output empty when the build was
    already there.
    """
    sources = sorted(CSRC.glob("*.cu"))
    flags = [*NVCC_FLAGS, *(f"-D{name}" for name in defines)]
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libldpc_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # objects and the library get temporary names, and the library is
    # renamed when complete: concurrent builds never load a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        cmds = [[nvcc, *flags, "-c", "-o", obj, str(src)]
                for obj, src in zip(objs, sources)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        outs = [proc.communicate()[0] for proc in procs]
        cmds.append([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(Path(tmp) / "lib.so"), *objs])
        if all(proc.returncode == 0 for proc in procs):
            link = subprocess.run(cmds[-1], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            procs.append(link)
            outs.append(link.stdout)
        for cmd, proc, out in zip(cmds, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        os.replace(Path(tmp) / "lib.so", lib)
    return lib, time.perf_counter() - t0, "".join(outs)


@functools.lru_cache(maxsize=None)
def load_library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process and
    set of ``defines``)."""
    path, _, _ = build_library(defines)
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ldpc_gf2_eliminate.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.ldpc_gf2_eliminate.restype = i32
    lib.ldpc_gf2_osd0.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.ldpc_gf2_osd0.restype = i32
    lib.ldpc_gf2_eliminate_cluster.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.ldpc_gf2_eliminate_cluster.restype = i32
    lib.ldpc_gf2_osd0_cluster.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.ldpc_gf2_osd0_cluster.restype = i32
    lib.ldpc_gf2_cluster_plan.argtypes = [i32] * 3 + [ctypes.POINTER(i32)]
    lib.ldpc_gf2_cluster_plan.restype = i32
    lib.ldpc_gf2_plan.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
    lib.ldpc_gf2_plan.restype = None
    if "LDPC_GF2_PHASE_CLOCKS" in defines:
        lib.ldpc_gf2_phase_clocks.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.ldpc_gf2_phase_clocks.restype = i32
        lib.ldpc_gf2_cluster_clocks.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.ldpc_gf2_cluster_clocks.restype = i32
    i64, f32 = ctypes.c_longlong, ctypes.c_float
    lib.ldpc_minsum_check.argtypes = ([ptr] * 5 + [i32] * 3 + [i64] + [f32] * 3
                                      + [i32, i32, i32, ptr])
    lib.ldpc_minsum_check.restype = i32
    lib.ldpc_minsum_check_iter.argtypes = ([ptr] * 7 + [i32, i64] + [i32] * 4 + [f32] * 3
                                           + [i32, i32, i32, ptr])
    lib.ldpc_minsum_check_iter.restype = i32
    lib.ldpc_minsum_var.argtypes = ([ptr] * 6 + [i32, ptr, i32, i64] + [ptr] * 4 + [i32] * 3
                                    + [i64, i32, i32, ptr])
    lib.ldpc_minsum_var.restype = i32
    lib.ldpc_minsum_stage_plan.argtypes = [i64, i32, i32, ctypes.POINTER(i32)]
    lib.ldpc_minsum_stage_plan.restype = None
    lib.ldpc_minsum_packed_plan.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
    lib.ldpc_minsum_packed_plan.restype = i32
    lib.ldpc_qc_minsum.argtypes = [ptr] * 7 + [i32] * 13 + [f32] * 3 + [i64, i32, ptr]
    lib.ldpc_qc_minsum.restype = i32
    lib.ldpc_qc_smem_bytes.argtypes = [i32] * 12
    lib.ldpc_qc_smem_bytes.restype = i64
    lib.ldpc_cuda_error_string.argtypes = [i32]
    lib.ldpc_cuda_error_string.restype = ctypes.c_char_p
    return lib
