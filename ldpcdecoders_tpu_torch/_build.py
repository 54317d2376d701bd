"""Build the CUDA kernels in ``csrc/`` with nvcc at first use, load with ctypes.

The sources compile into one shared library with a plain C interface
(no PyTorch headers, so the build takes seconds).  The library lands in
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def build_library() -> tuple[Path, float, str]:
    """Compile ``csrc/*.cu`` unless an identical build exists.

    Returns ``(library path, build seconds, compiler output)``; seconds is 0
    and the output empty when the build was already there.
    """
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libldpc_gf2_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, seconds, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    path, _, _ = build_library()
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ldpc_gf2_eliminate.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.ldpc_gf2_eliminate.restype = i32
    lib.ldpc_gf2_osd0.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.ldpc_gf2_osd0.restype = i32
    lib.ldpc_cuda_error_string.argtypes = [i32]
    lib.ldpc_cuda_error_string.restype = ctypes.c_char_p
    return lib
