"""Native (C++) host tier: lazily built ctypes bindings.

Counterpart of ``ldpcdecoders_tpu/native/__init__.py``, with the same C++
sources (``graph_compiler.cpp``, ``gf2_host.cpp``, ``gf2_osd.cpp``) and the
same entry points, plus two in ``gf2_osd.cpp``.  The shared library is built
with the system g++ at first use into ``_kernels/`` beside the package
(listed in ``.gitignore``), under a name that hashes the sources, so an
edited source is rebuilt.  Every entry
point returns None where the library cannot be built; the decoders that
need it (the host OSD of models/bposd.py and models/staged.py) raise there.

The host OSD (``gf2_osd0_host``, ``gf2_osd_cs_host``) serves OSD lanes too
large for one block of the CUDA eliminations (ops/cuda_gf2.py), where the
caller asks for it (``osd_impl="host"``, the staged decoder's OSD pick): it
is bitwise equal to the device OSD given the same column order.  Where
every lane shares a candidate's column order and ``bp = 0`` (the staged
decoder's posterior-free candidate), ``gf2_osd_cs_prepare`` eliminates once
and ``gf2_osd_cs_prepared_host`` replays that on each lane's syndrome, with
the outputs of ``gf2_osd_cs_host``.  A foreign call releases the interpreter
lock, so it overlaps work on the card from another thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = [
    "compile_tanner_native",
    "native_available",
    "pack_gf2_rows",
    "gf2_pack_cols",
    "gf2_osd0_host",
    "gf2_osd_cs_host",
    "gf2_osd_cs_prepare",
    "gf2_osd_cs_prepared_host",
    "OsdCsPrepared",
    "gf2_syndromes_packed",
    "gf2_verify_packed",
]

_lock = threading.Lock()
_lib = None
_build_failed = False

_SRCS = [Path(__file__).parent / name
         for name in ("graph_compiler.cpp", "gf2_host.cpp", "gf2_osd.cpp")]
_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]
BUILD_DIR = Path(__file__).parent.parent / "_kernels"


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRCS:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"ldpc_native_{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    so_path = _library_path()
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # built under a temporary name and renamed when complete:
        # concurrent builds never load a half-written library
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
            tmp_so = os.path.join(td, "ldpc_native.so")
            subprocess.run(["g++", *_FLAGS, "-o", tmp_so, *map(str, _SRCS)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp_so, so_path)
    return so_path


def _bind(lib):
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    signatures = {
        "compile_tanner": (ctypes.c_int, [ptr] + [i64] * 4 + [ptr] * 6),
        "degrees": (None, [ptr, i64, i64, ptr, ptr]),
        "gf2_pack_rows": (None, [ptr, i64, i64, i64, ptr]),
        "gf2_syndromes_packed": (None, [ptr, i64, i64, ptr, i64, ptr]),
        "gf2_osd0_host": (None, [ptr, i64, i64, i64, ptr, ptr, ptr, i64, ptr, ptr]),
        "gf2_osd_cs_host": (None, [ptr] + [i64] * 5 + [ptr] * 3 + [i64, ptr, ptr]),
        "gf2_osd_cs_prepare": (i64, [ptr] + [i64] * 3 + [ptr] * 7),
        "gf2_osd_cs_prepared_host": (None, [i64] * 6 + [ptr] * 7 + [i64, ptr, ptr]),
        "gf2_pack_cols": (None, [ptr, i64, i64, i64, ptr]),
        "gf2_verify_packed": (None, [ptr, i64, i64, ptr, ptr, i64, ptr, ptr]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            _lib = _bind(ctypes.CDLL(str(_build())))
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def compile_tanner_native(H: np.ndarray, max_dc: int, max_dv: int):
    """Fill padded adjacency + gather arrays via the C++ compiler.

    Returns ``(chk_vars, chk_mask, var_chks, var_mask, c2v, v2c)`` or
    ``None`` if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    H = np.ascontiguousarray(H, dtype=np.uint8)
    m, n = H.shape
    chk_vars = np.zeros((m, max_dc), np.int32)
    chk_mask = np.zeros((m, max_dc), np.uint8)
    var_chks = np.zeros((n, max_dv), np.int32)
    var_mask = np.zeros((n, max_dv), np.uint8)
    c2v = np.zeros((m, max_dc), np.int32)
    v2c = np.zeros((n, max_dv), np.int32)
    rc = lib.compile_tanner(
        H.ctypes.data, m, n, max_dc, max_dv,
        chk_vars.ctypes.data, chk_mask.ctypes.data, var_chks.ctypes.data,
        var_mask.ctypes.data, c2v.ctypes.data, v2c.ctypes.data,
    )
    if rc != 0:
        raise ValueError("degree exceeds padded maximum (internal error)")
    return chk_vars, chk_mask.astype(bool), var_chks, var_mask.astype(bool), c2v, v2c


def pack_gf2_rows(M: np.ndarray) -> np.ndarray | None:
    """Pack a ``[rows, n]`` 0/1 matrix into ``[rows, ceil(n/64)]`` uint64
    words (threaded C++), or ``None`` if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    M = np.ascontiguousarray(M, dtype=np.uint8)
    rows, n = M.shape
    nw = (n + 63) // 64
    out = np.empty((rows, nw), np.uint64)
    lib.gf2_pack_rows(M.ctypes.data, rows, n, nw, out.ctypes.data)
    return out


def gf2_syndromes_packed(Hp: np.ndarray, Ep: np.ndarray, m: int) -> np.ndarray | None:
    """``[B, m]`` uint8 syndromes from packed H rows and packed error rows."""
    lib = _load()
    if lib is None:
        return None
    B, nw = Ep.shape
    if Hp.shape != (m, nw):
        raise ValueError(f"packed H shape {Hp.shape} != ({m}, {nw})")
    out = np.empty((B, m), np.uint8)
    lib.gf2_syndromes_packed(Hp.ctypes.data, m, nw, Ep.ctypes.data, B, out.ctypes.data)
    return out


def gf2_verify_packed(Hp: np.ndarray, Ep: np.ndarray, Gp: np.ndarray):
    """Fused decode verification on packed lanes.

    Returns ``(exact [B] bool, smatch [B] bool)`` where ``exact`` is
    bitwise recovery of the injected error and ``smatch`` is syndrome
    consistency (H @ (E xor G) == 0); ``None`` if native is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    m, nw = Hp.shape
    B = Ep.shape[0]
    if Ep.shape != (B, nw) or Gp.shape != (B, nw):
        raise ValueError("packed error/guess shapes disagree with packed H")
    exact = np.empty((B,), np.uint8)
    smatch = np.empty((B,), np.uint8)
    lib.gf2_verify_packed(Hp.ctypes.data, m, nw, Ep.ctypes.data, Gp.ctypes.data, B,
                          exact.ctypes.data, smatch.ctypes.data)
    return exact.astype(bool), smatch.astype(bool)


def gf2_pack_cols(H: np.ndarray) -> np.ndarray | None:
    """Pack ``[m, n]`` 0/1 H into ``[n, ceil(m/64)]`` uint64 column
    bitsets (bit r of word w = row 64w+r), or ``None`` if unavailable."""
    lib = _load()
    if lib is None:
        return None
    H = np.ascontiguousarray(H, dtype=np.uint8)
    m, n = H.shape
    mw = (m + 63) // 64
    out = np.empty((n, mw), np.uint64)
    lib.gf2_pack_cols(H.ctypes.data, m, n, mw, out.ctypes.data)
    return out


def _osd_args(Hcols, m, order, bp, syn):
    """Validate and make contiguous the arguments shared by the host OSDs."""
    Hcols = np.ascontiguousarray(Hcols, dtype=np.uint64)
    n, mw = Hcols.shape
    order = np.ascontiguousarray(order, dtype=np.int32)
    bp = np.ascontiguousarray(bp, dtype=np.uint8)
    syn = np.ascontiguousarray(syn, dtype=np.uint8)
    B = order.shape[0]
    if order.shape != (B, n) or bp.shape != (B, n) or syn.shape != (B, m):
        raise ValueError(
            f"shape mismatch: order {order.shape}, bp {bp.shape}, "
            f"syn {syn.shape} for n={n}, m={m}")
    if order.size and (order.min() < 0 or order.max() >= n):
        # the C++ indexes Hcols with these directly; OOB would be UB
        raise ValueError("order entries must be column indices in [0, n)")
    if mw != (m + 63) // 64:
        raise ValueError(f"m={m} inconsistent with packed-column width {mw} words")
    return Hcols, n, mw, order, bp, syn, B


def gf2_osd0_host(Hcols: np.ndarray, m: int, order: np.ndarray,
                  bp: np.ndarray, syn: np.ndarray):
    """Threaded host OSD-0 over packed columns (see native/gf2_osd.cpp).

    Bit-identical to the device path (ops/gf2.py ``gf2_osd0``) given the
    same per-lane column order; built for problem widths the device
    elimination cannot hold.

    Args:
      Hcols: ``[n, ceil(m/64)]`` uint64 packed columns (gf2_pack_cols).
      m: row count.
      order: ``[B, n]`` int32 per-lane scan order, most reliable first.
      bp: ``[B, n]`` uint8 hard decisions (original column order).
      syn: ``[B, m]`` uint8 syndromes.

    Returns ``(out [B, n] uint8, consistent [B] bool)`` or ``None`` if
    the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    Hcols, n, mw, order, bp, syn, B = _osd_args(Hcols, m, order, bp, syn)
    out = np.empty((B, n), np.uint8)
    consistent = np.empty(B, np.uint8)
    lib.gf2_osd0_host(Hcols.ctypes.data, n, m, mw, order.ctypes.data, bp.ctypes.data,
                      syn.ctypes.data, B, out.ctypes.data, consistent.ctypes.data)
    return out, consistent.astype(bool)


def gf2_osd_cs_host(Hcols: np.ndarray, m: int, lam: int, order: np.ndarray,
                    bp: np.ndarray, syn: np.ndarray, lam3: int = 0):
    """Threaded host OSD-CS (combination sweep; native/gf2_osd.cpp).

    Same conventions as :func:`gf2_osd0_host` plus ``lam``, the pair-
    sweep depth over the most-reliable non-pivot columns, and ``lam3``,
    the triple-sweep depth (order-3 combinations; 0 disables, the device
    sweep's semantics, to which lam3=0 is bitwise equal).  Returns
    ``(out, consistent)`` or ``None`` if the native library is
    unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    Hcols, n, mw, order, bp, syn, B = _osd_args(Hcols, m, order, bp, syn)
    if lam < 0 or lam3 < 0:
        raise ValueError("lam and lam3 must be >= 0")
    out = np.empty((B, n), np.uint8)
    consistent = np.empty(B, np.uint8)
    lib.gf2_osd_cs_host(Hcols.ctypes.data, n, m, mw, int(lam), int(lam3),
                        order.ctypes.data, bp.ctypes.data, syn.ctypes.data,
                        B, out.ctypes.data, consistent.ctypes.data)
    return out, consistent.astype(bool)


@dataclass(frozen=True, eq=False)
class OsdCsPrepared:
    """One OSD-CS elimination in a column order every lane shares, with
    ``bp = 0`` (:func:`gf2_osd_cs_prepare`): the pivot rows ``prow [rank]``,
    each pivot's reduced column ``cand [rank, mw]`` and combination ``cw
    [rank, pw]`` as installed, the pivot columns ``pivcol [rank]``, and the
    non-pivot combinations ``npw [n - rank, pw]`` and columns ``npcol``."""

    n: int
    m: int
    prow: np.ndarray
    cand: np.ndarray
    cw: np.ndarray
    pivcol: np.ndarray
    npw: np.ndarray
    npcol: np.ndarray


def gf2_osd_cs_prepare(Hcols: np.ndarray, m: int, order: np.ndarray):
    """The elimination of an OSD-CS candidate whose column ``order [n]``
    and hard decisions (all 0) every lane shares, made once
    (native/gf2_osd.cpp): what :func:`gf2_osd_cs_prepared_host` replays on
    each lane's syndrome.  Returns an :class:`OsdCsPrepared`, or ``None``
    if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    Hcols, n, mw, order2, _, _, _ = _osd_args(
        Hcols, m, np.asarray(order)[None], np.zeros((1, len(order)), np.uint8),
        np.zeros((1, m), np.uint8))
    pw = (m + 63) // 64
    prow = np.empty(m, np.int64)
    cand = np.empty((m, mw), np.uint64)
    cw = np.empty((m, pw), np.uint64)
    pivcol = np.empty(m, np.int32)
    npw = np.empty((n, pw), np.uint64)
    npcol = np.empty(n, np.int32)
    rank = lib.gf2_osd_cs_prepare(
        Hcols.ctypes.data, n, m, mw, order2.ctypes.data, prow.ctypes.data,
        cand.ctypes.data, cw.ctypes.data, pivcol.ctypes.data, npw.ctypes.data,
        npcol.ctypes.data)
    return OsdCsPrepared(n, m, prow[:rank].copy(), cand[:rank].copy(), cw[:rank].copy(),
                         pivcol[:rank].copy(), npw[:n - rank].copy(), npcol[:n - rank].copy())


def gf2_osd_cs_prepared_host(state: OsdCsPrepared, lam: int, syn: np.ndarray,
                             lam3: int = 0):
    """Threaded host OSD-CS of ``syn [B, m]`` in ``state``'s shared order
    with ``bp = 0``: per lane only the syndrome's reduction and the sweep.
    Bitwise :func:`gf2_osd_cs_host` with that order and ``bp`` on every
    lane.  Returns ``(out [B, n] uint8, consistent [B] bool)`` or ``None``
    if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if lam < 0 or lam3 < 0:
        raise ValueError("lam and lam3 must be >= 0")
    n, m = state.n, state.m
    syn = np.ascontiguousarray(syn, dtype=np.uint8)
    if syn.ndim != 2 or syn.shape[1] != m:
        raise ValueError(f"shape mismatch: syn {syn.shape} for m={m}")
    B = syn.shape[0]
    out = np.empty((B, n), np.uint8)
    consistent = np.empty(B, np.uint8)
    lib.gf2_osd_cs_prepared_host(
        n, m, (m + 63) // 64, int(lam), int(lam3), len(state.prow),
        state.prow.ctypes.data, state.cand.ctypes.data, state.cw.ctypes.data,
        state.pivcol.ctypes.data, state.npw.ctypes.data, state.npcol.ctypes.data,
        syn.ctypes.data, B, out.ctypes.data, consistent.ctypes.data)
    return out, consistent.astype(bool)
