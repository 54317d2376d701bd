"""Hand-written CUDA kernels for the OSD eliminations, and their plain versions.

Counterpart of ``ldpcdecoders_tpu/ops/pallas_gf2.py``.  The kernels live in
``csrc/gf2_elim.cu`` (built by ``_build.py``):

  * :func:`gf2_osd0_cuda` replaces ``gf2_osd0_pallas`` (``_osd0_kernel``);
  * :func:`gf2_eliminate_cuda` replaces ``gf2_eliminate_pallas``
    (``_elim_kernel``).

Each wrapper takes the same shapes and returns the same values as its
Pallas counterpart, with int32 tensors carrying the uint32 bit patterns.
For tensors on the CPU a wrapper runs its plain torch version
(:func:`gf2_osd0_ref`, :func:`gf2_eliminate_ref`); for CUDA tensors it
launches the kernel or raises.  ``<wrapper>.launches`` counts the kernel
launches of each wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from .gf2 import gf2_eliminate, gf2_osd0

__all__ = [
    "gf2_osd0_cuda",
    "gf2_eliminate_cuda",
    "gf2_osd0_ref",
    "gf2_eliminate_ref",
    "smem_bytes",
    "MAX_SMEM_BYTES",
]

#: dynamic shared memory one Hopper block can opt in to (227 KB)
MAX_SMEM_BYTES = 232_448


def smem_bytes(W: int, m: int, *, osd0: bool) -> int:
    """Shared memory a lane's block takes: two pivot slots, the pivot map,
    the syndrome (double-buffered for OSD-0) and the packed ``[W, m]``
    system, all in 32-bit words (the same sum as ``csrc/gf2_elim.cu``)."""
    return 4 * (2 + m * (1 + (2 if osd0 else 1)) + W * m)


def gf2_osd0_ref(Ht, resid, bp_err, n):
    """Plain torch version of the OSD-0 kernel (see ops/gf2.py ``gf2_osd0``)."""
    return gf2_osd0(Ht, resid, bp_err, n)


def gf2_eliminate_ref(Ht, s, n):
    """Plain torch version of the elimination kernel: ``(Ht', s', pivcol)``."""
    Ht2, s2, piv, _ = gf2_eliminate(Ht, s, n)
    return Ht2, s2, piv


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 (uint32 bit patterns), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _prepare(Ht, n, osd0):
    """Validate the packed system and return ``(lib, B, W, m, stream)``."""
    from .._build import load_library

    if Ht.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {Ht.device}")
    if Ht.ndim != 3:
        raise ValueError(f"Ht must be [B, W, m], got shape {tuple(Ht.shape)}")
    B, W, m = Ht.shape
    if W != (n + 31) // 32:
        raise ValueError(f"Ht has {W} words per row; {n} columns need {(n + 31) // 32}")
    _check("Ht", Ht, (B, W, m), Ht.device)
    need = smem_bytes(W, m, osd0=osd0)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"one lane of a [{m}, {n}] system takes {need} bytes of shared memory; "
            f"a Hopper block holds at most {MAX_SMEM_BYTES}")
    stream = torch.cuda.current_stream(Ht.device).cuda_stream
    return load_library(), B, W, m, stream


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.ldpc_cuda_error_string(rc).decode()}")


def gf2_osd0_cuda(Ht, resid, bp_err, n):
    """Batched OSD-0 elimination; returns the ``[B, n]`` int32 correction.

    Args:
      Ht: ``[B, W, m]`` int32 transposed packed rows (sorted columns).
      resid: ``[B, m]`` int32 0/1 residual syndrome of ``bp_err``.
      bp_err: ``[B, n]`` int32 0/1 BP hard decisions (sorted order).
      n: column count.
    """
    if Ht.device.type == "cpu":
        return gf2_osd0_ref(Ht, resid, bp_err, n)
    lib, B, W, m, stream = _prepare(Ht, n, osd0=True)
    _check("resid", resid, (B, m), Ht.device)
    _check("bp_err", bp_err, (B, n), Ht.device)
    corr = torch.empty((B, n), dtype=torch.int32, device=Ht.device)
    if B == 0:
        return corr
    with torch.cuda.device(Ht.device):  # the launch goes to the current device
        rc = lib.ldpc_gf2_osd0(Ht.data_ptr(), resid.data_ptr(), bp_err.data_ptr(),
                               corr.data_ptr(), B, W, m, n, stream)
    _raise_on(lib, rc, "gf2_osd0")
    gf2_osd0_cuda.launches += 1
    return corr


def gf2_eliminate_cuda(Ht, s, n):
    """Batched Gauss–Jordan RREF of packed columns.

    Args:
      Ht: ``[B, W, m]`` int32 transposed packed rows.
      s: ``[B, m]`` int32 0/1 syndromes, co-transformed.
      n: column count.

    Returns ``(Ht' [B, W, m], s' [B, m], pivcol [B, m])`` (int32) with
    ``pivcol[b, i]`` = row i's pivot column or the sentinel ``n``.
    """
    if Ht.device.type == "cpu":
        return gf2_eliminate_ref(Ht, s, n)
    lib, B, W, m, stream = _prepare(Ht, n, osd0=False)
    _check("s", s, (B, m), Ht.device)
    Ht2 = torch.empty_like(Ht)
    s2 = torch.empty_like(s)
    piv = torch.empty((B, m), dtype=torch.int32, device=Ht.device)
    if B == 0:
        return Ht2, s2, piv
    with torch.cuda.device(Ht.device):
        rc = lib.ldpc_gf2_eliminate(Ht.data_ptr(), s.data_ptr(), Ht2.data_ptr(),
                                    s2.data_ptr(), piv.data_ptr(), B, W, m, n, stream)
    _raise_on(lib, rc, "gf2_eliminate")
    gf2_eliminate_cuda.launches += 1
    return Ht2, s2, piv


gf2_osd0_cuda.launches = 0
gf2_eliminate_cuda.launches = 0
