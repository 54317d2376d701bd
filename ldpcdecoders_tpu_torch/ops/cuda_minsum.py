"""Hand-written CUDA kernels for the min-sum message updates.

Counterpart of ``ldpcdecoders_tpu/ops/pallas_minsum.py``.  The kernels live
in ``csrc/minsum.cu`` (built by ``_build.py``):

  * :func:`minsum_check_cuda` replaces ``check_update_pallas``
    (``_check_kernel``);
  * :func:`minsum_var_cuda` replaces ``var_update_pallas`` (``_var_kernel``).

Each also does the cross-layout gather that precedes its update, reading
the other side's messages through the static index table.  For tensors on
the CPU a wrapper runs its plain torch version (ops/minsum.py); for CUDA
tensors it launches the kernel or raises.  ``<wrapper>.launches`` counts the
kernel launches of each wrapper.
"""

from __future__ import annotations

import torch

from .minsum import BIG, check_core_ref, check_update_ref, var_update_ref

__all__ = ["minsum_check_cuda", "minsum_var_cuda"]

_DTYPES = (torch.float32, torch.bfloat16)
# the padded-slot magnitude rounded to each message dtype, once
_BIG = {dtype: float(torch.tensor(BIG, dtype=dtype)) for dtype in _DTYPES}


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _messages(name, x):
    """Validate a message tensor's device and dtype; True if it is on the CPU."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"expected a CPU or CUDA tensor, got {x.device}")
    return x.device.type == "cpu"


def _launch(fn, what, x, *args):
    """Call a launcher of the kernel library on ``x``'s device and stream."""
    from .._build import load_library

    lib = load_library()  # built and loaded once per process
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):  # the launch goes to the current device
        rc = getattr(lib, fn)(*args, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.ldpc_cuda_error_string(rc).decode()}")


def minsum_check_cuda(x, idx, syn_flip, chk_mask, alpha, beta):
    """Min-sum check update; returns ``mu [B, dc, m]``.

    Args:
      x: with ``idx``, the var-side messages ``[B, dv*n]`` that the kernel
        gathers through the table; with ``idx=None``, the check-slot
        messages ``[B, dc, m]`` themselves.  float32 or bfloat16.
      idx: ``[dc*m]`` int32 table (``c2v`` of ``TannerGraph.slot_major``) or
        None.
      syn_flip: ``[B, m]`` bool syndrome.
      chk_mask: ``[dc, m]`` bool edge-validity mask.
      alpha, beta: normalization factor and offset, floats already rounded
        to the message dtype.
    """
    on_cpu = _messages("x", x)
    dc, m = chk_mask.shape
    if x.ndim != (2 if idx is not None else 3) or (idx is None and x.shape[1:] != (dc, m)):
        raise ValueError(
            f"x must be [B, dv*n] with idx or [B, {dc}, {m}] without, got {tuple(x.shape)}")
    if on_cpu:
        if idx is None:
            return check_core_ref(x, syn_flip, chk_mask, alpha, beta)
        return check_update_ref(x, idx, syn_flip, chk_mask, alpha, beta)
    B = x.shape[0]
    _check("x", x, x.shape, x.dtype, x.device)
    if idx is not None:
        _check("idx", idx, (dc * m,), torch.int32, x.device)
    _check("syn_flip", syn_flip, (B, m), torch.bool, x.device)
    _check("chk_mask", chk_mask, (dc, m), torch.bool, x.device)
    mu = torch.empty((B, dc, m), dtype=x.dtype, device=x.device)
    if B == 0:
        return mu
    _launch("ldpc_minsum_check", "minsum_check", x,
            x.data_ptr(), None if idx is None else idx.data_ptr(), syn_flip.data_ptr(),
            chk_mask.data_ptr(), mu.data_ptr(), B, m, dc, x.numel() // B,
            float(alpha), float(beta), _BIG[x.dtype])
    minsum_check_cuda.launches += 1
    return mu


def minsum_var_cuda(mu_flat, v2c, var_mask, L0, W=None, want_nu=True):
    """Min-sum variable update; returns ``(nu [B, dv, n], total [B, n])``.

    Args:
      mu_flat: check-side messages ``[B, dc*m]``, float32 or bfloat16,
        gathered through ``v2c`` by the kernel.
      v2c: ``[dv*n]`` int32 table (``v2c`` of ``TannerGraph.slot_major``).
      var_mask: ``[dv, n]`` bool edge-validity mask.
      L0: channel LLRs, broadcastable to ``[B, n]``, in the message dtype.
      W: optional ``[dv, n]`` per-edge weights in the message dtype.
      want_nu: with False only ``total`` is computed and ``nu`` is None.
    """
    on_cpu = _messages("mu_flat", mu_flat)
    dv, n = var_mask.shape
    if mu_flat.ndim != 2:
        raise ValueError(f"mu_flat must be [B, dc*m], got {tuple(mu_flat.shape)}")
    if on_cpu:
        return var_update_ref(mu_flat, v2c, var_mask, L0, W, want_nu)
    B, dtype, device = mu_flat.shape[0], mu_flat.dtype, mu_flat.device
    if dv > 1024:  # the kernel sums at most 32 windows of 32 slots
        raise ValueError(f"minsum_var_cuda takes at most 1024 slots a variable, got {dv}")
    if L0.shape != (B, n) or not L0.is_contiguous():
        L0 = torch.broadcast_to(L0, (B, n)).contiguous()
    _check("mu_flat", mu_flat, mu_flat.shape, dtype, device)
    _check("v2c", v2c, (dv * n,), torch.int32, device)
    _check("var_mask", var_mask, (dv, n), torch.bool, device)
    _check("L0", L0, (B, n), dtype, device)
    if W is not None:
        _check("W", W, (dv, n), dtype, device)
    nu = torch.empty((B, dv, n), dtype=dtype, device=device) if want_nu else None
    total = torch.empty((B, n), dtype=dtype, device=device)
    if B == 0:
        return nu, total
    _launch("ldpc_minsum_var", "minsum_var", mu_flat,
            mu_flat.data_ptr(), v2c.data_ptr(), var_mask.data_ptr(), L0.data_ptr(),
            None if W is None else W.data_ptr(), None if nu is None else nu.data_ptr(),
            total.data_ptr(), B, n, dv, mu_flat.shape[1])
    minsum_var_cuda.launches += 1
    return nu, total


minsum_check_cuda.launches = 0
minsum_var_cuda.launches = 0
