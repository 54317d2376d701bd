"""Hand-written CUDA kernels for the min-sum message updates.

Counterpart of ``ldpcdecoders_tpu/ops/pallas_minsum.py``.  The kernels live
in ``csrc/minsum.cu`` (built by ``_build.py``):

  * K3, ``minsum_check_kernel``, replaces ``check_update_pallas``
    (``_check_kernel``).  Two wrappers launch it:
    :func:`minsum_check_cuda` (messages read directly or through an index
    table) and :func:`minsum_check_iter_cuda` (the check layout's iteration:
    the messages rebuilt from the totals and the previous ``mu``, and the
    damping mix, in place).
  * K4, ``minsum_var_kernel``, replaces ``var_update_pallas``
    (``_var_kernel``).  Two wrappers launch it: :func:`minsum_var_cuda`
    (totals and fresh leave-one-out messages) and
    :func:`minsum_var_iter_cuda` (the damping mix in place and the freeze of
    the ``[B, n]`` outputs).

Each gathers the other side's messages through the static index table
itself.  For tensors on the CPU a wrapper runs its plain torch version
(ops/minsum.py); for CUDA tensors it launches the kernel or raises.
``<wrapper>.launches`` counts the kernel launches of each wrapper.

The kernels run each node's loops to its degree: the masks' real slots come
first (codes/graph.py).  ``chk_deg`` / ``var_deg`` pass the degrees
(:func:`ops.minsum.slot_degrees`); without them a wrapper computes and checks
them, which reads the result back to the host.

``lane_tile`` (64 or 128; :func:`minsum_check_cuda` gathered,
:func:`minsum_check_iter_cuda`, and :func:`minsum_var_iter_cuda`) takes
``MinSumDecode``'s state lane-tiled, in either layout: every per-lane
argument in its tiled form ``[B / T, *rest, T]`` (ops/minsum.py
:func:`~ops.minsum.tile_lanes`), B a multiple of T, so that a warp of the
kernels reads 32 lanes of one node (csrc/minsum.cu, "Lane tiles").
:func:`minsum_var_iter_cuda` on tiles takes the check layout's form (no
``nu``: the totals and the freeze) and the variable layout's (``nu`` in
place, with ``W`` and every ``gamma`` kind).  ``<wrapper>.routes`` counts
the launches by layout: ``"lane_major"`` (``lane_tile=1``) and
``"lane_tiled"``, and for :func:`minsum_var_iter_cuda` the variable
layout's form on tiles apart, ``"lane_tiled_nu"``.

In bfloat16 the check wrappers' tiled launches take K3's packed body,
``minsum_check_packed_kernel`` (a thread T / 32 lanes of one check, each
slot's vectors loaded whole): their per-lane tensors must then be aligned to
those vectors (T / 16 bytes), and each launch adds its lanes to the counter
``minsum_check_lane_iters_packed`` (``utils/profiling.count``).
:func:`packed_plan` gives the body's block on the card.
"""

from __future__ import annotations

import torch

from ..utils.profiling import count
from .minsum import (
    BIG,
    check_core_ref,
    check_iter_ref,
    check_update_ref,
    slot_degrees,
    var_iter_ref,
    var_update_ref,
)

__all__ = ["minsum_check_cuda", "minsum_check_iter_cuda", "minsum_var_cuda",
           "minsum_var_iter_cuda", "packed_plan", "stage_plan", "stages_by_default"]

_DTYPES = (torch.float32, torch.bfloat16)
# the padded-slot magnitude rounded to each message dtype, once
_BIG = {dtype: float(torch.tensor(BIG, dtype=dtype)) for dtype in _DTYPES}
# damping kinds of the launchers
_GAMMA_NONE, _GAMMA_LANE, _GAMMA_VAR = 0, 1, 2
# stage argument of the check launchers: where the gathered row fits
_STAGE_AUTO = -1
_MAX_STAGE_THREADS = 1024
_MAX_SMEM = 232448
_SMEM_PER_SM = 233472  # each block reserves 1 KB of it
_STAGE_MIN_ROW = 48 * 1024
# the lane tiles the launchers take (csrc/minsum.cu kTiles) besides 1
LANE_TILES = (64, 128)


def stage_plan(row_bytes: int, m: int, dc: int) -> tuple[int, int]:
    """``(threads, shared-memory bytes)`` of K3's staged form (one block per
    lane, the lane's gathered row of ``row_bytes`` in shared memory beside a
    sign word per 32 slots and thread); 0 threads where it does not fit a
    block and the flat form runs.  Mirrors ``stage_plan`` in csrc/minsum.cu."""
    words = (dc + 31) // 32
    t = min(-(-m // 32) * 32, _MAX_STAGE_THREADS)
    b = row_bytes + 4 * words * t
    while b > _MAX_SMEM and t > 128:
        t = (t // 2 + 31) // 32 * 32
        b = row_bytes + 4 * words * t
    return (t if b <= _MAX_SMEM else 0), b


def stages_by_default(row_bytes: int, m: int, dc: int) -> bool:
    """Whether K3's launcher takes the staged form when the caller leaves it
    the choice: for a row of at least 48 KB where two staged blocks fit an
    SM, the one case it was measured faster (csrc/minsum.cu)."""
    threads, b = stage_plan(row_bytes, m, dc)
    return threads > 0 and row_bytes >= _STAGE_MIN_ROW and 2 * (b + 1024) <= _SMEM_PER_SM


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


def _degrees(name, deg, mask, device):
    """The degrees of ``mask``'s nodes, given (checked for shape) or computed."""
    if deg is None:
        return slot_degrees(mask)
    _check(name, deg, (mask.shape[1],), torch.int32, device)
    return deg


def _gamma(gamma, nu, lanes, n, nu_shape, dtype, device, tail=()):
    """The launchers' (pointer, kind, lane stride) of a damping factor: a
    0-dim tensor (one for every lane), ``[B]`` or ``[B, n]`` (``lanes`` and
    ``tail`` as the state's: ``[B / T, T]``, ``[B / T, n, T]`` lane-tiled);
    damping needs the previous messages ``nu``."""
    if gamma is None:
        return None, _GAMMA_NONE, 0
    if nu is None:
        raise ValueError("damping needs the previous messages nu")
    _check("nu", nu, nu_shape, dtype, device)
    kinds = {(): (_GAMMA_LANE, 0), (lanes, *tail): (_GAMMA_LANE, 1),
             (lanes, n, *tail): (_GAMMA_VAR, n)}
    kind = kinds.get(tuple(gamma.shape))
    if kind is None:
        raise ValueError(f"gamma must be 0-dim, [B] or [B, n] (lane-tiled as the state), got "
                         f"{tuple(gamma.shape)}")
    _check("gamma", gamma, gamma.shape, dtype, device)
    return (gamma.data_ptr(), *kind)


def _tail(lane_tile):
    """Validate ``lane_tile``; the trailing dimension it adds to every
    per-lane tensor: ``()`` for 1, ``(T,)`` for a tile."""
    if lane_tile != 1 and lane_tile not in LANE_TILES:
        raise ValueError(f"lane_tile must be 1 or one of {LANE_TILES}, got {lane_tile}")
    return () if lane_tile == 1 else (lane_tile,)


def _count(wrapper, lane_tile, tiled_route="lane_tiled"):
    wrapper.launches += 1
    wrapper.routes["lane_major" if lane_tile == 1 else tiled_route] += 1


def _packed(dtype, lane_tile, *tensors):
    """Whether a check launch takes the packed body (bfloat16 on a tile);
    if so, ``tensors`` (None and 0-dim skipped) must be aligned to its
    vectors of T / 32 lanes."""
    if dtype != torch.bfloat16 or lane_tile == 1:
        return False
    size = 2 * lane_tile // 32
    if any(t.data_ptr() % size for t in tensors if t is not None and t.ndim > 0):
        raise ValueError(f"bfloat16 lane-tiled check arguments must be {size}-byte aligned")
    return True


def packed_plan(dc: int, lane_tile: int, *, gathered: bool = False,
                gamma_kind: int = _GAMMA_NONE) -> dict:
    """The packed check body's block on the current card for checks of
    ``dc`` slots: ``threads``, ``smem_bytes``, ``registers`` a thread and
    ``blocks_per_sm``; ``gathered`` the GATHER form, else the iteration
    form with damping kind ``gamma_kind`` (0 none, 1 per lane, 2 per
    variable)."""
    import ctypes

    from .._build import load_library

    lib = load_library()
    out = (ctypes.c_int * 4)()
    rc = lib.ldpc_minsum_packed_plan(dc, lane_tile, 1 if gathered else 2, gamma_kind, out)
    if rc != 0:
        raise RuntimeError(f"packed plan failed: {lib.ldpc_cuda_error_string(rc).decode()}")
    return dict(zip(("threads", "smem_bytes", "registers", "blocks_per_sm"), out))


def _launch(fn, what, x, *args):
    """Call a launcher of the kernel library on ``x``'s device and stream."""
    from .._build import load_library

    lib = load_library()  # built and loaded once per process
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):  # the launch goes to the current device
        rc = getattr(lib, fn)(*args, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.ldpc_cuda_error_string(rc).decode()}")


def _stage_arg(_stage):
    return _STAGE_AUTO if _stage is None else int(bool(_stage))


def minsum_check_cuda(x, idx, syn_flip, chk_mask, alpha, beta, *, chk_deg=None, _stage=None,
                      lane_tile=1):
    """Min-sum check update; returns ``mu [B, dc, m]`` (every slot written).

    Args:
      x: with ``idx``, the messages ``[B, stride]`` that the kernel gathers
        through the table (the variable layout's ``nu [B, dv*n]``, or the
        check layout's first iteration, ``L0 [B, n]`` through the check
        slots' variables); with ``idx=None``, the check-slot messages
        ``[B, dc, m]`` themselves.  float32 or bfloat16.
      idx: ``[dc*m]`` int32 table into a lane's row of ``x`` (``c2v`` of
        ``TannerGraph.slot_major``, or the check slots' variables) or None.
      syn_flip: ``[B, m]`` bool syndrome.
      chk_mask: ``[dc, m]`` bool edge-validity mask, real slots first.
      alpha, beta: normalization factor and offset, floats already rounded
        to the message dtype.
      chk_deg: ``[m]`` int32 degrees of the checks (computed when None).
      _stage: None leaves the launcher the choice (:func:`stages_by_default`:
        the gathered row staged in shared memory where it is at least 48 KB
        and two such blocks fit an SM); True / False force the staged /
        flat form.
      lane_tile: 1, or (with ``idx``) 64 / 128: ``x``, ``syn_flip`` and the
        returned ``mu`` in their lane-tiled forms (the flat form).
    """
    on_cpu = _messages("x", x)
    tail = _tail(lane_tile)
    dc, m = chk_mask.shape
    if tail and idx is None:
        raise ValueError("lane tiles take the gathered form (idx) only")
    if (x.ndim != (2 if idx is not None else 3) + len(tail) or x.shape[x.ndim - len(tail):] != tail
            or (idx is None and x.shape[1:] != (dc, m))):
        raise ValueError(
            f"x must be [B, stride] with idx or [B, {dc}, {m}] without (lane-tiled "
            f"[B / T, stride, T]), got {tuple(x.shape)}")
    if on_cpu:
        if idx is None:
            return check_core_ref(x, syn_flip, chk_mask, alpha, beta)
        return check_update_ref(x, idx, syn_flip, chk_mask, alpha, beta, lane_tile)
    if tail and _stage:
        raise ValueError("the staged form takes lane_tile=1")
    lanes = x.shape[0]  # lanes, or tiles of lane_tile
    _check("x", x, x.shape, x.dtype, x.device)
    if idx is not None:
        _check("idx", idx, (dc * m,), torch.int32, x.device)
    _check("syn_flip", syn_flip, (lanes, m, *tail), torch.bool, x.device)
    _check("chk_mask", chk_mask, (dc, m), torch.bool, x.device)
    deg = _degrees("chk_deg", chk_deg, chk_mask, x.device)
    mu = torch.empty((lanes, dc, m, *tail), dtype=x.dtype, device=x.device)
    packed = _packed(x.dtype, lane_tile, x)
    if lanes == 0:
        return mu
    B = lanes * lane_tile
    _launch("ldpc_minsum_check", "minsum_check", x,
            x.data_ptr(), None if idx is None else idx.data_ptr(), syn_flip.data_ptr(),
            deg.data_ptr(), mu.data_ptr(), B, m, dc, x.numel() // B,
            float(alpha), float(beta), _BIG[x.dtype], _stage_arg(_stage), lane_tile)
    _count(minsum_check_cuda, lane_tile)
    if packed:
        count("minsum_check_lane_iters_packed", B)
    return mu


def minsum_check_iter_cuda(mu, total, chk_varidx, syn_flip, chk_mask, alpha, beta, *,
                           gamma=None, nu=None, chk_deg=None, _stage=None, lane_tile=1):
    """The check layout's min-sum iteration, from the second on, in place;
    returns ``mu``.

    Each real slot's message is rebuilt as ``total[var] - mu`` and, with
    ``gamma``, mixed with the previous message: ``g * nu + (1 - g) *
    new``; then the check update writes the new ``mu`` over the old.

    Args:
      mu: ``[B, dc, m]`` the previous check->variable messages; receives
        the new ones on the real slots.  float32 or bfloat16.
      total: ``[B, n]`` the previous iteration's totals, in ``mu``'s dtype.
      chk_varidx: ``[dc*m]`` int32, the variable of each check slot.
      syn_flip, chk_mask, alpha, beta, chk_deg, _stage: as
        :func:`minsum_check_cuda`.
      gamma: None, or the damping factor in ``mu``'s dtype: 0-dim (every
        lane), ``[B]`` (per lane) or ``[B, n]`` (per variable, read through
        ``chk_varidx``).
      nu: with ``gamma``, ``[B, dc, m]`` the previous variable->check
        messages; receives the mixed ones on the real slots.
      lane_tile: 1, or 64 / 128: every per-lane argument in its lane-tiled
        form (``mu [B / T, dc, m, T]``, ``total [B / T, n, T]``, ...; the flat
        form).
    """
    on_cpu = _messages("mu", mu)
    tail = _tail(lane_tile)
    dc, m = chk_mask.shape
    if mu.shape[1:] != (dc, m, *tail) or total.ndim != 2 + len(tail):
        raise ValueError(f"mu must be [B, {dc}, {m}] and total [B, n] (lane-tiled "
                         f"[B / T, ..., T]), got {tuple(mu.shape)} and {tuple(total.shape)}")
    if (nu is None) != (gamma is None):
        raise ValueError("the check layout keeps nu exactly when it damps (gamma)")
    if on_cpu:
        return check_iter_ref(mu, total, chk_varidx, syn_flip, chk_mask, alpha, beta, gamma, nu,
                              lane_tile)
    if tail and _stage:
        raise ValueError("the staged form takes lane_tile=1")
    (lanes, n), dtype, device = total.shape[:2], mu.dtype, mu.device
    _check("mu", mu, (lanes, dc, m, *tail), dtype, device)
    _check("total", total, (lanes, n, *tail), dtype, device)
    _check("chk_varidx", chk_varidx, (dc * m,), torch.int32, device)
    _check("syn_flip", syn_flip, (lanes, m, *tail), torch.bool, device)
    _check("chk_mask", chk_mask, (dc, m), torch.bool, device)
    deg = _degrees("chk_deg", chk_deg, chk_mask, device)
    g_ptr, g_kind, g_stride = _gamma(gamma, nu, lanes, n, (lanes, dc, m, *tail), dtype, device,
                                     tail)
    packed = _packed(dtype, lane_tile, mu, nu, total, gamma)
    if lanes == 0:
        return mu
    _launch("ldpc_minsum_check_iter", "minsum_check_iter", mu,
            mu.data_ptr(), None if nu is None else nu.data_ptr(), total.data_ptr(),
            chk_varidx.data_ptr(), syn_flip.data_ptr(), deg.data_ptr(), g_ptr, g_kind,
            g_stride, lanes * lane_tile, m, dc, n, float(alpha), float(beta), _BIG[dtype],
            _stage_arg(_stage), lane_tile)
    _count(minsum_check_iter_cuda, lane_tile)
    if packed:
        count("minsum_check_lane_iters_packed", lanes * lane_tile)
    return mu


def _var_common(mu_flat, v2c, var_mask, L0, W, var_deg, tail=()):
    """Shared validation of the two variable-update wrappers (CUDA tensors);
    returns ``(B, dv, n, L0, deg)`` with ``L0`` made ``[B, n]`` (``B`` the
    tiles and ``L0`` as given where lane-tiled)."""
    dv, n = var_mask.shape
    B, dtype, device = mu_flat.shape[0], mu_flat.dtype, mu_flat.device
    if dv > 1024:  # the kernel sums at most 32 windows of 32 slots
        raise ValueError(f"the min-sum variable kernel takes at most 1024 slots a variable, "
                         f"got {dv}")
    if not tail and (L0.shape != (B, n) or not L0.is_contiguous()):
        L0 = torch.broadcast_to(L0, (B, n)).contiguous()
    _check("mu_flat", mu_flat, mu_flat.shape, dtype, device)
    _check("v2c", v2c, (dv * n,), torch.int32, device)
    _check("var_mask", var_mask, (dv, n), torch.bool, device)
    _check("L0", L0, (B, n, *tail), dtype, device)
    if W is not None:
        _check("W", W, (dv, n), dtype, device)
    return B, dv, n, L0, _degrees("var_deg", var_deg, var_mask, device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def minsum_var_cuda(mu_flat, v2c, var_mask, L0, W=None, want_nu=True, *, var_deg=None):
    """Min-sum variable update; returns ``(nu [B, dv, n], total [B, n])``.

    Args:
      mu_flat: check-side messages ``[B, dc*m]``, float32 or bfloat16,
        gathered through ``v2c`` by the kernel.
      v2c: ``[dv*n]`` int32 table (``v2c`` of ``TannerGraph.slot_major``).
      var_mask: ``[dv, n]`` bool edge-validity mask, real slots first.
      L0: channel LLRs, broadcastable to ``[B, n]``, in the message dtype.
      W: optional ``[dv, n]`` per-edge weights in the message dtype.
      want_nu: with False only ``total`` is computed and ``nu`` is None.
      var_deg: ``[n]`` int32 degrees of the variables (computed when None).
    """
    on_cpu = _messages("mu_flat", mu_flat)
    if mu_flat.ndim != 2:
        raise ValueError(f"mu_flat must be [B, dc*m], got {tuple(mu_flat.shape)}")
    if on_cpu:
        return var_update_ref(mu_flat, v2c, var_mask, L0, W, want_nu)
    B, dv, n, L0, deg = _var_common(mu_flat, v2c, var_mask, L0, W, var_deg)
    dtype, device = mu_flat.dtype, mu_flat.device
    nu = torch.empty((B, dv, n), dtype=dtype, device=device) if want_nu else None
    total = torch.empty((B, n), dtype=dtype, device=device)
    if B == 0:
        return nu, total
    _launch("ldpc_minsum_var", "minsum_var", mu_flat,
            mu_flat.data_ptr(), v2c.data_ptr(), deg.data_ptr(), L0.data_ptr(), _ptr(W),
            _ptr(nu), int(want_nu), None, _GAMMA_NONE, 0, total.data_ptr(), None, None, None,
            B, n, dv, mu_flat.shape[1], 1)
    _count(minsum_var_cuda, 1)
    return nu, total


def minsum_var_iter_cuda(mu_flat, v2c, var_mask, L0, *, W=None, nu=None, gamma=None,
                         total=None, done=None, err=None, llrs=None, var_deg=None, lane_tile=1):
    """The variable update of a min-sum iteration, in place; returns
    ``total``.

    Args:
      mu_flat, v2c, var_mask, L0, W, var_deg: as :func:`minsum_var_cuda`.
      nu: None, or ``[B, dv, n]`` the previous variable->check messages
        (the variable layout); receives ``total - msg`` on the real slots,
        mixed with the previous messages by ``gamma`` where given (0-dim,
        ``[B]`` or ``[B, n]``, in the message dtype).
      total: None, or ``[B, n]`` that receives ``L0 + sum``.
      done: None, or ``[B]`` bool with ``err [B, n]`` float32 and ``llrs
        [B, n]`` in the message dtype: the lanes not done take
        ``err = total < 0`` and ``llrs = total`` (``llrs`` must not alias
        ``L0``).
      lane_tile: 1, or 64 / 128: ``mu_flat [B / T, dc*m, T]``, ``L0``,
        ``total``, ``err`` and ``llrs [B / T, n, T]``, ``done [B / T, T]``,
        ``nu [B / T, dv, n, T]``, ``gamma`` ``[B / T, T]`` or ``[B / T, n,
        T]`` (0-dim as it is); ``W`` only with ``nu`` (the variable
        layout's form).  The kernel loads and stores a thread's T / 32
        lanes as one vector, so ``mu_flat``, ``L0``, ``total``, ``nu`` and a
        ``[B, n]`` ``gamma`` must be 16-byte aligned.
    """
    on_cpu = _messages("mu_flat", mu_flat)
    tail = _tail(lane_tile)
    if mu_flat.ndim != 2 + len(tail) or mu_flat.shape[2:] != tail:
        raise ValueError(f"mu_flat must be [B, dc*m] (lane-tiled [B / T, dc*m, T]), got "
                         f"{tuple(mu_flat.shape)}")
    if (done is None) != (err is None) or (done is None) != (llrs is None):
        raise ValueError("done, err and llrs go together")
    if tail and nu is None and W is not None:
        raise ValueError("lane tiles take W with nu only (the variable layout's form)")
    if on_cpu:
        return var_iter_ref(mu_flat, v2c, var_mask, L0, W=W, nu=nu, gamma=gamma, total=total,
                            done=done, err=err, llrs=llrs, lane_tile=lane_tile)
    B, dv, n, L0, deg = _var_common(mu_flat, v2c, var_mask, L0, W, var_deg, tail)
    dtype, device = mu_flat.dtype, mu_flat.device
    g_ptr, g_kind, g_stride = _gamma(gamma, nu, B, n, (B, dv, n, *tail), dtype, device, tail)
    if nu is not None:
        _check("nu", nu, (B, dv, n, *tail), dtype, device)
    if total is not None:
        _check("total", total, (B, n, *tail), dtype, device)
    if done is not None:
        _check("done", done, (B, *tail), torch.bool, device)
        _check("err", err, (B, n, *tail), torch.float32, device)
        _check("llrs", llrs, (B, n, *tail), dtype, device)
        if llrs.data_ptr() == L0.data_ptr():
            raise ValueError("llrs must not alias L0")
    if tail and any(t.data_ptr() % 16 for t in (mu_flat, L0, total, nu, gamma)
                    if t is not None and t.ndim > 0):
        raise ValueError("lane-tiled mu_flat, L0, total, nu and gamma must be 16-byte aligned")
    if B == 0:
        return total
    _launch("ldpc_minsum_var", "minsum_var_iter", mu_flat,
            mu_flat.data_ptr(), v2c.data_ptr(), deg.data_ptr(), L0.data_ptr(), _ptr(W),
            _ptr(nu), 0 if nu is None else 2, g_ptr, g_kind, g_stride, _ptr(total),
            _ptr(done), _ptr(err), _ptr(llrs), B * lane_tile, n, dv, mu_flat.shape[1],
            lane_tile)
    _count(minsum_var_iter_cuda, lane_tile, "lane_tiled" if nu is None else "lane_tiled_nu")
    return total


for _wrapper in (minsum_check_cuda, minsum_check_iter_cuda, minsum_var_cuda,
                 minsum_var_iter_cuda):
    _wrapper.launches = 0
    _wrapper.routes = {"lane_major": 0, "lane_tiled": 0}
minsum_var_iter_cuda.routes["lane_tiled_nu"] = 0
del _wrapper
