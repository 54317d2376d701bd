"""Plain torch versions of the min-sum message updates.

These are the functions the two min-sum kernels compute
(``csrc/minsum.cu``, wrapped in ops/cuda_minsum.py), written with the
rounding points and reduction orders of the reference package's default
path (``ldpcdecoders_tpu/models/minsum.py`` ``check_core`` /
``var_update``), so that the CPU, the card and the kernels agree bit for
bit:

  * check update: padded slots read as ``+BIG``; the leave-one-out minimum
    is ``min2`` at a unique minimum slot and ``min1`` elsewhere (equal to
    the two-minimum sweep with first-minimum ties); signs combine by XOR
    parity with the syndrome; ``alpha * excl`` and ``- beta`` round
    separately (no fused multiply-add);
  * variable update: masked messages (optionally weighted) are summed in
    float32 starting from 0 in the reference's order (:func:`slot_sum`:
    slot by slot up to 32 slots; past that by windows of 32 slots, as XLA
    on the CPU reduces them), the sum is rounded to the message dtype
    once, then ``total = L0 + sum`` and ``nu = total - msg`` each round to
    the message dtype.  The sum takes the float32 products
    ``msg * W`` (exact for bfloat16 factors), as the reference's compiled
    program does; ``nu`` subtracts the product rounded to the message
    dtype.

Messages are slot-major ``[B, slot, node]``; the ``*_update_ref`` forms
take the other side's flattened messages and gather through the static
tables of codes/graph.py first.

The ``*_iter_ref`` forms are one min-sum iteration of the reference's
``decode`` / ``decode_check`` bodies around the two updates, in the order
the reference computes it, updating their state in place as the kernels do:

  * :func:`check_iter_ref`, the check layout from the second iteration on:
    the rebuild ``total[var] - mu``, the damping mix
    ``g * nu + (1 - g) * new`` (``g`` a scalar, per lane ``[B]`` or per
    variable ``[B, n]``), then the check update;
  * :func:`var_iter_ref`: the variable update's ``total``, the
    leave-one-out messages mixed with the previous ones by the damping
    factor (the variable layout), and the freeze of ``err`` / ``llrs`` on
    the lanes not yet done.

The kernels update the real slots only; a padded slot's value is never read.

Lane tiles.  The check layout's state may be lane-tiled (``lane_tile`` T of
64 or 128, :func:`tile_lanes`): the tiled form of a ``[B, *rest]``
tensor is ``[B / T, *rest, T]``, the lanes padded to a multiple of T, so
that the kernels' warps read the lanes of one node at once.  ``check_update_ref``,
``check_iter_ref`` and ``var_iter_ref`` take ``lane_tile``: the tiled form
is the plain version between an un-tile and a re-tile, so it is the
``lane_tile=1`` form bit for bit.  T = 1 is the untiled tensor itself.
:func:`gather_lanes_ref` takes some of a tiled tensor's lanes into another
tiling (the min-sum loop's compaction, on the CPU and on a card).
"""

from __future__ import annotations

import torch

__all__ = [
    "BIG",
    "check_core_ref",
    "var_core_ref",
    "check_update_ref",
    "var_update_ref",
    "check_iter_ref",
    "var_iter_ref",
    "slot_degrees",
    "slot_sum",
    "tile_lanes",
    "untile_lanes",
    "gather_lanes_ref",
]

#: magnitude a padded check slot reads as (positive, so inert in the parity)
BIG = 1e30
#: slots summed one by one before the sum goes by windows
SLOT_WINDOW = 32


def slot_sum(prod: torch.Tensor) -> torch.Tensor:
    """``prod [B, dv, n]`` float32 summed over the slot axis in the order of
    the reference's ``jnp.sum`` (XLA on the CPU, op by op).  Up to
    :data:`SLOT_WINDOW` slots: one by one from 0.  Past that: padded to a
    multiple of 32 slots, half of the padding (rounded down) before slot 0
    and the rest after the last, each window of 32 summed one by one from
    0, then the window sums summed the same way (recursively)."""
    dv = prod.shape[1]
    if dv <= SLOT_WINDOW:
        acc = torch.zeros((prod.shape[0], prod.shape[2]), dtype=prod.dtype,
                          device=prod.device)
        for k in range(dv):
            acc = acc + prod[:, k]
        return acc
    p = -(-dv // SLOT_WINDOW)
    low = (p * SLOT_WINDOW - dv) // 2
    parts = [slot_sum(prod[:, max(0, w * SLOT_WINDOW - low):(w + 1) * SLOT_WINDOW - low])
             for w in range(p)]
    return slot_sum(torch.stack(parts, dim=1))


def check_core_ref(Ng, syn_flip, chk_mask, alpha, beta):
    """Check-slot messages ``Ng [B, dc, m]`` -> ``mu [B, dc, m]``.

    Args:
      Ng: var->check messages in check-slot layout.
      syn_flip: ``[B, m]`` bool syndrome.
      chk_mask: ``[dc, m]`` bool edge-validity mask.
      alpha, beta: normalization factor and offset (floats already rounded
        to the message dtype).
    """
    big = torch.tensor(BIG, dtype=Ng.dtype, device=Ng.device)
    masked = torch.where(chk_mask, Ng, big)
    mag = masked.abs()
    neg = masked < 0
    min1 = mag.amin(dim=1, keepdim=True)
    eq1 = mag == min1
    unique = eq1.sum(dim=1, keepdim=True) == 1
    min2 = torch.where(eq1, big, mag).amin(dim=1, keepdim=True)
    parity = (neg.sum(dim=1, keepdim=True) & 1).to(torch.bool)
    excl = torch.where(eq1 & unique, min2, min1)
    flip = parity ^ neg ^ syn_flip[:, None, :]
    mag_out = torch.clamp_min(alpha * excl - beta, 0.0)
    return torch.where(flip, -mag_out, mag_out)


def var_core_ref(Mg, var_mask, L0, W=None, want_nu=True):
    """Var-slot messages ``Mg [B, dv, n]`` -> ``(nu [B, dv, n], total [B, n])``.

    ``L0`` is the channel LLR, broadcastable to ``[B, n]``; ``W [dv, n]``
    optionally weights each incoming message.  With ``want_nu=False`` only
    ``total`` is computed and ``nu`` is None.
    """
    dtype = Mg.dtype
    Mg = torch.where(var_mask, Mg, torch.zeros((), dtype=dtype, device=Mg.device))
    prod = Mg.to(torch.float32)
    if W is not None:
        prod = prod * W.to(dtype).to(torch.float32)
        Mg = prod.to(dtype)
    total = L0 + slot_sum(prod).to(dtype)
    nu = total[:, None, :] - Mg if want_nu else None
    return nu, total


def tile_lanes(x: torch.Tensor, lane_tile: int, fill=0) -> torch.Tensor:
    """``x [B, *rest]`` -> ``[ceil(B / T), *rest, T]``, contiguous, the lanes
    past B set to ``fill``; ``x`` itself for T = 1."""
    if lane_tile == 1:
        return x
    B, rest = x.shape[0], tuple(x.shape[1:])
    bt = -(-B // lane_tile)
    if bt * lane_tile != B:
        pad = torch.full((bt * lane_tile - B, *rest), fill, dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad])
    return x.reshape(bt, lane_tile, *rest).movedim(1, -1).contiguous()


def untile_lanes(x: torch.Tensor, lane_tile: int) -> torch.Tensor:
    """``x [Bt, *rest, T]`` -> ``[Bt * T, *rest]`` (the padded lanes last),
    contiguous; ``x`` itself for T = 1."""
    if lane_tile == 1:
        return x
    return x.movedim(-1, 1).reshape(x.shape[0] * lane_tile, *x.shape[1:-1]).contiguous()


def gather_lanes_ref(x: torch.Tensor, lane_tile: int, lane_tile_out: int,
                     lanes: torch.Tensor) -> torch.Tensor:
    """The lanes ``lanes`` (indices into the lanes of ``x``, a multiple of
    ``lane_tile_out`` of them) of the tiled ``x [bt, *rest, T]`` (T = 1:
    ``[B, *rest]``), tiled by ``lane_tile_out``: ``[len(lanes) / T2, *rest,
    T2]``.  Between tilings, an indexed copy into ``[*rest, bt2, T2]`` (two
    index tensors of ``[bt2, T2]``: a card materializes no index of the
    state's size) and one transposing copy."""
    T, T2 = lane_tile, lane_tile_out
    if T == 1 and T2 == 1:
        return x.index_select(0, lanes)
    rest = x.shape[1:-1] if T > 1 else x.shape[1:]
    R, bt2 = rest.numel(), lanes.shape[0] // T2
    tile, lane = (lanes // T).view(bt2, T2), (lanes % T).view(bt2, T2)
    y = x.reshape(x.shape[0], R, T).transpose(0, 1)[:, tile, lane].transpose(0, 1).contiguous()
    return y.reshape(bt2, *rest, T2) if T2 > 1 else y.reshape(bt2, *rest)


def _untiled(lane_tile, *tensors):
    """Each per-lane tensor's untiled form (None and 0-dim as they are)."""
    return [t if t is None or t.ndim == 0 else untile_lanes(t, lane_tile) for t in tensors]


def check_update_ref(nu_flat, c2v, syn_flip, chk_mask, alpha, beta, lane_tile=1):
    """Var-side ``nu_flat [B, dv*n]`` -> check-side ``mu [B, dc, m]`` (their
    tiled forms with ``lane_tile``)."""
    if lane_tile > 1:
        nu_u, syn_u = _untiled(lane_tile, nu_flat, syn_flip)
        return tile_lanes(check_update_ref(nu_u, c2v, syn_u, chk_mask, alpha, beta), lane_tile)
    dc, m = chk_mask.shape
    Ng = nu_flat.index_select(1, c2v).reshape(nu_flat.shape[0], dc, m)
    return check_core_ref(Ng, syn_flip, chk_mask, alpha, beta)


def var_update_ref(mu_flat, v2c, var_mask, L0, W=None, want_nu=True):
    """Check-side ``mu_flat [B, dc*m]`` -> ``(nu [B, dv, n], total [B, n])``."""
    dv, n = var_mask.shape
    Mg = mu_flat.index_select(1, v2c).reshape(mu_flat.shape[0], dv, n)
    return var_core_ref(Mg, var_mask, L0, W, want_nu)


def slot_degrees(mask: torch.Tensor) -> torch.Tensor:
    """Real slots of each node, ``[node]`` int32, of a ``[slot, node]`` mask
    whose real slots come first (as codes/graph.py lays them out: the
    kernels run each node's loops to its degree); raises otherwise."""
    deg = mask.sum(dim=0, dtype=torch.int32)
    prefix = torch.arange(mask.shape[0], device=mask.device)[:, None] < deg
    if not torch.equal(mask, prefix):
        raise ValueError("the min-sum kernels take masks whose real slots come first "
                         "(codes/graph.py's layout)")
    return deg


def _gamma_like(gamma, B, shape_one, per_var):
    """The damping factor broadcast as the reference broadcasts it: a
    0-dim tensor as it is, ``[B]`` per lane, ``[B, n]`` through ``per_var``."""
    if gamma.ndim == 0:
        return gamma
    if gamma.ndim == 1:
        return gamma.reshape(B, *shape_one)
    return per_var(gamma)


def check_iter_ref(mu, total, chk_varidx, syn_flip, chk_mask, alpha, beta, gamma=None,
                   nu=None, lane_tile=1):
    """The check layout's iteration, in place; returns ``mu``.

    ``mu [B, dc, m]`` holds the previous check->variable messages and
    receives the new ones; ``total [B, n]`` the previous totals;
    ``chk_varidx [dc*m]`` the variable of each check slot.  The message of a
    slot is ``total[var] - mu``; with ``gamma`` (the message dtype: 0-dim,
    ``[B]`` or ``[B, n]``) it is mixed with ``nu [B, dc, m]``, the previous
    messages, which receives the mix.  With ``lane_tile`` every per-lane
    tensor is in its tiled form.
    """
    if lane_tile > 1:
        mu_u, total_u, syn_u, gamma_u, nu_u = _untiled(lane_tile, mu, total, syn_flip, gamma, nu)
        check_iter_ref(mu_u, total_u, chk_varidx, syn_u, chk_mask, alpha, beta, gamma_u, nu_u)
        mu.copy_(tile_lanes(mu_u, lane_tile))
        if nu is not None:
            nu.copy_(tile_lanes(nu_u, lane_tile))
        return mu
    B, dc, m = mu.shape
    new = total.index_select(1, chk_varidx).reshape(B, dc, m) - mu
    if gamma is not None:
        g = _gamma_like(gamma, B, (1, 1), lambda t: t.index_select(1, chk_varidx).reshape(
            B, dc, m))
        new = g * nu + (1.0 - g) * new
        nu.copy_(new)
    mu.copy_(check_core_ref(new, syn_flip, chk_mask, alpha, beta))
    return mu


def var_iter_ref(mu_flat, v2c, var_mask, L0, *, W=None, nu=None, gamma=None, total=None,
                 done=None, err=None, llrs=None, lane_tile=1):
    """The variable update of an iteration, in place; returns ``total``.

    ``total [B, n]``, where given, receives ``L0 + sum``.  ``nu [B, dv, n]``,
    where given, holds the previous variable->check messages and receives
    ``total - msg``, mixed with them by ``gamma`` (0-dim, ``[B]`` or
    ``[B, n]``) where given.  With ``done [B]`` the lanes not done take
    ``err = total < 0`` (float32) and ``llrs = total``.  With ``lane_tile``
    every per-lane tensor is in its tiled form (``L0`` too, not broadcast).
    """
    if lane_tile > 1:
        per_lane = dict(nu=nu, gamma=gamma, total=total, done=done, err=err, llrs=llrs)
        untiled = dict(zip(per_lane, _untiled(lane_tile, *per_lane.values())))
        mu_u, L0_u = _untiled(lane_tile, mu_flat, L0)
        var_iter_ref(mu_u, v2c, var_mask, L0_u, W=W, **untiled)
        for name in ("nu", "total", "err", "llrs"):
            if per_lane[name] is not None:
                per_lane[name].copy_(tile_lanes(untiled[name], lane_tile))
        return total
    new, tot = var_update_ref(mu_flat, v2c, var_mask, L0, W, nu is not None)
    if nu is not None:
        if gamma is not None:
            B, _, n = nu.shape
            g = _gamma_like(gamma, B, (1, 1), lambda t: t.reshape(B, 1, n))
            new = g * nu + (1.0 - g) * new
        nu.copy_(new)
    if total is not None:
        total.copy_(tot)
    if done is not None:
        active = ~done[:, None]
        err.copy_(torch.where(active, (tot < 0).to(torch.float32), err))
        llrs.copy_(torch.where(active, tot, llrs))
    return total
