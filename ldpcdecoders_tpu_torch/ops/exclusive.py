"""Exclusive (leave-one-out) products over a small padded degree axis.

Counterpart of ``ldpcdecoders_tpu/ops/exclusive.py``.  Both helpers are
unrolled left-to-right / right-to-left loops over the degree axis, one
multiply per slot, so each product has the same association order as the
reference package's scans (``jnp.cumprod`` there accumulates left to
right).  ``torch.cumprod`` is not used: it associates differently and
changes results in the last bit, which the bitwise BP parity relies on.
"""

from __future__ import annotations

import torch

__all__ = ["exclusive_prods", "guarded_exclusive_prod_scan"]


def exclusive_prods(x: torch.Tensor, dim: int = -1):
    """Return (fwd, bwd) exclusive cumulative products along ``dim``.

    ``fwd[k] = x[0] * ... * x[k-1]`` accumulated left-to-right;
    ``bwd[k] = x[d-1] * ... * x[k+1]`` accumulated right-to-left.
    """
    d = x.shape[dim]
    slots = x.unbind(dim)
    fwd = [torch.ones_like(slots[0])]
    for k in range(d - 1):
        fwd.append(fwd[-1] * slots[k])
    bwd = [torch.ones_like(slots[0])]
    for k in range(d - 1, 0, -1):
        bwd.append(bwd[-1] * slots[k])
    return torch.stack(fwd, dim), torch.stack(bwd[::-1], dim)


def guarded_exclusive_prod_scan(x: torch.Tensor, init: torch.Tensor, *, dim: int = 1,
                                nan_reset: float = 1.0):
    """Serial exclusive product with the reference's NaN guard.

    A running product that is reset to ``nan_reset`` whenever it becomes
    NaN, forward (seeded with ``init``) and backward (seeded with 1).

    Returns ``(excl, total)``: ``excl`` has ``x``'s shape — the guarded
    product of all factors except the one at that slot; ``total`` is the
    guarded product of all factors, seeded with ``init``.
    """
    slots = x.unbind(dim)
    d = len(slots)
    reset = torch.full_like(init, nan_reset)

    fwd = []
    temp = init
    for k in range(d):
        fwd.append(temp)
        temp = temp * slots[k]
        temp = torch.where(torch.isnan(temp), reset, temp)
    total = temp

    out = [None] * d
    temp = torch.ones_like(init)
    for k in range(d - 1, -1, -1):
        out[k] = fwd[k] * temp
        temp = temp * slots[k]
        temp = torch.where(torch.isnan(temp), reset, temp)
    return torch.stack(out, dim), total
