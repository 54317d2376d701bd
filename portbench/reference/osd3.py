"""OSD-CS with the triple sweep, in plain torch.

For one lane: a 0/1 matrix ``M [m, n]``, a syndrome ``s``, a hard decision
``bp [n]`` and a column order (most reliable first).  The information set,
the base solution and the scan order are ``reference.osd``'s (its
elimination is reused as it is); the sweep goes one order further:

  * every non-pivot column ``c`` in scan order has its unique
    representation ``w_c`` in the pivot columns; flipping a set ``F`` of
    non-pivot columns flips them and the pivot columns of the XOR of their
    ``w_c``, so the change of Hamming weight is the sum over ``F`` of
    ``1 - 2 bp[c]`` plus, over the pivot columns, ``1 - 2 x`` where the
    XOR is 1 (``x`` the base solution there);
  * singles run over every non-pivot column, pairs ``i < j`` over the first
    ``lam`` of them and triples ``i < j < k`` over the first ``lam3`` of
    them, each family in lexicographic order of scan positions; the first
    least change wins each family;
  * a triple is taken where its change is negative and below both the best
    pair's and the best single's; else a pair where negative and below the
    best single; else a single where negative; else the base solution.

With ``lam3`` below 3 there is no triple and this is ``reference.osd``'s
OSD-CS.  Weights are counted in float32 sums of +-1: exact.
"""

from __future__ import annotations

import itertools

import torch

from .osd import _eliminate, _pack, _unpack

__all__ = ["osd_cs"]


def _best(deltas: torch.Tensor):
    """``(index of the first least entry, its value)``, ``(-1, inf)`` if empty."""
    if deltas.numel() == 0:
        return -1, float("inf")
    j = int(torch.argmin(deltas))
    return j, float(deltas[j])


def _sweep(Wb: torch.Tensor, xp: torch.Tensor, bp_scan: torch.Tensor, npos: torch.Tensor,
           lam: int, lam3: int) -> list[int]:
    """The scan positions to flip for one lane: ``Wb [rank, n]`` bool the
    pivot rows' bits by scan position, ``xp [rank]`` the base solution on
    the pivot columns, ``bp_scan [n]`` the hard decision by scan position,
    ``npos`` the non-pivot scan positions in order."""
    s = (1 - 2 * xp).to(torch.float32)  # +1 where a flip adds weight
    W = Wb[:, npos]  # [rank, n_np]: w_c, non-pivots in scan order
    own = (1 - 2 * bp_scan[npos]).to(torch.float32)

    def change(*cols):
        flip = W[:, cols[0]]
        for c in cols[1:]:
            flip = flip ^ W[:, c]
        return sum(own[c] for c in cols) + s @ flip.to(torch.float32)

    j1, best1 = _best(change(torch.arange(npos.numel(), device=W.device)))
    families = [([j1], best1)]
    for order, width in ((2, lam), (3, lam3)):
        k = min(width, npos.numel())
        combos = list(itertools.combinations(range(k), order))
        if not combos:
            families.append(([], float("inf")))
            continue
        idx = torch.tensor(combos, device=W.device).T  # [order, T], lexicographic
        j, best = _best(change(*idx))
        families.append((idx[:, j].tolist(), best))
    (one, best1), (two, best2), (three, best3) = families
    if best3 < 0 and best3 < best2 and best3 < best1:
        return [int(npos[c]) for c in three]
    if best2 < 0 and best2 < best1:
        return [int(npos[c]) for c in two]
    if best1 < 0:
        return [int(npos[one[0]])]
    return []


def osd_cs(M: torch.Tensor, syn: torch.Tensor, bp: torch.Tensor, order: torch.Tensor,
           lam: int, lam3: int):
    """OSD-CS with triples of ``L`` lanes.

    ``M [m, n]`` 0/1, ``syn [L, m]``, ``bp [L, n]`` 0/1 and ``order [L, n]``
    (column indices, most reliable first), all on one device.  Returns
    ``(out [L, n] uint8, consistent [L] bool)``.
    """
    m, n = M.shape
    L = syn.shape[0]
    dev = M.device
    if L == 0:
        return torch.zeros((0, n), dtype=torch.uint8, device=dev), torch.zeros(
            0, dtype=torch.bool, device=dev)
    # residual of the hard decision: r = s + M bp (float32 sums of 0/1: exact)
    r = (torch.remainder(bp.to(torch.float32) @ M.to(torch.float32).T, 2.0) != 0) ^ syn.to(
        torch.bool)
    Mb = M.to(torch.bool)
    P = torch.stack([_pack(Mb[:, order[l]]) for l in range(L)])  # [L, m, w]
    piv_col = _eliminate(P, r, n)
    outs = torch.empty((L, n), dtype=torch.uint8, device=dev)
    consistent = ~((piv_col < 0) & r).any(dim=1)
    for l in range(L):
        rows = torch.nonzero(piv_col[l] >= 0)[:, 0]
        pos = piv_col[l][rows]  # scan positions of the pivots
        Wb = _unpack(P[l, rows], n)  # [rank, n] by scan position
        ordl = order[l]
        bpl = bp[l].to(torch.int64)
        piv_orig = ordl[pos]
        xp = bpl[piv_orig] ^ r[l, rows].to(torch.int64)
        x = bpl.clone()
        x[piv_orig] = xp
        nonpiv = torch.ones(n, dtype=torch.bool, device=dev)
        nonpiv[pos] = False
        npos = torch.nonzero(nonpiv)[:, 0]
        for q in _sweep(Wb, xp, bpl[ordl], npos, lam, lam3):
            x[ordl[q]] ^= 1
            x[piv_orig] ^= Wb[:, q].to(torch.int64)
        outs[l] = x.to(torch.uint8)
    return outs, consistent
