"""Ordered-statistics decoding with a combination sweep (OSD-CS), in plain torch.

For one lane: a 0/1 matrix ``M [m, n]``, a syndrome ``s``, a hard decision
``bp [n]`` and a column order (most reliable first).

  1. The information set is the first linearly independent columns in that
     order (the pivot columns of the reduced row echelon form of the
     column-permuted matrix).
  2. The base solution keeps ``bp`` on every other column and solves the
     pivot columns so that ``M x = s``; the lane is consistent when ``s``
     lies in the column space.
  3. The sweep scores by Hamming weight: flipping a non-pivot column ``c``
     also flips the pivot columns of its unique representation ``w_c`` in
     the pivot columns.  Singles run over every non-pivot column, pairs over
     the first ``lam`` of them (both in scan order); the first minimum wins
     each.  A pair is taken where it is negative and below the best single,
     else a single where it is negative, else the base solution.

Lanes are eliminated together on the device, rows packed 63 columns to an
int64 word (the sign bit is never used), one pivot a step.
"""

from __future__ import annotations

import torch

__all__ = ["osd_cs"]

_BITS = 63
_WINDOW_WORDS = 8


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """``[..., n]`` 0/1 -> ``[..., ceil(n / 63)]`` int64, column c at bit c % 63."""
    n = bits.shape[-1]
    words = -(-n // _BITS)
    pad = torch.zeros((*bits.shape[:-1], words * _BITS - n), dtype=bits.dtype, device=bits.device)
    b = torch.cat([bits, pad], dim=-1).reshape(*bits.shape[:-1], words, _BITS).to(torch.int64)
    shifts = torch.arange(_BITS, device=bits.device, dtype=torch.int64)
    return (b << shifts).sum(dim=-1)


def _unpack(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`_pack`: ``[..., w]`` -> ``[..., n]`` bool."""
    shifts = torch.arange(_BITS, device=words.device, dtype=torch.int64)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :n].to(torch.bool)


def _eliminate(P: torch.Tensor, r: torch.Tensor, n: int):
    """Reduced row echelon form of each lane's packed ``P [L, m, w]``, the
    residual ``r [L, m]`` (bool) carried along; both reduced in place.

    Returns ``piv_col [L, m]``: each row's pivot column (-1 for a row with
    none)."""
    L, m, w = P.shape
    dev = P.device
    lanes = torch.arange(L, device=dev)
    piv_col = torch.full((L, m), -1, dtype=torch.int64, device=dev)
    ptr = torch.zeros(L, dtype=torch.int64, device=dev)
    rank = torch.zeros(L, dtype=torch.int64, device=dev)
    win = torch.arange(_WINDOW_WORDS, device=dev)
    cols_in_win = torch.arange(_WINDOW_WORDS * _BITS, device=dev)
    step = 0
    while True:
        active = (ptr < n) & (rank < m)
        if step % 16 == 0 and not bool(active.any()):
            break
        step += 1
        w0 = ptr // _BITS
        widx = (w0[:, None] + win).clamp_max(w - 1)  # [L, W]
        words = torch.gather(P, 2, widx[:, None, :].expand(L, m, _WINDOW_WORDS))
        bits = _unpack(words, _WINDOW_WORDS * _BITS)  # [L, m, W*63]
        col = w0[:, None] * _BITS + cols_in_win  # absolute column of each window bit
        valid = (col >= ptr[:, None]) & (col < n) & ((w0[:, None] + win) < w).repeat_interleave(
            _BITS, dim=1)
        free = piv_col < 0  # rows without a pivot yet
        hit = bits & free[:, :, None] & valid[:, None, :]
        colany = hit.any(dim=1)  # [L, W*63]
        has = colany.any(dim=1) & active
        first = colany.to(torch.uint8).argmax(dim=1)  # first True
        c = w0 * _BITS + first
        colbits = torch.gather(bits, 2, first[:, None, None].expand(L, m, 1))[:, :, 0]  # [L, m]
        prow = (colbits & free).to(torch.uint8).argmax(dim=1)  # pivot row
        others = colbits & has[:, None]
        others[lanes, prow] = False
        pivot_words = P[lanes, prow]  # [L, w]
        mask = -(others.to(torch.int64))  # all ones where the row takes the pivot row
        P ^= mask[:, :, None] & pivot_words[:, None, :]
        r ^= others & r[lanes, prow][:, None]
        sel = has[:, None] & (torch.arange(m, device=dev)[None, :] == prow[:, None])
        piv_col = torch.where(sel, c[:, None], piv_col)
        rank = rank + has.to(torch.int64)
        nxt = torch.where(has, c + 1, (w0 + _WINDOW_WORDS) * _BITS)
        ptr = torch.where(active, nxt, ptr)
    return piv_col


def osd_cs(M: torch.Tensor, syn: torch.Tensor, bp: torch.Tensor, order: torch.Tensor,
           lam: int):
    """OSD-CS of ``L`` lanes.

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
    Mf = M.to(torch.float32)
    bpf = bp.to(torch.float32)
    # residual of the hard decision: r = s + M bp (float32 sums of 0/1: exact)
    r = (torch.remainder(bpf @ Mf.T, 2.0) != 0) ^ syn.to(torch.bool)
    Mb = M.to(torch.bool)
    P = torch.stack([_pack(Mb[:, order[l]]) for l in range(L)])  # [L, m, w]
    piv_col = _eliminate(P, r, n)
    outs = torch.empty((L, n), dtype=torch.uint8, device=dev)
    consistent = ~((piv_col < 0) & r).any(dim=1)
    for l in range(L):
        pc = piv_col[l]
        rows = torch.nonzero(pc >= 0)[:, 0]
        pos = pc[rows]  # scan positions of the pivots
        Wf = _unpack(P[l, rows], n).to(torch.float32)  # [rank, n] by scan position
        ordl = order[l]
        bpl = bp[l].to(torch.int64)
        x = bpl.clone()
        piv_orig = ordl[pos]
        xp = bpl[piv_orig] ^ r[l, rows].to(torch.int64)
        x[piv_orig] = xp
        s = (1 - 2 * xp).to(torch.float32)  # +1 where a flip adds weight
        nonpiv = torch.ones(n, dtype=torch.bool, device=dev)
        nonpiv[pos] = False
        bp_scan = bpl[ordl]
        d1 = (1 - 2 * bp_scan).to(torch.float32) + s @ Wf
        d1 = torch.where(nonpiv, d1, torch.inf)
        npos = torch.nonzero(nonpiv)[:, 0]
        choice = []
        if npos.numel():
            j1 = int(torch.argmin(d1))
            best1 = float(d1[j1])
            lead = npos[:lam]
            best2 = float("inf")
            if lead.numel() >= 2:
                Wl = Wf[:, lead]
                ov = Wl.T @ (s[:, None] * Wl)
                d2 = d1[lead][:, None] + d1[lead][None, :] - 2.0 * ov
                k = lead.numel()
                upper = torch.triu(torch.ones((k, k), dtype=torch.bool, device=dev), diagonal=1)
                d2 = torch.where(upper, d2, torch.inf).reshape(-1)
                ij = int(torch.argmin(d2))
                best2 = float(d2[ij])
            if best2 < 0 and best2 < best1:
                choice = [int(lead[ij // k]), int(lead[ij % k])]
            elif best1 < 0:
                choice = [j1]
        for q in choice:
            x[ordl[q]] ^= 1
            x[piv_orig] ^= Wf[:, q].to(torch.int64)
        outs[l] = x.to(torch.uint8)
    return outs, consistent
