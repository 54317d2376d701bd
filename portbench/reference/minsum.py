"""Plain min-sum decoding in torch: the reference the benchmark holds the port to.

A straightforward implementation of normalized min-sum belief propagation
as the configurations state it, written from the algorithm and from no code
of the program: it imports nothing of ``ldpcdecoders_tpu_torch``.  It fixes
the points where floating-point rounding makes a difference, so that a
float32 decode is reproducible bit for bit:

  * messages are kept per edge in check-slot form ``[S, slot, check]``
    (slot k of check i is its k-th variable, ascending); padded slots read
    as ``BIG``;
  * the check update is the two-minimum rule: an edge gets the second
    minimum where it holds the check's unique minimum and the minimum
    elsewhere; its sign is the parity of the other edges' signs and the
    syndrome bit; ``alpha * excl - beta`` is rounded twice, then clamped at 0;
  * a variable's total is ``L0 + sum``, the sum of its incoming check
    messages in float32 from 0, one slot at a time in ascending check
    order, then rounded to the message dtype;
  * the next message on an edge is ``total - (its check message)``; with
    damping ``g`` it is ``g * old + (1 - g) * new``, each product and the
    sum rounded on their own;
  * the first iteration's messages are the channel LLRs themselves.

The hard decision is ``total < 0``.  The syndrome test runs every
``check_every``-th iteration and at the last; a lane whose decision then
reproduces its syndrome is frozen with that decision, its LLRs and the
iteration count.  ``track_best`` returns for a lane that never converges the
decision and LLRs of the checked iterate with the fewest mismatched checks
(the first such iterate).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["BIG", "Graph", "decode", "decode_stated", "llr_of"]

#: magnitude a padded check slot reads as
BIG = 1e30
_NEVER = 1 << 30


def llr_of(p) -> np.ndarray:
    """Channel LLRs ``log((1 - p) / p)`` in float64, as numpy."""
    p = np.asarray(p, np.float64)
    return np.log((1.0 - p) / p)


class Graph:
    """The edge tables of a 0/1 matrix ``M [m, n]`` on ``device``.

    ``chk_var [dc, m]``: variable of slot k of check i (0 past the degree);
    ``chk_mask [dc, m]``; ``var_slot [dv, n]``: the flat check-slot index
    ``k * m + i`` of variable j's k-th check (ascending; 0 past the degree);
    ``var_mask [dv, n]``; ``Mt [n, m]`` float32 for syndromes.
    """

    def __init__(self, M, device):
        M = sp.csr_matrix(M, dtype=np.uint8)
        M.sort_indices()
        m, n = M.shape
        rows = np.repeat(np.arange(m), np.diff(M.indptr))
        cols = M.indices.astype(np.int64)
        cslot = np.arange(cols.size) - np.repeat(M.indptr[:-1], np.diff(M.indptr))
        dc = int(np.diff(M.indptr).max())
        by_var = np.lexsort((rows, cols))  # by variable, then ascending check
        vdeg = np.bincount(cols, minlength=n)
        dv = int(vdeg.max())
        starts = np.concatenate([[0], np.cumsum(vdeg)[:-1]])
        vslot = np.arange(cols.size) - np.repeat(starts, vdeg)
        chk_var = np.zeros((dc, m), np.int64)
        chk_mask = np.zeros((dc, m), bool)
        chk_var[cslot, rows] = cols
        chk_mask[cslot, rows] = True
        var_slot = np.zeros((dv, n), np.int64)
        var_mask = np.zeros((dv, n), bool)
        e = by_var
        var_slot[vslot, cols[e]] = cslot[e] * m + rows[e]
        var_mask[vslot, cols[e]] = True
        self.m, self.n, self.dc, self.dv = m, n, dc, dv
        t = dict(device=device)
        self.chk_var = torch.as_tensor(chk_var.reshape(-1), **t)
        self.chk_mask = torch.as_tensor(chk_mask, **t)
        self.var_slot = torch.as_tensor(var_slot, **t)
        self.var_mask = torch.as_tensor(var_mask, **t)
        self.Mt = torch.as_tensor(M.T.toarray(), dtype=torch.float32, **t)

    def syndrome(self, x: torch.Tensor) -> torch.Tensor:
        """``[S, n]`` 0/1 -> ``[S, m]`` bool (float32 sums of 0/1: exact)."""
        return torch.remainder(x.to(torch.float32) @ self.Mt, 2.0) != 0


def _check_update(new, syn, g: Graph, alpha: float, beta: float):
    big = torch.tensor(BIG, dtype=new.dtype, device=new.device)
    x = torch.where(g.chk_mask, new, big)
    mag = x.abs()
    neg = x < 0
    min1 = mag.amin(dim=1, keepdim=True)
    at_min = mag == min1
    unique = at_min.sum(dim=1, keepdim=True) == 1
    min2 = torch.where(at_min, big, mag).amin(dim=1, keepdim=True)
    excl = torch.where(at_min & unique, min2, min1)
    parity = (neg.sum(dim=1, keepdim=True) & 1).to(torch.bool)
    flip = parity ^ neg ^ syn[:, None, :]
    out = torch.clamp_min(alpha * excl - beta, 0.0)
    return torch.where(flip, -out, out)


def _totals(mu, L0, g: Graph):
    S = mu.shape[0]
    flat = mu.reshape(S, -1)
    zero = torch.zeros((), dtype=mu.dtype, device=mu.device)
    acc = torch.zeros((S, g.n), dtype=torch.float32, device=mu.device)
    for k in range(g.dv):
        msg = torch.where(g.var_mask[k], flat.index_select(1, g.var_slot[k]), zero)
        acc = acc + msg.to(torch.float32)
    return L0 + acc.to(mu.dtype)


def decode(g: Graph, syn, L0, max_iters: int, *, check_every: int = 1, damping=None,
           alpha: float = 1.0, beta: float = 0.0, dtype=torch.float32,
           track_best: bool = False):
    """Decode ``syn [S, m]`` (0/1) from channel LLRs ``L0 [n]`` (float32).

    Returns ``(err [S, n] int8, converged [S] bool, iters [S] int32,
    llrs [S, n] float32)`` as tensors on the graph's device.
    """
    dev = g.chk_var.device
    syn = torch.as_tensor(syn, device=dev).to(torch.bool)
    S, n, m = syn.shape[0], g.n, g.m
    L0 = torch.as_tensor(L0, device=dev).to(torch.float32).to(dtype)
    L0 = torch.broadcast_to(L0, (S, n))
    gam = None if not damping else torch.tensor(float(damping), dtype=dtype, device=dev)
    err = torch.zeros((S, n), dtype=torch.float32, device=dev)
    llrs = L0.clone()
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    iters = torch.zeros(S, dtype=torch.int32, device=dev)
    if track_best:
        best_mis = torch.full((S,), _NEVER, dtype=torch.int32, device=dev)
        best_err = torch.zeros((S, n), dtype=torch.float32, device=dev)
        best_llr = L0.to(torch.float32)
    msg = L0.index_select(1, g.chk_var).reshape(S, g.dc, m)
    mu = None
    it = 0
    while it < max_iters and S:
        if mu is not None:
            new = total.index_select(1, g.chk_var).reshape(S, g.dc, m) - mu
            msg = new if gam is None else gam * msg + (1.0 - gam) * new
        mu = _check_update(msg, syn, g, alpha, beta)
        total = _totals(mu, L0, g)
        it += 1
        if it % check_every and it < max_iters:
            continue
        active = ~done
        err = torch.where(active[:, None], (total < 0).to(torch.float32), err)
        llrs = torch.where(active[:, None], total, llrs)
        mis = (g.syndrome(err) != syn).sum(dim=1).to(torch.int32)
        ok = mis == 0
        iters = torch.where(ok & active, it, iters)
        done = done | ok
        if track_best:
            better = active & (mis < best_mis)
            best_mis = torch.where(better, mis, best_mis)
            best_err = torch.where(better[:, None], err, best_err)
            best_llr = torch.where(better[:, None], llrs.to(torch.float32), best_llr)
        if bool(done.all()):
            break
    iters = torch.where(done, iters, it).to(torch.int32)
    if track_best:
        return best_err.to(torch.int8), done, iters, best_llr
    return err.to(torch.int8), done, iters, llrs.to(torch.float32)


_STATED = {"max_iters", "alpha", "beta", "damping", "check_every", "dtype"}


def decode_stated(M, priors, s: dict, syn: np.ndarray, device) -> dict:
    """The min-sum decoder as the settings ``s`` state it (float32 only),
    on ``syn [S, m]`` uint8 with the channel priors ``[n]``.  Returns numpy
    ``err``, ``converged``, ``iters`` and ``llrs``."""
    extra = set(s) - _STATED
    if extra or s.get("dtype", "float32") != "float32":
        raise NotImplementedError(f"settings this reference does not cover: {sorted(extra)}")
    g = Graph(M, device)
    L0 = torch.as_tensor(llr_of(priors).astype(np.float32), device=device)
    err, conv, iters, llrs = decode(
        g, torch.as_tensor(syn, device=device), L0, int(s["max_iters"]),
        check_every=int(s.get("check_every", 1)), damping=float(s.get("damping", 0.0)),
        alpha=float(s.get("alpha", 1.0)), beta=float(s.get("beta", 0.0)))
    return {"err": err.cpu().numpy(), "converged": conv.cpu().numpy(),
            "iters": iters.cpu().numpy(), "llrs": llrs.cpu().numpy()}
