"""The staged circuit-level decoder, as the configuration states it, in plain torch.

Per shot (``[D, N]`` detector matrix ``A``, mechanism priors ``p``):

  1. stage 0: damped min-sum (``reference.minsum``) at the stage-0 cap,
     rounded up to the ``check_every`` grid;
  2. a shot stage 0 leaves unconverged is decoded again from scratch, deep
     (``deep_iters``, the same damping, ``track_best``); its iteration count
     is the stage-0 cap plus the deep count;
  3. a shot the deep stage leaves unconverged goes to OSD-CS
     (``reference.osd``) twice: from the deep decision with its columns in
     descending ``|LLR|`` order (stable), and from the all-zero decision with
     the columns in descending ``|log((1 - p) / p)|`` order (stable).  Of the
     syndrome-consistent candidates the one of least ``sum(x * LLR0)``
     wins, the first where they tie; the first candidate where none is
     consistent.

The converged flag is True where stage 0 or the deep stage converged.  This
covers one ensemble member with a scalar damping factor and no relay legs
(the configurations that use this reference); anything else raises.

The pick is made on exact sums.  The program adds float32 LLRs, so two
candidates whose exact scores lie within that sum's rounding of each other
are a tie it may break either way: :func:`decode_stated` returns both candidates
and their scores for the comparison to accept either.
"""

from __future__ import annotations

import numpy as np
import torch

from . import minsum, osd

__all__ = ["decode_stated", "check_settings"]

_OSD_LANES = 64
_SUPPORTED = {"gammas", "stage0_iters", "deep_iters", "lam", "lam3", "check_every", "alpha",
              "relay_legs", "dtype", "deep_dtype", "osd_rank", "layout"}


def check_settings(s: dict):
    """Raise where the stated settings leave what this reference covers."""
    extra = set(s) - _SUPPORTED
    if extra:
        raise NotImplementedError(f"settings this reference does not cover: {sorted(extra)}")
    gammas = s["gammas"]
    if len(gammas) != 1 or isinstance(gammas[0], (list, tuple)):
        raise NotImplementedError("one scalar ensemble member only")
    if s.get("relay_legs", 0) or s.get("lam3", 0):
        raise NotImplementedError("no relay legs and no triple sweep")
    if s.get("osd_rank", "abs_llr") != "abs_llr":
        raise NotImplementedError("columns ranked by |LLR| only")
    if s.get("dtype", "float32") != "float32" or s.get("deep_dtype", "float32") != "float32":
        raise NotImplementedError("float32 only")


def decode_stated(A, priors, s: dict, syn: np.ndarray, device) -> dict:
    """Decode ``syn [S, D]`` uint8.  Returns numpy ``err [S, N] int8``,
    ``converged``, ``iters`` and, per shot that reached OSD, its two
    candidates with their exact scores and consistency (``osd``: a dict
    from the shot's row to ``(candidates [2, N], scores [2], consistent
    [2])``)."""
    check_settings(s)
    g = minsum.Graph(A, device)
    llr0 = minsum.llr_of(priors).astype(np.float32)
    L0 = torch.as_tensor(llr0, device=device)
    ce = int(s.get("check_every", 1))
    cap0 = -(-int(s["stage0_iters"]) // ce) * ce
    kw = dict(check_every=ce, damping=float(s["gammas"][0]), alpha=float(s.get("alpha", 1.0)))
    syn_t = torch.as_tensor(syn, device=device)
    err, conv, iters, _ = minsum.decode(g, syn_t, L0, cap0, **kw)
    err, conv, iters = err.cpu().numpy(), conv.cpu().numpy(), iters.cpu().numpy()
    out = {"err": err, "converged": conv.copy(), "iters": iters, "osd": {}}
    need = np.flatnonzero(~conv)
    if need.size == 0:
        return out
    e2, c2, i2, l2 = minsum.decode(g, syn_t[torch.as_tensor(need, device=device)], L0,
                                   int(s["deep_iters"]), track_best=True, **kw)
    c2 = c2.cpu().numpy()
    err[need] = e2.cpu().numpy()
    iters[need] = cap0 + i2.cpu().numpy()
    out["converged"][need] = c2
    fail = np.flatnonzero(~c2)
    if fail.size == 0:
        return out
    rows = need[fail]
    idx = torch.as_tensor(fail, device=device)
    bp = e2.index_select(0, idx).to(torch.uint8)
    llr = l2.index_select(0, idx).cpu().numpy()
    order = np.argsort(-np.abs(llr), axis=1, kind="stable")
    prior_order = np.argsort(-np.abs(llr0), kind="stable")
    M = torch.as_tensor(np.asarray(A.todense()), dtype=torch.uint8, device=device)
    syn_f = syn_t[torch.as_tensor(rows, device=device)]
    t = dict(device=device)
    orders = (torch.as_tensor(order, **t),
              torch.as_tensor(np.broadcast_to(prior_order, order.shape).copy(), **t))
    decisions = (bp, torch.zeros_like(bp))
    cands = np.empty((rows.size, 2, A.shape[1]), np.uint8)
    cons = np.empty((rows.size, 2), bool)
    for lo in range(0, rows.size, _OSD_LANES):  # lanes eliminated together
        sl = slice(lo, lo + _OSD_LANES)
        for k in range(2):
            c, ok = osd.osd_cs(M, syn_f[sl], decisions[k][sl], orders[k][sl], int(s["lam"]))
            cands[sl, k], cons[sl, k] = c.cpu().numpy(), ok.cpu().numpy()
    scores = cands.astype(np.float64) @ llr0.astype(np.float64)  # exact: float32 terms
    for k, row in enumerate(rows):
        ranked = np.where(cons[k], scores[k], np.inf)
        pick = int(np.argmin(ranked)) if cons[k].any() else 0
        err[row] = cands[k, pick].astype(np.int8)
        out["osd"][int(row)] = (cands[k], scores[k], cons[k])
    return out
