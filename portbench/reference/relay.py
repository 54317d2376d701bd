"""The staged decoder's flagship tier, as the configuration states it, in plain torch.

Per shot (``[D, N]`` detector matrix ``A``, mechanism priors ``p``, channel
LLRs ``LLR0 = log((1 - p) / p)`` in float32), every setting from the
configuration's ``stated`` block:

  1. **Stage 0**, as ``reference.staged``'s: damped min-sum
     (``reference.minsum``) at the ``dtype`` stated (float32) with the
     damping ``gammas[0]`` (a scalar), the cap ``stage0_iters`` rounded up
     to the ``check_every`` grid.
  2. **The deep ensemble.**  A shot stage 0 leaves unconverged is decoded
     again from scratch by each of the K members, ``deep_iters``
     iterations with ``track_best``, messages in ``deep_dtype``.  Member k
     damps each edge by its variable's memory strength: for a ``[lo, hi]``
     member the row ``np.random.default_rng(dmem_seed + k).uniform(lo, hi,
     N)``, for a scalar member the scalar in every place.  The
     min-sum is ``reference.minsum``'s, its rounding points unchanged
     (its check update and its float32 slot sums are reused as they are);
     the only difference is the damping factor, which is per edge:
     ``g * old + (1 - g) * new`` with ``g`` the edge's variable's
     strength.  Rounding: a drawn row (float64) is rounded to float32 and
     then to the message dtype (bfloat16, to nearest even); a scalar
     member is its float32 rounded the same way; ``1 - g`` is computed
     from that rounded ``g`` and rounded to the message dtype; each
     product and the sum round to it on their own; ``LLR0`` is rounded from
     float32 to the message dtype.
  3. **The pick.**  Of the members that converged, the one whose error
     estimate ``x`` has the least exact ``sum(x * LLR0)`` wins (float64
     sums of float32 terms: exact at these magnitudes), the first member
     where they tie; where none converged, member 0's (its best iterate).
     The shot's iteration count is the stage-0 cap plus the picked
     member's count (``deep_iters`` where none converged), and it is
     converged where some member is.
  4. **Relay legs.**  Leg l = 0 .. ``relay_legs`` - 1 re-decodes only the
     shots still unconverged, K members again from scratch with fresh rows
     ``np.random.default_rng((relay_seed, l, k)).uniform(*relay_range,
     N)`` (rounded as above), ``relay_iters`` iterations, the same pick.
     A shot a leg solves takes that leg's pick and adds the picked
     member's count to its iteration count; a leg that does not solve it
     adds nothing.  The draws depend on the leg and the member alone, and
     lanes never read each other, so a shot's answer is the same whatever
     shots share its bucket.
  5. **The host OSD.**  A shot no leg solves (nor the deep ensemble, with
     no legs) goes to OSD-CS with triples (``reference.osd3``, ``lam``
     pairs and ``lam3`` triples) K + 1 times: from each member's decision
     of the last leg (of the deep ensemble, with no legs), columns in the
     stable descending order of that member's ``|LLR|`` (float32 from its
     message dtype), and from the all-zero decision with the columns in
     the stable descending order of ``|LLR0|``.  Of the
     syndrome-consistent candidates the one of least exact ``sum(x *
     LLR0)`` wins, the first where they tie; candidate 0 where none is
     consistent.  Its converged flag stays False and its iteration count
     is step 3's.

The program sums the OSD's candidate scores in float32, so two candidates
whose exact scores lie within that sum's rounding are a tie it may break
either way: the shot's candidates, their exact scores and consistency are
returned (``osd``) for the comparison's tie rule.  ``member_iters`` is
each shot's sum of the iteration counts of every member lane it ran in
steps 2 and 4.
"""

from __future__ import annotations

import numpy as np
import torch

from . import minsum, osd3

__all__ = ["decode_stated", "check_settings"]

_OSD_LANES = 64
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_REQUIRED = {"gammas", "stage0_iters", "deep_iters", "relay_iters", "relay_legs",
             "relay_range", "lam", "lam3", "check_every", "alpha", "dtype", "deep_dtype",
             "osd_rank", "layout", "dmem_seed", "relay_seed"}


def check_settings(s: dict):
    """Raise where the stated settings leave what this reference covers."""
    if set(s) != _REQUIRED:
        raise NotImplementedError(f"settings this reference does not cover: "
                                  f"{sorted(set(s) ^ _REQUIRED)}")
    if isinstance(s["gammas"][0], (list, tuple)):
        raise NotImplementedError("stage 0 takes a scalar gammas[0]")
    if s["osd_rank"] != "abs_llr":
        raise NotImplementedError("columns ranked by |LLR| only")
    if s["layout"] != "check":
        raise NotImplementedError("the check layout only")
    if s["dtype"] not in _DTYPES or s["deep_dtype"] not in _DTYPES:
        raise NotImplementedError("float32 or bfloat16 messages only")


def _rows(draws) -> np.ndarray:
    return np.stack([np.asarray(d, np.float64).astype(np.float32) for d in draws])


def member_rows(s: dict, n: int) -> np.ndarray:
    """``[K, n]`` float32: the deep ensemble's memory strengths."""
    return _rows(np.random.default_rng(int(s["dmem_seed"]) + k).uniform(g[0], g[1], n)
                 if isinstance(g, (list, tuple)) else np.full(n, g)
                 for k, g in enumerate(s["gammas"]))


def relay_rows(s: dict, leg: int, n: int) -> np.ndarray:
    """``[K, n]`` float32: relay leg ``leg``'s memory strengths."""
    lo, hi = s["relay_range"]
    return _rows(np.random.default_rng((int(s["relay_seed"]), leg, k)).uniform(lo, hi, n)
                 for k in range(len(s["gammas"])))


def decode_rows(g: minsum.Graph, syn, L0, rows, max_iters: int, *, check_every: int,
                alpha: float, dtype):
    """``reference.minsum.decode`` with ``track_best``, each lane damped per
    edge by its row of ``rows [S, n]`` (float32).  Returns ``(err [S, n]
    int8, converged [S], iters [S] int32, llrs [S, n] float32)``."""
    dev = g.chk_var.device
    syn = torch.as_tensor(syn, device=dev).to(torch.bool)
    S, n, m = syn.shape[0], g.n, g.m
    L0 = torch.broadcast_to(torch.as_tensor(L0, device=dev).to(torch.float32).to(dtype), (S, n))
    gam = torch.as_tensor(rows, device=dev).to(dtype).index_select(1, g.chk_var).reshape(
        S, g.dc, m)
    keep = 1.0 - gam
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    iters = torch.zeros(S, dtype=torch.int32, device=dev)
    best_mis = torch.full((S,), 1 << 30, dtype=torch.int32, device=dev)
    best_err = torch.zeros((S, n), dtype=torch.float32, device=dev)
    best_llr = L0.to(torch.float32)
    msg = L0.index_select(1, g.chk_var).reshape(S, g.dc, m)
    mu = None
    it = 0
    while it < max_iters and S:
        if mu is not None:
            new = total.index_select(1, g.chk_var).reshape(S, g.dc, m) - mu
            msg = gam * msg + keep * new
        mu = minsum._check_update(msg, syn, g, alpha, 0.0)
        total = minsum._totals(mu, L0, g)
        it += 1
        if it % check_every and it < max_iters:
            continue
        active = ~done
        err = (total < 0).to(torch.float32)
        mis = (g.syndrome(err) != syn).sum(dim=1).to(torch.int32)
        ok = mis == 0
        iters = torch.where(ok & active, it, iters)
        done = done | ok
        better = active & (mis < best_mis)
        best_mis = torch.where(better, mis, best_mis)
        best_err = torch.where(better[:, None], err, best_err)
        best_llr = torch.where(better[:, None], total.to(torch.float32), best_llr)
        if bool(done.all()):
            break
    iters = torch.where(done, iters, it).to(torch.int32)
    return best_err.to(torch.int8), done, iters, best_llr


def _ensemble(g, syn, L0, rows, cap, llr0, kw):
    """The K members of ``rows [K, n]`` on each shot of ``syn [S, m]`` and
    the pick.  Returns numpy ``(err [S, n], solved [S], iters [S], member
    err [K, S, n], member llrs [K, S, n], member iters [K, S])``."""
    K, S, n = rows.shape[0], syn.shape[0], g.n
    lanes = np.repeat(rows, S, axis=0)  # lane k * S + i: member k of shot i
    e, c, i, ll = decode_rows(g, syn.repeat(K, 1), L0, lanes, cap, **kw)
    e = e.cpu().numpy().reshape(K, S, n)
    c, i = c.cpu().numpy().reshape(K, S), i.cpu().numpy().reshape(K, S)
    score = np.where(c, e.astype(np.float64) @ llr0.astype(np.float64), np.inf)
    pick = np.argmin(score, axis=0)  # the first least; 0 where all are inf
    shots = np.arange(S)
    return (e[pick, shots], c.any(axis=0), i[pick, shots], e,
            ll.cpu().numpy().reshape(K, S, n), i)


def _osd(A, syn_f, bps, llrs, llr0, s, device):
    """Step 5 on ``F`` failing shots: ``bps``/``llrs [K, F, N]`` of their
    members.  Returns ``(candidates [F, K + 1, N] uint8, consistent [F, K
    + 1])``."""
    K, F, N = bps.shape
    M = torch.as_tensor(np.asarray(A.todense()), dtype=torch.uint8, device=device)
    orders = [np.argsort(-np.abs(llrs[k]), axis=1, kind="stable") for k in range(K)]
    orders.append(np.tile(np.argsort(-np.abs(llr0), kind="stable"), (F, 1)))
    decisions = [bps[k] for k in range(K)] + [np.zeros((F, N), np.uint8)]
    cands = np.empty((F, K + 1, N), np.uint8)
    cons = np.empty((F, K + 1), bool)
    t = dict(device=device)
    for lo in range(0, F, _OSD_LANES):  # lanes eliminated together
        sl = slice(lo, lo + _OSD_LANES)
        for k in range(K + 1):
            c, ok = osd3.osd_cs(M, torch.as_tensor(syn_f[sl], **t),
                                torch.as_tensor(decisions[k][sl], dtype=torch.uint8, **t),
                                torch.as_tensor(orders[k][sl], **t),
                                int(s["lam"]), int(s["lam3"]))
            cands[sl, k], cons[sl, k] = c.cpu().numpy(), ok.cpu().numpy()
    return cands, cons


def decode_stated(A, priors, s: dict, syn: np.ndarray, device) -> dict:
    """Decode ``syn [S, D]`` uint8.  Returns numpy ``err [S, N] int8``,
    ``converged``, ``iters``, ``member_iters`` and, per shot that reached
    the OSD, its K + 1 candidates with their exact scores and consistency
    (``osd``: a dict from the shot's row to ``(candidates [K + 1, N],
    scores [K + 1], consistent [K + 1])``)."""
    check_settings(s)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = minsum.Graph(A, device)
    n = A.shape[1]
    llr0 = minsum.llr_of(priors).astype(np.float32)
    L0 = torch.as_tensor(llr0, device=device)
    ce, alpha = int(s["check_every"]), float(s["alpha"])
    cap0 = -(-int(s["stage0_iters"]) // ce) * ce
    syn_t = torch.as_tensor(syn, device=device)
    err, conv, iters, _ = minsum.decode(g, syn_t, L0, cap0, check_every=ce, alpha=alpha,
                                        damping=float(s["gammas"][0]),
                                        dtype=_DTYPES[s["dtype"]])
    err, conv, iters = err.cpu().numpy(), conv.cpu().numpy(), iters.cpu().numpy()
    out = {"err": err, "converged": conv.copy(), "iters": iters,
           "member_iters": np.zeros(syn.shape[0], np.int64), "osd": {}}
    need = np.flatnonzero(~conv)
    if need.size == 0:
        return out
    kw = dict(check_every=ce, alpha=alpha, dtype=_DTYPES[s["deep_dtype"]])
    ep, sv, it, e_k, l_k, i_k = _ensemble(g, syn_t[torch.as_tensor(need, device=device)], L0,
                                          member_rows(s, n), int(s["deep_iters"]), llr0, kw)
    err[need], iters[need], out["converged"][need] = ep, cap0 + it, sv
    out["member_iters"][need] += i_k.sum(axis=0)
    left = np.flatnonzero(~sv)  # positions in the members' arrays
    for leg in range(int(s["relay_legs"])):
        if left.size == 0:
            break
        rows = need[left]
        ep, sv, it, e_k, l_k, i_k = _ensemble(g, syn_t[torch.as_tensor(rows, device=device)],
                                              L0, relay_rows(s, leg, n),
                                              int(s["relay_iters"]), llr0, kw)
        out["member_iters"][rows] += i_k.sum(axis=0)
        err[rows[sv]], out["converged"][rows[sv]] = ep[sv], True
        iters[rows[sv]] += it[sv]
        need, left = rows, np.flatnonzero(~sv)
    if left.size == 0:
        return out
    rows = need[left]
    cands, cons = _osd(A, syn[rows], e_k[:, left].astype(np.uint8), l_k[:, left], llr0, s,
                       device)
    scores = cands.astype(np.float64) @ llr0.astype(np.float64)  # exact: float32 terms
    for k, row in enumerate(rows):
        ranked = np.where(cons[k], scores[k], np.inf)
        err[row] = cands[k, int(np.argmin(ranked)) if cons[k].any() else 0].astype(np.int8)
        out["osd"][int(row)] = (cands[k], scores[k], cons[k])
    return out
