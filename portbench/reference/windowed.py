"""Sliding-window decoding of a detector error model, as the configuration states it,
in plain torch and numpy.

The construction (sliding-window decoding of a memory experiment under
circuit-level noise, as in Gong, Cammerer and Renes, arXiv:2403.18901): a
``[D, N]`` detector matrix ``A`` whose detector ``d`` is measured in round
``d // r`` (``r = detectors_per_round``, ``R = D / r`` rounds), windows of
``W = window`` rounds that commit ``C = commit`` rounds each.

  1. **The plan.**  Windows start at ``t = 0, C, 2C, ...``.  While more
     than ``W`` rounds remain from ``t``, the window covers rounds ``[t,
     t + W)`` and is open; the first that would reach the last round covers
     ``[t, R)`` and is closed, and is the last.
  2. **The window model.**  A mechanism's earliest round is the least round
     of its detectors (``R`` for a mechanism with none).  An open window's
     columns are the mechanisms whose earliest round lies in ``[t, t + W)``,
     the closed window's those whose earliest round is ``t`` or later; its
     rows are the detectors of its rounds, and its matrix is ``A`` at those
     rows and columns (a mechanism's detectors past an open window are
     left out: the open boundary).  Its priors are its columns'.
  3. **The commit.**  An open window commits its columns whose earliest
     round lies before ``t + C``, the closed window all of its columns.  No
     mechanism may span more than ``W - C + 1`` rounds, so a committed
     mechanism's detectors all lie inside its window.
  4. **The decode.**  Each window in turn decodes its rows of the record
     with ``reference.relay`` (the staged flagship) at the stated inner
     settings: every stated setting but ``detectors_per_round``,
     ``window`` and ``commit``.  The committed columns take the window's
     answer; after an open window, the committed answer ``x_c`` is removed
     from the record of the rounds from ``t + C`` on: ``d[rows >= (t + C) r]
     ^= A[rows >= (t + C) r, committed] x_c mod 2`` (integer sums).
  5. **A shot's outputs.**  ``err`` is the committed answers; ``converged``
     holds where every window's did; ``iters`` is the sum of its windows'
     iteration counts; ``window_converged`` is ``[S, windows]``.

The program sums a window's OSD candidate scores in float32, so where two
consistent candidates' exact scores lie within that sum's rounding (the
comparison's tie rule, ``portbench/check.py``) it may pick either, and
what it commits decides what the later windows see.  For each such tied
candidate that commits other columns than the pick, the later windows
are run on from it for that shot alone (at the shot's first tied window,
and no further branching there); the shot's
``osd`` entry lists the pick's whole answer first and then each branch's,
with the window's exact scores and all consistent, for the comparison to
accept either.  A branch whose iteration count differs from the pick's is
never accepted there.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from . import relay

__all__ = ["decode_stated", "check_settings", "plan", "windows"]

_WINDOW = ("detectors_per_round", "window", "commit")


def check_settings(s: dict):
    """Raise where the stated settings leave what this reference covers."""
    missing = [k for k in _WINDOW if k not in s]
    if missing:
        raise NotImplementedError(f"window settings missing: {missing}")
    relay.check_settings(inner_settings(s))


def inner_settings(s: dict) -> dict:
    """The stated settings of each window's decoder."""
    return {k: v for k, v in s.items() if k not in _WINDOW}


def plan(rounds: int, window: int, commit: int) -> list[tuple[int, int, bool]]:
    """``(first round, rounds, closed)`` of each window (step 1)."""
    out, t = [], 0
    while rounds - t > window:
        out.append((t, window, False))
        t += commit
    return out + [(t, rounds - t, True)]


def earliest_rounds(A: sp.csc_matrix, r: int) -> np.ndarray:
    """Each column's least detector round; the number of rounds where it has
    no detector."""
    R = A.shape[0] // r
    first = np.full(A.shape[1], R, np.int64)
    nonempty = np.flatnonzero(np.diff(A.indptr))
    if nonempty.size:
        rounds = A.indices.astype(np.int64) // r
        first[nonempty] = np.minimum.reduceat(rounds, A.indptr[nonempty])
    return first


def windows(A, priors, r: int, window: int, commit: int) -> list[dict]:
    """Steps 1-3: per window its ``rows`` (a slice of detectors), ``cols``,
    ``matrix`` (csr), ``priors``, ``commit`` (a mask over ``cols``) and
    ``closed``."""
    A = sp.csc_matrix(A)
    D = A.shape[0]
    if D % r:
        raise ValueError(f"{r} detectors a round do not divide {D}")
    if not 1 <= commit < window:
        raise ValueError(f"commit {commit} must lie in [1, window {window})")
    R = D // r
    first = earliest_rounds(A, r)
    last = np.full(A.shape[1], -1, np.int64)
    nonempty = np.flatnonzero(np.diff(A.indptr))
    if nonempty.size:
        last[nonempty] = np.maximum.reduceat(A.indices.astype(np.int64) // r,
                                             A.indptr[nonempty])
    if (last - first + 1).max() > window - commit + 1:
        raise ValueError("a mechanism spans more rounds than the windows' overlap covers")
    out = []
    for t, rounds, closed in plan(R, window, commit):
        rows = slice(t * r, (t + rounds) * r)
        if closed:
            cols = np.flatnonzero(first >= t)
            keep = np.ones(cols.size, bool)
        else:
            cols = np.flatnonzero((first >= t) & (first < t + rounds))
            keep = first[cols] < t + commit
        out.append({"rows": rows, "cols": cols, "matrix": sp.csr_matrix(A[rows][:, cols]),
                    "priors": np.asarray(priors, np.float64)[cols], "commit": keep,
                    "closed": closed, "first_round": t})
    return out


_EPS32 = 2.0 ** -24  # the comparison's tie rule: a float32 sum's rounding


def _tied(cands, scores, cons, pick: int) -> list[int]:
    """The consistent candidates other than ``pick`` whose exact scores lie
    within a float32 sum's rounding of the pick's."""
    out = []
    for k in np.flatnonzero(cons):
        if k == pick or np.array_equal(cands[k], cands[pick]):
            continue
        terms = int(cands[k].sum()) + int(cands[pick].sum())
        if abs(scores[k] - scores[pick]) <= terms * _EPS32 * max(scores[k], scores[pick]):
            out.append(int(k))
    return out


def _commit(A, w, x, commit: int, r: int, err, d):
    """Step 4's commit of window ``w``'s answers ``x [S, n_w]`` into ``err``
    and, after an open window, out of the later rounds of the records ``d``."""
    x_c = x[:, w["commit"]].astype(np.int64)
    committed = w["cols"][w["commit"]]
    err[:, committed] = x_c
    if not w["closed"]:
        lo = (w["first_round"] + commit) * r
        later = A[lo:][:, committed].astype(np.int64)
        d[:, lo:] ^= (np.asarray((later @ x_c.T).T) % 2).astype(np.uint8)


def _run(A, wins, inner, commit, r, d, err, iters, wconv, device, first=0, ties=None):
    """Windows ``first`` on of the records ``d``, updating ``d``, ``err``,
    ``iters`` and ``wconv`` in place.  With ``ties`` (a dict), a shot with
    tied OSD candidates gets ``ties[row]``: ``(its pick's score, [(branch
    err, branch iters, branch score), ...])``."""
    for k in range(first, len(wins)):
        w = wins[k]
        ref = relay.decode_stated(w["matrix"], w["priors"], inner, d[:, w["rows"]], device)
        if ties is not None:
            for row, (cands, scores, cons) in ref["osd"].items():
                if row in ties:
                    continue  # a shot branches at its first tied window only
                pick = next(j for j in range(len(cands))
                            if np.array_equal(cands[j], ref["err"][row]))
                for j in _tied(cands, scores, cons, pick):
                    if np.array_equal(cands[j][w["commit"]], cands[pick][w["commit"]]):
                        continue  # the same commit: the same answer
                    one = slice(row, row + 1)
                    b_d, b_err = d[one].copy(), err[one].copy()
                    b_iters, b_wconv = iters[one] + ref["iters"][row], wconv[one].copy()
                    b_wconv[:, k] = ref["converged"][row]
                    _commit(A, w, cands[j][None].astype(np.int8), commit, r, b_err, b_d)
                    _run(A, wins, inner, commit, r, b_d, b_err, b_iters, b_wconv, device,
                         first=k + 1)
                    ties.setdefault(row, (scores[pick], []))[1].append(
                        (b_err[0], int(b_iters[0]), scores[j]))
        wconv[:, k] = ref["converged"]
        iters += ref["iters"]
        _commit(A, w, ref["err"], commit, r, err, d)


def decode_stated(A, priors, s: dict, syn: np.ndarray, device) -> dict:
    """Decode ``syn [S, D]`` uint8.  Returns numpy ``err [S, N] int8``,
    ``converged``, ``iters``, ``window_converged`` and, per shot with tied
    OSD candidates, ``osd[row] = (answers [M, N], window scores [M],
    consistent [M])``, the pick's answer first."""
    check_settings(s)
    A = sp.csr_matrix(A)
    r = int(s["detectors_per_round"])
    d = np.array(syn, dtype=np.uint8)
    S = d.shape[0]
    wins = windows(A, priors, r, int(s["window"]), int(s["commit"]))
    err = np.zeros((S, A.shape[1]), np.int8)
    iters = np.zeros(S, np.int64)
    wconv = np.zeros((S, len(wins)), bool)
    ties: dict = {}
    _run(A, wins, inner_settings(s), int(s["commit"]), r, d, err, iters, wconv, device,
         ties=ties)
    osd = {}
    for row, (score, branches) in ties.items():
        kept = [(e, sc) for e, it, sc in branches if it == iters[row]]
        if kept:
            osd[row] = (np.stack([err[row]] + [e for e, _ in kept]),
                        np.array([score] + [sc for _, sc in kept]),
                        np.ones(len(kept) + 1, bool))
    return {"err": err, "converged": wconv.all(axis=1), "iters": iters,
            "window_converged": wconv, "osd": osd}
