"""Whether the window's answers are right.

Three numbers, on the answers the timed calls themselves returned:

  * ``inconsistent``: over every shot of the kept calls, the answers that
    break the decoder's guarantee of reproducing their syndrome (every
    answer, or the converged ones, as the configuration's ``check`` says).
  * ``differ``: over a sample of shots drawn from the seed, the answers
    whose error estimate, converged flag or iteration count differ from the
    plain reference's (``reference/<name>.py``, run on the same syndromes
    with the configuration's stated settings).  Where the reference reports
    candidates whose scores the program's float32 sums cannot order (see
    ``reference/staged.py``), the program's answer may be either; such
    shots are counted as ``ties``, which is reported and not compared.
  * ``llr_gap`` (where the decoder returns LLRs): the widest gap between the
    program's output LLRs and the reference's over the sample.

Each compared number has its limit in the configuration's ``check.limits``.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

__all__ = ["compare"]

_EPS32 = 2.0 ** -24


def _inconsistent(M_t, syn, err, conv, rule: str) -> int:
    s = torch.remainder(torch.as_tensor(err, device=M_t.device).to(torch.float32) @ M_t, 2.0)
    bad = (s != torch.as_tensor(syn, device=M_t.device).to(torch.float32)).any(dim=1)
    if rule == "converged":
        bad = bad & torch.as_tensor(conv, device=M_t.device)
    return int(bad.sum())


def _tie(port_err, cands, scores, cons) -> bool:
    """Whether ``port_err`` is a consistent candidate whose float32 score
    cannot be told from the least one's."""
    ok = np.flatnonzero(cons)
    if ok.size == 0:
        return False
    best = ok[np.argmin(scores[ok])]
    for k in ok:
        if np.array_equal(port_err, cands[k]):
            terms = cands[k].sum() + cands[best].sum()
            return abs(scores[k] - scores[best]) <= terms * _EPS32 * max(scores[k], scores[best])
    return False


def compare(cell, code, channel, pool, kept, device) -> dict:
    """``kept``: ``(pool index, rows, err, converged, iters, llr rows or
    None)`` per kept call, ``err``/``converged`` whole and the rest for the
    sampled ``rows``.  Returns ``{name: {"value": v, "limit": l}}`` and the
    uncompared counts under ``"_info"``."""
    chk = cell.config["check"]
    M_t = torch.as_tensor(code.M.T.toarray(), dtype=torch.float32, device=device)
    inconsistent = 0
    for idx, _, err, conv, _, _ in kept:
        inconsistent += _inconsistent(M_t, pool[idx], err, conv, chk["consistent"])
    del M_t
    syn = np.concatenate([pool[idx][rows] for idx, rows, *_ in kept])
    p_err = np.concatenate([err[rows] for _, rows, err, *_ in kept])
    p_conv = np.concatenate([conv[rows] for _, rows, _, conv, *_ in kept])
    p_iters = np.concatenate([it for *_, it, _ in kept])
    p_llrs = None if kept[0][5] is None else np.concatenate([ll for *_, ll in kept])
    ref_mod = importlib.import_module(f"portbench.reference.{cell.config['reference']}")
    stated = cell.config["stated"]
    differ = ties = 0
    gaps = [0.0]
    block = int(chk["block_rows"])
    for lo in range(0, syn.shape[0], block):
        sl = slice(lo, lo + block)
        ref = ref_mod.decode_stated(code.M, channel.priors, stated, syn[sl], device)
        same = ((p_err[sl] == ref["err"]).all(axis=1) & (p_conv[sl] == ref["converged"])
                & (p_iters[sl] == ref["iters"]))
        for r in np.flatnonzero(~same):
            osd = ref.get("osd", {}).get(int(r))
            if (osd is not None and p_conv[sl][r] == ref["converged"][r]
                    and p_iters[sl][r] == ref["iters"][r] and _tie(p_err[sl][r], *osd)):
                ties += 1
            else:
                differ += 1
        if p_llrs is not None:
            gaps.append(float(np.abs(p_llrs[sl].astype(np.float64) - ref["llrs"]).max()))
    limits = chk["limits"]
    out = {"inconsistent": {"value": inconsistent, "limit": limits["inconsistent"]},
           "differ": {"value": differ, "limit": limits["differ"]}}
    if p_llrs is not None:
        out["llr_gap"] = {"value": float(np.max(gaps)), "limit": limits["llr_gap"]}  # NaN stays
    out["_info"] = {"sampled": int(syn.shape[0]), "ties": ties,
                    "kept_shots": int(sum(k[2].shape[0] for k in kept))}
    return out
