"""BP+OSD-CS with a damped min-sum inner decoder, as the configuration states it, in plain torch.

Per shot (``[D, N]`` detector matrix ``A``, mechanism priors ``p``):

  1. the inner decoder: damped min-sum (``reference.minsum``) from the
     priors' LLRs ``log((1 - p) / p)`` in float32, ``max_iters``
     iterations, the syndrome checked every ``check_every``-th iteration.
     Its message state is kept per edge in check-slot form; the program's
     variable layout keeps it per edge in variable-slot form.  The damping
     mix ``g * old + (1 - g) * new`` of the message on an edge, with
     ``new = total - (its check message)``, is the same float32 arithmetic
     in either form, so this reference needs nothing beyond
     ``reference.minsum``;
  2. a shot the inner decoder leaves unconverged goes to OSD-CS
     (``reference.osd``) from the inner decision, with its columns in the
     stable descending order of ``max(exp(L), 1 - exp(L))`` on the float32
     output LLRs ``L``: the rule of the reference package
     (LDPCDecoders.jl, ``belief_propagation_osd.jl``), computed in float32
     as ``torch.exp`` gives it on the device.  This departs from
     Fossorier's ranking by ``|L|``: every column with ``L < 0`` (a
     reliability below 1) ranks after every column with ``L >= 0``;
  3. a converged shot keeps the inner decoder's answer.

The converged flag and the iteration count are the inner decoder's.  Only
these settings are covered (``osd_scope`` ``"failed"``, OSD-CS, float32);
anything else raises.  OSD-CS needs ``osd_order`` of at least 1: the
program takes ``osd_order`` 0 as OSD-0, another algorithm (the
configuration's control).
"""

from __future__ import annotations

import numpy as np
import torch

from . import minsum, osd

__all__ = ["decode_stated", "check_settings", "reliability_order"]

_OSD_LANES = 64
_SUPPORTED = {"max_iters", "inner", "damping", "alpha", "check_every", "layout", "dtype",
              "osd_method", "osd_order", "osd_scope", "osd_rank"}


def check_settings(s: dict):
    """Raise where the stated settings leave what this reference covers."""
    extra = set(s) - _SUPPORTED
    if extra:
        raise NotImplementedError(f"settings this reference does not cover: {sorted(extra)}")
    want = {"inner": "minsum", "layout": "var", "dtype": "float32",
            "osd_method": "combination_sweep", "osd_scope": "failed",
            "osd_rank": "max_exp_llr"}
    for key, value in want.items():
        if s.get(key, value) != value:
            raise NotImplementedError(f"{key} {s[key]!r}: this reference covers {value!r} only")


def reliability_order(llrs: torch.Tensor) -> torch.Tensor:
    """Columns by stable descending ``max(exp(L), 1 - exp(L))`` of the
    float32 LLRs ``[S, N]`` (an LLR that overflows ``exp`` ties at inf and
    keeps its index order)."""
    p = torch.exp(llrs.to(torch.float32))
    return torch.argsort(-torch.maximum(p, 1.0 - p), dim=1, stable=True)


def decode_stated(A, priors, s: dict, syn: np.ndarray, device, *,
                  inner_dtype=torch.float32) -> dict:
    """Decode ``syn [S, D]`` uint8.  Returns numpy ``err [S, N] int8``,
    ``converged`` and ``iters``.  ``inner_dtype`` is the inner min-sum's
    (the stated float32; bfloat16 for the lower-precision reading of
    ``tools/bposd_bf16_control.py``)."""
    check_settings(s)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = minsum.Graph(A, device)
    L0 = torch.as_tensor(minsum.llr_of(priors).astype(np.float32), device=device)
    syn_t = torch.as_tensor(syn, device=device)
    err, conv, iters, llrs = minsum.decode(
        g, syn_t, L0, int(s["max_iters"]), check_every=int(s.get("check_every", 1)),
        damping=float(s.get("damping", 0.0)), alpha=float(s.get("alpha", 1.0)),
        dtype=inner_dtype)
    out = {"err": err.cpu().numpy(), "converged": conv.cpu().numpy(),
           "iters": iters.cpu().numpy()}
    fail = torch.nonzero(~conv)[:, 0]
    if fail.numel() == 0:
        return out
    M = torch.as_tensor(np.asarray(A.todense()), dtype=torch.uint8, device=device)
    order = reliability_order(llrs.index_select(0, fail))
    bp = err.index_select(0, fail).to(torch.uint8)
    syn_f = syn_t.index_select(0, fail)
    rows = fail.cpu().numpy()
    for lo in range(0, rows.size, _OSD_LANES):  # lanes eliminated together
        sl = slice(lo, lo + _OSD_LANES)
        x, _ = osd.osd_cs(M, syn_f[sl], bp[sl], order[sl], int(s["osd_order"]))
        out["err"][rows[sl]] = x.cpu().numpy().astype(np.int8)
    return out
