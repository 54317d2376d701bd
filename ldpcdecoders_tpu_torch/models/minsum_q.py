"""Int8-quantized min-sum decoder.

Counterpart of ``ldpcdecoders_tpu/models/minsum_q.py``: min-sum with the
messages stored as int8 fixed-point LLRs (``scale`` LSBs per LLR unit),
totals accumulated in int32 (degree * 127 never overflows) and every
variable-to-check message clipped to [-127, 127] on write; ``beta_q`` is an
integer offset (offset min-sum) in quantized units.  All of it is integer
work, so the port is bitwise the reference on every output.

The reference calls this path bandwidth-optimal on its TPU; on the card
the claim is not assumed: ``chip_smoke.py`` path (aa) measures the bytes
an iteration moves and its time beside float32 min-sum's (PERF.md).  The
JAX package has no Pallas kernel here; an iteration is plain torch: a
gather and the two-minimum reduction of the check update, a gather, a sum
and a clip of the variable update, and the syndrome check.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.graph import TannerGraph
from ..ops.syndrome import SyndromeCheck
from .base import Decoder, resolve_device
from .bp import as_graph
from .priors import per_to_quantized_llr

__all__ = ["QuantizedMinSumDecoder", "QuantizedMinSumDecode", "make_minsum_q_decode_fn"]

_Q_MAX = 127


class QuantizedMinSumDecode(torch.nn.Module):
    """``forward(syndromes [B, m], L0q=None) -> (err int8, converged bool,
    iters int32, llr_q int32)``: the counterpart of the reference's
    ``make_minsum_q_decode_fn``.  ``L0q`` overrides the quantized channel
    LLR for one call: an integer scalar, ``[n]`` or ``[B, n]`` (a number,
    numpy array or tensor, taken as int32 as the reference takes it)."""

    def __init__(self, graph: TannerGraph, per: float, max_iters: int, *, device,
                 scale: float = 4.0, beta_q: int = 1):
        super().__init__()
        device = resolve_device(device)
        self.m, self.n = graph.m, graph.n
        self.max_dc, self.max_dv = graph.max_dc, graph.max_dv
        self.max_iters = int(max_iters)
        self.beta_q = int(beta_q)
        self.default_L0q = per_to_quantized_llr(per, scale)
        c2v_t, v2c_t, chk_mask_t, var_mask_t = graph.slot_major()
        self.register_buffer("c2v", torch.as_tensor(c2v_t.astype(np.int64), device=device))
        self.register_buffer("v2c", torch.as_tensor(v2c_t.astype(np.int64), device=device))
        self.register_buffer("chk_mask", torch.as_tensor(chk_mask_t, device=device))
        self.register_buffer("var_mask", torch.as_tensor(var_mask_t, device=device))
        self.syndrome_from = SyndromeCheck(graph, device)

    def check_update(self, nu_flat: torch.Tensor, syn_flip: torch.Tensor) -> torch.Tensor:
        """int8 ``[B, dv * n]`` var->check messages -> int8 ``[B, dc, m]``.

        Padded slots read as magnitude 127 (inert in the minimums).  The
        leave-one-out minimum is min2 at a unique minimum and min1
        elsewhere, the reference's unrolled two-minimum sweep (ties give
        min1 everywhere); min2 starts from 127, as there."""
        B, m = nu_flat.shape[0], self.m
        Ng = nu_flat.index_select(1, self.c2v).reshape(B, self.max_dc, m)
        mag = torch.where(self.chk_mask, Ng.abs(), _Q_MAX).to(torch.int8)
        neg = (Ng < 0) & self.chk_mask
        min1 = mag.amin(dim=1, keepdim=True)
        eq1 = mag == min1
        unique = eq1.sum(dim=1, keepdim=True) == 1
        min2 = torch.where(eq1, _Q_MAX, mag).to(torch.int8).amin(dim=1, keepdim=True)
        excl = torch.where(eq1 & unique, min2, min1)
        parity = (neg.sum(dim=1, keepdim=True) & 1).to(torch.bool)
        flip = parity ^ neg ^ syn_flip[:, None, :]
        # int8 arithmetic, as the reference's (it wraps alike)
        mag_out = torch.clamp_min(excl - torch.tensor(self.beta_q, dtype=torch.int8), 0)
        return torch.where(flip, -mag_out, mag_out)

    def var_update(self, mu: torch.Tensor, L0q):
        """int8 ``[B, dc, m]`` -> (int8 ``nu [B, dv, n]``, int32 ``total [B, n]``)."""
        B = mu.shape[0]
        Mg = mu.reshape(B, self.max_dc * self.m).index_select(1, self.v2c)
        Mg = torch.where(self.var_mask, Mg.reshape(B, self.max_dv, self.n), 0).to(torch.int8)
        total = L0q + Mg.sum(dim=1, dtype=torch.int32)
        nu = torch.clamp(total[:, None, :] - Mg.to(torch.int32), -_Q_MAX, _Q_MAX)
        return nu.to(torch.int8), total

    def forward(self, syndromes: torch.Tensor, L0q=None):
        B, n, device = syndromes.shape[0], self.n, syndromes.device
        L0q = torch.as_tensor(self.default_L0q if L0q is None else L0q,
                              device=device).to(torch.int32)
        syn_f = syndromes.to(torch.float32)
        syn_flip = syndromes.to(torch.bool)
        # scalar, [n] or per-lane [B, n]: the slot axis goes before n
        nu = torch.broadcast_to((L0q[..., None, :] if L0q.ndim else L0q).to(torch.int8),
                                (B, self.max_dv, n)).contiguous()
        err = torch.zeros((B, n), dtype=torch.float32, device=device)
        llr = torch.broadcast_to(L0q, (B, n)).contiguous()
        done = torch.zeros((B,), dtype=torch.bool, device=device)
        iters = torch.zeros((B,), dtype=torch.int32, device=device)
        it = 0
        while it < self.max_iters and not bool(done.all()):
            mu = self.check_update(nu.reshape(B, self.max_dv * n), syn_flip)
            nu, total = self.var_update(mu, L0q)
            active = ~done
            err = torch.where(active[:, None], (total < 0).to(torch.float32), err)
            llr = torch.where(active[:, None], total, llr)
            ok = (self.syndrome_from(err) == syn_f).all(dim=-1)
            iters = torch.where(ok & active, it + 1, iters)
            done = done | ok
            it += 1
        iters = torch.where(done, iters, it).to(torch.int32)
        return err.to(torch.int8), done, iters, llr


def make_minsum_q_decode_fn(graph: TannerGraph, per: float, max_iters: int, *,
                            scale: float = 4.0, beta_q: int = 1, device=None):
    """Build ``decode(syndromes [B, m], L0q=None) -> (err int8, converged
    bool, iters int32, llr_q int32)``, the reference's functional core,
    running :class:`QuantizedMinSumDecode` on ``device`` (None: the current
    CUDA card).  ``syndromes`` and ``L0q`` may be numbers, numpy arrays or
    tensors; they are moved to ``device``.
    """
    q = QuantizedMinSumDecode(graph, per, max_iters, device=device, scale=scale, beta_q=beta_q)
    device = q.var_mask.device

    def decode(syndromes, L0q=None):
        return q(torch.as_tensor(syndromes, device=device), L0q)

    return decode


class QuantizedMinSumDecoder(Decoder):
    """Int8 fixed-point min-sum decoder.

    Args:
      H: ``[m, n]`` parity-check matrix, or a compiled TannerGraph.
      per: physical error rate (sets the quantized channel LLR; scalar).
      max_iters: maximum iterations.
      scale: fixed-point LSBs per LLR unit (default 4.0: steps of 0.25).
      beta_q: integer offset-min-sum correction in quantized units (default 1).
      device: where decoding runs; None is the current CUDA card.
    """

    supports_vector_prior = False

    def __init__(self, H, per: float, max_iters: int, *, scale: float = 4.0, beta_q: int = 1,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.graph = as_graph(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = float(per)
        self.max_iters = int(max_iters)
        self.scale = float(scale)
        self.beta_q = int(beta_q)
        self.minsum_q = QuantizedMinSumDecode(self.graph, self.per, self.max_iters,
                                              device=self.device, scale=self.scale,
                                              beta_q=self.beta_q)

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        L0q = None if per is None else per_to_quantized_llr(per, self.scale)
        err, converged, iters, llr = self.minsum_q(syndromes, L0q)
        return err, converged, iters, {"llr_q": llr}
