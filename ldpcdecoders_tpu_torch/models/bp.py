"""Batched sum-product belief-propagation decoder.

Counterpart of ``ldpcdecoders_tpu/models/bp.py``, with the same numerics:
probability-ratio messages, ``delta = 2/(1+q) - 1`` products with the
syndrome sign folded into the check-node prefix, ``x -> (1-x)/(1+x)`` ratio
maps, a NaN-guarded variable-node scan, ``log(1/total)`` soft output and the
hard decision ``total >= 1``.  Every expression keeps the reference
package's association order, so err / converged / iters agree bitwise.

Messages live in the slot-major ``[B, slot, node]`` layout, connected by
static gather tables (codes/graph.py).  The reference's ``while_loop``
becomes a Python loop that stops once every lane has converged; reading
that flag costs one host synchronization per iteration on a card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.graph import TannerGraph
from ..ops.exclusive import exclusive_prods, guarded_exclusive_prod_scan
from ..ops.syndrome import SyndromeCheck
from .base import Decoder, resolve_device
from .priors import per_to_ratio

__all__ = ["BeliefPropagationDecoder", "BPDecode"]


def as_graph(H) -> TannerGraph:
    return H if isinstance(H, TannerGraph) else TannerGraph.from_pcm(H)


class BPDecode(torch.nn.Module):
    """``forward(syndromes [B, m], ratio=None) -> (err int8, converged bool,
    iters int32, logp)`` with the graph's tables as buffers on ``device``
    (the counterpart of the reference's ``make_bp_decode_fn``).

    ``ratio`` overrides the channel prior (probability-ratio domain,
    scalar, ``[n]`` or ``[B, n]``) for one call.
    """

    def __init__(self, graph: TannerGraph, per, max_iters: int, *, device,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.m, self.n = graph.m, graph.n
        self.max_dc, self.max_dv = graph.max_dc, graph.max_dv
        self.max_iters = int(max_iters)
        self.dtype = dtype
        c2v_t, v2c_t, chk_mask_t, var_mask_t = graph.slot_major()

        def buf(name, a):
            self.register_buffer(name, torch.as_tensor(a, device=device))

        buf("c2v", c2v_t.astype(np.int64))
        buf("v2c", v2c_t.astype(np.int64))
        buf("chk_mask", chk_mask_t)  # [max_dc, m]
        buf("var_mask", var_mask_t)  # [max_dv, n]
        self.register_buffer("default_ratio", self.as_ratio(per))
        self.syndrome_from = SyndromeCheck(graph, device)

    def as_ratio(self, per) -> torch.Tensor:
        """Validate a scalar / [n] / [B, n] prior; convert to the ratio domain."""
        return torch.as_tensor(per_to_ratio(per, self.n), dtype=self.dtype,
                               device=self.var_mask.device)

    def check_update(self, Q, syn_sign):
        """Var-side messages Q [B, dv, n] -> check-side R [B, dc, m]."""
        B, one = Q.shape[0], 1.0
        Qg = Q.reshape(B, self.max_dv * self.n).index_select(1, self.c2v)
        Qg = Qg.reshape(B, self.max_dc, self.m)
        delta = 2.0 / (one + Qg) - one
        delta = torch.where(self.chk_mask, delta, torch.ones((), dtype=delta.dtype,
                                                             device=delta.device))
        fwd, bwd = exclusive_prods(delta, dim=1)
        r = syn_sign[:, None, :] * fwd * bwd
        return (one - r) / (one + r)

    def var_update(self, R, channel_ratio):
        """Check-side R [B, dc, m] -> (Q [B, dv, n], err [B, n], logp)."""
        B = R.shape[0]
        Rg = R.reshape(B, self.max_dc * self.m).index_select(1, self.v2c)
        Rg = Rg.reshape(B, self.max_dv, self.n)
        Rg = torch.where(self.var_mask, Rg, torch.ones((), dtype=Rg.dtype, device=Rg.device))
        init = torch.broadcast_to(channel_ratio, (B, self.n)).to(self.dtype)
        Q, total = guarded_exclusive_prod_scan(Rg, init, dim=1)
        logp = torch.log(1.0 / total)
        err = (total >= 1.0).to(torch.float32)
        return Q, err, logp

    def forward(self, syndromes: torch.Tensor, ratio: torch.Tensor | None = None):
        channel_ratio = self.default_ratio if ratio is None else ratio
        B, n, device = syndromes.shape[0], self.n, syndromes.device
        syn_f = syndromes.to(torch.float32)
        syn_sign = (1.0 - 2.0 * syn_f).to(self.dtype)

        prior = channel_ratio[..., None, :] if channel_ratio.ndim else channel_ratio
        one = torch.ones((), dtype=self.dtype, device=device)
        Q = torch.where(self.var_mask, prior, one) * torch.ones((B, 1, 1), dtype=self.dtype,
                                                                 device=device)
        err = torch.zeros((B, n), dtype=torch.float32, device=device)
        logp = torch.zeros((B, n), dtype=self.dtype, device=device)
        done = torch.zeros((B,), dtype=torch.bool, device=device)
        iters = torch.zeros((B,), dtype=torch.int32, device=device)

        it = 0
        while it < self.max_iters and not bool(done.all()):
            R = self.check_update(Q, syn_sign)
            Q, errn, logpn = self.var_update(R, channel_ratio)
            active = ~done
            # only the [B, n] outputs freeze on convergence; the message
            # state of done lanes no longer reaches any output
            err = torch.where(active[:, None], errn, err)
            logp = torch.where(active[:, None], logpn, logp)
            ok = (self.syndrome_from(err) == syn_f).all(dim=-1)
            iters = torch.where(ok & active, it + 1, iters)
            done = done | ok
            it += 1
        iters = torch.where(done, iters, it).to(torch.int32)
        return err.to(torch.int8), done, iters, logp


class BeliefPropagationDecoder(Decoder):
    """Sum-product BP decoder with reference-parity numerics.

    Args:
      H: ``[m, n]`` parity-check matrix (dense or scipy-sparse 0/1), or a
        compiled :class:`TannerGraph`.
      per: physical error rate (scalar or per-bit ``[n]``).
      max_iters: maximum BP iterations.
      device: where the graph tables live and decoding runs.
      dtype: message dtype (float32 default).
    """

    def __init__(self, H, per, max_iters: int, *, device="cpu", dtype=torch.float32):
        super().__init__()
        self.device = resolve_device(device)
        self.graph = as_graph(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = per if np.ndim(per) else float(per)
        self.max_iters = int(max_iters)
        self.bp = BPDecode(self.graph, self.per, self.max_iters, device=self.device,
                           dtype=dtype)

    def _decode_batch(self, syndromes, per=None):
        ratio = None if per is None else self.bp.as_ratio(per)
        err, converged, iters, logp = self.bp(syndromes, ratio)
        return err, converged, iters, {"log_probabs": logp}
