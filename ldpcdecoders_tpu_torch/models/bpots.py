"""Batched BP decoder with Ordered-Trapping-Set (OTS) biasing.

Counterpart of ``ldpcdecoders_tpu/models/bpots.py`` (the Julia package's
LLR-domain BP-OTS, bpots_decoder.jl:226-340), in plain torch with the same
semantics and the same association order:

  * variable-to-check messages as the total minus the own message over the
    padded variable-side layout;
  * check-to-variable messages from exclusive products of clamped tanh
    values, the syndrome sign, atanh and the +/-100 clamp;
  * oscillation counting, best-(mismatch, weight) tracking and convergence
    at the first zero mismatch;
  * every ``T`` iterations, on lanes still unmatched: the working prior is
    reset to the depolarizing-channel LLR and the most oscillating node
    (ties: smaller ``|llr|``, then first index) and the least reliable one
    are biased to ``-C``.

The reference gates the biasing with ``lax.cond`` on the iteration counter;
here the counter is a host integer, so the gate is a Python ``if`` and needs
no synchronization.  The loop stops once every lane has converged (one host
read per iteration on a card); ``trace=True`` runs all ``max_iters``
iterations and returns the reference's per-iteration records.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.graph import TannerGraph
from ..ops.clamps import MSG_CLAMP, TANH_CLAMP
from ..ops.exclusive import exclusive_prods
from ..ops.minsum import slot_sum
from ..ops.syndrome import SyndromeCheck
from .base import Decoder, resolve_device
from .bp import as_graph
from .priors import per_to_depolarizing_llr

__all__ = ["BPOTSDecoder", "BPOTSDecode", "make_bpots_decode_fn", "select_bias_nodes"]


def select_bias_nodes(osc: torch.Tensor, absllr: torch.Tensor):
    """OTS bias-node selection with the reference's tie order.

    j1 = argmax oscillation count, ties broken by smaller ``|llr|``, then
    first index (bpots_decoder.jl:300-321); j2 = global argmin ``|llr|``,
    first index on ties (bpots_decoder.jl:323-334; j2 may equal j1).
    Batched: ``osc [B, n]`` int, ``absllr [B, n]``; returns ``(j1 [B], j2
    [B], has_osc [B])``: biasing applies only where the largest
    oscillation count is above 0.
    """
    max_osc = osc.amax(dim=-1)
    has_osc = max_osc > 0
    cand = osc == max_osc[:, None]
    inf = torch.full((), float("inf"), dtype=absllr.dtype, device=absllr.device)
    j1 = torch.where(cand, absllr, inf).argmin(dim=-1)
    j2 = absllr.argmin(dim=-1)
    return j1, j2, has_osc


class BPOTSDecode(torch.nn.Module):
    """``forward(syndromes [B, m], pi=None) -> (best_dec int8, converged
    bool, iters int32, llrs)``, or with ``trace=True`` ``(outputs,
    records)`` where ``records`` stacks each iteration's ``dec``, ``osc``
    (before the bias), ``mis``, ``weight``, ``best_mis``, ``best_w``,
    ``llrs``, ``j1``, ``j2``, ``biased`` and ``active`` along a leading
    ``[max_iters]`` axis (the reference's trace dict).

    ``pi`` overrides the prior LLR (scalar, ``[n]`` or ``[B, n]``, in the
    message dtype) for one call.
    """

    def __init__(self, graph: TannerGraph, per, max_iters: int, T: int = 9, C: float = 2.0,
                 *, device, dtype=torch.float32, trace: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.m, self.n = graph.m, graph.n
        self.max_dc, self.max_dv = graph.max_dc, graph.max_dv
        self.max_iters, self.T, self.C = int(max_iters), int(T), float(C)
        self.dtype, self.trace = dtype, bool(trace)
        c2v_t, v2c_t, chk_mask_t, var_mask_t = graph.slot_major()

        def buf(name, a):
            self.register_buffer(name, torch.as_tensor(a, device=device))

        buf("c2v", c2v_t.astype(np.int64))
        buf("v2c", v2c_t.astype(np.int64))
        buf("chk_mask", chk_mask_t)  # [max_dc, m]
        buf("var_mask", var_mask_t)  # [max_dv, n]
        # depolarizing-channel LLR prior (bpots_decoder.jl:231); scalar or [n]
        self.register_buffer("default_pi", self.as_prior(per))
        self.syndrome_from = SyndromeCheck(graph, device)

    def as_prior(self, per) -> torch.Tensor:
        return torch.as_tensor(per_to_depolarizing_llr(per, self.n), dtype=self.dtype,
                               device=self.var_mask.device)

    def messages(self, Mg, Omega, syn_bool):
        """One BP-OTS message pass: ``Mg [B, dv, n]`` -> ``(Mg_new, llrs)``."""
        B, dt = Mg.shape[0], self.dtype
        one = torch.ones((), dtype=dt, device=Mg.device)
        total = Omega + slot_sum(Mg)
        nu = total[:, None, :] - Mg
        Ng = nu.reshape(B, self.max_dv * self.n).index_select(1, self.c2v)
        Ng = Ng.reshape(B, self.max_dc, self.m)
        t = torch.clamp(torch.tanh(0.5 * Ng), -TANH_CLAMP, TANH_CLAMP)
        t = torch.where(self.chk_mask, t, one)
        fwd, bwd = exclusive_prods(t, dim=1)
        prod = fwd * bwd
        prod = torch.where(syn_bool[:, None, :], -prod, prod)
        prod = torch.clamp(prod, -TANH_CLAMP, TANH_CLAMP)
        mu = torch.clamp(2.0 * torch.atanh(prod), -MSG_CLAMP, MSG_CLAMP)
        Mg_new = mu.reshape(B, self.max_dc * self.m).index_select(1, self.v2c)
        Mg_new = Mg_new.reshape(B, self.max_dv, self.n)
        Mg_new = torch.where(self.var_mask, Mg_new, torch.zeros((), dtype=dt, device=Mg.device))
        return Mg_new, Omega + slot_sum(Mg_new)

    def forward(self, syndromes: torch.Tensor, pi: torch.Tensor | None = None):
        pi_val = self.default_pi if pi is None else pi
        B, m, n, device = syndromes.shape[0], self.m, self.n, syndromes.device
        i32 = dict(dtype=torch.int32, device=device)
        syn_f = syndromes.to(torch.float32)
        syn_bool = syndromes.to(torch.bool)
        neg_C = torch.full((), -self.C, dtype=self.dtype, device=device)

        Mg = torch.zeros((B, self.max_dv, n), dtype=self.dtype, device=device)
        Omega = torch.broadcast_to(pi_val, (B, n)).to(self.dtype).clone()
        osc = torch.zeros((B, n), **i32)
        prior_dec = torch.zeros((B, n), **i32)
        best_dec = torch.zeros((B, n), **i32)
        best_mis = torch.full((B,), m, **i32)
        best_w = torch.full((B,), n, **i32)
        llrs = torch.zeros((B, n), dtype=self.dtype, device=device)
        done = torch.zeros((B,), dtype=torch.bool, device=device)
        iters = torch.zeros((B,), **i32)
        cols = torch.arange(n, device=device)
        records = []

        it = 0
        while it < self.max_iters and (self.trace or not bool(done.all())):
            active = ~done
            Mg, llrs_it = self.messages(Mg, Omega, syn_bool)
            dec = (llrs_it < 0).to(torch.int32)
            # oscillation tracking from the second iteration on
            osc_it = osc + (dec ^ prior_dec) if it >= 1 else osc
            syn_hat = self.syndrome_from(dec.to(torch.float32))
            mis = (syn_hat != syn_f).sum(dim=-1).to(torch.int32)
            weight = dec.sum(dim=-1).to(torch.int32)
            better = (mis < best_mis) | ((mis == best_mis) & (weight < best_w))
            upd = active & better
            best_dec = torch.where(upd[:, None], dec, best_dec)
            best_mis = torch.where(upd, mis, best_mis)
            best_w = torch.where(upd, weight, best_w)
            newly = active & (mis == 0)
            iters = torch.where(newly, it + 1, iters)
            done = done | newly

            zj = torch.zeros((B,), **i32)
            j1, j2, biased, osc_post = zj, zj, torch.zeros_like(done), osc_it
            if (it + 1) % self.T == 0:
                # OTS biasing of the lanes still unmatched
                bias_lane = active & ~newly & (mis > 0)
                j1, j2, has_osc = select_bias_nodes(osc_it, llrs_it.abs())
                oh1 = cols == j1[:, None]
                oh2 = cols == j2[:, None]
                apply_b = (bias_lane & has_osc)[:, None]
                Omega_biased = torch.where((oh1 | oh2) & apply_b, neg_C, pi_val)
                Omega = torch.where(bias_lane[:, None], Omega_biased, Omega)
                osc_post = torch.where(oh1 & apply_b, 0, osc_it)
                j1, j2, biased = j1.to(torch.int32), j2.to(torch.int32), bias_lane & has_osc
            if self.trace:
                records.append(dict(dec=dec, osc=osc_it, mis=mis, weight=weight,
                                    best_mis=best_mis, best_w=best_w, llrs=llrs_it, j1=j1,
                                    j2=j2, biased=biased, active=active))
            # freeze finished lanes; the [B, dv, n] messages of done lanes
            # are left alone (they reach no output)
            am = active[:, None]
            osc = torch.where(am, osc_post, osc)
            prior_dec = torch.where(am, dec, prior_dec)
            llrs = torch.where(am, llrs_it, llrs)
            it += 1
        iters = torch.where(done, iters, it).to(torch.int32)
        outputs = (best_dec.to(torch.int8), done, iters, llrs)
        if self.trace:
            return outputs, {k: torch.stack([r[k] for r in records]) for k in records[0]}
        return outputs


def make_bpots_decode_fn(graph: TannerGraph, per, max_iters: int, T: int = 9, C: float = 2.0,
                         *, device=None, dtype=torch.float32, trace: bool = False) -> BPOTSDecode:
    """The decode module: ``(syndromes [B, m], pi=None) -> (best_dec,
    converged, iters, llrs)``, or ``(outputs, records)`` with
    ``trace=True`` (use ``dtype=torch.float64`` for trace work)."""
    return BPOTSDecode(graph, per, max_iters, T, C, device=device, dtype=dtype, trace=trace)


class BPOTSDecoder(Decoder):
    """BP with Ordered-Trapping-Set biasing to escape trapping sets.

    Args:
      H: ``[m, n]`` parity-check matrix, or a compiled TannerGraph.
      per: physical error rate (depolarizing prior; scalar or ``[n]``).
      max_iters: maximum BP iterations.
      T: biasing period (default 9, as bpots_decoder.jl:90).
      C: bias constant (default 2.0).
      dtype: message dtype (``torch.float32`` default, ``torch.float64``
        for trace work).
      device: where decoding runs; None is the current CUDA card.

    Returns the best decision found, ranked by (syndrome mismatch count,
    error weight); ``converged`` means a zero-mismatch solution was found.
    """

    def __init__(self, H, per, max_iters: int, *, T: int = 9, C: float = 2.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.graph = as_graph(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = per if np.ndim(per) else float(per)
        self.max_iters = int(max_iters)
        self.T, self.C, self.dtype = int(T), float(C), dtype
        self.bpots = make_bpots_decode_fn(self.graph, self.per, self.max_iters, self.T, self.C,
                                          device=self.device, dtype=dtype)

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        pi = None if per is None else self.bpots.as_prior(per)
        err, converged, iters, llrs = self.bpots(syndromes, pi)
        return err, converged, iters, {"llrs": llrs}
