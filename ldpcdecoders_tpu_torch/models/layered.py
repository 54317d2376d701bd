"""Layered (serial-C schedule) min-sum decoder.

Counterpart of ``ldpcdecoders_tpu/models/layered.py``.  Flooding min-sum
updates every message from the previous iteration's state; the layered
schedule processes the checks in groups, each group seeing the totals the
groups before it updated, and converges in about half the sweeps.

The checks are partitioned on the host into conflict-free layers (no
variable touched twice within a layer: :func:`build_layers`, carried
bitwise from the reference).  Per layer:

    nu    = total[vars] - mu_old          (gather from the [B, n] totals)
    mu    = minsum(nu)                     (two-min + sign parity)
    total += mu - mu_old                   (an indexed add over the layer)

Each layer keeps only its real edges in the add's index list: the
reference's padded slots all point at variable 0 with a delta of exactly
0, and the real indices of a layer are unique by construction, so the add
is a plain indexed add with the same result on the CPU and the card (a
CUDA ``index_add_`` with duplicate indices would be atomic, in no fixed
order).  The check update is ``ops/minsum.py::check_core_ref`` on the
layer's ``[B, dc, mL]`` slots, which gives the reference's unrolled
two-minimum sweep bit for bit; every product rounds on its own (no fused
multiply-add), as the reference computes op by op.  Convergence is checked
once per full sweep, with one host read of ``done`` per sweep.

The JAX package has no Pallas kernel here: a layer is a few dozen plain
torch launches (chip_smoke.py counts them per sweep).
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.graph import TannerGraph
from ..ops.minsum import check_core_ref
from ..ops.syndrome import SyndromeCheck
from .base import Decoder, resolve_device
from .bp import as_graph
from .minsum import from_reference_params
from .priors import per_to_llr

__all__ = ["LayeredMinSumDecoder", "LayeredMinSumDecode", "build_layers",
           "make_layered_minsum_fn"]


def build_layers(graph: TannerGraph):
    """Greedy conflict-free partition of checks into layers.

    Returns ``(layer_of_check [m], n_layers)`` such that no two checks in
    a layer share a variable.
    """
    m = graph.m
    layers_vars: list[set] = []
    layer_of = np.zeros(m, dtype=np.int64)
    for i in range(m):
        nbrs = set(graph.chk_vars[i, graph.chk_mask[i]].tolist())
        for li, used in enumerate(layers_vars):
            if not (used & nbrs):
                used |= nbrs
                layer_of[i] = li
                break
        else:
            layers_vars.append(set(nbrs))
            layer_of[i] = len(layers_vars) - 1
    return layer_of, len(layers_vars)


class LayeredMinSumDecode(torch.nn.Module):
    """``forward(syndromes [B, m], L0=None) -> (err int8, converged bool,
    sweeps int32, total llrs)``: the counterpart of the reference's
    ``make_layered_minsum_fn``.

    ``max_iters`` counts full sweeps (all layers).  ``damping`` in [0, 1)
    mixes each layer's new check messages with the previous sweep's
    (``mu <- damping * mu_old + (1 - damping) * mu_new``).  ``L0``
    overrides the channel LLR (scalar, ``[n]`` or ``[B, n]``) for one call.
    As in the reference, the returned totals keep evolving on converged
    lanes until every lane has converged; ``err`` freezes per lane.
    """

    def __init__(self, graph: TannerGraph, per, max_iters: int, *, device, alpha=1.0,
                 beta=0.0, dtype=torch.float32, damping: float = 0.0):
        super().__init__()
        device = resolve_device(device)
        if not 0.0 <= float(damping) < 1.0:
            raise ValueError(f"damping must be in [0, 1), got {damping}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.m, self.n = graph.m, graph.n
        self.max_iters = int(max_iters)
        self.dtype = dtype
        self.damping = float(damping)
        self.alpha, self.beta, _ = from_reference_params(
            alpha, beta, None, max_iters=self.max_iters, max_dv=graph.max_dv, n=self.n,
            dtype=dtype, device=device)
        layer_of, self.n_layers = build_layers(graph)
        self.layer_sizes = []
        for li in range(self.n_layers):
            checks = np.flatnonzero(layer_of == li)  # the reference's fill order
            cv = np.ascontiguousarray(graph.chk_vars[checks].T)  # [dc, mL]
            cm = np.ascontiguousarray(graph.chk_mask[checks].T)
            real = np.flatnonzero(cm.reshape(-1))
            self.register_buffer(f"checks{li}", torch.as_tensor(checks, device=device))
            self.register_buffer(f"cv{li}", torch.as_tensor(cv.reshape(-1).astype(np.int64),
                                                            device=device))
            self.register_buffer(f"cm{li}", torch.as_tensor(cm, device=device))
            self.register_buffer(f"real{li}", torch.as_tensor(real, device=device))
            self.register_buffer(f"idx{li}", torch.as_tensor(
                cv.reshape(-1)[real].astype(np.int64), device=device))
            self.layer_sizes.append(int(checks.size))
        self.max_dc = graph.max_dc
        self.register_buffer("default_L0",
                             torch.as_tensor(per_to_llr(per, self.n)).to(dtype).to(device))
        gam = torch.tensor(self.damping, dtype=dtype)
        self.register_buffer("gam", gam.to(device))
        self.register_buffer("one_minus_gam", (1.0 - gam).to(device))
        self.syndrome_from = SyndromeCheck(graph, device)

    def as_prior(self, per) -> torch.Tensor:
        """Validate a scalar / [n] / [B, n] prior; convert to float32 LLRs."""
        return torch.as_tensor(per_to_llr(per, self.n), dtype=torch.float32,
                               device=self.default_L0.device)

    def layer(self, li: int):
        """The buffers of layer ``li``: ``(checks, cv, cm, real, idx)``."""
        return tuple(getattr(self, f"{name}{li}")
                     for name in ("checks", "cv", "cm", "real", "idx"))

    def forward(self, syndromes: torch.Tensor, L0: torch.Tensor | None = None):
        B, n, device, dtype = syndromes.shape[0], self.n, syndromes.device, self.dtype
        L0 = self.default_L0 if L0 is None else torch.as_tensor(L0, device=device)
        total = torch.broadcast_to(L0.to(dtype), (B, n)).contiguous().clone()
        syn_f = syndromes.to(torch.float32)
        syn_flip = syndromes.to(torch.bool)
        layers = [self.layer(li) for li in range(self.n_layers)]
        syn_l = [syn_flip.index_select(1, checks) for checks, *_ in layers]
        mu = [torch.zeros((B, self.max_dc, size), dtype=dtype, device=device)
              for size in self.layer_sizes]
        zero = torch.zeros((), dtype=dtype, device=device)
        err = torch.zeros((B, n), dtype=torch.float32, device=device)
        done = torch.zeros((B,), dtype=torch.bool, device=device)
        iters = torch.zeros((B,), dtype=torch.int32, device=device)
        it = 0
        while it < self.max_iters and not bool(done.all()):
            for li, (_, cv, cm, real, idx) in enumerate(layers):
                nu = total.index_select(1, cv).reshape(mu[li].shape) - mu[li]
                new = torch.where(cm, check_core_ref(nu, syn_l[li], cm, self.alpha, self.beta),
                                  zero)
                if self.damping:
                    new = self.gam * mu[li] + self.one_minus_gam * new
                delta = (new - mu[li]).reshape(B, -1).index_select(1, real)
                total.index_add_(1, idx, delta)
                mu[li] = new
            errn = (total < 0).to(torch.float32)
            active = ~done
            err = torch.where(active[:, None], errn, err)
            ok = (self.syndrome_from(err) == syn_f).all(dim=-1)
            iters = torch.where(ok & active, it + 1, iters)
            done = done | ok
            it += 1
        iters = torch.where(done, iters, it).to(torch.int32)
        return err.to(torch.int8), done, iters, total


def make_layered_minsum_fn(graph: TannerGraph, per, max_iters: int, *, alpha=1.0, beta=0.0,
                           dtype=torch.float32, damping: float = 0.0, device=None):
    """Build ``decode(syndromes [B, m], L0=None) -> (err int8, converged
    bool, sweeps int32, llr)``, the reference's functional core, running
    :class:`LayeredMinSumDecode` on ``device`` (None: the current CUDA card).

    ``max_iters`` counts full sweeps.  ``dtype`` is a torch dtype where the
    reference takes a jnp one.  ``syndromes`` and ``L0`` (scalar, ``[n]`` or
    ``[B, n]``) may be numbers, numpy arrays or tensors; they are moved to
    ``device``.
    """
    layered = LayeredMinSumDecode(graph, per, max_iters, device=device, alpha=alpha, beta=beta,
                                  dtype=dtype, damping=damping)
    device = layered.default_L0.device

    def decode(syndromes, L0=None):
        return layered(torch.as_tensor(syndromes, device=device), L0)

    return decode


class LayeredMinSumDecoder(Decoder):
    """Layered-schedule min-sum (about half the sweeps of flooding).

    Args:
      H: ``[m, n]`` parity-check matrix, or a compiled TannerGraph.
      per: physical error rate (scalar or per-bit ``[n]``).
      max_iters: maximum full sweeps.
      alpha, beta: normalized/offset min-sum parameters.  alpha defaults
        to 0.8 (not 1.0), as in the reference: the layered schedule's
        faster propagation amplifies plain min-sum's magnitude
        overestimate.
      damping: message damping in [0, 1).
      dtype: message dtype, torch.float32 or torch.bfloat16.
      device: where decoding runs; None is the current CUDA card.
    """

    def __init__(self, H, per, max_iters: int, *, alpha: float = 0.8, beta: float = 0.0,
                 damping: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.graph = as_graph(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = per if np.ndim(per) else float(per)
        self.max_iters = int(max_iters)
        self.damping = float(damping)
        self.layered = LayeredMinSumDecode(
            self.graph, self.per, self.max_iters, device=self.device, alpha=alpha, beta=beta,
            dtype=dtype, damping=self.damping)
        self.n_layers = self.layered.n_layers

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        L0 = None if per is None else self.layered.as_prior(per)
        err, converged, iters, llr = self.layered(syndromes, L0)
        return err, converged, iters, {"llrs": llr}
