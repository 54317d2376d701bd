"""Batched normalized/offset min-sum BP decoder.

Counterpart of ``ldpcdecoders_tpu/models/minsum.py``, with the same
numerics as its default path.  Min-sum replaces the check node's tanh/ratio
products with a sign-parity + two-minimum reduction: no transcendentals, no
NaN guards, at a loss of about 0.1-0.2 dB against sum-product that the
normalization factor alpha mostly recovers (Chen & Fossorier 2002).

Messages live in the slot-major ``[B, slot, node]`` layout.  An iteration
is two launches of the hand-written kernels of ops/cuda_minsum.py on a card
(their plain versions on the CPU), each doing its own cross-layout gather:

  * the check update (K3).  In the check layout from the second iteration
    on, it also rebuilds the messages as ``total[var] - mu`` and applies the
    damping mix, updating ``mu`` (and, damped, ``nu``) in place;
  * the variable update (K4): the totals, in the variable layout the
    leave-one-out messages and the damping mix in place, and on the
    iterations that run the syndrome check the freeze of ``err`` / ``llrs``.

In the check layout the kernels' state (``mu``, damped ``nu``, the totals,
``L0``, the gammas, the syndrome bits and the frozen ``err`` / ``llrs``) is
lane-tiled, T lanes innermost (ops/minsum.py ``tile_lanes``;
:func:`lane_tile_for`: 64 or 128 lanes by batch on a card, lane-major below
64 lanes and on the CPU; the lanes padded to a multiple of T, the padded lanes out of ``done``,
``iters`` and the checks): tiled once at entry, untiled once at exit, and
``err`` (with ``track_best`` also ``llrs``) untiled for each syndrome
check.  The tiling changes no lane's arithmetic, so every output is the
lane-major decode's bit for bit.

The syndrome check, ``iters`` / ``done`` and ``track_best`` are plain torch
and run only where the check runs: ``done`` changes nowhere else, and the
outputs an iteration between two checks would freeze are overwritten by the
next check's.  The reference's ``while_loop`` becomes a Python loop that
stops once every lane has converged; the host reads that flag (one
synchronization on a card) at the checks alone: every ``check_every``-th
iteration and the last.  ``early_exit=False`` runs all ``max_iters``
iterations with no host read (the outputs of converged lanes are frozen).
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.graph import TannerGraph
from ..ops.cuda_minsum import (LANE_TILES, minsum_check_cuda, minsum_check_iter_cuda,
                                minsum_var_iter_cuda)
from ..ops.minsum import slot_degrees, tile_lanes, untile_lanes
from ..ops.syndrome import SyndromeCheck
from ..utils.profiling import count, host_bool, span
from .base import Decoder, resolve_device
from .bp import as_graph
from .priors import per_to_llr

__all__ = ["MinSumDecoder", "MinSumDecode", "from_reference_params", "make_minsum_decode_fn"]

_BIG_MISMATCH = 1 << 30


def lane_tile_for(B: int) -> int:
    """The check layout's lane tile on a card for a batch of ``B`` lanes: of
    the kernels' tiles (64, 128 lanes; csrc/minsum.cu "Lane tiles"), the one
    that pads the batch least, the largest of those that tie; 1 (lane-major)
    below 64 lanes, where a tile would be largely padding.  Larger tiles are
    faster a lane, padding is work: at the bb144 R=6 DEM's shape a decode of
    6 x 256 lanes took 0.74x the lane-major time on 128-lane tiles, one of 6 x
    32 lanes 0.74x on 64-lane tiles and 1.07x padded to 128, one of 24 lanes
    1.35x padded to 64 (H100 80GB HBM3, 700 W; PERF.md)."""
    if B < LANE_TILES[0]:
        return 1
    return min(LANE_TILES, key=lambda t: (-(-B // t) * t, -t))


def from_reference_params(alpha, beta, edge_weights, *, max_iters, max_dv, n, dtype, device):
    """Carry a min-sum schedule across from numpy.

    ``alpha`` / ``beta`` are scalars or per-iteration ``[max_iters]`` arrays;
    ``edge_weights`` is None or ``[max_iters, max_dv, n]`` (var-slot layout).
    Returns ``(alphas, betas, edge_weights)``: the factors as Python floats
    rounded to ``dtype`` (a list of ``max_iters`` floats each if either was
    per-iteration, else one float each), and the weights as a ``dtype``
    tensor on ``device``.
    """

    def rounded(v):
        return torch.as_tensor(np.array(v, np.float64)).to(dtype).to(torch.float64)

    if np.ndim(alpha) or np.ndim(beta):
        alphas = rounded(np.broadcast_to(alpha, (max_iters,))).tolist()
        betas = rounded(np.broadcast_to(beta, (max_iters,))).tolist()
    else:
        alphas, betas = float(rounded(alpha)), float(rounded(beta))
    if edge_weights is not None:
        edge_weights = torch.as_tensor(np.asarray(edge_weights), device=device).to(dtype)
        if tuple(edge_weights.shape) != (max_iters, max_dv, n):
            raise ValueError(
                f"edge_weights must be [{max_iters}, {max_dv}, {n}], "
                f"got {tuple(edge_weights.shape)}")
        edge_weights = edge_weights.contiguous()
    return alphas, betas, edge_weights


class MinSumDecode(torch.nn.Module):
    """``forward(syndromes [B, m], L0=None, gamma=None) -> (err int8,
    converged bool, iters int32, llrs)`` with the graph's tables as buffers
    on ``device`` (the counterpart of the reference's
    ``make_minsum_decode_fn``).

    ``L0`` overrides the channel LLR (scalar, ``[n]`` or ``[B, n]``) for one
    call; ``early_exit=False`` runs every iteration without reading
    ``done`` on the host (the fused BP+OSD).

    ``damping`` in [0, 1) mixes each new variable->check message with the
    previous iteration's (``nu <- damping * nu_old + (1-damping) * nu_new``),
    the standard stabilizer for loopy, trapping-set-heavy graphs.  With
    ``lane_damping=True`` the factor is a decode-time argument instead:
    ``gamma [B]`` gives one factor per lane (tiling one syndrome across K
    lanes with K factors runs an ensemble as ordinary batch lanes), and
    ``gamma [B, n]`` per-variable memory strengths, possibly negative.

    ``check_every`` runs the syndrome-consistency test only every k-th
    iteration (always at the last).  A lane that becomes consistent between
    checks freezes at the next check: convergence claims are unchanged,
    iteration counts are rounded up to the check grid.

    ``edge_weights [max_iters, max_dv, n]`` applies per-edge message
    weights (var-slot layout) in the variable update; ``alpha`` / ``beta``
    may be per-iteration ``[max_iters]`` arrays.

    ``layout`` selects the message residency: ``"var"`` keeps the
    var->check messages ``nu [B, max_dv, n]`` as state; ``"check"`` keeps
    them in check-slot layout ``[B, max_dc, m]`` and rebuilds them as
    ``total[var] - mu``, so the check update reads its state directly.  The
    check layout takes neither ``edge_weights`` nor per-iteration alpha.

    ``track_best`` returns, for a lane that never converges, the hard
    decision and LLRs of the iterate with the fewest syndrome mismatches
    seen at any check instead of the last one.
    """

    def __init__(self, graph: TannerGraph, per, max_iters: int, *, device,
                 alpha=1.0, beta=0.0, dtype=torch.float32, edge_weights=None,
                 damping: float = 0.0, check_every: int = 1, lane_damping: bool = False,
                 layout: str = "var", track_best: bool = False, _lane_tile: int | None = None):
        super().__init__()
        device = resolve_device(device)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.m, self.n = graph.m, graph.n
        self.max_dc, self.max_dv = graph.max_dc, graph.max_dv
        self.max_iters = int(max_iters)
        self.dtype = dtype
        self.per_iter_ab = bool(np.ndim(alpha) or np.ndim(beta))
        self.alpha, self.beta, edge_weights = from_reference_params(
            alpha, beta, edge_weights, max_iters=self.max_iters, max_dv=self.max_dv,
            n=self.n, dtype=dtype, device=device)
        if not 0.0 <= float(damping) < 1.0:
            raise ValueError(f"damping must be in [0, 1), got {damping}")
        if lane_damping and damping:
            raise ValueError("pass lane_damping gammas at decode time, not a "
                             "baked scalar damping")
        self.check_every = int(check_every)
        if self.check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        if layout not in ("var", "check"):
            raise ValueError(f"layout must be 'var' or 'check', got {layout!r}")
        if layout == "check" and (edge_weights is not None or self.per_iter_ab):
            raise ValueError("layout='check' supports neither edge_weights nor "
                             "per-iteration alpha/beta")
        self.damping = float(damping)
        self.lane_damping = bool(lane_damping)
        self.layout = layout
        self.track_best = bool(track_best)
        # the check layout's lane tile: None, by batch on a card
        # (lane_tile_for) and lane-major on the CPU; the variable layout is
        # lane-major
        self._lane_tile = _lane_tile if layout == "check" else 1

        c2v_t, v2c_t, chk_mask_t, var_mask_t = graph.slot_major()

        def buf(name, a):
            self.register_buffer(name, None if a is None else torch.as_tensor(a, device=device))

        buf("c2v", c2v_t.astype(np.int32))
        buf("v2c", v2c_t.astype(np.int32))
        buf("chk_mask", chk_mask_t)  # [max_dc, m]
        buf("var_mask", var_mask_t)  # [max_dv, n]
        # the kernels run each node's loops to its degree (real slots first)
        buf("chk_deg", slot_degrees(torch.as_tensor(chk_mask_t)))
        buf("var_deg", slot_degrees(torch.as_tensor(var_mask_t)))
        # var index per check slot: the check layout gathers totals through it
        buf("chk_varidx", np.ascontiguousarray(graph.chk_vars.T).reshape(-1).astype(np.int32)
            if layout == "check" else None)
        buf("edge_weights", edge_weights)
        buf("default_L0", torch.as_tensor(per_to_llr(per, self.n)).to(dtype))
        buf("gam", torch.tensor(self.damping, dtype=dtype))
        self.syndrome_from = SyndromeCheck(graph, device)

    def as_prior(self, per) -> torch.Tensor:
        """Validate a scalar / [n] / [B, n] prior; convert to float32 LLRs."""
        return torch.as_tensor(per_to_llr(per, self.n), dtype=torch.float32,
                               device=self.var_mask.device)

    def forward(self, syndromes: torch.Tensor, L0: torch.Tensor | None = None, gamma=None, *,
                early_exit: bool = True):
        with span("ldpc.minsum.decode"):
            return self._forward(syndromes, L0, gamma, early_exit)

    def _forward(self, syndromes, L0, gamma, early_exit):
        if self.lane_damping:
            if gamma is None:
                raise ValueError("lane_damping decoders take a [B] gamma")
        elif gamma is not None:
            raise ValueError("gamma requires lane_damping=True")
        B, n, m, device = syndromes.shape[0], self.n, self.m, syndromes.device
        check_layout = self.layout == "check"
        L0 = self.default_L0 if L0 is None else torch.as_tensor(L0, device=device)
        # scalar, [n] or per-lane [B, n]; normalize to [B, n] once
        L0 = torch.broadcast_to(L0.to(self.dtype), (B, n)).contiguous()
        syn_f = syndromes.to(torch.float32)
        syn_flip = syndromes.to(torch.bool).contiguous()

        g = self.gam if self.damping else None
        if self.lane_damping:
            g = torch.as_tensor(gamma, device=device).to(self.dtype)
            g = (g.reshape(B) if g.ndim == 1 else g.reshape(B, n)).contiguous()

        # the kernels' state, lane-tiled in the check layout: the tiled form
        # of a [B, ...] tensor is [B / T, ..., T] (T = 1: the tensor itself),
        # the lanes past B padded (done there, so never frozen)
        T = self._lane_tile
        if T is None:  # the CPU's plain versions gain nothing from tiles
            T = lane_tile_for(B) if device.type == "cuda" else 1
        bt = -(-B // T)

        def lanes(*rest):
            return (bt, *rest, T) if T > 1 else (bt, *rest)

        def untile(t):
            return untile_lanes(t, T)[:B]

        L0_k = tile_lanes(L0, T)
        flip_k = tile_lanes(syn_flip, T)
        g_k = g if g is None or g.ndim == 0 else tile_lanes(g, T)
        # llrs is written in place by the freeze: a copy, never L0 itself
        err_k = torch.zeros(lanes(n), dtype=torch.float32, device=device)
        llrs_k = L0_k.clone()
        done = torch.zeros((B,), dtype=torch.bool, device=device)
        done_k = tile_lanes(done, T, True)
        iters = torch.zeros((B,), dtype=torch.int32, device=device)
        if self.track_best:
            bmis = torch.full((B,), _BIG_MISMATCH, dtype=torch.int32, device=device)
            berr = torch.zeros((B, n), dtype=torch.float32, device=device)
            bllr = L0.to(torch.float32)
        chk_kw = dict(chk_deg=self.chk_deg, lane_tile=T)
        var_kw = dict(var_deg=self.var_deg, lane_tile=T)
        if check_layout:
            # state: mu [B, dc, m], the totals, and nu [B, dc, m] where damped
            # (the first iteration's messages are L0 at each slot's variable)
            mu = None
            total = torch.empty_like(L0_k)
            nu = (None if g is None else
                  L0_k.index_select(1, self.chk_varidx).reshape(lanes(self.max_dc, m)))
        else:
            nu = torch.broadcast_to(L0[:, None, :], (B, self.max_dv, n)).contiguous()

        it = 0
        while it < self.max_iters and B:
            # the iterations up to the next check (the last always checks)
            with span("ldpc.minsum.iters"):
                checked = False
                while not checked:
                    alpha, beta = ((self.alpha[it], self.beta[it]) if self.per_iter_ab
                                   else (self.alpha, self.beta))
                    checked = (it + 1) % self.check_every == 0 or it + 1 >= self.max_iters
                    # the freeze only where the check reads it (done is fixed between)
                    freeze = dict(done=done_k, err=err_k, llrs=llrs_k) if checked else {}
                    if check_layout:
                        if mu is None:
                            mu = minsum_check_cuda(L0_k, self.chk_varidx, flip_k,
                                                   self.chk_mask, alpha, beta, **chk_kw)
                        else:
                            minsum_check_iter_cuda(mu, total, self.chk_varidx, flip_k,
                                                   self.chk_mask, alpha, beta, gamma=g_k,
                                                   nu=nu, **chk_kw)
                        minsum_var_iter_cuda(mu.reshape(lanes(self.max_dc * m)), self.v2c,
                                             self.var_mask, L0_k, total=total, **freeze,
                                             **var_kw)
                    else:
                        mu = minsum_check_cuda(nu.reshape(B, self.max_dv * n), self.c2v,
                                               syn_flip, self.chk_mask, alpha, beta, **chk_kw)
                        W = None if self.edge_weights is None else self.edge_weights[it]
                        minsum_var_iter_cuda(mu.reshape(B, self.max_dc * m), self.v2c,
                                             self.var_mask, L0, W=W, nu=nu, gamma=g,
                                             **freeze, **var_kw)
                    it += 1
            with span("ldpc.minsum.check"):
                err = untile(err_k)
                active = ~done
                mis = (self.syndrome_from(err) != syn_f).sum(dim=-1).to(torch.int32)
                ok = mis == 0
                iters = torch.where(ok & active, it, iters)
                done = done | ok
                done_k = tile_lanes(done, T, True)
                if self.track_best:
                    better = active & (mis < bmis)
                    bmis = torch.where(better, mis, bmis)
                    berr = torch.where(better[:, None], err, berr)
                    bllr = torch.where(better[:, None], untile(llrs_k).to(torch.float32), bllr)
                # ``done`` changes only where the check ran: read it there alone
                if early_exit and host_bool(done.all()):
                    break
        # lanes launched (tile padding and ensemble members included) times
        # the iterations run
        count("minsum_lane_iters_launched", bt * T * it)
        iters = torch.where(done, iters, it).to(torch.int32)
        if self.track_best:
            # converged lanes froze at mismatch 0 (their best); the rest
            # report their least-inconsistent iterate
            return berr.to(torch.int8), done, iters, bllr
        return untile(err_k).to(torch.int8), done, iters, untile(llrs_k)


def make_minsum_decode_fn(graph: TannerGraph, per, max_iters: int, *, alpha=1.0, beta=0.0,
                          dtype=torch.float32, use_pallas: bool = False,
                          pallas_interpret: bool = False, edge_weights=None,
                          damping: float = 0.0, check_every: int = 1,
                          lane_damping: bool = False, vectorized_check: bool | None = None,
                          layout: str = "var", track_best: bool = False, device=None):
    """Build ``decode(syndromes [B, m], L0=None, gamma=None) -> (err int8,
    converged bool, iters int32, llrs)``, the reference's functional core,
    running :class:`MinSumDecode` (its knobs are documented there) on
    ``device`` (None: the current CUDA card).  On a CUDA device every
    iteration runs the hand-written check and variable kernels.

    ``dtype`` is a torch dtype (``torch.float32``, ``torch.bfloat16``) where
    the reference takes a jnp one.  The reference's TPU knobs are accepted
    and ignored: ``use_pallas`` / ``pallas_interpret`` (the kernels always
    run on a card, and the prior may be overridden either way) and
    ``vectorized_check`` (the reference's two check forms are bit-identical).
    ``syndromes``, ``L0`` (scalar, ``[n]`` or ``[B, n]``) and ``gamma`` may be
    numbers, numpy arrays or tensors; they are moved to ``device``.
    """
    del use_pallas, pallas_interpret, vectorized_check
    ms = MinSumDecode(graph, per, max_iters, device=device, alpha=alpha, beta=beta, dtype=dtype,
                      edge_weights=edge_weights, damping=damping, check_every=check_every,
                      lane_damping=lane_damping, layout=layout, track_best=track_best)
    device = ms.var_mask.device

    def decode(syndromes, L0=None, gamma=None):
        return ms(torch.as_tensor(syndromes, device=device), L0, gamma)

    return decode


class MinSumDecoder(Decoder):
    """Normalized/offset min-sum decoder (LLR domain).

    Args:
      H: ``[m, n]`` parity-check matrix (dense or scipy-sparse 0/1), or a
        compiled :class:`TannerGraph`.
      per: physical error rate (sets the channel LLR), scalar or ``[n]``.
      max_iters: maximum iterations.
      alpha: normalization factor (1.0 = plain min-sum; about 0.8 typically
        recovers most of the sum-product gap).
      beta: offset subtracted from the magnitude before clamping at 0.
      damping: message-damping factor in [0, 1).
      check_every: run the syndrome-consistency test every k-th iteration.
      dtype: message dtype, torch.float32 or torch.bfloat16.
      layout: message residency, ``"var"`` (default) or ``"check"``
        (decode-equivalent, not bitwise).
      device: where the graph tables live and decoding runs; None is the
        current CUDA card.  On a CUDA device the message updates run in the
        hand-written kernels.

    :class:`MinSumDecode` has the remaining knobs (``edge_weights``,
    ``lane_damping``, ``track_best``).

    Example:

    >>> import numpy as np
    >>> from ldpcdecoders_tpu_torch import MinSumDecoder
    >>> H = np.array([[1, 1, 0], [0, 1, 1]], np.uint8)
    >>> dec = MinSumDecoder(H, 0.05, 10, device="cpu")
    >>> err, converged = dec.decode(np.array([1, 0]))
    >>> err.astype(int).tolist(), converged
    ([1, 0, 0], True)
    """

    def __init__(self, H, per, max_iters: int, *, alpha=1.0, beta=0.0,
                 dtype=torch.float32, damping: float = 0.0, check_every: int = 1,
                 layout: str = "var", device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.graph = as_graph(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = per if np.ndim(per) else float(per)
        self.max_iters = int(max_iters)
        self.alpha = alpha if np.ndim(alpha) else float(alpha)
        self.beta = beta if np.ndim(beta) else float(beta)
        self.dtype = dtype
        self.damping = float(damping)
        self.check_every = int(check_every)
        self.layout = str(layout)
        self.minsum = MinSumDecode(
            self.graph, self.per, self.max_iters, device=self.device, alpha=alpha, beta=beta,
            dtype=dtype, damping=damping, check_every=check_every, layout=layout)

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        L0 = None if per is None else self.minsum.as_prior(per)
        err, converged, iters, llrs = self.minsum(syndromes, L0)
        return err, converged, iters, {"llrs": llrs}
