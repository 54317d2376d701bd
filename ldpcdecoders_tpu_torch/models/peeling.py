"""Batched erasure-channel peeling decoder (+ exact GF(2) completion).

Counterpart of ``ldpcdecoders_tpu/models/peeling.py``.  Peeling is a chain
of "find a check with exactly one erased neighbour, read that bit off its
syndrome" steps, batched as parallel leaf peeling: every degree-1 check of
every lane resolves in the same round (simultaneous assignments to one bit
agree: every determining check's syndrome gives the same value).

When peeling stalls on a stopping set (every remaining check touches two
or more erasures), ``on_stuck="gf2"`` completes exactly: the residual
system ``H[:, eps] x = s_res`` goes through the Gauss–Jordan elimination
(ops/cuda_gf2.py ``gf2_eliminate_cuda``: on a card the hand-written kernel,
and for lanes past one block, such as the (2400, 6, 3) code's, its
device-memory body) with the columns outside the erasure masked to zero
per lane, so pivots land on erased bits only: maximum-likelihood decoding
on the erasure channel.  ``on_stuck="fail"`` reports stuck lanes as not
converged.

The reference's ``while_loop`` on "any lane progressed" becomes a Python
loop with one host read of that flag per round, and its ``lax.cond`` gate
around the elimination one host read of ``stuck.any()``.  The elimination
runs on the stuck lanes alone (compacted): a lane that peeled its whole
erasure has an all-zero masked system, whose elimination leaves ``fix`` at
0 and makes the lane solvable exactly when its residual syndrome is 0, so
the compacted output is identical.  All of it is bool and int work:
``err``, ``ok`` and ``depth`` are bitwise the reference's.

API note: erasure decoding needs the erasure mask beside the syndrome, so
this class does not subclass ``Decoder``: ``batch_decode(syndromes,
erasures)`` / ``decode(syndrome, erasure)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.graph import TannerGraph
from ..ops.cuda_gf2 import gf2_eliminate_cuda
from ..ops.gf2 import pack_bits, scatter_pivots
from ..ops.syndrome import SyndromeCheck
from .base import resolve_device

__all__ = ["ErasurePeelingDecoder", "PeelingDecode", "PeelCore", "make_peeling_decode_fn",
           "make_peel_fn", "graph_of"]


def graph_of(H) -> TannerGraph:
    """A TannerGraph as the reference's erasure decoders build it: sparse
    input from its edges (no dense H), dense input with its H."""
    if isinstance(H, TannerGraph):
        return H
    if hasattr(H, "tocoo"):
        coo = H.tocoo()
        return TannerGraph.from_edges(coo.row, coo.col, *H.shape)
    return TannerGraph.from_pcm(np.asarray(H))


class PeelCore(torch.nn.Module):
    """Parallel leaf peeling: ``forward(syndromes [B, m], erasures [B, n])
    -> (err [B, n] int32, eps_left [B, n] bool, s_res [B, m] int32, depth
    [B] int32)``, the fixed point of simultaneous degree-1-check
    resolution (the reference's ``make_peel_fn``).  ``depth`` is the last
    round in which the lane resolved a bit.  ``rounds_run`` holds the
    rounds of the last call (one host read each)."""

    def __init__(self, graph: TannerGraph, max_rounds: int | None = None, *, device):
        super().__init__()
        device = resolve_device(device)
        self.m, self.n = graph.m, graph.n
        self.dc, self.dv = graph.chk_vars.shape[1], graph.var_chks.shape[1]
        self.max_rounds = int(max_rounds) if max_rounds is not None else self.n
        self.register_buffer("cv", torch.as_tensor(graph.chk_vars.reshape(-1).astype(np.int64),
                                                   device=device))
        self.register_buffer("cm", torch.as_tensor(graph.chk_mask, device=device))
        self.register_buffer("vc", torch.as_tensor(graph.var_chks.reshape(-1).astype(np.int64),
                                                   device=device))
        self.register_buffer("vm", torch.as_tensor(graph.var_mask, device=device))
        self.syndrome_from = SyndromeCheck(graph, device)
        self.rounds_run = 0

    def forward(self, syndromes: torch.Tensor, erasures: torch.Tensor):
        B, m, n, device = syndromes.shape[0], self.m, self.n, syndromes.device
        s = syndromes.to(torch.int32)
        eps = erasures.to(torch.bool)
        err = torch.zeros((B, n), dtype=torch.int32, device=device)
        depth = torch.zeros((B,), dtype=torch.int32, device=device)
        rounds, progressed = 0, True
        while progressed and rounds < self.max_rounds:
            eg = eps.index_select(1, self.cv).reshape(B, m, self.dc) & self.cm
            det = eg.sum(dim=-1) == 1  # checks with one erased neighbour
            detg = det.index_select(1, self.vc).reshape(B, n, self.dv) & self.vm
            newly = detg.any(dim=-1) & eps
            sg = (s == 1).index_select(1, self.vc).reshape(B, n, self.dv)
            val = (detg & sg).any(dim=-1).to(torch.int32)
            err = torch.where(newly, val, err)
            # flip the checks of every newly fixed 1-bit
            delta = (newly & (val == 1)).to(torch.float32)
            lane_prog = newly.any(dim=1)
            s = torch.where(lane_prog[:, None], s ^ self.syndrome_from(delta).to(torch.int32), s)
            depth = torch.where(lane_prog, rounds + 1, depth)
            eps = eps & ~newly
            rounds += 1
            progressed = bool(lane_prog.any())  # the host read of the round
        self.rounds_run = rounds
        return err, eps, s, depth


def make_peel_fn(graph: TannerGraph, max_rounds: int | None = None, *, device=None):
    """The parallel leaf-peeling core (reference ``make_peel_fn``)."""
    return PeelCore(graph, max_rounds, device=device)


class PeelingDecode(torch.nn.Module):
    """``forward(syndromes [B, m], erasures [B, n]) -> (err int8, ok bool,
    depth int32)`` (the reference's ``make_peeling_decode_fn``)."""

    def __init__(self, graph: TannerGraph, *, on_stuck: str = "gf2",
                 max_rounds: int | None = None, device):
        super().__init__()
        if on_stuck not in ("gf2", "fail"):
            raise ValueError(f"on_stuck must be 'gf2' or 'fail', got {on_stuck!r}")
        device = resolve_device(device)
        self.m, self.n = graph.m, graph.n
        self.on_stuck = on_stuck
        self.peel = PeelCore(graph, max_rounds, device=device)
        self.syndrome_from = SyndromeCheck(graph, device)
        self.register_buffer("Hp0", None)
        if on_stuck == "gf2":
            if graph.H is None:
                raise ValueError(
                    "on_stuck='gf2' needs a dense H on the graph (from_pcm); "
                    "use on_stuck='fail' for dense-free from_edges graphs")
            # packed rows [m, W]: the per-lane column mask is a packed AND
            self.register_buffer("Hp0", pack_bits(torch.as_tensor(
                np.asarray(graph.H, dtype=np.uint8), device=device)))
        #: lanes of the last call that went through the elimination
        self.gf2_lanes = 0

    def solve_residual(self, eps_left, s_res):
        """Exact completion of the given lanes: the RREF of H with the
        columns outside each lane's erasure zeroed.  Returns ``(fix [b, n]
        int32, solvable [b] bool)``."""
        n = self.n
        Hp = self.Hp0[None] & pack_bits(eps_left)[:, None, :]  # [b, m, W]
        Ht = Hp.transpose(1, 2).contiguous()  # [b, W, m]
        _, s2, piv = gf2_eliminate_cuda(Ht, s_res.to(torch.int32).contiguous(), n)
        fix = scatter_pivots(torch.zeros_like(eps_left, dtype=torch.int32), piv, s2, n)
        # rows without a pivot must carry a zero syndrome, else no solution
        solvable = ((piv < n) | (s2 == 0)).all(dim=1)
        return fix, solvable

    def forward(self, syndromes: torch.Tensor, erasures: torch.Tensor):
        err, eps_left, s_res, depth = self.peel(syndromes, erasures)
        stuck = eps_left.any(dim=1)
        self.gf2_lanes = 0
        if self.on_stuck == "gf2":
            # a lane with nothing left is solvable iff its residual is 0
            ok = (s_res == 0).all(dim=1)
            idx = stuck.nonzero()[:, 0] if bool(stuck.any()) else None  # the gate
            if idx is not None:
                self.gf2_lanes = int(idx.numel())
                fix, solvable = self.solve_residual(eps_left[idx], s_res[idx])
                err[idx] = torch.where(eps_left[idx], fix, err[idx])
                ok[idx] = solvable
        else:
            ok = ~stuck
        # safety net: lanes declared ok must reproduce their syndromes
        synhat = self.syndrome_from(err.to(torch.float32))
        ok = ok & (synhat == syndromes.to(torch.float32)).all(dim=1)
        return err.to(torch.int8), ok, depth


def make_peeling_decode_fn(graph: TannerGraph, *, on_stuck: str = "gf2",
                           max_rounds: int | None = None, device=None):
    """The erasure decode (reference ``make_peeling_decode_fn``)."""
    return PeelingDecode(graph, on_stuck=on_stuck, max_rounds=max_rounds, device=device)


class ErasurePeelingDecoder(torch.nn.Module):
    """Erasure-channel decoder: parallel peeling + optional exact GF(2)
    completion of stopping sets.

    Args:
      H: parity-check matrix (dense, scipy.sparse, or ``TannerGraph``).
      on_stuck: ``"gf2"`` (default: ML completion of stopping sets by the
        elimination; needs a dense H) or ``"fail"`` (pure peeling).
      max_rounds: cap on parallel peeling rounds (default n).
      device: where decoding runs; None is the current CUDA card.
    """

    def __init__(self, H, *, on_stuck: str = "gf2", max_rounds: int | None = None,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.graph = graph_of(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.on_stuck = on_stuck
        self.peeling = PeelingDecode(self.graph, on_stuck=on_stuck, max_rounds=max_rounds,
                                     device=self.device)

    def _check(self, syndromes, erasures):
        syndromes, erasures = np.asarray(syndromes), np.asarray(erasures)
        if syndromes.ndim != 2 or syndromes.shape[1] != self.m:
            raise ValueError(
                f"expected syndromes of shape [B, {self.m}], got {syndromes.shape}")
        if erasures.shape != (syndromes.shape[0], self.n):
            raise ValueError(
                f"expected erasures of shape [B={syndromes.shape[0]}, {self.n}], "
                f"got {erasures.shape}")
        return (torch.as_tensor(syndromes, device=self.device),
                torch.as_tensor(erasures, device=self.device))

    def batch_decode_detailed(self, syndromes, erasures):
        """``(errors [B, n] int8, ok [B] bool, depth [B] int32)`` as numpy."""
        err, ok, depth = self.peeling(*self._check(syndromes, erasures))
        return err.cpu().numpy(), ok.cpu().numpy(), depth.cpu().numpy()

    def batch_decode(self, syndromes, erasures):
        """Decode ``[B, m]`` syndromes with ``[B, n]`` erasure masks.

        Returns ``(errors [B, n] int8, ok [B] bool)``; ``ok`` lanes are
        exactly syndrome-consistent with support inside the erasure.
        """
        err, ok, _ = self.batch_decode_detailed(syndromes, erasures)
        return err, ok

    def decode(self, syndrome, erasure):
        """Single-syndrome convenience; returns ``(error [n] int8, ok)``."""
        err, ok = self.batch_decode(np.asarray(syndrome)[None], np.asarray(erasure)[None])
        return err[0], bool(ok[0])
