"""Ensemble decoding: K member decoders, one max-likelihood pick.

Counterpart of ``ldpcdecoders_tpu/models/ensemble.py``.  BP-family
decoders on degenerate graphs (circuit-level detector models especially)
fail on different shots depending on schedule knobs, so every member
decodes the batch and each shot takes the **maximum-likelihood
syndrome-consistent** candidate: the least soft prior weight
``sum(log((1-p)/p))`` over asserted error positions (plain Hamming weight
when no prior is given).  Shots where no member is consistent keep the
first member's output (flagged non-converged).

Homogeneous :class:`~.minsum.MinSumDecoder` members that differ only in
damping fuse into one lane-damped decode (``MinSumDecode(lane_damping=
True)``: members are batch lanes, the pick on the device); any other mix
runs K sequential member decodes and a host selection pass.  A member 0
with a per-bit prior vector takes the sequential loop (the reference
raises there: it compares the priors with ``!=``).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Decoder
from .priors import per_to_llr
from .staged import first_min_pick

__all__ = ["EnsembleDecoder"]


class EnsembleDecoder(Decoder):
    """Decode with every member; per shot keep the most likely
    syndrome-consistent candidate.

    The generic ensemble: members may be any decoders of this package on
    the same code and device.  For damping / disordered-memory variants of
    one min-sum on a detector model, :class:`~.staged.StagedDemDecoder`
    runs the ensemble only on the lanes the first decode left unsolved.

    Args:
      members: decoders on the same ``[m, n]`` code (at least one).
      priors: optional ``[n]`` per-bit error probabilities used for the
        ML ranking (e.g. a DEM's mechanism priors).  ``None`` ranks by
        Hamming weight.
      H: optional explicit ``[m, n]`` parity-check / detector matrix
        for the consistency check; defaults to the first member's
        attached dense matrix.
    """

    def __init__(self, members, *, priors=None, H=None):
        super().__init__()
        members = list(members)
        if not members:
            raise ValueError("need at least one member decoder")
        m, n = members[0].m, members[0].n
        for d in members:
            if (d.m, d.n) != (m, n):
                raise ValueError(
                    f"member {type(d).__name__} is [{d.m}, {d.n}]; "
                    f"ensemble is [{m}, {n}]")
            if d.device != members[0].device:
                raise ValueError(f"member {type(d).__name__} is on {d.device}; "
                                 f"member 0 on {members[0].device}")
        self.members = torch.nn.ModuleList(members)
        self.device = members[0].device
        self.m, self.n = m, n
        if H is None:
            graph = getattr(members[0], "graph", None)
            if graph is None or getattr(graph, "H", None) is None:
                raise ValueError(
                    "pass H= explicitly (the first member carries no "
                    "dense matrix for the consistency check)")
            H = graph.H
        self._H = (np.asarray(H.todense() if hasattr(H, "todense") else H)
                   != 0).astype(np.uint8)
        if self._H.shape != (m, n):
            raise ValueError(f"H must be [{m}, {n}], got {self._H.shape}")
        if priors is None:
            self._w = np.ones(n, np.float64)  # Hamming weight
        else:
            priors = np.asarray(priors, np.float64)
            if priors.shape != (n,) or np.any(priors <= 0) or np.any(priors >= 1):
                raise ValueError(f"priors must be [{n}] strictly in (0, 1)")
            self._w = np.log((1.0 - priors) / priors)
        self._fused_gammas = self._try_fuse_plan()
        self.fused = None
        if self._fused_gammas is not None:
            from .minsum import MinSumDecode

            d0 = members[0]
            self.fused = MinSumDecode(
                d0.graph, d0.per, d0.max_iters, device=self.device, alpha=d0.alpha,
                beta=d0.beta, dtype=d0.dtype, check_every=d0.check_every, lane_damping=True)
            self.register_buffer("w_f32", torch.as_tensor(self._w.astype(np.float32),
                                                          device=self.device))

    def _try_fuse_plan(self):
        """Per-member damping vector when the ensemble is fusable
        (homogeneous ``MinSumDecoder`` members on one graph differing only
        in ``damping``, with scalar priors), else ``None``."""
        from .minsum import MinSumDecoder

        ms = list(self.members)
        if len(ms) < 2 or not all(type(d) is MinSumDecoder for d in ms):
            return None
        d0 = ms[0]
        if np.ndim(d0.per) or np.ndim(d0.alpha) or np.ndim(d0.beta):
            return None
        for d in ms[1:]:
            if d.graph is not d0.graph and not (
                    d.graph.H is not None and d0.graph.H is not None
                    and np.array_equal(d.graph.H, d0.graph.H)):
                return None
            if (np.ndim(d.per) or d.per != d0.per
                    or d.max_iters != d0.max_iters or d.alpha != d0.alpha
                    or d.beta != d0.beta or d.dtype != d0.dtype
                    or d.check_every != d0.check_every):
                return None
        return np.asarray([d.damping for d in ms], np.float32)

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        B = syndromes.shape[0]
        K = len(self.members)
        if self.fused is not None:
            # K member lanes of one lane-damped decode, the ML pick on the
            # device; ties go to the first member with the least score, and
            # a shot no member solved keeps member 0's output, as the loop
            L0 = None
            if per is not None:
                L0 = torch.as_tensor(per_to_llr(per, self.n), dtype=torch.float32,
                                     device=self.device)
            syn_t = syndromes.repeat(K, 1)
            gam = torch.as_tensor(np.repeat(self._fused_gammas, B), device=self.device)
            err, conv, iters, _ = self.fused(syn_t, L0, gam)
            score = (err.to(torch.float32) * self.w_f32).sum(dim=1)
            score = torch.where(conv, score, torch.inf).reshape(K, B)
            pick = first_min_pick(score)
            best = score[pick, torch.arange(B, device=self.device)]
            any_ok = conv.reshape(K, B).any(dim=0)
            out = err.reshape(K, B, self.n)[pick, torch.arange(B, device=self.device)]
            return (out, any_ok, iters.reshape(K, B).sum(dim=0).to(torch.int32),
                    {"ml_score": torch.where(torch.isinf(best), -1.0, best)})
        syn = syndromes.cpu().numpy().astype(np.uint8)
        best = np.full(B, np.inf)
        out = None
        iters_acc = np.zeros(B, np.int64)
        any_consistent = np.zeros(B, bool)
        for k, dec in enumerate(self.members):
            e, conv, iters, _ = dec._call_decode(syndromes, seed + k, per)
            e = e.cpu().numpy().astype(np.uint8)
            iters_acc += iters.cpu().numpy().astype(np.int64)
            consistent = (((e @ self._H.T) & 1) == syn).all(axis=1)
            score = np.where(consistent, (e * self._w[None, :]).sum(axis=1), np.inf)
            if out is None:
                out = e.copy()  # fallback: first member's output
            upd = score < best
            out[upd] = e[upd]
            best[upd] = score[upd]
            any_consistent |= consistent
        dev = self.device
        return (torch.as_tensor(out.astype(np.int8), device=dev),
                torch.as_tensor(any_consistent, device=dev),
                torch.as_tensor(iters_acc.astype(np.int32), device=dev),
                {"ml_score": torch.as_tensor(np.where(np.isinf(best), -1.0, best),
                                             dtype=torch.float32, device=dev)})
