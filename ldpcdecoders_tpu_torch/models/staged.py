"""Staged circuit-level decoding: the production path for wide DEMs.

Counterpart of ``ldpcdecoders_tpu/models/staged.py``, with the same
decoding semantics, lane for lane:

  * **Stage 0**: damped min-sum on the full batch at a modest iteration
    cap.  Per-lane freezing makes the cap exact: a lane that converges at
    iteration t gives the same output whatever the cap past t (on the
    ``check_every`` grid).
  * **Stage 1 (deep ensemble)**: lanes still unconverged are compacted
    into a bucket, tiled K ways with the ensemble's damping factors
    (``lane_damping``: members are ordinary batch lanes of one decode), and
    decoded deep with ``track_best``.  Each shot takes the
    syndrome-consistent member whose correction has maximum likelihood
    (least sum of log((1-p)/p) over flipped mechanisms), picked on the
    device.  Relay legs (``relay_legs``) re-decode the survivors with fresh
    disordered-memory draws.
  * **Stage 2 (host OSD)**: shots no member solved go to the native
    OSD-CS (native/gf2_osd.cpp), per member and for a posterior-free
    candidate in prior order, with the same ML pick.

The min-sum message updates run in the hand-written kernels
(ops/cuda_minsum.py) on a card.  The OSD of this path always runs on the
host, as the reference's does (one lane of the bb144 R=6 model, 864 x
31,648, would take the elimination kernels' device-memory body).
:meth:`StagedDemDecoder.run_eval` samples mechanisms on the device from a
``torch.Generator`` seeded per batch from ``np.random.default_rng(seed)``
(the reference draws with ``jax.random``, which torch cannot reproduce) and
overlaps the host OSD, on a worker thread that touches only numpy, with
the device work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.graph import TannerGraph
from ..utils.profiling import count, span, to_device, to_host
from .base import Decoder, resolve_device
from .minsum import MinSumDecode
from .priors import next_pow2

__all__ = ["StagedDemDecoder", "draw_mechanisms"]


def draw_mechanisms(prior: torch.Tensor, b: int, noise_seed: int) -> torch.Tensor:
    """``[b, N]`` float32 0/1 mechanism draws: ``uniform < prior`` from a
    ``torch.Generator`` on ``prior``'s device seeded with ``noise_seed``."""
    gen = torch.Generator(device=prior.device)
    gen.manual_seed(int(noise_seed))
    u = torch.rand((b, prior.shape[0]), generator=gen, device=prior.device)
    return (u < prior).to(torch.float32)


def first_min_pick(score: torch.Tensor):
    """Per column of ``score [K, B]``: the first row holding the minimum."""
    best = score.amin(dim=0)
    rows = torch.arange(score.shape[0], device=score.device)[:, None]
    return torch.where(score == best, rows, score.shape[0]).amin(dim=0)


class StagedDemDecoder(Decoder):
    """Staged damped-min-sum ensemble + native OSD for detector models.

    Args:
      A: ``[D, N]`` detector matrix (dense or scipy.sparse).
      priors: ``[N]`` per-mechanism probabilities in (0, 1).
      observables: optional ``[k, N]`` observable matrix (required by
        :meth:`predict_observables` and :meth:`run_eval`).
      gammas: ensemble damping factors; ``gammas[0]`` also drives stage 0.
        A member is a scalar damping factor or a ``(lo, hi)`` pair, which
        draws a per-mechanism memory strength U[lo, hi) (disordered-memory
        BP, Relay-BP arXiv:2506.01779).
      stage0_iters: full-batch iteration cap, rounded up to the
        ``check_every`` grid (where the cap's exactness holds).
      deep_iters: straggler-bucket iteration cap.
      alpha: min-sum normalization.
      lam / lam3: host OSD-CS pair / triple sweep depths.
      dtype: stage-0 message dtype (torch.float32 default, or bfloat16).
      deep_dtype: stage-1 message dtype (defaults to torch.float32).
      check_every: syndrome-test cadence (see models/minsum.py).
      min_bucket: smallest straggler-bucket width.
      max_bucket: largest straggler-bucket width (default: from the
        device memory, utils/hbm.py).
      relay_legs: re-decode still-unsolved lanes up to this many more
        times with fresh disordered-memory draws (Relay-BP's legs).
      osd_rank: the host OSD's column order: ``"abs_llr"`` (|LLR|) or
        ``"legacy"`` (max(exp(llr), 1-exp(llr)), models/bposd.py's).
      relay_range: (lo, hi) for relay-leg gamma draws.
      hbm_bytes: explicit device-memory budget for the batch/bucket
        ceilings (utils/hbm.py reads the card when omitted).
      layout: message residency of the stage-0/deep decodes ("var" or
        "check"; models/minsum.py).
      relay_iters: iteration cap of relay legs (defaults to ``deep_iters``).
      device: where decoding runs; None is the current CUDA card.
    """

    def __init__(self, A, priors, *, observables=None, gammas=(0.4,),
                 stage0_iters: int = 96, deep_iters: int = 1000,
                 alpha: float = 1.0, lam: int = 40, lam3: int = 0,
                 dtype=None, deep_dtype=None, check_every: int = 8,
                 min_bucket: int = 32, max_bucket: int | None = None,
                 relay_legs: int = 0, osd_rank: str = "abs_llr",
                 relay_range: tuple = (-0.24, 0.66),
                 hbm_bytes: int | None = None, layout: str = "var",
                 relay_iters: int | None = None, device=None):
        super().__init__()
        import scipy.sparse as sp

        from ..utils.hbm import max_lanes_for

        A = sp.csr_matrix(A).astype(np.uint8)
        self.D, self.N = A.shape
        self.m, self.n = self.D, self.N
        priors = np.asarray(priors, np.float64)
        if priors.shape != (self.N,):
            raise ValueError(f"priors must be [{self.N}], got {priors.shape}")
        if np.any(priors <= 0.0) or np.any(priors >= 1.0):
            raise ValueError("mechanism priors must lie strictly in (0, 1)")
        if not gammas:
            raise ValueError("gammas needs at least one damping factor")
        self.device = resolve_device(device)
        self._prior = priors
        self.O = (None if observables is None
                  else np.asarray(observables, np.uint8) % 2)
        if self.O is not None and self.O.shape[1] != self.N:
            raise ValueError(
                f"observables must be [k, {self.N}], got {self.O.shape}")
        # a pair member draws its own deterministic row (seeded by index)
        self.gammas = tuple(
            (float(g[0]), float(g[1])) if isinstance(g, (tuple, list))
            else float(g) for g in gammas)
        self.K = len(self.gammas)
        rows = np.empty((self.K, self.N), np.float32)
        self._has_dmem = False
        for k, g in enumerate(self.gammas):
            if isinstance(g, tuple):
                lo, hi = g
                if not (-1.0 < lo <= hi < 1.0):
                    raise ValueError(
                        f"dmem range must satisfy -1 < lo <= hi < 1, got {g}")
                rows[k] = np.random.default_rng(
                    0xD3E + k).uniform(lo, hi, self.N).astype(np.float32)
                self._has_dmem = True
            else:
                if not -1.0 < g < 1.0:
                    raise ValueError(f"damping must be in (-1, 1), got {g}")
                rows[k] = g
        self._gamma_rows = rows
        if osd_rank not in ("abs_llr", "legacy"):
            raise ValueError("osd_rank must be 'abs_llr' or 'legacy'")
        self.osd_rank = osd_rank
        self.relay_legs = int(relay_legs)
        self.relay_range = (float(relay_range[0]), float(relay_range[1]))
        if not -1.0 < self.relay_range[0] <= self.relay_range[1] < 1.0:
            raise ValueError(f"relay_range out of (-1, 1): {relay_range}")
        # relay legs pass [K, N] rows; scalar members are promoted to full
        # rows when relay is on, so every deep decode takes one shape
        self._gamma_arg = (rows if self._has_dmem or self.relay_legs
                           else rows[:, 0].copy())
        ce = max(1, int(check_every))
        self.stage0_iters = -(-int(stage0_iters) // ce) * ce
        self.deep_iters = int(deep_iters)
        self.lam, self.lam3 = int(lam), int(lam3)
        self.min_bucket = int(min_bucket)
        self.max_iters = self.stage0_iters + self.deep_iters

        Ad = np.asarray(A.todense())
        self.A = A
        self.graph = TannerGraph.from_pcm(Ad)
        self._llr0 = np.log((1.0 - priors) / priors).astype(np.float32)

        from ..native import gf2_pack_cols, native_available

        if not native_available():
            raise RuntimeError(
                "StagedDemDecoder needs the native host OSD (g++); "
                "build failed or unavailable")
        self._Hcols = gf2_pack_cols(Ad)

        self.dtype = torch.float32 if dtype is None else dtype
        self.deep_dtype = torch.float32 if deep_dtype is None else deep_dtype
        # batch/bucket ceilings from the device's memory (utils/hbm.py)
        self._max_stage0_batch = max_lanes_for(
            self.graph, dtype_bytes=torch.finfo(self.dtype).bits // 8,
            fraction=0.85, device=self.device, hbm_bytes=hbm_bytes, lo=256, hi=8192)
        if max_bucket is None:
            # the deep decode shares the memory with stage-0 work: budget
            # K*Bb member lanes at a conservative fraction
            deep_lanes = max_lanes_for(
                self.graph, dtype_bytes=torch.finfo(self.deep_dtype).bits // 8,
                fraction=0.45, device=self.device, hbm_bytes=hbm_bytes,
                lo=self.min_bucket, hi=16384)
            mb = max(self.min_bucket, deep_lanes // self.K)
            p = self.min_bucket
            while p * 2 <= mb:
                p *= 2
            self.max_bucket = p
        else:
            self.max_bucket = int(max_bucket)
        g0 = self.gammas[0]
        if isinstance(g0, tuple):  # dmem member: a scalar proxy for stage 0
            g0 = float(np.clip((g0[0] + g0[1]) / 2, 0.0, 0.9))
        self.stage0_gamma = max(0.0, g0)
        self.layout = str(layout)
        per0 = float(priors.mean())
        self.stage0 = MinSumDecode(
            self.graph, per0, self.stage0_iters, device=self.device, alpha=alpha,
            dtype=self.dtype, damping=self.stage0_gamma, check_every=check_every,
            layout=self.layout)
        # track_best: a trapped member lane reports its least-inconsistent
        # iterate, not wherever the oscillation stopped (the OSD ranks
        # columns by that iterate's LLRs)
        self.deep = MinSumDecode(
            self.graph, per0, self.deep_iters, device=self.device, alpha=alpha,
            dtype=self.deep_dtype, lane_damping=True, check_every=check_every,
            layout=self.layout, track_best=True)
        self.relay_iters = self.deep_iters if relay_iters is None else int(relay_iters)
        self.relay = (self.deep if self.relay_iters == self.deep_iters else MinSumDecode(
            self.graph, per0, self.relay_iters, device=self.device, alpha=alpha,
            dtype=self.deep_dtype, lane_damping=True, check_every=check_every,
            layout=self.layout, track_best=True))
        self.register_buffer("L0_default", torch.as_tensor(self._llr0, device=self.device))
        self.register_buffer("gamma_arg", torch.as_tensor(self._gamma_arg, device=self.device))
        self._eval_tables = None

    # -- device steps -------------------------------------------------------

    def _deep_step(self, det, L0, llr0_d, gam_rows, relay: bool = False):
        """K-member deep ensemble on a ``[Bb, D]`` bucket with the
        syndrome-consistent ML pick on the device.  ``gam_rows`` is ``[K]``
        or ``[K, N]``; ``relay`` selects the relay-leg iteration cap.

        Returns ``(err_pick [Bb, N] int8, solved [Bb], iters_pick [Bb],
        err3 [K, Bb, N] int8, llrs3 [K, Bb, N] float32)``."""
        raw = self.relay if relay else self.deep
        K, Bb = self.K, det.shape[0]
        gam_t = gam_rows.repeat_interleave(Bb, dim=0)
        syn_t = det.repeat(K, 1)
        err, conv, iters, llrs = raw(syn_t, L0, gam_t)
        score = (err.to(torch.float32) * llr0_d).sum(dim=1).reshape(K, Bb)
        conv2 = conv.reshape(K, Bb)
        pick = first_min_pick(torch.where(conv2, score, torch.inf))
        lanes = torch.arange(Bb, device=det.device)
        err3 = err.reshape(K, Bb, self.N)
        return (err3[pick, lanes], conv2.any(dim=0), iters.reshape(K, Bb)[pick, lanes],
                err3, llrs.reshape(K, Bb, self.N))

    def _relay_rows(self, leg: int) -> np.ndarray:
        """Fresh disordered-memory draws for relay leg ``leg``: K new
        per-mechanism gamma vectors, deterministic per (leg, member) and
        independent of the decoder instance, which makes pooling lanes of
        different buckets into one relay decode replay-exact."""
        lo, hi = self.relay_range
        r = np.empty((self.K, self.N), np.float32)
        for k in range(self.K):
            r[k] = np.random.default_rng((0xE1A9, leg, k)).uniform(lo, hi, self.N)
        return r

    def _run_relay(self, det, L0, llr0_d, out, solved_np, iters_np, err3, llrs3):
        """Relay legs over the ``det [Bb, D]`` lanes, updating the numpy
        ``out``, ``solved_np`` and ``iters_np`` in place: each leg re-decodes
        only the remaining survivors with fresh disordered-memory draws,
        right-sized to the survivor count.

        Returns ``(err3, llrs3, pos_map)``: the last executed leg's member
        arrays and ``pos_map[b]`` locating lane ``b`` inside them (for the
        OSD gather on still-unsolved lanes)."""
        Bb = det.shape[0]
        pos_map = np.arange(Bb)
        for leg in range(self.relay_legs):
            un = np.flatnonzero(~solved_np)
            if un.size == 0:
                break
            Bb_leg = max(self.min_bucket, next_pow2(un.size))
            idxp = np.concatenate([un, np.repeat(un[:1], Bb_leg - un.size)])
            with span("ldpc.staged.relay"):
                rows = to_device(self._relay_rows(leg), self.device)
                ep, sv, it2, err3, llrs3 = self._deep_step(
                    det[to_device(idxp, det.device)], L0, llr0_d, rows, relay=True)
                # the leg's three reads in a row: one wait for the device
                sv_np, ep_np, it_np = to_host(sv[: un.size], ep[: un.size], it2[: un.size])
                newly = un[sv_np]
                out[newly] = ep_np[sv_np]
                iters_np[newly] += it_np[sv_np]
                solved_np[newly] = True
                pos_map = np.full(Bb, 0)
                pos_map[un] = np.arange(un.size)
        return err3, llrs3, pos_map

    def _deep_relay(self, det_b, L0, llr0_d):
        """Deep ensemble + relay restarts: leg 0 on the full bucket, then
        :meth:`_run_relay` on its survivors.

        Returns ``(out, solved, iters, err3, llrs3, pos_map)``, the first
        three as numpy arrays."""
        Bb = det_b.shape[0]
        err_pick, solved, it_pick, err3, llrs3 = self._deep_step(
            det_b, L0, llr0_d, self.gamma_arg)
        out, solved_np, iters_np = (a.copy() for a in to_host(err_pick, solved, it_pick))
        pos_map = np.arange(Bb)
        if self.relay_legs and not solved_np.all():
            err3, llrs3, pos_map = self._run_relay(
                det_b, L0, llr0_d, out, solved_np, iters_np, err3, llrs3)
        return out, solved_np, iters_np, err3, llrs3, pos_map

    def _gather_failed(self, err3, llrs3, pos):
        """The host OSD's inputs for the member rows ``pos``: their hard
        decisions (uint8) and column reliability order (int32, stable
        descending), not the ``[K, Bb, N]`` float soft outputs."""
        with span("ldpc.staged.gather"):
            idx = to_device(pos, err3.device)
            bp = err3.index_select(1, idx)  # [K, nf, N]
            llr = llrs3.index_select(1, idx).to(torch.float32)
            if self.osd_rank == "abs_llr":
                # |LLR|: a bit confidently 1 is as reliable as one confidently 0
                rel = llr.abs()
            else:
                probs = torch.exp(llr)
                rel = torch.maximum(probs, 1.0 - probs)
            order = torch.argsort(-rel, dim=-1, stable=True)
            return to_host(bp.to(torch.uint8), order.to(torch.int32))

    # -- host OSD ----------------------------------------------------------

    def _host_osd_pick(self, syn_np, bp_np, order_np, llr0_np):
        """Native OSD-CS per candidate on ``[K, nf, ...]`` lanes, then the
        same ML pick: the least prior-weighted correction among
        syndrome-consistent candidates (member 0's output where none is).
        A posterior-free candidate joins the pick: ``bp = 0`` with the
        channel-prior reliability order (information-set decoding in
        static prior order, immune to a trapped lane's LLRs)."""
        from ..native import gf2_osd_cs_host

        K, nf, _ = bp_np.shape
        count("osd_lanes", nf)
        count("osd_candidates", (K + 1) * nf)
        prior_order = np.argsort(-np.abs(llr0_np), kind="stable").astype(np.int32)
        bp_ext = np.concatenate([bp_np, np.zeros((1, nf, self.N), np.uint8)])
        order_ext = np.concatenate(
            [order_np, np.broadcast_to(prior_order, (1, nf, self.N))]).astype(np.int32)
        outs = np.empty((K + 1, nf, self.N), np.uint8)
        cons = np.empty((K + 1, nf), bool)
        for k in range(K + 1):
            o, c = gf2_osd_cs_host(self._Hcols, self.D, self.lam, order_ext[k], bp_ext[k],
                                   syn_np, lam3=self.lam3)
            outs[k], cons[k] = o, c
        score = outs.astype(np.float32) @ llr0_np
        score[~cons] = np.inf
        pick = np.argmin(score, axis=0)
        all_bad = ~cons.any(axis=0)
        if all_bad.any():  # unreachable syndrome: keep member 0's output
            pick[all_bad] = 0
        return outs[pick, np.arange(nf)], cons.any(axis=0)

    # -- Decoder contract ----------------------------------------------------

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        B = syndromes.shape[0]
        # the largest batch one stage-0 decode carries (utils/hbm.py);
        # bigger inputs decode in chunks
        cap = self._max_stage0_batch
        if B > cap:
            parts = [self._decode_batch(syndromes[lo:lo + cap], seed, per)[:3]
                     for lo in range(0, B, cap)]
            return (*(torch.cat(p) for p in zip(*parts)), {})
        with span("ldpc.staged.stage0"):
            L0, llr0_np, llr0_d = self._channel(per)
            err0, conv0, it0, _ = self.stage0(syndromes, L0)
        return self._post_stage0(syndromes, err0, conv0, it0, L0, llr0_np, llr0_d)

    def _channel(self, per=None):
        """Channel LLRs for a decode call: ``(L0 device, llr0 numpy, llr0
        device)``, the default priors unless ``per`` overrides them."""
        if per is None:
            return self.L0_default, self._llr0, self.L0_default
        p = np.broadcast_to(np.asarray(per, np.float64), (self.N,))
        llr0_np = np.log((1.0 - p) / p).astype(np.float32)
        llr0_d = torch.as_tensor(llr0_np, device=self.device)
        return llr0_d, llr0_np, llr0_d

    def _post_stage0(self, syn, err0, conv0, it0, L0, llr0_np, llr0_d):
        """Stages 1-2 given stage-0 results: compact stragglers into
        deep-ensemble buckets (+ relay legs), then the native host OSD on
        the shots no member solved."""
        # the reads of stage 0's results belong to its span
        with span("ldpc.staged.stage0"):
            (conv0_np,) = to_host(conv0)
            need = np.flatnonzero(~conv0_np)
            if need.size == 0:
                return err0, conv0, it0, {}
            syn_np, out, iters = to_host(syn, err0, it0)
            syn_np, out, iters = syn_np.astype(np.uint8), out.copy(), iters.copy()
            solved = conv0_np.copy()
        # deep buckets are capped at max_bucket lanes: the K-member tile
        # multiplies the batch
        for lo in range(0, need.size, self.max_bucket):
            with span("ldpc.staged.deep"):
                chunk = need[lo: lo + self.max_bucket]
                Bb = max(self.min_bucket, next_pow2(chunk.size))
                count("deep_lanes", chunk.size)
                count("deep_lanes_padded", Bb)
                idx = np.concatenate([chunk, np.repeat(chunk[:1], Bb - chunk.size)])
                det_b = syn[to_device(idx, syn.device)]
                ep_np, deep_solved_f, it_np, err3, llrs3, pos_map = self._deep_relay(
                    det_b, L0, llr0_d)
                deep_solved_np = deep_solved_f[: chunk.size]
                out[chunk] = ep_np[: chunk.size]
                iters[chunk] = self.stage0_iters + it_np[: chunk.size]
                solved[chunk] = deep_solved_np
                fail = chunk[~deep_solved_np]
                # rows of the failed lanes inside the last leg's arrays
                pos = pos_map[np.flatnonzero(~deep_solved_np)]
            if fail.size:
                bp_np, order_np = self._gather_failed(err3, llrs3, pos)
                with span("ldpc.staged.osd"):
                    picked, _ = self._host_osd_pick(syn_np[fail], bp_np, order_np, llr0_np)
                    out[fail] = picked.astype(np.int8)
        # `solved` = some stage produced a syndrome-consistent estimate
        # without OSD (BP-converged); OSD output is consistent whenever the
        # syndrome is in span (the bposd convention)
        with span("ldpc.to_device"):
            dev = self.device
            return to_device(out, dev), to_device(solved, dev), to_device(iters, dev), {}

    def predict_observables(self, detectors, *, seed: int = 0):
        """Decode and project onto the logical observables."""
        if self.O is None:
            raise ValueError("no observables matrix was provided")
        x, conv = self.batch_decode(detectors, seed=seed)
        flips = (x.astype(np.uint8) @ self.O.T) & 1
        return flips, conv

    # -- pipelined device-resident evaluation --------------------------------

    def _eval_step(self, noise_seed: int, b: int, L0):
        """Stage-0 evaluation batch on the device: sample mechanisms from
        the priors, build detector records, decode, and settle the verdict
        of every converged lane.  Returns ``(counts [3], conv [b], det [b,
        D] uint8, obs_t [b, k] uint8)`` as device tensors."""
        if self._eval_tables is None:
            f32 = dict(dtype=torch.float32, device=self.device)
            self._eval_tables = (
                torch.as_tensor(np.asarray(self.A.todense()).T, **f32),
                torch.as_tensor(self.O.T, **f32),
                torch.as_tensor(self._prior, **f32))
        AdT, OdT, prior = self._eval_tables
        # float32 products of 0/1 matrices: exact (sums of at most the
        # largest column weight of A or O)
        x = draw_mechanisms(prior, b, noise_seed)
        det = torch.remainder(x @ AdT, 2.0).to(torch.uint8)
        err, conv, iters, _ = self.stage0(det, L0)
        obs_t = torch.remainder(x @ OdT, 2.0).to(torch.uint8)
        obs_p = torch.remainder(err.to(torch.float32) @ OdT, 2.0).to(torch.uint8)
        fail = (obs_p != obs_t).any(dim=1)
        counts = torch.stack([conv.sum(), (fail & conv).sum(),
                              torch.where(conv, iters, 0).sum()])
        return counts, conv, det, obs_t

    def run_eval(self, shots: int, *, batch: int = 2048, seed: int = 0,
                 pipeline: int = 4, deep_bucket: int = 256,
                 max_seconds: float | None = None, per=None) -> dict:
        """DEM-sampled logical-error evaluation.

        Three streams: stage-0 batches; stragglers pooled across batches
        and dispatched as deep-ensemble buckets (and relay jobs); shots no
        member solves through the native host OSD on a worker thread,
        overlapped with device work.  ``shots`` rounds up to a whole
        number of batches.  Batch ``i`` draws its mechanisms with
        :func:`draw_mechanisms` seeded by the i-th
        ``np.random.default_rng(seed).integers(1 << 31)``.  Returns the
        sweep-style stats dict plus a stage-by-stage profile.
        """
        import time
        from concurrent.futures import ThreadPoolExecutor

        from ..utils.metrics import wilson_interval

        if self.O is None:
            raise ValueError("run_eval needs an observables matrix")
        L0, llr0_np, llr0_d = self._channel(per)

        n_batches = max(1, -(-shots // batch))
        trials = fails = conv0 = it0_sum = 0
        fails_s0 = fails_deep = fails_relay = fails_osd = 0
        deep_shots = deep_solved = osd_shots = osd_consistent = 0
        relay_shots = relay_solved = 0
        t_osd = deep_wall = relay_wall = stage0_wall = 0.0
        pool_det: list[np.ndarray] = []
        pool_obs: list[np.ndarray] = []
        pool_n = 0
        # survivors of deep leg 0 pool across buckets into full-width relay
        # jobs: relay draws are (leg, member)-indexed and lanes are
        # independent, so pooling is replay-exact
        rpool_det: list[np.ndarray] = []
        rpool_obs: list[np.ndarray] = []
        rpool_n = 0
        pending: list = []  # ("s0", tensors) | ("deep"/"relay", ...)
        osd_futs: list = []
        rng0 = np.random.default_rng(seed)
        dev = self.device
        t0 = time.perf_counter()

        def osd_job(syn_np, bp_np, order_np, obs_np):
            # the worker thread: numpy and the native library only
            t = time.perf_counter()
            with span("ldpc.staged.osd"):
                picked, cons = self._host_osd_pick(syn_np, bp_np, order_np, llr0_np)
            pred = (picked.astype(np.uint8) @ self.O.T) & 1
            f = int((pred != obs_np).any(axis=1).sum())
            return f, int(cons.sum()), syn_np.shape[0], time.perf_counter() - t

        def dispatch_deep(force=False):
            nonlocal pool_n
            while pool_n >= deep_bucket or (force and pool_n):
                det_all = np.concatenate(pool_det)
                obs_all = np.concatenate(pool_obs)
                take = min(deep_bucket, pool_n)
                det_b, obs_b = det_all[:take], obs_all[:take]
                pool_det.clear()
                pool_obs.clear()
                if take < det_all.shape[0]:
                    pool_det.append(det_all[take:])
                    pool_obs.append(obs_all[take:])
                pool_n -= take
                pad = deep_bucket - take
                if pad:
                    det_b = np.concatenate([det_b, np.repeat(det_b[:1], pad, axis=0)])
                    obs_b = np.concatenate([obs_b, np.repeat(obs_b[:1], pad, axis=0)])
                pending.append(("deep", det_b, obs_b, take, time.perf_counter()))

        def dispatch_relay(force=False):
            # half-bucket threshold: waiting for a full bucket would push
            # nearly all relay work past the stage-0 stream
            nonlocal rpool_n
            while rpool_n >= max(32, deep_bucket // 2) or (force and rpool_n):
                det_all = np.concatenate(rpool_det)
                obs_all = np.concatenate(rpool_obs)
                take = min(deep_bucket, rpool_n)
                rpool_det.clear()
                rpool_obs.clear()
                if take < det_all.shape[0]:
                    rpool_det.append(det_all[take:])
                    rpool_obs.append(obs_all[take:])
                rpool_n -= take
                # no padding: relay legs right-size internally
                pending.append(("relay", det_all[:take], obs_all[:take], take,
                                time.perf_counter()))

        def to_osd(det_u, obs_u, err3, llrs3, rowpos):
            """Host OSD of still-unsolved lanes: their hard decisions and
            reliability order come to the host here, on the main thread."""
            bp_np, order_np = self._gather_failed(err3, llrs3, rowpos)
            osd_futs.append(executor.submit(osd_job, det_u, bp_np, order_np, obs_u))

        def drain_one():
            nonlocal trials, fails, conv0, it0_sum, pool_n, deep_shots, \
                deep_solved, deep_wall, fails_s0, fails_deep, rpool_n, \
                relay_shots, relay_solved, relay_wall, fails_relay, stage0_wall
            item = pending.pop(0)
            if item[0] == "s0":
                t = time.perf_counter()
                c, conv_np, det_np, obs_np = to_host(*item[1])
                stage0_wall += time.perf_counter() - t
                trials += conv_np.shape[0]
                conv0 += int(c[0])
                fails += int(c[1])
                fails_s0 += int(c[1])
                it0_sum += int(c[2])
                miss = np.flatnonzero(~conv_np)
                if miss.size:
                    pool_det.append(det_np[miss])
                    pool_obs.append(obs_np[miss])
                    pool_n += miss.size
                dispatch_deep()
                return
            if item[0] == "deep":
                _, det_b, obs_b, take, t_disp = item
                det_t = torch.as_tensor(det_b, device=dev)
                ep_d, solved_d, _, err3, llrs3 = self._deep_step(
                    det_t, L0, llr0_d, self.gamma_arg)
                ep, solved_np = to_host(ep_d, solved_d[:take])
                deep_wall += time.perf_counter() - t_disp
                deep_shots += take
                deep_solved += int(solved_np.sum())
                # verdicts for BP-solved lanes
                pred = (ep[:take].astype(np.int32) @ self.O.T.astype(np.int32)) & 1
                f = int(((pred != obs_b[:take]).any(axis=1) & solved_np).sum())
                fails += f
                fails_deep += f
                unsolved = np.flatnonzero(~solved_np)
                if unsolved.size:
                    if self.relay_legs:
                        rpool_det.append(det_b[unsolved])
                        rpool_obs.append(obs_b[unsolved])
                        rpool_n += unsolved.size
                        dispatch_relay()
                    else:
                        to_osd(det_b[unsolved], obs_b[unsolved], err3, llrs3, unsolved)
                return
            _, det_r, obs_r, take, t_disp = item
            out = np.zeros((take, self.N), np.int8)
            solved_np = np.zeros(take, bool)
            iters_np = np.zeros(take, np.int64)
            err3, llrs3, pos_map = self._run_relay(
                torch.as_tensor(det_r, device=dev), L0, llr0_d, out, solved_np, iters_np,
                None, None)
            relay_wall += time.perf_counter() - t_disp
            relay_shots += take
            relay_solved += int(solved_np.sum())
            pred = (out.astype(np.int32) @ self.O.T.astype(np.int32)) & 1
            f = int(((pred != obs_r).any(axis=1) & solved_np).sum())
            fails += f
            fails_relay += f
            unsolved = np.flatnonzero(~solved_np)
            if unsolved.size:
                to_osd(det_r[unsolved], obs_r[unsolved], err3, llrs3, pos_map[unsolved])

        with ThreadPoolExecutor(max_workers=1) as executor:
            dispatched = 0
            while dispatched < n_batches:
                if max_seconds is not None and (time.perf_counter() - t0) >= max_seconds:
                    break
                noise_seed = int(rng0.integers(1 << 31))
                t = time.perf_counter()
                pending.append(("s0", self._eval_step(noise_seed, batch, L0)))
                stage0_wall += time.perf_counter() - t
                dispatched += 1
                while len(pending) > max(1, pipeline):
                    drain_one()
            while pending:
                drain_one()
            dispatch_deep(force=True)
            while pending:
                drain_one()
            dispatch_relay(force=True)
            while pending:
                drain_one()
            for fut in osd_futs:
                f, cns, n_real, dt_osd = fut.result()
                fails += f
                fails_osd += f
                osd_shots += n_real
                osd_consistent += cns
                t_osd += dt_osd
        dt = time.perf_counter() - t0

        lo, hi = wilson_interval(fails, trials)
        return {
            "shots": trials,
            "fails": fails,
            "logical_rate": fails / trials if trials else 0.0,
            "logical_ci95": [lo, hi],
            # BP-solved by any stage (stage 0, deep, or relay), the
            # semantics of batch_decode's solved flag; stage-0-only
            # convergence is profile["stage0_conv"]
            "converged": ((conv0 + deep_solved + relay_solved) / trials
                          if trials else 0.0),
            "throughput_shots_per_s": trials / dt if dt else 0.0,
            "device_sampled": True,
            "profile": {
                "stage0_conv": conv0 / trials if trials else 0.0,
                "fails_by_stage": {"stage0": fails_s0, "deep": fails_deep,
                                   "relay": fails_relay, "osd": fails_osd},
                "stage0_mean_iters": it0_sum / max(conv0, 1),
                "deep_shots": deep_shots,
                "deep_solved": deep_solved,
                "relay_shots": relay_shots,
                "relay_solved": relay_solved,
                "osd_shots": osd_shots,
                "osd_consistent": osd_consistent,
                "wall_s": dt,
                "stage0_wall_s": stage0_wall,
                "deep_drain_wall_s": deep_wall,
                "relay_drain_wall_s": relay_wall,
                "osd_thread_s": t_osd,
                "gammas": list(self.gammas),
                "stage0_iters": self.stage0_iters,
                "deep_iters": self.deep_iters,
                "deep_bucket": deep_bucket,
                "lam": self.lam,
                "lam3": self.lam3,
            },
        }
