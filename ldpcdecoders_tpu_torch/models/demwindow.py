"""Windowed circuit-level decoding: streaming any DEM in bounded memory.

Counterpart of ``ldpcdecoders_tpu/models/demwindow.py``: the window/commit
construction of models/window.py generalized to any detector error model
with a detector-time structure.

  * detectors are grouped into rounds (``detectors_per_round``);
  * each window decodes rounds ``[t, t+W)``: its columns are the mechanisms
    whose earliest detector round lies in the window, truncated to the
    window's rows (the open future boundary);
  * mechanisms whose earliest round lies before ``t+C`` are committed.  The
    guard ``span <= W - C + 1`` makes sure a committing mechanism's whole
    footprint was inside the window; committed mechanisms that touch later
    rounds are XORed out of the remaining record;
  * the lookahead estimates are discarded and decoded again, with full
    context, by the next window; the final window decodes all remaining
    rounds closed and commits everything.

Structurally identical windows (the time-uniform bulk of a memory
experiment) share one inner decoder, keyed by the sha256 of the window's
sparse structure and priors.  The inner is the port's
:class:`~.staged.StagedDemDecoder` (default; ``stage0_iters`` defaults to
``min(48, deep_iters)``) or a :class:`~.detector.DetectorGraphDecoder` of
any prior-capable kind, each on ``device``.  The orchestration is numpy, as
the reference's.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .base import resolve_device

__all__ = ["WindowedDemDecoder"]


class WindowedDemDecoder:
    """Streaming window/commit decoder over an arbitrary DEM.

    Args:
      A: ``[D, N]`` detector matrix (dense or scipy.sparse); detector ``d``
        belongs to round ``d // detectors_per_round``.
      priors: ``[N]`` mechanism probabilities.
      detectors_per_round: detectors measured per round (a divisor of D).
      window: rounds decoded per window, ``W >= 2``.
      commit: rounds committed (and slid past) per window,
        ``1 <= commit < window``.
      observables: optional ``[k, N]`` observable matrix.
      decoder: ``"staged"`` (default) or any prior-capable DecoderConfig
        kind (``"bposd"``, ``"minsum"``, ...).
      max_iters: inner iteration cap (staged: ``deep_iters``).
      device: where the inner decoders run; None is the current CUDA card.
      **knobs: forwarded to the inner decoder.
    """

    def __init__(self, A, priors, *, detectors_per_round: int, window: int = 3,
                 commit: int = 1, observables=None, decoder: str = "staged",
                 max_iters: int = 200, device=None, **knobs):
        import scipy.sparse as sp

        A = sp.csc_matrix(A).astype(np.uint8)
        self.D, self.N = A.shape
        r = int(detectors_per_round)
        if r <= 0 or self.D % r:
            raise ValueError(f"detectors_per_round={r} does not divide D={self.D}")
        self.r = r
        self.R = self.D // r
        W, C = int(window), int(commit)
        if W < 2:
            raise ValueError(f"window must be >= 2 rounds, got {window}")
        if not 1 <= C < W:
            raise ValueError(f"commit must be in [1, window), got {commit} (window={W})")
        if self.R < W:
            raise ValueError(f"stream has {self.R} rounds < window={W}")
        self.window, self.commit = W, C
        priors = np.asarray(priors, np.float64)
        if priors.shape != (self.N,):
            raise ValueError(f"priors must be [{self.N}]")
        self.A = A
        self._prior = priors
        self.O = None if observables is None else np.asarray(observables, np.uint8) % 2
        self.decoder = decoder
        self.max_iters = int(max_iters)
        self.device = resolve_device(device)
        self.knobs = dict(knobs)

        # mechanism round spans
        rmin = np.full(self.N, self.R, np.int64)
        rmax = np.full(self.N, -1, np.int64)
        for j in range(self.N):
            rows = A.indices[A.indptr[j]: A.indptr[j + 1]]
            if rows.size:
                rds = rows // r
                rmin[j], rmax[j] = rds.min(), rds.max()
        self._rmin, self._rmax = rmin, rmax
        span = rmax - rmin + 1
        if span.max() > W - C + 1:
            raise ValueError(
                f"a mechanism spans {int(span.max())} rounds; window-commit overlap "
                f"W-C+1={W - C + 1} must cover the longest mechanism or commits would "
                "truncate live evidence")
        # window plan: offsets t = 0, C, 2C, ... with a closed tail
        self._plan: list[tuple[int, int, bool]] = []  # (t, rounds, closed)
        t = 0
        while self.R - t > W:
            self._plan.append((t, W, False))
            t += C
        self._plan.append((t, self.R - t, True))
        self._dec_cache: dict[str, object] = {}
        self._win_cache: dict[int, tuple] = {}

    def _window_model(self, idx: int):
        """``(cols, A_w, priors_w, commit_mask)`` of window ``idx``: the
        columns by earliest detector round (every active column has
        ``rmin >= t``; committing columns, ``rmin < t+C``, carry their
        whole footprint by the span guard)."""
        if idx in self._win_cache:
            return self._win_cache[idx]
        t, rounds, closed = self._plan[idx]
        rmin, C = self._rmin, self.commit
        hi = t + rounds
        if closed:
            cols = np.flatnonzero(rmin >= t)
            commit_mask = np.ones(cols.size, bool)
        else:
            cols = np.flatnonzero((rmin >= t) & (rmin < hi))
            commit_mask = rmin[cols] < t + C
        rows = np.arange(t * self.r, hi * self.r)
        A_w = self.A[:, cols][rows, :]
        pr_w = self._prior[cols]
        self._win_cache[idx] = (cols, A_w, pr_w, commit_mask)
        return self._win_cache[idx]

    def _decoder_for(self, A_w, pr_w):
        """The inner decoder, shared across structurally identical windows."""
        import scipy.sparse as sp

        A_w = sp.csr_matrix(A_w)
        h = hashlib.sha256()
        h.update(A_w.indptr.tobytes())
        h.update(A_w.indices.tobytes())
        h.update(np.round(pr_w, 14).tobytes())
        key = h.hexdigest()
        if key in self._dec_cache:
            return self._dec_cache[key]
        if self.decoder == "staged":
            from .staged import StagedDemDecoder

            knobs = dict(self.knobs)
            knobs.setdefault("deep_iters", self.max_iters)
            knobs.setdefault("stage0_iters", min(48, knobs["deep_iters"]))
            dec = StagedDemDecoder(A_w, pr_w, device=self.device, **knobs)
        else:
            from .detector import DetectorGraphDecoder

            dec = DetectorGraphDecoder(A_w, pr_w, self.max_iters, decoder=self.decoder,
                                       device=self.device, **self.knobs)
        self._dec_cache[key] = dec
        return dec

    def decode_detector_stream(self, detectors, *, seed: int = 0):
        """Decode a detector record ``[B, R, r]`` (or ``[B, D]``) by sliding
        windows.  Returns ``(mechanisms [B, N] int8, info)`` with ``info =
        {"windows", "converged", "rounds"}``; every column commits once."""
        d = np.asarray(detectors).astype(np.uint8)
        if d.ndim == 3:
            if d.shape[1:] != (self.R, self.r):
                raise ValueError(f"expected [B, {self.R}, {self.r}], got {d.shape}")
            d = d.reshape(d.shape[0], self.D)
        if d.ndim != 2 or d.shape[1] != self.D:
            raise ValueError(f"expected detectors [B, {self.D}], got {d.shape}")
        B = d.shape[0]
        d = d.copy()  # the record is adjusted as commits land
        out = np.zeros((B, self.N), np.int8)
        conv_sum = 0.0
        for idx, (t, rounds, closed) in enumerate(self._plan):
            cols, A_w, pr_w, commit_mask = self._window_model(idx)
            dec = self._decoder_for(A_w, pr_w)
            rec = d[:, t * self.r: (t + rounds) * self.r]
            x, conv = dec.batch_decode(rec, seed=seed + idx)
            cc = cols[commit_mask]
            out[:, cc] = x[:, commit_mask]
            conv_sum += float(np.asarray(conv).mean())
            if not closed:
                # committed mechanisms may flip detectors in rounds >= t+C:
                # remove them from the record the later windows decode
                lo = (t + self.commit) * self.r
                A_fut = self.A[lo:, cc]
                if A_fut.nnz:
                    contrib = (A_fut.astype(np.int32)
                               @ x[:, commit_mask].astype(np.int32).T).T & 1
                    d[:, lo:] ^= contrib.astype(np.uint8)
        info = {"windows": len(self._plan), "converged": conv_sum / len(self._plan),
                "rounds": self.R}
        return out, info

    def predict_observables(self, detectors, *, seed: int = 0):
        """Windowed decode projected onto the logical observables."""
        if self.O is None:
            raise ValueError("no observables matrix was provided")
        x, info = self.decode_detector_stream(detectors, seed=seed)
        flips = (x.astype(np.uint8) @ self.O.T) & 1
        return flips, info
