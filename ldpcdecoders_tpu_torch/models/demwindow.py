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
any prior-capable kind, each on ``device``.

The decoder is a :class:`~.base.Decoder` over the whole record (``m = D``
detectors, ``n = N`` mechanisms), and a call runs on ``device``: the
record stays there, each window's rows go to its inner's
``_decode_batch`` (its device tensors, and no nested ``ldpc.call``), and
the commit splice and the record update ``d[:, lo:] ^= A_fut x_c mod 2``
run there too, the update as a float32 product of 0/1 values over the
committed columns that touch a later round (sums of a few ones: exact).
The only host reads are the inner decoder's own.  A shot is converged
where every window converged; its ``iters`` is the sum of its windows'
inner counts; ``aux["window_converged"]`` is ``[B, windows]``.
:meth:`decode_detector_stream` and :meth:`predict_observables` are that
call with the reference's outputs.

Spans and counters (utils/profiling.py): ``ldpc.window`` (one a window,
inside ``ldpc.decode``, around the inner's spans) holding
``ldpc.window.commit`` (the splice and the record update; while
recording it closes where the device has done them, and the inner's
queued work drains before it opens); ``windows``, ``window_commit_cols``,
``window_lanes_unconverged`` (read only while recording), and for window
``k`` the inner's ``stage0_lane_iters`` and ``member_lane_iters`` counted
within it, again as ``stage0_lane_iters.w<k>`` and
``member_lane_iters.w<k>``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..utils.profiling import call_counters, count, count_sum, settle, span
from .base import Decoder, resolve_device

__all__ = ["WindowedDemDecoder"]

#: the inner's counters that are also kept per window
_PER_WINDOW = ("stage0_lane_iters", "member_lane_iters")


class WindowedDemDecoder(Decoder):
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
      device: where decoding runs; None is the current CUDA card.
      **knobs: forwarded to the inner decoder.

    ``per=`` overrides the priors for one call with an ``[N]`` vector,
    which each window takes at its own columns.
    """

    def __init__(self, A, priors, *, detectors_per_round: int, window: int = 3,
                 commit: int = 1, observables=None, decoder: str = "staged",
                 max_iters: int = 200, device=None, **knobs):
        super().__init__()
        import scipy.sparse as sp

        A = sp.csc_matrix(A).astype(np.uint8)
        self.D, self.N = A.shape
        self.m, self.n = self.D, self.N
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
        extent = rmax - rmin + 1
        if extent.max() > W - C + 1:
            raise ValueError(
                f"a mechanism spans {int(extent.max())} rounds; window-commit overlap "
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
        self._commit_cache: dict[int, tuple] = {}

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

    def _commit_tables(self, idx: int):
        """Device tables of window ``idx``'s commit: ``(committed columns
        [c], their positions in the window's answer [c], update)``, where
        ``update`` is None for the closed window and else ``(positions in
        the window's answer of the committed columns that touch a later
        round [u], the detectors they touch [f], their 0/1 incidence [u,
        f] float32)``."""
        if idx in self._commit_cache:
            return self._commit_cache[idx]
        t, _, closed = self._plan[idx]
        cols, _, _, commit_mask = self._window_model(idx)
        pos = np.flatnonzero(commit_mask)
        dev = self.device
        update = None
        if not closed:
            lo = (t + self.commit) * self.r
            A_fut = self.A[lo:, cols[pos]].tocsc()
            touch = np.flatnonzero(np.diff(A_fut.indptr))
            if touch.size:
                sub = A_fut[:, touch].tocsr()
                rows = np.flatnonzero(np.diff(sub.indptr))
                update = (torch.as_tensor(pos[touch], device=dev),
                          torch.as_tensor(lo + rows, device=dev),
                          torch.as_tensor(sub[rows].T.toarray(), dtype=torch.float32,
                                          device=dev))
        self._commit_cache[idx] = (torch.as_tensor(cols[pos], device=dev),
                                   torch.as_tensor(pos, device=dev), update)
        return self._commit_cache[idx]

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

    # -- Decoder contract ----------------------------------------------------

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        """The windows in order on the device record ``[B, D]``."""
        if per is not None:
            per = np.asarray(per, np.float64)
            if per.shape != (self.N,):
                raise ValueError(f"per must be an [{self.N}] vector of mechanism priors, "
                                 f"got shape {per.shape}")
        B, dev = syndromes.shape[0], syndromes.device
        d = syndromes.to(torch.uint8, copy=True)  # the record is adjusted as commits land
        out = torch.zeros((B, self.N), dtype=torch.int8, device=dev)
        wconv = torch.zeros((B, len(self._plan)), dtype=torch.bool, device=dev)
        iters = torch.zeros(B, dtype=torch.int32, device=dev)
        for idx, (t, rounds, _) in enumerate(self._plan):
            with span("ldpc.window"):
                cols, A_w, pr_w, _ = self._window_model(idx)
                dec = self._decoder_for(A_w, pr_w)
                cc, pos, update = self._commit_tables(idx)
                rec = d[:, t * self.r: (t + rounds) * self.r].contiguous()
                before = call_counters()
                x, conv, it, _ = dec._decode_batch(rec, seed + idx,
                                                   per=None if per is None else per[cols])
                count("windows")
                count("window_commit_cols", cc.numel())
                count_sum("window_lanes_unconverged", ~conv)
                if before is not None:
                    after = call_counters()
                    for name in _PER_WINDOW:
                        count(f"{name}.w{idx}", after.get(name, 0) - before.get(name, 0))
                settle(dev)
                with span("ldpc.window.commit"):
                    out[:, cc] = x.index_select(1, pos).to(torch.int8)
                    if update is not None:
                        # committed mechanisms may flip detectors in rounds >= t+C:
                        # remove them from the record the later windows decode
                        touch, rows, F = update
                        flips = torch.remainder(
                            x.index_select(1, touch).to(torch.float32) @ F, 2.0)
                        d[:, rows] ^= flips.to(torch.uint8)
                    wconv[:, idx] = conv
                    iters += it.to(torch.int32)
                    settle(dev)
        return out, wconv.all(dim=1), iters, {"window_converged": wconv}

    def decode_detector_stream(self, detectors, *, seed: int = 0):
        """Decode a detector record ``[B, R, r]`` (or ``[B, D]``) by sliding
        windows.  Returns ``(mechanisms [B, N] int8, info)`` with ``info =
        {"windows", "converged", "rounds"}`` (``converged``: the windows'
        converged shares, averaged); every column commits once."""
        d = np.asarray(detectors).astype(np.uint8)
        if d.ndim == 3:
            if d.shape[1:] != (self.R, self.r):
                raise ValueError(f"expected [B, {self.R}, {self.r}], got {d.shape}")
            d = d.reshape(d.shape[0], self.D)
        if d.ndim != 2 or d.shape[1] != self.D:
            raise ValueError(f"expected detectors [B, {self.D}], got {d.shape}")
        out, _, _, aux, _ = self.batch_decode_detailed(d, seed=seed)
        info = {"windows": len(self._plan),
                "converged": float(aux["window_converged"].mean(axis=0).mean()),
                "rounds": self.R}
        return out, info

    def predict_observables(self, detectors, *, seed: int = 0):
        """Windowed decode projected onto the logical observables."""
        if self.O is None:
            raise ValueError("no observables matrix was provided")
        x, info = self.decode_detector_stream(detectors, seed=seed)
        flips = (x.astype(np.uint8) @ self.O.T) & 1
        return flips, info
