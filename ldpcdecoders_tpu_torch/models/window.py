"""Sliding-window streaming decoding of unbounded syndrome streams.

Counterpart of ``ldpcdecoders_tpu/models/window.py``.  A real-time decoder
cannot wait for a run's final (perfect) readout: it decodes a window of
``W`` rounds over the open-boundary space-time graph (``perfect_last=False``:
the window's last rounds may still be explained by future measurement
errors), commits the oldest ``C`` rounds of its solution, slides by ``C``,
and decodes the stream's final window over the closed graph.

Cross-window bookkeeping is one XOR: committing round ``t``'s
measurement-error estimate ``u_t`` removes it from the next window's first
detector (``d_{t+1} = H e_{t+1} + u_{t+1} + u_t``), so the stream
telescopes: the final cumulative estimate reproduces the final perfect
syndrome exactly, like a full-history decode.

One route, the reference's device chain: the ``[B, m]`` carry, the
accumulated correction ``E`` and the convergence sum (a float32 device sum,
as the reference's) stay on the decoder's device between windows, with no
host read of the window's own, and come to the host once at the end.  The
inner decoders do what they do on their own (BP+OSD's failing-lane
compaction reads the converged flags once a window).  The reference builds
its bposd inner ``fused=True`` and then runs it eagerly (reference
window.py:72-76); so does the port, output-identical.  Closed tail decoders are built
lazily per tail length.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.spacetime import detectors_of
from .base import resolve_device
from .spacetime import SpaceTimeDecoder

__all__ = ["SlidingWindowDecoder"]


class SlidingWindowDecoder(torch.nn.Module):
    """Streaming decoder: window ``W`` rounds, commit ``C``, slide.

    Args:
      H: ``[m, n]`` stabilizer block.
      per: per-round data-error rate (scalar or ``[n]``).
      max_iters: BP iteration cap per window decode.
      window: rounds per decoded window, ``W >= 2``.
      commit: rounds committed (and slid past) per window,
        ``1 <= commit < window``.
      meas_error_rate: readout flip rate (default ``per``).
      decoder: inner decoder kind (prior-capable; ``"bposd"`` default).
      device: where decoding runs; None is the current CUDA card.
      **knobs: extra DecoderConfig fields of the inner decoder.
    """

    def __init__(self, H, per, max_iters: int, *, window: int = 3, commit: int = 1,
                 meas_error_rate=None, decoder: str = "bposd", device=None, **knobs):
        super().__init__()
        W, C = int(window), int(commit)
        if W < 2:
            raise ValueError(f"window must be >= 2 rounds, got {window}")
        if not 1 <= C < W:
            raise ValueError(f"commit must be in [1, window), got {commit} (window={window})")
        self.window, self.commit = W, C
        self.device = resolve_device(device)
        self._mk = dict(per=per, max_iters=max_iters, meas_error_rate=meas_error_rate,
                        decoder=decoder, **knobs)
        # one open-boundary decoder serves every mid-stream window
        self._open = SpaceTimeDecoder(H, W, per, max_iters, meas_error_rate=meas_error_rate,
                                      decoder=decoder, perfect_last=False, device=self.device,
                                      **knobs)
        self._closed: dict[int, SpaceTimeDecoder] = {}
        # per-round block shapes (not the open decoder's R*m record length)
        self.m, self.n = self._open.block_m, self._open.block_n
        self._Hs = H

    def _tail(self, rounds: int) -> SpaceTimeDecoder:
        if rounds not in self._closed:
            mk = dict(self._mk)
            per, max_iters = mk.pop("per"), mk.pop("max_iters")
            self._closed[rounds] = SpaceTimeDecoder(
                self._Hs, rounds, per, max_iters, meas_error_rate=mk.pop("meas_error_rate"),
                decoder=mk.pop("decoder"), perfect_last=True, device=self.device, **mk)
        return self._closed[rounds]

    def decode_stream(self, syndromes, *, seed: int = 0):
        """Decode a full measured stream ``[B, R, m]`` (last round perfect)
        by sliding windows; returns ``(errors [B, n] int8, info)`` where
        ``errors`` is the cumulative data correction after round ``R`` and
        ``info`` has ``windows`` (decode count), ``converged`` (fraction of
        window decodes whose inner converged, averaged over lanes) and
        ``rounds``."""
        s = np.asarray(syndromes).astype(np.uint8)
        if s.ndim != 3 or s.shape[2] != self.m:
            raise ValueError(f"expected syndromes of shape [B, R, {self.m}], got {s.shape}")
        return self.decode_detector_stream(detectors_of(s).reshape(s.shape), seed=seed)

    def decode_detector_stream(self, detectors, *, seed: int = 0):
        """Like :meth:`decode_stream` on a precomputed detector record
        ``[B, R, m]`` (``detectors_of`` of the syndrome history, round-major)."""
        d = torch.as_tensor(detectors, device=self.device)
        if d.ndim != 3 or d.shape[2] != self.m:
            raise ValueError(f"expected detectors of shape [B, R, {self.m}], "
                             f"got {tuple(d.shape)}")
        B, R, m = d.shape
        W, C = self.window, self.commit
        d = d.to(torch.int32)
        E = torch.zeros((B, self.n), dtype=torch.int32, device=self.device)
        carry = torch.zeros((B, m), dtype=torch.int32, device=self.device)
        conv_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        t = step = 0
        while R - t > W:
            win = d[:, t:t + W].clone()
            win[:, 0] ^= carry
            _, conv, _, aux = self._open._decode_batch(win.reshape(B, W * m).to(torch.uint8),
                                                       seed + step)
            data = aux["data_rounds"].to(torch.int32)
            meas = aux["meas"].to(torch.int32)
            E = E ^ (data[:, :C].sum(dim=1) & 1)
            carry = meas[:, C - 1] & 1
            conv_sum = conv_sum + conv.to(torch.float32).mean()
            t += C
            step += 1
        rem = R - t
        win = d[:, t:].clone()
        win[:, 0] ^= carry
        e_tail, conv, _, _ = self._tail(rem)._decode_batch(
            win.reshape(B, rem * m).to(torch.uint8), seed + step)
        E = (E ^ e_tail.to(torch.int32)).to(torch.int8)
        conv_sum = conv_sum + conv.to(torch.float32).mean()
        # the stream's one fetch
        return E.cpu().numpy(), {"windows": step + 1,
                                 "converged": float(conv_sum) / (step + 1), "rounds": R}
