"""Decoder base class: the public API surface of the port.

Counterpart of ``ldpcdecoders_tpu/models/base.py``.  Decoding is
batch-first: a batch is a leading tensor axis decoded in lock-step, and the
single-syndrome ``decode`` is the batch-of-one case.  Every decoder returns
a uniform int8 error estimate.

Each decoder is an ``nn.Module`` whose graph tables are registered buffers
on the ``device`` it was built for.  A decoder never picks a device itself:
asking for CUDA where none is available raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Decoder", "DecodeStats", "decode", "batchdecode", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if it names an absent CUDA card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} was requested but torch.cuda.is_available() is False")
    return device


@dataclasses.dataclass(frozen=True)
class DecodeStats:
    """Per-batch summary: convergence and iteration counts."""

    batch_size: int
    converged_fraction: float
    mean_iters: float
    max_iters_used: int

    @staticmethod
    def from_arrays(converged: np.ndarray, iters: np.ndarray) -> "DecodeStats":
        return DecodeStats(
            batch_size=int(converged.shape[0]),
            converged_fraction=float(np.mean(converged)),
            mean_iters=float(np.mean(iters)),
            max_iters_used=int(np.max(iters)) if iters.size else 0,
        )


class Decoder(torch.nn.Module):
    """Abstract batched syndrome decoder.

    Concrete decoders implement ``_decode_batch(syndromes, per=None) ->
    (errors, converged, iters, aux)`` over tensors on ``self.device``; this
    base class provides the host-facing ``decode`` / ``batch_decode`` API.
    """

    #: number of parity checks (rows of H)
    m: int
    #: number of variable nodes (columns of H)
    n: int
    device: torch.device

    def _decode_batch(self, syndromes: torch.Tensor, per=None):
        raise NotImplementedError

    def _call_decode(self, syndromes, per):
        syndromes = torch.as_tensor(syndromes, device=self.device)
        if syndromes.ndim != 2 or syndromes.shape[1] != self.m:
            raise ValueError(
                f"expected syndromes of shape [B, {self.m}], got {tuple(syndromes.shape)}"
            )
        if np.ndim(per) == 2 and np.shape(per)[0] != syndromes.shape[0]:
            raise ValueError(
                f"per-lane prior batch ({np.shape(per)[0]}) must match the "
                f"syndrome batch ({syndromes.shape[0]})"
            )
        return self._decode_batch(syndromes, per=per)

    # -- public API -------------------------------------------------------

    def decode(self, syndrome, *, per=None):
        """Decode one syndrome; returns ``(error[n] int8, converged bool)``."""
        syndrome = np.asarray(syndrome)
        errors, converged = self.batch_decode(syndrome[None, :], per=per)
        return errors[0], bool(converged[0])

    def batch_decode(self, syndromes, *, per=None):
        """Decode a batch; ``syndromes`` is ``[B, m]`` (batch-first).

        ``per`` optionally overrides the constructor's physical error rate
        for this call.

        Returns ``(errors [B, n] int8, converged [B] bool)`` as numpy arrays.
        """
        errors, converged, _, _ = self._call_decode(np.asarray(syndromes), per)
        return errors.cpu().numpy(), converged.cpu().numpy()

    def batch_decode_async(self, syndromes, *, per=None):
        """Decode a batch and return ``(errors, converged)`` as tensors on
        the decoder's device, without copying them to the host.  A tensor
        input on that device is used as it is.  Decoders with host-side
        orchestration (OSD-0's failing-lane compaction, BP's early exit)
        still synchronize internally."""
        errors, converged, _, _ = self._call_decode(syndromes, per)
        return errors, converged

    def batch_decode_detailed(self, syndromes, *, per=None):
        """Like :meth:`batch_decode` but also returns iteration counts,
        decoder-specific auxiliary output, and :class:`DecodeStats`."""
        errors, converged, iters, aux = self._call_decode(np.asarray(syndromes), per)
        errors = errors.cpu().numpy()
        converged = converged.cpu().numpy()
        iters = iters.cpu().numpy()
        aux = {k: v.cpu().numpy() for k, v in aux.items()}
        return errors, converged, iters, aux, DecodeStats.from_arrays(converged, iters)


def decode(decoder: Decoder, syndrome, **kw):
    """Free-function form of ``decoder.decode`` (reference ``decode!``)."""
    return decoder.decode(syndrome, **kw)


def batchdecode(decoder: Decoder, syndromes, **kw):
    """Free-function form of ``decoder.batch_decode`` (reference
    ``batchdecode!``), batch-first."""
    return decoder.batch_decode(syndromes, **kw)
