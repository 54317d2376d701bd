"""Decoder base class: the public API surface of the port.

Counterpart of ``ldpcdecoders_tpu/models/base.py``.  Decoding is
batch-first: a batch is a leading tensor axis decoded in lock-step, and the
single-syndrome ``decode`` is the batch-of-one case.  Every decoder returns
a uniform int8 error estimate.

Each decoder is an ``nn.Module`` whose graph tables are registered buffers
on the ``device`` it was built for.  ``device=None`` is the current CUDA
card; a decoder never picks the CPU itself, and asking for CUDA where none
is available raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.profiling import call_span, span, to_device, to_host

__all__ = ["Decoder", "DecodeStats", "decode", "batchdecode", "decode_soft", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, or the current CUDA card for None; raises if
    that is an absent CUDA card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} was requested but torch.cuda.is_available() is False "
                "(pass device='cpu' to decode on the CPU)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
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

    Concrete decoders implement ``_decode_batch(syndromes, seed=0,
    per=None) -> (errors, converged, iters, aux)`` over tensors on
    ``self.device``; this base class provides the host-facing ``decode`` /
    ``batch_decode`` API.  ``seed`` keys a randomized decoder's draws (the
    bit-flip decoder's tie-breaks); the other decoders are deterministic
    and ignore it.
    """

    #: number of parity checks (rows of H)
    m: int
    #: number of variable nodes (columns of H)
    n: int
    device: torch.device
    #: whether converged=True guarantees the estimate reproduces the
    #: syndrome (True except for bit-flip, which also reports convergence
    #: when no flip is worthwhile)
    converged_implies_syndrome_match: bool = True
    #: whether ``per=`` can override the channel prior for one call
    #: (False: bit-flip)
    supports_per_override: bool = True
    #: whether a per-bit ``[n]`` prior vector is accepted (False: bit-flip)
    supports_vector_prior: bool = True

    def _decode_batch(self, syndromes: torch.Tensor, seed: int = 0, per=None):
        raise NotImplementedError

    def _call_decode(self, syndromes, seed, per):
        with span("ldpc.to_device"):
            syndromes = to_device(syndromes, self.device)
        if syndromes.ndim != 2 or syndromes.shape[1] != self.m:
            raise ValueError(
                f"expected syndromes of shape [B, {self.m}], got {tuple(syndromes.shape)}"
            )
        if np.ndim(per) == 2 and np.shape(per)[0] != syndromes.shape[0]:
            raise ValueError(
                f"per-lane prior batch ({np.shape(per)[0]}) must match the "
                f"syndrome batch ({syndromes.shape[0]})"
            )
        if per is not None and not self.supports_per_override:
            raise ValueError(
                f"{type(self).__name__} does not support per-call channel prior overrides")
        with span("ldpc.decode"):
            return self._decode_batch(syndromes, seed, per=per)

    # -- public API -------------------------------------------------------

    def decode(self, syndrome, *, seed: int = 0, per=None):
        """Decode one syndrome; returns ``(error[n] int8, converged bool)``."""
        syndrome = np.asarray(syndrome)
        errors, converged = self.batch_decode(syndrome[None, :], seed=seed, per=per)
        return errors[0], bool(converged[0])

    def batch_decode(self, syndromes, *, seed: int = 0, per=None):
        """Decode a batch; ``syndromes`` is ``[B, m]`` (batch-first).

        ``per`` optionally overrides the constructor's physical error rate
        for this call.

        Returns ``(errors [B, n] int8, converged [B] bool)`` as numpy arrays.
        """
        with call_span():
            errors, converged, _, _ = self._call_decode(np.asarray(syndromes), seed, per)
            with span("ldpc.to_host"):
                return to_host(errors, converged)

    def batch_decode_async(self, syndromes, *, seed: int = 0, per=None):
        """Decode a batch and return ``(errors, converged)`` as tensors on
        the decoder's device, without copying them to the host.  A tensor
        input on that device is used as it is.  Decoders with host-side
        orchestration (OSD-0's failing-lane compaction, BP's early exit)
        still synchronize internally."""
        with call_span():
            errors, converged, _, _ = self._call_decode(syndromes, seed, per)
        return errors, converged

    def batch_decode_detailed_async(self, syndromes, *, seed: int = 0, per=None):
        """Like :meth:`batch_decode_detailed` without the copies to the
        host: returns ``(errors, converged, iters, aux)`` as tensors on the
        decoder's device."""
        with call_span():
            return self._call_decode(syndromes, seed, per)

    def batch_decode_detailed(self, syndromes, *, seed: int = 0, per=None):
        """Like :meth:`batch_decode` but also returns iteration counts,
        decoder-specific auxiliary output, and :class:`DecodeStats`."""
        with call_span():
            errors, converged, iters, aux = self._call_decode(np.asarray(syndromes), seed, per)
            with span("ldpc.to_host"):
                # numpy has no bfloat16: such values come back as float32 (exact)
                errors, converged, iters, *soft = to_host(
                    errors, converged, iters,
                    *(v.float() if v.dtype == torch.bfloat16 else v for v in aux.values()))
            aux = dict(zip(aux, soft))
            return errors, converged, iters, aux, DecodeStats.from_arrays(converged, iters)


def decode(decoder: Decoder, syndrome, **kw):
    """Free-function form of ``decoder.decode`` (reference ``decode!``)."""
    return decoder.decode(syndrome, **kw)


def batchdecode(decoder: Decoder, syndromes, **kw):
    """Free-function form of ``decoder.batch_decode`` (reference
    ``batchdecode!``), batch-first."""
    return decoder.batch_decode(syndromes, **kw)


def decode_soft(decoder: Decoder, llrs, *, seed: int = 0):
    """Codeword-domain soft-input decoding from received channel LLRs.

    The classical-FEC entry point (BPSK/AWGN etc.): given per-bit received
    LLRs ``[B, n]`` (positive = bit 0 more likely), take the hard decision,
    decode its syndrome with per-lane priors derived from the LLR
    magnitudes (``p_wrong = 1/(1+e^{|llr|})``), and flip the estimated
    error pattern back out.  Needs a decoder that accepts ``[B, n]`` priors
    (BP, min-sum).

    Returns ``(codeword [B, n] int8, converged [B] bool)``.
    """
    from ..ops.syndrome import SyndromeCheck

    llrs = np.asarray(llrs, dtype=np.float64)
    if llrs.ndim != 2 or llrs.shape[1] != decoder.n:
        raise ValueError(f"expected llrs of shape [B, {decoder.n}], got {llrs.shape}")
    hard = (llrs < 0).astype(np.int8)
    syn_fn = getattr(decoder, "_soft_syndrome_fn", None)
    if syn_fn is None:  # built once; re-used across streaming calls
        syn_fn = SyndromeCheck(decoder.graph, decoder.device)
        decoder._soft_syndrome_fn = syn_fn
    syn = syn_fn(torch.as_tensor(hard.astype(np.float32), device=decoder.device))
    # probability the hard decision is wrong; floored away from 0 so the
    # prior stays finite for saturated LLRs
    p_wrong = np.clip(1.0 / (1.0 + np.exp(np.abs(llrs))), 1e-12, 0.5)
    err, converged = decoder.batch_decode(syn.to(torch.int8).cpu().numpy(), seed=seed,
                                          per=p_wrong)
    return (hard ^ err.astype(np.int8)).astype(np.int8), converged
