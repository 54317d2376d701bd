"""Debug validation: opt-in checks of a decoder's inputs and outputs.

Counterpart of ``ldpcdecoders_tpu/utils/debug.py``: input validation and
output invariants (binary estimates, converged lanes that reproduce their
syndromes, soft values free of NaN).  The checks are numpy; tensors,
also on a CUDA card, are copied to the host first.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["validate_inputs", "check_decode_invariants"]


def _host(x) -> np.ndarray:
    """``x`` as a numpy array; a tensor is copied to the host (bfloat16 as
    float32, which holds it exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def validate_inputs(decoder, syndromes) -> None:
    """Raise ValueError on malformed syndromes (shape, dtype, values)."""
    syndromes = _host(syndromes)
    if syndromes.ndim != 2 or syndromes.shape[1] != decoder.m:
        raise ValueError(
            f"expected syndromes of shape [B, {decoder.m}], got {syndromes.shape}"
        )
    u = np.unique(syndromes)
    if not np.isin(u, (0, 1)).all():
        raise ValueError(f"syndromes must be 0/1; found values {u[:8]}")


def check_decode_invariants(decoder, syndromes, errors, converged, aux=None) -> None:
    """Assert decoder-output invariants; raise AssertionError on violation.

    * error estimates are 0/1;
    * every converged lane's estimate reproduces its syndrome (where the
      decoder's ``converged_implies_syndrome_match`` says it must);
    * auxiliary soft outputs contain no NaNs.
    """
    H = decoder.graph.require_H()
    errors = _host(errors)
    syndromes = _host(syndromes)
    converged = _host(converged)
    u = np.unique(errors)
    assert np.isin(u, (0, 1)).all(), f"non-binary error estimate values {u[:8]}"
    if getattr(decoder, "converged_implies_syndrome_match", True):
        synhat = (errors.astype(np.int64) @ H.astype(np.int64).T) % 2
        bad = np.flatnonzero(converged & (synhat != syndromes).any(axis=1))
        assert bad.size == 0, f"lanes {bad[:8]} flagged converged but syndrome mismatches"
    for k, v in (aux or {}).items():
        v = _host(v)
        if np.issubdtype(v.dtype, np.floating):
            assert not np.isnan(v).any(), f"NaN in aux['{k}']"
