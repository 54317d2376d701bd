"""Channel-prior helpers (counterpart of ``ldpcdecoders_tpu/models/priors.py``).

Host-side numpy: the prior is validated and converted in float64 before it
is cast to the decoder's message dtype.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "validate_per",
    "per_to_ratio",
    "per_to_llr",
    "per_to_depolarizing_llr",
    "per_to_quantized_llr",
    "next_pow2",
]


def validate_per(per, n: int) -> np.ndarray:
    """Accept a scalar, an [n] vector, or a per-lane [B, n] matrix in
    (0, 1); return a float64 ndarray."""
    per_arr = np.asarray(per, dtype=np.float64)
    if per_arr.ndim > 2 or (per_arr.ndim >= 1 and per_arr.shape[-1] != n):
        raise ValueError(f"per must be a scalar, an [{n}] vector, or [B, {n}]")
    return per_arr


def per_to_ratio(per, n: int) -> np.ndarray:
    """p -> p/(1-p) (sum-product probability-ratio domain)."""
    p = validate_per(per, n)
    return p / (1.0 - p)


def per_to_llr(per, n: int) -> np.ndarray:
    """p -> log((1-p)/p) (binary-symmetric-channel LLR)."""
    p = validate_per(per, n)
    return np.log((1.0 - p) / p)


def per_to_depolarizing_llr(per, n: int) -> np.ndarray:
    """p -> log((1-2p/3)/(2p/3)) (depolarizing prior)."""
    p = validate_per(per, n)
    return np.log((1.0 - 2.0 * p / 3.0) / (2.0 * p / 3.0))


def per_to_quantized_llr(per, scale: float) -> int:
    """Scalar p -> round(scale * llr) clipped to the int8 range."""
    if np.ndim(per):
        raise ValueError("quantized decoders need a scalar per")
    return int(np.clip(round(float(np.log((1.0 - per) / per) * scale)), -127, 127))


def next_pow2(x: int) -> int:
    b = 1
    while b < x:
        b *= 2
    return b
