"""Gallager regular LDPC parity-check-matrix construction.

Counterpart of ``ldpcdecoders_tpu/codes/gallager.py``: the same numpy calls
in the same order, so the same ``rng`` gives the same ``H`` in both
packages.  A base block of ``n_equations/wc`` rows with ``wr`` consecutive
ones per row is stacked with ``wc-1`` column-shuffled copies.
"""

from __future__ import annotations

import numpy as np

__all__ = ["parity_check_matrix"]


def parity_check_matrix(
    n: int, wr: int, wc: int, *, rng: np.random.Generator | int | None = None
) -> np.ndarray:
    """Build a random (wr, wc)-regular Gallager LDPC parity-check matrix.

    Args:
      n: code length (number of columns). Must be divisible by ``wr``.
      wr: row weight (bits per parity-check equation).
      wc: column weight (parity checks per bit).
      rng: optional ``np.random.Generator`` or integer seed.

    Returns:
      ``[n*wc//wr, n]`` uint8 matrix with constant row sums ``wr`` and column
      sums ``wc``.
    """
    if n % wr != 0:
        raise ValueError(f"n ({n}) must be divisible by wr ({wr})")
    if rng is None or isinstance(rng, (int, np.integer)):
        rng = np.random.default_rng(rng)

    n_equations = (n * wc) // wr
    block_size = n_equations // wc

    # base block: row i has ones in columns [i*wr, (i+1)*wr)
    block = np.kron(
        np.eye(block_size, dtype=np.uint8), np.ones((1, wr), dtype=np.uint8)
    )

    parts = [block]
    for _ in range(wc - 1):
        parts.append(block[:, rng.permutation(n)])
    return np.concatenate(parts, axis=0)
