"""Gallager regular LDPC parity-check-matrix construction.

Counterpart of ``ldpcdecoders_tpu/codes/gallager.py``: the same numpy calls
in the same order, so the same ``rng`` gives the same ``H`` in both
packages; ``save_pcm`` / ``load_pcm`` write and read the same text, so
either package reads the other's files.  A base block of ``n_equations/wc`` rows with ``wr`` consecutive
ones per row is stacked with ``wc-1`` column-shuffled copies.
"""

from __future__ import annotations

import numpy as np

__all__ = ["parity_check_matrix", "save_pcm", "load_pcm"]


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


def save_pcm(H: np.ndarray, file_path: str) -> None:
    """Save a parity-check matrix as whitespace-delimited integer text (the
    format of the original package's ``save_pcm``)."""
    np.savetxt(file_path, np.asarray(H, dtype=np.int64), fmt="%d")


def load_pcm(file_path: str) -> np.ndarray:
    """Load a parity-check matrix saved by :func:`save_pcm` (int64, 2-D)."""
    H = np.loadtxt(file_path, dtype=np.int64)
    return np.atleast_2d(H)
