"""Decoding-quality metrics (counterpart of ``ldpcdecoders_tpu/utils/metrics.py``).

Carried so far: the GF(2) null-space basis (``codes/bicycle.py`` counts
logical qubits with it) and the Wilson interval (``models/staged.py``
``run_eval``); the rest of the reference module belongs to the evaluation
harness.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["gf2_kernel_basis", "wilson_interval"]


def wilson_interval(failures: int, trials: int, z: float = 1.96) -> tuple[float, float]:
    """Wilson score interval for a failure-rate estimate.

    Example:
      >>> lo, hi = wilson_interval(5, 100)
      >>> bool(lo < 0.05 < hi)
      True
    """
    if trials == 0:
        return (0.0, 1.0)
    p = failures / trials
    denom = 1.0 + z * z / trials
    center = (p + z * z / (2 * trials)) / denom
    half = z * math.sqrt(p * (1 - p) / trials + z * z / (4 * trials * trials)) / denom
    return (max(0.0, center - half), min(1.0, center + half))


def gf2_kernel_basis(H) -> np.ndarray:
    """Basis of the GF(2) null space of ``H`` as a ``[k, n]`` 0/1 array.

    For a CSS block this is the space of undetectable errors; quotienting
    by the opposite block's row span yields the logical operators.
    Host-side dense RREF, intended for small and moderate codes.
    """
    if hasattr(H, "toarray"):
        H = H.toarray()
    A = (np.asarray(H) != 0).astype(np.uint8).copy()
    m, n = A.shape
    pivots = []
    r = 0
    for j in range(n):
        if r == m:
            break
        rows_with = np.flatnonzero(A[r:, j]) + r
        if rows_with.size == 0:
            continue
        k = rows_with[0]
        A[[r, k]] = A[[k, r]]
        elim = np.flatnonzero(A[:, j])
        elim = elim[elim != r]
        A[elim] ^= A[r]
        pivots.append(j)
        r += 1
    free = [j for j in range(n) if j not in set(pivots)]
    basis = np.zeros((len(free), n), np.uint8)
    for i, j in enumerate(free):
        basis[i, j] = 1
        # pivot variable values follow from the RREF rows
        for rr, pj in enumerate(pivots):
            if A[rr, j]:
                basis[i, pj] = 1
    return basis
