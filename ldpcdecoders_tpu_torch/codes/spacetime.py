"""Space-time (multi-round) detector graphs for phenomenological noise.

Counterpart of ``ldpcdecoders_tpu/codes/spacetime.py`` (numpy and scipy,
the same arrays).  Each of ``R`` stabilizer-measurement rounds reports
``s_r = H @ (e_1 + ... + e_r) + u_r`` where ``e_r`` are the fresh data
errors of round ``r`` and ``u_r`` is the round's measurement (readout)
error.  Decoding each round independently mistakes every flipped readout
for a data error; the standard fix is to decode the *detector* record

    d_r = s_r XOR s_{r-1}          (s_0 = 0)
        = H @ e_r + u_r + u_{r-1}

over a space-time Tanner graph whose variables are every round's fresh
data errors plus every round's measurement errors.  That graph is just
another (sparse) parity-check matrix, so the batched decoders apply
unchanged: one call decodes all ``R`` rounds of a batch of shots.

This module builds that matrix.  Layout of the ``A`` columns::

    [ e_1 (n) | e_2 (n) | ... | e_R (n) | u_1 (m) | ... | u_{R-1} (m) ]

with row block ``r`` (m rows, 1-based) holding ``H`` at the ``e_r``
block, ``I_m`` at ``u_r`` (when ``r < R``; the last round is read out
perfectly: the conventional closure that makes the decoding problem
well-posed) and ``I_m`` at ``u_{r-1}`` (when ``r > 1``).  With
``perfect_last=False`` a ``u_R`` column block is appended instead and
row ``R`` gets ``I_m`` there (open boundary: use when a later window
will absorb the tail, e.g. sliding-window decoding).

``rounds=1`` with ``perfect_last=True`` degenerates to ``A == H``:
single-shot decoding is the exact special case.
"""

from __future__ import annotations

import numpy as np

__all__ = ["spacetime_pcm", "spacetime_prior", "detectors_of"]


def spacetime_pcm(H, rounds: int, *, perfect_last: bool = True):
    """Space-time detector parity-check matrix for ``rounds`` noisy
    measurement rounds of the stabilizer block ``H``.

    Args:
      H: ``[m, n]`` stabilizer parity-check matrix (dense 0/1 array-like
        or scipy.sparse).
      rounds: number of measurement rounds ``R >= 1``.
      perfect_last: the final round is noiseless (default — the standard
        closed decoding problem).  ``False`` appends a ``u_R`` column
        block (open boundary for windowed decoding).

    Returns:
      ``A`` as ``scipy.sparse.csr_matrix`` of shape
      ``[R*m, R*n + (R-1)*m]`` (or ``[R*m, R*n + R*m]`` when
      ``perfect_last=False``), uint8.  Column layout is documented in
      the module docstring; rows are round-major (round ``r`` occupies
      rows ``(r-1)*m : r*m``).
    """
    import scipy.sparse as sp

    R = int(rounds)
    if R < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    Hs = sp.csr_matrix(H).astype(np.uint8)
    if Hs.nnz and Hs.data.max() > 1:
        raise ValueError("H must be a 0/1 matrix")
    m, n = Hs.shape
    n_meas = (R - 1 if perfect_last else R) * m
    I = sp.identity(m, dtype=np.uint8, format="csr")
    blocks = []
    for r in range(1, R + 1):
        row = [None] * R + [None] * (R - 1 if perfect_last else R)
        row[r - 1] = Hs
        if r < R or not perfect_last:
            row[R + r - 1] = I
        if r > 1:
            row[R + r - 2] = I
        blocks.append(row)
    A = sp.bmat(blocks, format="csr", dtype=np.uint8)
    assert A.shape == (R * m, R * n + n_meas)
    return A


def spacetime_prior(n: int, m: int, rounds: int, per, q,
                    *, perfect_last: bool = True) -> np.ndarray:
    """Per-column channel prior for :func:`spacetime_pcm`'s layout:
    ``per`` at every data-error column, ``q`` at every measurement-error
    column.  ``per`` may be a scalar or an ``[n]`` per-qubit vector
    (tiled across rounds); ``q`` a scalar or ``[m]`` vector.

    Returns a float64 ``[R*n + n_meas]`` vector suitable for the
    decoders' ``per=`` argument.
    """
    R = int(rounds)
    data = np.broadcast_to(np.asarray(per, np.float64), (n,))
    meas = np.broadcast_to(np.asarray(q, np.float64), (m,))
    n_meas_rounds = R - 1 if perfect_last else R
    return np.concatenate([np.tile(data, R), np.tile(meas, n_meas_rounds)])


def detectors_of(syndromes) -> np.ndarray:
    """XOR-difference detector record of a multi-round syndrome history.

    Args:
      syndromes: ``[B, R, m]`` (or ``[R, m]``) 0/1 measured syndromes,
        round-major.

    Returns the same-shape detector array ``d_r = s_r XOR s_{r-1}``
    (``s_0 = 0``), flattened to ``[B, R*m]`` (or ``[R*m]``) — the row
    layout :func:`spacetime_pcm` expects.
    """
    s = np.asarray(syndromes).astype(np.uint8)
    single = s.ndim == 2
    if single:
        s = s[None]
    if s.ndim != 3:
        raise ValueError(f"expected [B, R, m] or [R, m] syndromes, got {s.shape}")
    d = s.copy()
    d[:, 1:] ^= s[:, :-1]
    d = d.reshape(s.shape[0], -1)
    return d[0] if single else d
