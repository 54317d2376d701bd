"""Quasi-cyclic (QC) LDPC codes: protograph lifting with circulant blocks.

Counterpart of ``ldpcdecoders_tpu/codes/qc.py``: the same numpy calls in the
same order, so the same arguments give the same arrays in both packages.

Production classical LDPC codes (5G NR, IEEE 802.11/16, DVB-S2) are
quasi-cyclic: H is an ``[mb, nb]`` grid of ``Z x Z`` blocks, each either
zero or a cyclic-shift permutation matrix ``P^s``.  The circulant structure
is what lets a whole decode stay in on-chip memory (ops/cuda_qc.py): the
Tanner graph's cross-layout permutation degenerates to cyclic shifts along
the lift dimension, which are index arithmetic.

Conventions
-----------
A base matrix ``B`` is an ``[mb, nb]`` int array with entries in
``{-1} U [0, Z)``; ``-1`` marks an all-zero block and ``s >= 0`` the
circulant ``P^s`` defined by ``P^s[r, c] = 1  iff  c == (r + s) % Z``.
Lifted check ``i*Z + r`` therefore connects to lifted variable
``j*Z + (r + s) % Z`` for every non-negative entry ``s = B[i, j]``.
"""

from __future__ import annotations

import numpy as np

from .gallager import parity_check_matrix

__all__ = [
    "qc_lift",
    "qc_lift_edges",
    "qc_group_lift_edges",
    "random_qc_base_matrix",
    "save_base_matrix",
    "load_base_matrix",
]


def _validate_base(base: np.ndarray, Z: int) -> np.ndarray:
    base = np.asarray(base, dtype=np.int64)
    if base.ndim != 2:
        raise ValueError("base matrix must be 2-D")
    if Z < 1:
        raise ValueError(f"lift size Z must be >= 1, got {Z}")
    if base.size and (base.min() < -1 or base.max() >= Z):
        raise ValueError("base-matrix entries must be -1 (zero block) or shifts in [0, Z)")
    return base


def qc_lift_edges(base, Z: int):
    """Expand a base matrix into the lifted code's COO edge list.

    Returns ``(rows, cols, m, n)`` with ``m = mb*Z``, ``n = nb*Z`` — the
    production path for large lifts (feeds ``TannerGraph.from_edges``
    without ever materializing H).

    Example:
      >>> rows, cols, m, n = qc_lift_edges([[0, 1]], 3)
      >>> m, n
      (3, 6)
      >>> sorted(zip(rows.tolist(), cols.tolist()))
      [(0, 0), (0, 4), (1, 1), (1, 5), (2, 2), (2, 3)]
    """
    base = _validate_base(np.asarray(base), Z)
    mb, nb = base.shape
    bi, bj = np.nonzero(base >= 0)
    shifts = base[bi, bj]
    r = np.arange(Z, dtype=np.int64)
    rows = (bi[:, None] * Z + r[None, :]).reshape(-1)
    cols = (bj[:, None] * Z + (r[None, :] + shifts[:, None]) % Z).reshape(-1)
    return rows, cols, mb * Z, nb * Z


def qc_group_lift_edges(terms, mb: int, nb: int, l: int, m: int):
    """Expand 2-D group-circulant edge terms into the lifted COO edge list.

    The generalization of :func:`qc_lift_edges` from the cyclic group
    ``Z_Z`` to ``Z_l x Z_m`` (the "bivariate" structure of bicycle
    quantum codes, codes/bicycle.py): each term ``(i, j, a, b)`` places
    the monomial ``x^a y^b`` in block ``(i, j)``, connecting lifted
    check ``i*Z + w`` (where ``w`` flattens the group element
    ``(u, v) = divmod(w, m)``) to lifted variable
    ``j*Z + ((u+a)%l)*m + (v+b)%m`` with ``Z = l*m``.

    Multiple terms may share a block; duplicate terms are rejected
    (they would cancel over GF(2), leaving a phantom double edge in the
    Tanner graph).  Returns ``(rows, cols, m_checks, n)``.

    Example:
      >>> rows, cols, mc, n = qc_group_lift_edges([(0, 0, 0, 1)], 1, 1, 2, 2)
      >>> (mc, n), sorted(zip(rows.tolist(), cols.tolist()))
      ((4, 4), [(0, 1), (1, 0), (2, 3), (3, 2)])
    """
    if l < 1 or m < 1:
        raise ValueError(f"group sizes must be >= 1, got l={l}, m={m}")
    Z = l * m
    seen = set()
    for t in terms:
        i, j, a, b = (int(x) for x in t)
        if not (0 <= i < mb and 0 <= j < nb):
            raise ValueError(f"term {t}: block ({i}, {j}) outside [{mb}, {nb}]")
        if not (0 <= a < l and 0 <= b < m):
            raise ValueError(f"term {t}: shift ({a}, {b}) outside Z_{l} x Z_{m}")
        if (i, j, a, b) in seen:
            raise ValueError(f"duplicate term {(i, j, a, b)} (cancels over GF(2))")
        seen.add((i, j, a, b))
    w = np.arange(Z, dtype=np.int64)
    u, v = np.divmod(w, m)
    rows_parts, cols_parts = [], []
    for i, j, a, b in sorted(seen):
        rows_parts.append(i * Z + w)
        cols_parts.append(j * Z + ((u + a) % l) * m + (v + b) % m)
    rows = np.concatenate(rows_parts) if rows_parts else np.zeros(0, np.int64)
    cols = np.concatenate(cols_parts) if cols_parts else np.zeros(0, np.int64)
    return rows, cols, mb * Z, nb * Z


def qc_lift(base, Z: int) -> np.ndarray:
    """Densely lift a base matrix: each entry becomes a Z x Z circulant.

    Example:
      >>> qc_lift([[1, -1]], 2)
      array([[0, 1, 0, 0],
             [1, 0, 0, 0]], dtype=uint8)
    """
    base = _validate_base(np.asarray(base), Z)
    mb, nb = base.shape
    rows, cols, m, n = qc_lift_edges(base, Z)
    H = np.zeros((m, n), dtype=np.uint8)
    H[rows, cols] = 1
    return H


def random_qc_base_matrix(
    nb: int, wr: int, wc: int, Z: int, *, rng: np.random.Generator | int | None = None
) -> np.ndarray:
    """Random (wr, wc)-regular QC base matrix with shifts drawn from [0, Z).

    The block-level support is a Gallager (wr, wc)-regular matrix
    (:func:`parity_check_matrix` on the ``nb`` block columns), so the
    lifted code is (wr, wc)-regular with ``n = nb*Z`` variables — the QC
    analog of the reference's generator.  Shift values are uniform; for
    production codes designed for girth, load a standard base matrix via
    :func:`load_base_matrix` instead.

    Example:
      >>> B = random_qc_base_matrix(8, 4, 2, 16, rng=0)
      >>> B.shape
      (4, 8)
      >>> int((B >= 0).sum(axis=1)[0]), int((B >= 0).sum(axis=0)[0])
      (4, 2)
    """
    if rng is None or isinstance(rng, (int, np.integer)):
        rng = np.random.default_rng(rng)
    support = parity_check_matrix(nb, wr, wc, rng=rng).astype(bool)
    base = np.full(support.shape, -1, dtype=np.int64)
    base[support] = rng.integers(0, Z, size=int(support.sum()))
    return base


def save_base_matrix(base, Z: int, path) -> None:
    """Write a base matrix as text: first line ``mb nb Z``, then rows.

    Zero blocks are written as ``-1`` (the common convention in published
    5G NR / 802.11 base-graph tables, so standard tables paste in
    directly).
    """
    base = _validate_base(np.asarray(base), Z)
    mb, nb = base.shape
    with open(path, "w") as f:
        f.write(f"{mb} {nb} {Z}\n")
        for row in base:
            f.write(" ".join(str(int(v)) for v in row) + "\n")


def load_base_matrix(path):
    """Load a base matrix saved by :func:`save_base_matrix`.

    Returns ``(base, Z)``.
    """
    with open(path) as f:
        header = f.readline().split()
        if len(header) != 3:
            raise ValueError("base-matrix file must start with 'mb nb Z'")
        mb, nb, Z = (int(x) for x in header)
        base = np.loadtxt(f, dtype=np.int64, ndmin=2)
    if base.shape != (mb, nb):
        raise ValueError(f"expected {(mb, nb)} base matrix, file has {base.shape}")
    return _validate_base(base, Z), Z
