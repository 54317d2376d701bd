"""Quantum CSS code parity-check constructions (host-side, NumPy).

Counterpart of ``ldpcdecoders_tpu/codes/css.py``, carried unchanged: the
same matrices, bit for bit.  Toric, rotated surface, repetition, cycle and
Hamming codes, and the hypergraph product (dense, and as COO edge lists for
codes too large to densify).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "toric_code_x",
    "toric_code_z",
    "surface_code_x",
    "surface_code_z",
    "repetition_code",
    "cycle_matrix",
    "hamming_code",
    "hypergraph_product",
    "hypergraph_product_edges",
]


def _edge_index(d: int):
    """Index qubits on the edges of a d x d torus: horizontal then vertical."""

    def h(i, j):  # horizontal edge at vertex (i, j)
        return (i % d) * d + (j % d)

    def v(i, j):  # vertical edge at vertex (i, j)
        return d * d + (i % d) * d + (j % d)

    return h, v


def toric_code_x(d: int) -> np.ndarray:
    """X-stabilizer (vertex) parity-check matrix of the d x d toric code.

    2*d^2 qubits on edges, d^2 vertex stabilizers; each vertex touches the
    four incident edges.  Every row has weight 4 and every column weight 2.
    Equivalent in structure to QuantumClifford's ``parity_matrix_x(Toric(d,d))``.
    """
    h, v = _edge_index(d)
    H = np.zeros((d * d, 2 * d * d), dtype=np.uint8)
    for i in range(d):
        for j in range(d):
            s = i * d + j
            H[s, h(i, j)] = 1
            H[s, h(i, j - 1)] = 1
            H[s, v(i, j)] = 1
            H[s, v(i - 1, j)] = 1
    return H


def toric_code_z(d: int) -> np.ndarray:
    """Z-stabilizer (plaquette) parity-check matrix of the d x d toric code."""
    h, v = _edge_index(d)
    H = np.zeros((d * d, 2 * d * d), dtype=np.uint8)
    for i in range(d):
        for j in range(d):
            s = i * d + j
            H[s, h(i, j)] = 1
            H[s, h(i + 1, j)] = 1
            H[s, v(i, j)] = 1
            H[s, v(i, j + 1)] = 1
    return H


def surface_code_x(d: int) -> np.ndarray:
    """X-stabilizer parity checks of the distance-d (rotated) surface code.

    d^2 data qubits on a d x d grid; (d^2-1)/2 X-stabilizers on alternating
    faces (weight 4 in the bulk, weight 2 on the boundary).
    """
    if d % 2 == 0:
        raise ValueError("rotated surface code requires odd distance")
    rows = []
    q = lambda r, c: r * d + c
    # bulk faces: (r, c) face between data rows r,r+1 and cols c,c+1.
    for r in range(d - 1):
        for c in range(d - 1):
            if (r + c) % 2 == 0:  # X faces on even-parity plaquettes
                row = np.zeros(d * d, dtype=np.uint8)
                for rr, cc in ((r, c), (r, c + 1), (r + 1, c), (r + 1, c + 1)):
                    row[q(rr, cc)] = 1
                rows.append(row)
    # boundary (weight-2) X checks: top and bottom edges
    for c in range(d - 1):
        if (0 + c) % 2 == 1:  # top boundary
            row = np.zeros(d * d, dtype=np.uint8)
            row[q(0, c)] = 1
            row[q(0, c + 1)] = 1
            rows.append(row)
        if ((d - 2) + c) % 2 == 1:  # bottom boundary
            row = np.zeros(d * d, dtype=np.uint8)
            row[q(d - 1, c)] = 1
            row[q(d - 1, c + 1)] = 1
            rows.append(row)
    return np.stack(rows, axis=0)


def surface_code_z(d: int) -> np.ndarray:
    """Z-stabilizer parity checks of the distance-d rotated surface code."""
    if d % 2 == 0:
        raise ValueError("rotated surface code requires odd distance")
    rows = []
    q = lambda r, c: r * d + c
    for r in range(d - 1):
        for c in range(d - 1):
            if (r + c) % 2 == 1:  # Z faces on odd-parity plaquettes
                row = np.zeros(d * d, dtype=np.uint8)
                for rr, cc in ((r, c), (r, c + 1), (r + 1, c), (r + 1, c + 1)):
                    row[q(rr, cc)] = 1
                rows.append(row)
    for r in range(d - 1):
        if (r + 0) % 2 == 0:  # left boundary
            row = np.zeros(d * d, dtype=np.uint8)
            row[q(r, 0)] = 1
            row[q(r + 1, 0)] = 1
            rows.append(row)
        if (r + (d - 2)) % 2 == 0:  # right boundary
            row = np.zeros(d * d, dtype=np.uint8)
            row[q(r, d - 1)] = 1
            row[q(r + 1, d - 1)] = 1
            rows.append(row)
    return np.stack(rows, axis=0)


def repetition_code(n: int) -> np.ndarray:
    """Parity-check matrix of the length-n repetition code (n-1 checks)."""
    H = np.zeros((n - 1, n), dtype=np.uint8)
    for i in range(n - 1):
        H[i, i] = 1
        H[i, i + 1] = 1
    return H


def cycle_matrix(n: int) -> np.ndarray:
    """n x n circulant with ones on the diagonal and superdiagonal (wrap).

    The known-trapping-set adversarial matrix used by the reference BP-OTS
    tests (the Julia package's test_bpots.jl:14-25).
    """
    H = np.zeros((n, n), dtype=np.uint8)
    for j in range(n):
        H[j, j] = 1
        H[j, (j + 1) % n] = 1
    return H


def hypergraph_product(H1: np.ndarray, H2: np.ndarray):
    """Hypergraph-product CSS code of two classical parity-check matrices
    (Tillich & Zemor 2009) — the standard quantum-LDPC construction.

    Given H1 [m1, n1] and H2 [m2, n2], the product code has
    ``n1*n2 + m1*m2`` qubits with stabilizers::

        Hx = [ H1 (x) I_n2  |  I_m1 (x) H2^T ]
        Hz = [ I_n1 (x) H2  |  H1^T (x) I_m2 ]

    Returns ``(Hx, Hz)`` uint8 satisfying ``Hx @ Hz^T == 0 (mod 2)``.
    The toric code is the special case H1 = H2 = circulant repetition.
    """
    H1 = np.asarray(H1, dtype=np.uint8)
    H2 = np.asarray(H2, dtype=np.uint8)
    m1, n1 = H1.shape
    m2, n2 = H2.shape
    Hx = np.concatenate(
        [np.kron(H1, np.eye(n2, dtype=np.uint8)), np.kron(np.eye(m1, dtype=np.uint8), H2.T)],
        axis=1,
    )
    Hz = np.concatenate(
        [np.kron(np.eye(n1, dtype=np.uint8), H2), np.kron(H1.T, np.eye(m2, dtype=np.uint8))],
        axis=1,
    )
    return Hx, Hz


def hypergraph_product_edges(H1, H2):
    """Sparse hypergraph product: COO edge lists, never densified.

    Same construction as :func:`hypergraph_product` but emitted directly
    as edge lists, so million-qubit product codes build in milliseconds
    (the dense kron form needs terabytes at that scale).  Inputs are
    dense 0/1 matrices or ``(rows, cols, m, n)`` COO tuples.

    Returns ``(hx, hz)`` where each is a ``(rows, cols, m, n)`` tuple
    ready for :meth:`TannerGraph.from_edges`.

    Block structure (qubit columns: ``n1*n2`` 'vertical' then ``m1*m2``
    'horizontal'):

        Hx = [ H1 (x) I_n2  |  I_m1 (x) H2^T ]   rows: m1*n2
        Hz = [ I_n1 (x) H2  |  H1^T (x) I_m2 ]   rows: n1*m2
    """

    def as_coo(H):
        if isinstance(H, tuple):
            r, c, m, n = H
            return np.asarray(r, np.int64), np.asarray(c, np.int64), int(m), int(n)
        H = np.asarray(H)
        r, c = np.nonzero(H)
        return r.astype(np.int64), c.astype(np.int64), H.shape[0], H.shape[1]

    r1, c1, m1, n1 = as_coo(H1)
    r2, c2, m2, n2 = as_coo(H2)
    nq = n1 * n2 + m1 * m2

    def kron_edges(ra, ca, reps, row_mul, col_mul):
        """Edges of A (x) I_reps: (a,b) -> (a*row_mul + k, b*col_mul + k)."""
        k = np.arange(reps, dtype=np.int64)
        rows = (ra[:, None] * row_mul + k).reshape(-1)
        cols = (ca[:, None] * col_mul + k).reshape(-1)
        return rows, cols

    def eye_kron_edges(ra, ca, reps, row_mul, col_mul):
        """Edges of I_reps (x) A: (a,b) -> (k*row_mul + a, k*col_mul + b)."""
        k = np.arange(reps, dtype=np.int64)
        rows = (k[:, None] * row_mul + ra).reshape(-1)
        cols = (k[:, None] * col_mul + ca).reshape(-1)
        return rows, cols

    # Hx = [H1 (x) I_n2 | I_m1 (x) H2^T], shape [m1*n2, nq]
    xr1, xc1 = kron_edges(r1, c1, n2, n2, n2)
    xr2, xc2 = eye_kron_edges(c2, r2, m1, n2, m2)  # H2^T edges are (c2, r2)
    hx = (
        np.concatenate([xr1, xr2]),
        np.concatenate([xc1, n1 * n2 + xc2]),
        m1 * n2,
        nq,
    )

    # Hz = [I_n1 (x) H2 | H1^T (x) I_m2], shape [n1*m2, nq]
    zr1, zc1 = eye_kron_edges(r2, c2, n1, m2, n2)
    zr2, zc2 = kron_edges(c1, r1, m2, m2, m2)  # H1^T edges are (c1, r1)
    hz = (
        np.concatenate([zr1, zr2]),
        np.concatenate([zc1, n1 * n2 + zc2]),
        n1 * m2,
        nq,
    )
    return hx, hz


def hamming_code(r: int = 3) -> np.ndarray:
    """Parity-check matrix of the [2^r - 1, 2^r - r - 1] Hamming code."""
    n = 2**r - 1
    H = np.zeros((r, n), dtype=np.uint8)
    for j in range(1, n + 1):
        for i in range(r):
            H[i, j - 1] = (j >> i) & 1
    return H
