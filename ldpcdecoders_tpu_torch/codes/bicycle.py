"""Bivariate bicycle (BB) quantum LDPC codes.

Counterpart of ``ldpcdecoders_tpu/codes/bicycle.py`` (numpy only, the same
arrays).  The bivariate bicycle family (Bravyi et al., "High-threshold and
low-overhead fault-tolerant quantum memory", Nature 627, 778 (2024)) is the
quasi-abelian cousin of the quasi-cyclic classical codes in codes/qc.py:
every block of Hx/Hz is a sum of commuting 2-D circulant monomials, so the
codes keep the regular, static-shift structure that the whole-decode kernel
wants while offering far better encoding rates than surface codes.

Construction
------------
Over the group ``Z_l x Z_m`` let ``x`` shift the first coordinate and
``y`` the second.  A term ``(a, b)`` denotes the monomial ``x^a y^b``,
the ``lm x lm`` permutation matrix mapping group element ``(u, v)`` to
``(u+a mod l, v+b mod m)``.  Given polynomials ``A`` and ``B`` (mod-2
sums of terms),

    Hx = [A | B]          (lm checks, n = 2*lm qubits)
    Hz = [B^T | A^T]

The CSS condition ``Hx @ Hz^T = A B + B A = 0 (mod 2)`` holds for every
choice of A, B because the group algebra is commutative.  The logical
count is ``k = n - rank(Hx) - rank(Hz) = 2 * dim(ker A n ker B)``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "bb_poly_matrix",
    "bivariate_bicycle_code",
    "css_code_k",
    "named_bicycle_code",
    "BICYCLE_CODES",
]


def _monomial_cols(l: int, m: int, a: int, b: int) -> np.ndarray:
    """Column index of the single 1 in each row of the monomial x^a y^b."""
    u, v = np.divmod(np.arange(l * m), m)
    return ((u + a) % l) * m + (v + b) % m


def bb_poly_matrix(l: int, m: int, terms) -> np.ndarray:
    """Mod-2 sum of monomial permutation matrices over ``Z_l x Z_m``.

    ``terms`` is an iterable of ``(a, b)`` exponent pairs (x^a y^b);
    repeated terms cancel (GF(2)).

    Example:
      >>> bb_poly_matrix(2, 1, [(0, 0), (1, 0)])
      array([[1, 1],
             [1, 1]], dtype=uint8)
    """
    if l < 1 or m < 1:
        raise ValueError(f"group sizes must be >= 1, got l={l}, m={m}")
    M = np.zeros((l * m, l * m), np.uint8)
    rows = np.arange(l * m)
    for a, b in terms:
        M[rows, _monomial_cols(l, m, int(a), int(b))] ^= 1
    return M


def bivariate_bicycle_code(l: int, m: int, a_terms, b_terms):
    """Build the BB code's ``(Hx, Hz)`` stabilizer blocks.

    Args:
      l, m: cyclic group sizes (n = 2*l*m data qubits).
      a_terms, b_terms: the A and B polynomials as lists of ``(a, b)``
        exponent pairs meaning ``x^a y^b``.

    Returns ``(Hx, Hz)`` uint8 arrays of shape ``[l*m, 2*l*m]``; the
    CSS condition holds by construction (commutative group algebra).
    """
    A = bb_poly_matrix(l, m, a_terms)
    B = bb_poly_matrix(l, m, b_terms)
    Hx = np.concatenate([A, B], axis=1)
    Hz = np.concatenate([B.T, A.T], axis=1)
    return Hx, Hz


def css_code_k(Hx, Hz) -> int:
    """Logical-qubit count ``k = n - rank(Hx) - rank(Hz)`` over GF(2)."""
    from ..utils.metrics import gf2_kernel_basis

    Hx = np.asarray(Hx)
    Hz = np.asarray(Hz)
    n = Hx.shape[1]
    rank_x = n - gf2_kernel_basis(Hx).shape[0]
    rank_z = n - gf2_kernel_basis(Hz).shape[0]
    return int(n - rank_x - rank_z)


#: Named instances from Bravyi et al. (2024), Table 3.  ``d`` is the
#: reported distance (not re-verified here); ``k`` is verified by rank
#: in tests/test_torch_qc.py.
BICYCLE_CODES = {
    "bb72": dict(l=6, m=6,
                 a_terms=[(3, 0), (0, 1), (0, 2)],   # x^3 + y + y^2
                 b_terms=[(0, 3), (1, 0), (2, 0)],   # y^3 + x + x^2
                 n=72, k=12, d=6),
    "bb90": dict(l=15, m=3,
                 a_terms=[(9, 0), (0, 1), (0, 2)],   # x^9 + y + y^2
                 b_terms=[(0, 0), (2, 0), (7, 0)],   # 1 + x^2 + x^7
                 n=90, k=8, d=10),
    "bb108": dict(l=9, m=6,
                  a_terms=[(3, 0), (0, 1), (0, 2)],
                  b_terms=[(0, 3), (1, 0), (2, 0)],
                  n=108, k=8, d=10),
    # the "gross" code
    "bb144": dict(l=12, m=6,
                  a_terms=[(3, 0), (0, 1), (0, 2)],
                  b_terms=[(0, 3), (1, 0), (2, 0)],
                  n=144, k=12, d=12),
    "bb288": dict(l=12, m=12,
                  a_terms=[(3, 0), (0, 2), (0, 7)],  # x^3 + y^2 + y^7
                  b_terms=[(0, 3), (1, 0), (2, 0)],
                  n=288, k=12, d=18),
}


def named_bicycle_code(name: str):
    """Build a published BB code by name.

    Returns ``(Hx, Hz, info)`` where ``info`` is the registry entry
    (l, m, polynomial terms, n/k and the reported d).

    Example:
      >>> Hx, Hz, info = named_bicycle_code("bb72")
      >>> Hx.shape, info["k"]
      ((36, 72), 12)
    """
    if name not in BICYCLE_CODES:
        raise ValueError(f"unknown BB code '{name}' (choose from {sorted(BICYCLE_CODES)})")
    info = BICYCLE_CODES[name]
    Hx, Hz = bivariate_bicycle_code(
        info["l"], info["m"], info["a_terms"], info["b_terms"]
    )
    return Hx, Hz, dict(info)
