"""Tanner-graph compiler: 0/1 matrix -> fixed-shape padded edge lists.

Counterpart of ``ldpcdecoders_tpu/codes/graph.py`` (numpy only).  Decoders
work on two edge-message layouts:

  * check-major ``[..., m, max_dc]`` — slot k of row i is the k-th variable
    neighbour of check i (ascending variable index);
  * var-major   ``[..., n, max_dv]`` — slot k of row j is the k-th check
    neighbour of variable j (ascending check index).

Static gather permutations connect the two, so device code is fixed-shape
gathers.  Graphs are compiled by the vectorized :meth:`TannerGraph.from_edges`
or, for a large dense matrix, by the native C++ compiler (``native/``), as
the reference's ``from_pcm`` routes them; both produce the same arrays as
the reference package's per-entry loop and native compiler.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TannerGraph"]

# a dense H is attached to sparse input only up to this many entries: OSD
# needs it, and codes past this size are decoded without densifying
_DENSE_ATTACH_MAX_ELEMS = 4_000_000


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class TannerGraph:
    """Static, padded adjacency of a parity-check matrix H (m checks, n vars).

    Attributes:
      H: ``[m, n]`` uint8 dense parity-check matrix, or None for graphs
        compiled from a sparse edge list.
      chk_vars: ``[m, max_dc]`` int32 — variable index of each check's k-th
        neighbour (pad: 0).
      chk_mask: ``[m, max_dc]`` bool — True where the slot is a real edge.
      var_chks: ``[n, max_dv]`` int32 — check index of each variable's k-th
        neighbour (pad: 0).
      var_mask: ``[n, max_dv]`` bool.
      c2v_gather: ``[m, max_dc]`` int32 — flat index into a var-major edge
        array ``[n*max_dv]`` holding the same edge (pad: 0).
      v2c_gather: ``[n, max_dv]`` int32 — flat index into a check-major edge
        array ``[m*max_dc]`` holding the same edge (pad: 0).
    """

    m: int
    n: int
    max_dc: int
    max_dv: int
    n_edges: int
    H: np.ndarray | None
    chk_vars: np.ndarray
    chk_mask: np.ndarray
    var_chks: np.ndarray
    var_mask: np.ndarray
    c2v_gather: np.ndarray
    v2c_gather: np.ndarray

    def require_H(self) -> np.ndarray:
        if self.H is None:
            raise ValueError(
                "this operation needs the dense parity-check matrix, but the "
                "graph was compiled from a sparse edge list (from_edges)"
            )
        return self.H

    def slot_major(self):
        """Gather indices + masks for the slot-major ``[B, slot, node]`` layout.

        Returns ``(c2v_t, v2c_t, chk_mask_t, var_mask_t)`` where
        ``c2v_t [max_dc * m]`` indexes a flattened ``[max_dv * n]``
        var-major slot-major array, and vice versa; masks are
        ``[max_dc, m]`` / ``[max_dv, n]``.
        """
        m, n = self.m, self.n
        c2v_t = ((self.c2v_gather % self.max_dv) * n + (self.c2v_gather // self.max_dv)).T
        v2c_t = ((self.v2c_gather % self.max_dc) * m + (self.v2c_gather // self.max_dc)).T
        return (
            np.ascontiguousarray(c2v_t.reshape(-1)),
            np.ascontiguousarray(v2c_t.reshape(-1)),
            np.ascontiguousarray(self.chk_mask.T),
            np.ascontiguousarray(self.var_mask.T),
        )

    @staticmethod
    def from_arrays(
        m, n, max_dc, max_dv, n_edges, H, chk_vars, chk_mask, var_chks,
        var_mask, c2v_gather, v2c_gather,
    ) -> "TannerGraph":
        """Rebuild a graph from its fields, e.g. ``dataclasses.asdict`` of a
        graph compiled by the reference package."""
        return TannerGraph(
            m=int(m),
            n=int(n),
            max_dc=int(max_dc),
            max_dv=int(max_dv),
            n_edges=int(n_edges),
            H=None if H is None else np.ascontiguousarray(H, dtype=np.uint8),
            chk_vars=np.asarray(chk_vars, dtype=np.int32),
            chk_mask=np.asarray(chk_mask, dtype=bool),
            var_chks=np.asarray(var_chks, dtype=np.int32),
            var_mask=np.asarray(var_mask, dtype=bool),
            c2v_gather=np.asarray(c2v_gather, dtype=np.int32),
            v2c_gather=np.asarray(v2c_gather, dtype=np.int32),
        )

    @staticmethod
    def from_edges(
        rows, cols, m: int, n: int, *, degree_multiple: int = 1, H: np.ndarray | None = None
    ) -> "TannerGraph":
        """Compile a sparse COO edge list into padded edge-list form.

        Args:
          rows, cols: parallel int arrays of edge endpoints (check, var).
          m, n: matrix dimensions.
          degree_multiple: pad degrees to a multiple of this.
          H: optional dense matrix to attach (for OSD).
        """
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if rows.shape != cols.shape or rows.ndim != 1:
            raise ValueError("rows/cols must be parallel 1-D arrays")
        if rows.size and (rows.min() < 0 or rows.max() >= m or cols.min() < 0 or cols.max() >= n):
            raise ValueError("edge indices out of range")
        E = rows.size
        arange_E = np.arange(E, dtype=np.int64)

        def slot_starts(deg):
            # slot of each sorted edge within its node group: arange minus
            # the (repeated) group start offset
            return np.repeat(np.cumsum(deg) - deg, deg)

        chk_deg = np.bincount(rows, minlength=m)
        var_deg = np.bincount(cols, minlength=n)
        # one fused int64 sort key per layout; duplicate edges are adjacent
        # equal keys
        if E and m * n < 2**62:
            key_c = rows * n + cols
            order_c = np.argsort(key_c)  # check-major (i, then j)
            order_v = np.argsort(cols * m + rows)  # var-major (j, then i)
            dup = (np.diff(key_c[order_c]) == 0).any()
        else:
            order_c = np.lexsort((cols, rows))
            order_v = np.lexsort((rows, cols))
            rc, cc = rows[order_c], cols[order_c]
            dup = bool(
                E
                and (np.diff(np.stack([rc, cc]), axis=1) == 0).all(axis=0).any()
            )
        if dup:
            raise ValueError("duplicate edges in the edge list")
        slot_c_sorted = arange_E - slot_starts(chk_deg)
        slot_v_sorted = arange_E - slot_starts(var_deg)
        max_dc = _round_up(max(1, int(chk_deg.max(initial=1))), degree_multiple)
        max_dv = _round_up(max(1, int(var_deg.max(initial=1))), degree_multiple)

        # per-original-edge slots in each layout
        slot_c = np.empty(E, np.int64)
        slot_c[order_c] = slot_c_sorted
        slot_v = np.empty(E, np.int64)
        slot_v[order_v] = slot_v_sorted

        chk_vars = np.zeros((m, max_dc), np.int32)
        chk_mask = np.zeros((m, max_dc), bool)
        var_chks = np.zeros((n, max_dv), np.int32)
        var_mask = np.zeros((n, max_dv), bool)
        c2v_gather = np.zeros((m, max_dc), np.int32)
        v2c_gather = np.zeros((n, max_dv), np.int32)

        chk_vars[rows, slot_c] = cols
        chk_mask[rows, slot_c] = True
        var_chks[cols, slot_v] = rows
        var_mask[cols, slot_v] = True
        c2v_gather[rows, slot_c] = cols * max_dv + slot_v
        v2c_gather[cols, slot_v] = rows * max_dc + slot_c

        return TannerGraph(
            m=m,
            n=n,
            max_dc=max_dc,
            max_dv=max_dv,
            n_edges=int(E),
            H=H,
            chk_vars=chk_vars,
            chk_mask=chk_mask,
            var_chks=var_chks,
            var_mask=var_mask,
            c2v_gather=c2v_gather,
            v2c_gather=v2c_gather,
        )

    @staticmethod
    def from_pcm(H, *, degree_multiple: int = 1, use_native: bool | None = None) -> "TannerGraph":
        """Compile a dense or scipy-sparse 0/1 matrix into padded edge-list form.

        Args:
          H: ``[m, n]`` array-like of 0/1, or any scipy.sparse matrix
            (duck-typed through ``tocoo``).  Sparse inputs keep a dense H
            attached only when small enough for OSD.
          degree_multiple: round padded degrees up to a multiple of this.
          use_native: compile a dense H's tables with the native C++
            compiler (``native.compile_tanner_native``) or not; None (the
            default) takes it for more than 100,000 entries, as the
            reference does.  Where the native library cannot be built, numpy
            compiles them.  The graph is the same on every route.
        """
        if hasattr(H, "tocoo"):
            coo = H.tocoo().astype(np.int64)
            # duplicate COO entries sum; an entry != 0 is an edge
            coo.sum_duplicates()
            m_s, n_s = coo.shape
            keep = np.asarray(coo.data) != 0
            rows = np.asarray(coo.row)[keep]
            cols = np.asarray(coo.col)[keep]
            dense = None
            if m_s * n_s <= _DENSE_ATTACH_MAX_ELEMS:
                dense = np.zeros((m_s, n_s), np.uint8)
                dense[rows, cols] = 1
            return TannerGraph.from_edges(
                rows, cols, m_s, n_s, degree_multiple=degree_multiple, H=dense
            )
        H = np.asarray(H)
        if H.ndim != 2:
            raise ValueError("H must be 2-D")
        if H.dtype != np.uint8 or H.max(initial=0) > 1:
            H = (H != 0).astype(np.uint8)
        H = np.ascontiguousarray(H)
        m, n = H.shape
        if use_native is None:
            use_native = m * n > 100_000
        if use_native:
            from ..native import compile_tanner_native

            chk_deg = H.sum(axis=1, dtype=np.int64)
            max_dc = _round_up(max(1, int(chk_deg.max(initial=1))), degree_multiple)
            max_dv = _round_up(max(1, int(H.sum(axis=0, dtype=np.int64).max(initial=1))),
                               degree_multiple)
            out = compile_tanner_native(H, max_dc, max_dv)
            if out is not None:
                return TannerGraph.from_arrays(m, n, max_dc, max_dv, int(chk_deg.sum()), H, *out)
        rows, cols = np.nonzero(H)
        return TannerGraph.from_edges(
            rows, cols, H.shape[0], H.shape[1], degree_multiple=degree_multiple, H=H
        )
