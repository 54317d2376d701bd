"""Whole-decode min-sum / sum-product for group-circulant codes: the host
side and the plain torch version.

Counterpart of ``ldpcdecoders_tpu/ops/pallas_qc.py``.  A group-circulant
code over ``Z_l x Z_m`` (``Z = l*m``) is a list of edge terms
``(i, j, a, b)``: the monomial ``x^a y^b`` in block ``(i, j)`` connects
lifted check ``i*Z + w`` with ``(u, v) = divmod(w, m)`` to lifted variable
``j*Z + sigma(w)``, ``sigma(w) = ((u+a)%l)*m + (v+b)%m`` (codes/qc.py).
Plain quasi-cyclic codes are the ``m == 1`` case; bivariate bicycle codes
(codes/bicycle.py) use the full 2-D form.  With messages laid out
``[base edge, lane, Z]`` every check<->variable move is such a shift, so
the whole decode (every sweep, the syndrome check, the per-lane freeze)
needs no message outside on-chip memory: ops/cuda_qc.py does that in one
kernel launch.

This module holds what that kernel and its tests share:

  * :func:`qc_term_adjacency` and :class:`QCTerms`: the sorted term list,
    its per-block-row and per-block-column edge lists, and the int32 table
    the kernel reads;
  * :func:`qc_smem_bytes` / :func:`qc_launch_shape`: the kernel's
    shared-memory footprint and its block size;
  * :func:`qc_minsum_ref`: the plain torch version, the same arithmetic in
    the same order as the reference kernel body.  It runs on the CPU, and
    on a card only to be compared with the kernel.

Semantics: normalized/offset min-sum (two-min exclusive reduction, finite
1e30 sentinel) or exact sum-product (tanh rule with the clamps of
ops/clamps.py); ``flooding`` or serial-C ``layered`` schedule over base
rows; float32 or bfloat16 message *storage* with float32 arithmetic; a
baked scalar prior or per-bit priors; ``err`` / ``llr`` frozen per lane at
the sweep where the lane's syndrome is first met.  The variable update adds
in sorted-term order, not in ascending lifted check index, so multi-term
blocks can differ from the lifted-graph decoders in the last place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .clamps import MSG_CLAMP, TANH_CLAMP
from .minsum import BIG  # finite, so that a weight-1 row's message keeps the totals finite

__all__ = [
    "QCTerms",
    "qc_term_adjacency",
    "qc_smem_bytes",
    "qc_launch_shape",
    "qc_flooding_state",
    "qc_minsum_ref",
    "qc_modes",
    "SMEM_LIMIT",
    "HELD_EDGES",
    "SIGN_BITS",
]

#: dynamic shared memory one block can be given on an H100 (227 KB)
SMEM_LIMIT = 232_448
#: most threads of one block
MAX_THREADS = 1024
#: most threads of a flooding block that runs its base rows in groups
FLOOD_THREADS = 512
#: edges of a base row whose positions and values the kernel keeps in
#: registers (csrc/qc_minsum.cu kHeld); sum-product keeps the suffix
#: products of a heavier row's later edges in shared memory
HELD_EDGES = 8
#: sign bits of the flooding two-min state's word (csrc/qc_minsum.cu
#: kSignBits; idx1 takes the word's other 5 bits): min-sum rows of at most
#: this many edges keep two-min states, heavier ones their messages
SIGN_BITS = 27


def qc_term_adjacency(terms, mb: int, nb: int):
    """Static per-block-row / per-block-column edge lists.

    ``terms`` is an iterable of ``(i, j, a, b)``; returns
    ``(edges, row_edges, col_edges)`` where ``edges`` is the sorted term
    list (block-row-major, ascending block column then shift: the order
    codes/qc.py::qc_group_lift_edges emits) and ``row_edges[i]`` /
    ``col_edges[j]`` hold indices into it.
    """
    edges = sorted((int(i), int(j), int(a), int(b)) for i, j, a, b in terms)
    if len(set(edges)) != len(edges):
        raise ValueError("duplicate edge terms (cancel over GF(2))")
    row_edges = [[] for _ in range(mb)]
    col_edges = [[] for _ in range(nb)]
    for e, (i, j, _, _) in enumerate(edges):
        row_edges[i].append(e)
        col_edges[j].append(e)
    for i, r in enumerate(row_edges):
        if not r:
            raise ValueError(f"base row {i} has no edges")
    for j, c in enumerate(col_edges):
        if not c:
            raise ValueError(f"base column {j} has no edges")
    return edges, row_edges, col_edges


@dataclasses.dataclass(frozen=True)
class QCTerms:
    """A group-circulant code as the decode functions take it."""

    edges: tuple  # sorted (i, j, a, b)
    row_edges: tuple  # per block row: edge indices, a contiguous range
    col_edges: tuple  # per block column: edge indices, ascending
    mb: int
    nb: int
    l: int
    m: int

    @classmethod
    def build(cls, terms, mb: int, nb: int, group) -> "QCTerms":
        gl, gm = (int(x) for x in group)
        if gl < 1 or gm < 1:
            raise ValueError(f"group sizes must be >= 1, got {group}")
        edges, row_edges, col_edges = qc_term_adjacency(terms, mb, nb)
        for i, j, a, b in edges:
            if not (0 <= i < mb and 0 <= j < nb and 0 <= a < gl and 0 <= b < gm):
                raise ValueError(f"term {(i, j, a, b)} outside [{mb}, {nb}] x Z_{gl} x Z_{gm}")
        return cls(tuple(edges), tuple(map(tuple, row_edges)), tuple(map(tuple, col_edges)),
                   int(mb), int(nb), gl, gm)

    @property
    def Z(self) -> int:
        return self.l * self.m

    @property
    def Eb(self) -> int:
        return len(self.edges)

    @property
    def max_row_weight(self) -> int:
        return max(len(r) for r in self.row_edges)

    @property
    def two_phase_rows(self) -> tuple:
        """Per base row: whether two of its terms share a block column.  The
        kernel's layered sweep updates such a row in two phases through a
        row buffer in shared memory, any other row in one (it works the
        same flags out of the table)."""
        return tuple(len({self.edges[e][1] for e in r}) < len(r) for r in self.row_edges)

    @property
    def buffered_row_weight(self) -> int:
        """The row buffer's rows: the largest weight of a two-phase row, 0
        when there is none."""
        return max((len(r) for r, two in zip(self.row_edges, self.two_phase_rows) if two),
                   default=0)

    def table(self) -> np.ndarray:
        """The int32 table the kernel reads: per edge its block column and
        its two shifts (``Eb`` each), the row pointer (``mb+1``: a row's
        edges are contiguous in sorted order), the column pointer
        (``nb+1``) and the column edge list (``Eb``)."""
        j, a, b = (np.array([t[k] for t in self.edges], np.int32) for k in (1, 2, 3))
        row_ptr = np.cumsum([0] + [len(r) for r in self.row_edges])
        col_ptr = np.cumsum([0] + [len(c) for c in self.col_edges])
        col_idx = np.array([e for c in self.col_edges for e in c])
        return np.concatenate([j, a, b, row_ptr, col_ptr, col_idx]).astype(np.int32)


def qc_flooding_state(terms: QCTerms, sumproduct: bool) -> str:
    """How the kernel's flooding sweep keeps the check-to-variable messages:
    ``"two_min"`` (min-sum rows of at most :data:`SIGN_BITS` edges: per check
    position the two outgoing magnitudes and a word of signs and idx1, from
    which each edge's message is rebuilt bit for bit) or ``"messages"``
    (sum-product, or a heavier row: every edge's message)."""
    two_min = not sumproduct and terms.max_row_weight <= SIGN_BITS
    return "two_min" if two_min else "messages"


def qc_smem_bytes(terms: QCTerms, threads: int, itemsize: int, layered: bool,
                  sumproduct: bool, prior: bool = False) -> int:
    """Dynamic shared memory (bytes) of one block of the kernel, which holds
    one lane on ``threads`` threads; for sum-product one float32 per thread
    and row slot past :data:`HELD_EDGES` (the suffix products of a heavy
    row) in either schedule.

    Layered: the term table in the kernel's form (four words per edge, the
    row and column pointers, the column edge list, a flag per base row), the
    edge messages and the block columns' totals in the storage type, the
    syndrome bytes, and the new messages of one two-phase row in float32
    (none when every row is one-phase).

    Flooding: two tables of four words per edge (row order; column order
    with the inverse shifts), the row and column pointers, the float32
    totals (and with ``prior`` the lane's float32 prior), the messages as
    :func:`qc_flooding_state` keeps them (two-min: two magnitudes in the
    storage type and a 32-bit word per check position; else every edge's
    message in the storage type) and the syndrome bytes.
    """
    Eb, mb, nb, Z, rw = terms.Eb, terms.mb, terms.nb, terms.Z, terms.max_row_weight
    tail = max(rw - HELD_EDGES, 0) * threads if sumproduct else 0
    if layered:
        ints = 5 * Eb + 2 * mb + nb + 4
        floats = terms.buffered_row_weight * Z + tail
        return 4 * ints + 4 * floats + itemsize * (Eb + nb) * Z + mb * Z
    ints = 8 * Eb + mb + nb + 2
    floats = nb * Z * (2 if prior else 1) + tail
    two_min = qc_flooding_state(terms, sumproduct) == "two_min"
    state = (2 * itemsize + 4) * mb * Z if two_min else itemsize * Eb * Z
    return 4 * ints + 4 * floats + state + mb * Z


def qc_launch_shape(terms: QCTerms, itemsize: int, layered: bool, sumproduct: bool,
                    prior: bool = False):
    """``(threads per block, shared-memory bytes)`` of the kernel's launch:
    one lane per block.  Layered: ``min(Z, 1024)`` threads (the launcher
    takes fewer where the kernel's registers do not allow that many, and
    strides the positions over them).  Flooding: ``G`` groups of ``Z``
    threads, each group on its share of the base rows and block columns,
    with ``G`` the most that keeps the block at :data:`FLOOD_THREADS`
    threads and within the base graph's rows or columns (1 past
    ``FLOOD_THREADS // 2`` positions); with a ``prior``, the room to keep
    it on chip where that fits.  Raises when the lane does not fit a
    block's shared memory.
    """
    groups = 1 if layered else max(1, min(FLOOD_THREADS // terms.Z, max(terms.mb, terms.nb)))
    while True:  # sum-product slots grow with the threads
        threads = min(terms.Z * groups, MAX_THREADS)
        need = qc_smem_bytes(terms, threads, itemsize, layered, sumproduct)
        if groups == 1 or need <= SMEM_LIMIT:
            break
        groups -= 1
    if need > SMEM_LIMIT:
        raise ValueError(
            f"one lane needs {need} B of shared memory, over the {SMEM_LIMIT} B a block can "
            f"have (Eb={terms.Eb}, nb={terms.nb}, Z={terms.Z}, "
            f"{'layered' if layered else 'flooding'}, {itemsize} B messages): "
            "use dtype=torch.bfloat16, the layered schedule, or backend='lifted' "
            "(messages in device memory) for codes this large")
    if prior and not layered:
        with_prior = qc_smem_bytes(terms, threads, itemsize, False, sumproduct, prior=True)
        if with_prior <= SMEM_LIMIT:
            need = with_prior
    return threads, need


def qc_minsum_ref(syndromes, terms: QCTerms, L0: float, max_iters: int, *, alpha: float = 1.0,
                  beta: float = 0.0, schedule: str = "flooding", algorithm: str = "minsum",
                  dtype=torch.float32, priors=None):
    """Plain torch version of the whole decode.

    ``syndromes [B, mb*Z]`` (nonzero = violated check), ``priors`` None
    (the scalar ``L0`` everywhere) or float32 LLRs ``[nb*Z]`` / ``[B,
    nb*Z]``.  Returns ``(err int8 [B, nb*Z], converged bool [B], iters
    int32 [B], llrs float32 [B, nb*Z])``.

    Every step works on ``[B, Z]`` tensors per base edge or block column,
    in the order of the reference kernel body; values are rounded to
    ``dtype`` exactly where that body writes its message scratch, and all
    arithmetic is float32.  The loop stops once every lane has met its
    syndrome: outputs are frozen per lane, so lanes that would go on
    sweeping beside an unfinished one change nothing.
    """
    layered, sumprod = qc_modes(schedule, algorithm, dtype)
    gl, gm, Z, mb, nb, Eb = terms.l, terms.m, terms.Z, terms.mb, terms.nb, terms.Eb
    edges, row_edges, col_edges = terms.edges, terms.row_edges, terms.col_edges
    B, device = syndromes.shape[0], syndromes.device
    f32 = torch.float32
    if priors is not None:
        priors = torch.broadcast_to(priors.to(f32), (B, nb * Z))
    const_p = torch.full((B, Z), float(L0), dtype=f32, device=device)

    def p32(j):
        return const_p if priors is None else priors[:, j * Z:(j + 1) * Z]

    lane_v = torch.arange(Z, device=device) % gm

    def apply_shift(x, a, b):
        """out[w] = x[sigma(w)] for the monomial (a, b): one roll for
        ``b == 0``, else a select between two rolls on ``v < m - b``."""
        c1 = (a * gm + b) % Z
        if b == 0:
            return torch.roll(x, -c1, dims=-1) if c1 else x
        c2 = (a * gm + b - gm) % Z
        return torch.where(lane_v < gm - b, torch.roll(x, -c1, dims=-1),
                           torch.roll(x, -c2, dims=-1))

    def inv(a, b):
        return (gl - a) % gl, (gm - b) % gm

    def sumproduct_mu(ncs, syn_i):
        k = len(ncs)
        ts = [torch.clamp(torch.tanh(nc * 0.5), -TANH_CLAMP, TANH_CLAMP) for nc in ncs]
        one = torch.ones((B, Z), dtype=f32, device=device)
        fwd = [one]
        for i in range(k - 1):
            fwd.append(fwd[-1] * ts[i])
        bwd = [one]
        for i in range(k - 1, 0, -1):
            bwd.append(bwd[-1] * ts[i])
        bwd.reverse()
        outs = []
        for i in range(k):
            excl = torch.clamp(fwd[i] * bwd[i], -TANH_CLAMP, TANH_CLAMP)
            mu = torch.log1p(excl) - torch.log1p(-excl)  # = 2 atanh(excl)
            mu = torch.clamp(mu, -MSG_CLAMP, MSG_CLAMP)
            outs.append(torch.where(syn_i, -mu, mu))
        return outs

    def two_min_mu(ncs, syn_i):
        mags = [nc.abs() for nc in ncs]
        negs = [nc < 0.0 for nc in ncs]
        min1 = mags[0]
        idx1 = torch.zeros((B, Z), dtype=torch.int32, device=device)
        min2 = torch.full((B, Z), BIG, dtype=f32, device=device)
        parity = negs[0]
        for k in range(1, len(ncs)):
            v = mags[k]
            smaller = v < min1
            min2 = torch.where(smaller, min1, torch.minimum(min2, v))
            idx1 = torch.where(smaller, k, idx1)
            min1 = torch.where(smaller, v, min1)
            parity = parity ^ negs[k]
        outs = []
        for k in range(len(ncs)):
            excl = torch.where(idx1 == k, min2, min1)
            flip = parity ^ negs[k] ^ syn_i
            mag_out = torch.clamp_min(alpha * excl - beta, 0.0)
            outs.append(torch.where(flip, -mag_out, mag_out))
        return outs

    check_mu = sumproduct_mu if sumprod else two_min_mu

    # iteration-0 state: flooding seeds the variable-to-check messages with
    # the prior, layered zero check-to-variable messages and prior totals
    zeros = torch.zeros((B, Z), dtype=dtype, device=device)
    if layered:
        mu = [zeros for _ in range(Eb)]
        tot = [p32(j).to(dtype) for j in range(nb)]
    else:
        nu = [p32(edges[e][1]).to(dtype) for e in range(Eb)]
        mu = [zeros for _ in range(Eb)]
    err = [torch.zeros((B, Z), dtype=torch.bool, device=device) for _ in range(nb)]
    llr = [p32(j) for j in range(nb)]
    syn_b = [syndromes[:, i * Z:(i + 1) * Z] != 0 for i in range(mb)]

    done = torch.zeros((B,), dtype=torch.bool, device=device)
    iters = torch.zeros((B,), dtype=torch.int32, device=device)
    it = 0
    while it < max_iters and not bool(done.all()):
        active = ~done[:, None]
        if layered:
            # serial-C: each base row reads totals already updated by the
            # rows before it; within a row all reads precede all updates
            for i in range(mb):
                row = row_edges[i]
                ncs, olds = [], []
                for e in row:
                    _, j, a, b = edges[e]
                    old = mu[e].to(f32)
                    olds.append(old)
                    ncs.append(apply_shift(tot[j].to(f32) - old, a, b))
                outs = check_mu(ncs, syn_b[i])
                for k, e in enumerate(row):
                    _, j, a, b = edges[e]
                    mu_new = apply_shift(outs[k], *inv(a, b))
                    tot[j] = (tot[j].to(f32) + (mu_new - olds[k])).to(dtype)
                    mu[e] = mu_new.to(dtype)
            totals = [t.to(f32) for t in tot]
        else:
            for i in range(mb):
                row = row_edges[i]
                ncs = [apply_shift(nu[e].to(f32), *edges[e][2:]) for e in row]
                outs = check_mu(ncs, syn_b[i])
                for k, e in enumerate(row):
                    mu[e] = apply_shift(outs[k], *inv(*edges[e][2:])).to(dtype)
            totals = []
            for j in range(nb):
                total = p32(j)
                mus = [mu[e].to(f32) for e in col_edges[j]]
                for x in mus:
                    total = total + x
                for e, x in zip(col_edges[j], mus):
                    nu[e] = (total - x).to(dtype)
                totals.append(total)
        for j in range(nb):
            err[j] = torch.where(active, totals[j] < 0.0, err[j])
            llr[j] = torch.where(active, totals[j], llr[j])

        # syndrome check: check-oriented XOR of the frozen decisions
        ok = torch.ones((B,), dtype=torch.bool, device=device)
        for i in range(mb):
            par = torch.zeros((B, Z), dtype=torch.bool, device=device)
            for e in row_edges[i]:
                _, j, a, b = edges[e]
                par = par ^ apply_shift(err[j], a, b)
            ok = ok & (par == syn_b[i]).all(dim=1)
        iters = torch.where(ok & ~done, it + 1, iters)
        done = done | ok
        it += 1
    iters = torch.where(done, iters, it).to(torch.int32)
    err = torch.stack(err, dim=1).reshape(B, nb * Z).to(torch.int8)
    llrs = torch.stack(llr, dim=1).reshape(B, nb * Z).contiguous()
    return err, done, iters, llrs


def qc_modes(schedule, algorithm, dtype):
    """Validate the three mode arguments; returns ``(layered, sumproduct)``."""
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r} (want 'flooding' or 'layered')")
    if algorithm not in ("minsum", "sumproduct"):
        raise ValueError(f"unknown algorithm {algorithm!r} (want 'minsum' or 'sumproduct')")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    return schedule == "layered", algorithm == "sumproduct"
