"""Quasi-cyclic / group-circulant min-sum decoder: the whole-decode kernel path.

Counterpart of ``ldpcdecoders_tpu/models/qc_minsum.py``.
``QCMinSumDecoder`` decodes codes with circulant block structure.  Two
backends share one semantics (normalized/offset min-sum or sum-product,
per-lane early stop):

  * ``backend='cuda'``: the whole decode (every sweep, the syndrome check,
    the early exit) is ONE launch of the hand-written kernel with all
    messages in shared memory (ops/cuda_qc.py).  Cross-layout moves are
    index arithmetic on the circulant shifts, so nothing goes through
    device memory between sweeps and the host is not asked once per sweep.
    A decoder built with ``device="cpu"`` runs the kernel's plain torch
    version instead.
  * ``backend='lifted'``: the generic edge-list decoder (models/minsum.py,
    or models/bp.py for sum-product) on the lifted Tanner graph: the
    correctness oracle, and the way out for codes whose messages do not
    fit a block's shared memory.

Three construction paths:

  * ``QCMinSumDecoder(base, Z, ...)``: 1-D quasi-cyclic base matrix
    (codes/qc.py); the lifted graph orders each check's neighbors by
    ascending variable index, matching the generic decoder's slot order, so
    the two backends tie-break identically in flooding (their float32 sums
    associate differently, so LLRs agree to rounding, not bitwise).
  * ``QCMinSumDecoder.from_group_terms(terms, mb, nb, group, ...)``: 2-D
    group-circulant edge terms over ``Z_l x Z_m``
    (codes/qc.py::qc_group_lift_edges).
  * ``QCMinSumDecoder.for_bicycle(code, block, ...)``: one stabilizer
    block (Hx or Hz) of a bivariate bicycle quantum code
    (codes/bicycle.py); transposed blocks use inverse monomials.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.bicycle import BICYCLE_CODES
from ..codes.graph import TannerGraph
from ..codes.qc import qc_group_lift_edges, qc_lift_edges
from ..ops.cuda_qc import qc_minsum_cuda
from ..ops.qc_minsum import QCTerms, qc_launch_shape, qc_modes
from .base import Decoder, resolve_device
from .bp import BPDecode
from .layered import LayeredMinSumDecode
from .minsum import MinSumDecode
from .priors import per_to_llr

__all__ = ["QCMinSumDecoder", "bicycle_blocks", "qc_terms_from_reference"]


def bicycle_blocks(code, block: str):
    """``(l, m, (left terms, right terms))`` of one stabilizer block of a
    bivariate bicycle code: ``'x'`` is ``Hx = [A | B]``, ``'z'`` is
    ``Hz = [B^T | A^T]`` (the transpose of ``x^a y^b`` is its inverse).
    ``code`` is a registry name or an ``(l, m, a_terms, b_terms)`` tuple."""
    if isinstance(code, str):
        if code not in BICYCLE_CODES:
            raise ValueError(f"unknown BB code '{code}' (choose from {sorted(BICYCLE_CODES)})")
        info = BICYCLE_CODES[code]
        l, m, a_terms, b_terms = info["l"], info["m"], info["a_terms"], info["b_terms"]
    else:
        l, m, a_terms, b_terms = code
    l, m = int(l), int(m)

    def fwd(ts):
        return [(int(a) % l, int(b) % m) for a, b in ts]

    def inv(ts):
        return [((l - int(a)) % l, (m - int(b)) % m) for a, b in ts]

    if block == "x":
        return l, m, (fwd(a_terms), fwd(b_terms))
    if block == "z":
        return l, m, (inv(b_terms), inv(a_terms))
    raise ValueError(f"block must be 'x' or 'z', got {block!r}")


def qc_terms_from_reference(dec) -> dict:
    """The description of a reference-package ``QCMinSumDecoder`` as plain
    Python values: the keyword arguments with which
    :meth:`QCMinSumDecoder.from_group_terms` builds its counterpart
    (add ``device=`` and ``backend=``).  Reads attributes only."""
    return dict(
        terms=[tuple(int(x) for x in t) for t in dec.terms],
        mb=int(dec._mb), nb=int(dec._nb), group=tuple(int(x) for x in dec.group),
        per=float(dec.per), max_iters=int(dec.max_iters), alpha=float(dec.alpha),
        beta=float(dec.beta), schedule=str(dec.schedule), algorithm=str(dec.algorithm),
        dtype=getattr(torch, np.dtype(dec.dtype).name),
    )


class QCMinSumDecoder(Decoder):
    """Normalized/offset min-sum decoder for group-circulant LDPC codes.

    Args:
      base: ``[mb, nb]`` QC base matrix (-1 = zero block, else circulant
        shift in ``[0, Z)``); see codes/qc.py.
      Z: lift (circulant) size.
      per: physical error rate (sets the scalar channel LLR).
      max_iters: maximum BP iterations (full sweeps for 'layered').
      alpha, beta: min-sum normalization / offset.  alpha=None resolves to
        the schedule default: 1.0 flooding, 0.8 layered (the layered
        schedule amplifies min-sum's magnitude overestimate).
      backend: 'cuda' (the whole-decode kernel; 'auto' means the same) or
        'lifted' (generic edge-list decoder on the lifted graph).
      schedule: 'flooding' (default) or 'layered' (serial-C over base rows:
        conflict-free layers for single-term blocks, about half the
        sweeps).  The lifted backend's layered schedule is the layered
        min-sum decoder (models/layered.py) on the lifted graph.
      algorithm: 'minsum' (default) or 'sumproduct' (exact tanh rule).
      dtype: message storage precision, torch.float32 (default) or
        torch.bfloat16 (half the shared memory; arithmetic and LLR outputs
        stay float32).
      device: where the tables live and decoding runs; None is the current
        CUDA card.

    ``batch_decode(..., per=x)`` overrides the prior for one call (scalar,
    ``[n]`` or per-lane ``[B, n]``: erasures, punctured bits, sweeps).  The
    same kernel serves both cases: it reads per-bit priors from device
    memory when it is given any, so no second variant is built.

    Example:

    >>> import numpy as np
    >>> from ldpcdecoders_tpu_torch import QCMinSumDecoder, random_qc_base_matrix
    >>> base = random_qc_base_matrix(8, 4, 2, 16, rng=0)
    >>> dec = QCMinSumDecoder(base, 16, 0.05, 20, device="cpu")
    >>> err, converged = dec.decode(np.zeros(dec.m, np.int8))
    >>> int(err.sum()), converged
    (0, True)
    """

    def __init__(self, base, Z: int, per: float, max_iters: int, *, alpha: float | None = None,
                 beta: float = 0.0, backend: str = "cuda", schedule: str = "flooding",
                 algorithm: str = "minsum", dtype=torch.float32, device=None):
        super().__init__()
        base = np.asarray(base, dtype=np.int64)
        rows, cols, _, _ = qc_lift_edges(base, Z)
        mb, nb = base.shape
        bi, bj = np.nonzero(base >= 0)
        terms = [(int(i), int(j), int(base[i, j]), 0) for i, j in zip(bi, bj)]
        self.base = base
        self._setup(terms, mb, nb, (int(Z), 1), rows, cols, per, max_iters, alpha=alpha,
                    beta=beta, backend=backend, schedule=schedule, algorithm=algorithm,
                    dtype=dtype, device=device)

    @classmethod
    def from_group_terms(cls, terms, mb: int, nb: int, group: tuple[int, int], per: float,
                         max_iters: int, *, alpha: float | None = None, beta: float = 0.0,
                         backend: str = "cuda", schedule: str = "flooding",
                         algorithm: str = "minsum", dtype=torch.float32,
                         device=None) -> "QCMinSumDecoder":
        """Build from 2-D group-circulant edge terms over ``Z_l x Z_m``.

        ``terms`` is a list of ``(i, j, a, b)``: the monomial ``x^a y^b``
        in block ``(i, j)`` (multiple terms per block allowed).  See
        codes/qc.py::qc_group_lift_edges for the lifting convention.
        """
        gl, gm = (int(x) for x in group)
        terms = [tuple(int(x) for x in t) for t in terms]
        rows, cols, _, _ = qc_group_lift_edges(terms, mb, nb, gl, gm)
        self = cls.__new__(cls)
        Decoder.__init__(self)
        self.base = None
        self._setup(terms, int(mb), int(nb), (gl, gm), rows, cols, per, max_iters, alpha=alpha,
                    beta=beta, backend=backend, schedule=schedule, algorithm=algorithm,
                    dtype=dtype, device=device)
        return self

    @classmethod
    def for_bicycle(cls, code, block: str, per: float, max_iters: int,
                    **kwargs) -> "QCMinSumDecoder":
        """Decoder for one stabilizer block of a bivariate bicycle code.

        Args:
          code: a registry name ("bb144", ...) or ``(l, m, a_terms,
            b_terms)`` tuple (codes/bicycle.py conventions).
          block: 'x' for ``Hx = [A | B]`` or 'z' for ``Hz = [B^T | A^T]``.
          **kwargs: forwarded to :meth:`from_group_terms`.

        Example:

        >>> from ldpcdecoders_tpu_torch import QCMinSumDecoder
        >>> dec = QCMinSumDecoder.for_bicycle("bb72", "x", 0.01, 30, device="cpu")
        >>> dec.m, dec.n
        (36, 72)
        """
        l, m, blocks = bicycle_blocks(code, block)
        terms = [(0, j, a, b) for j, ts in enumerate(blocks) for a, b in ts]
        return cls.from_group_terms(terms, 1, 2, (l, m), per, max_iters, **kwargs)

    def _setup(self, terms, mb, nb, group, rows, cols, per, max_iters, *, alpha, beta, backend,
               schedule, algorithm, dtype, device):
        self.device = resolve_device(device)
        gl, gm = group
        Z = gl * gm
        m, n = mb * Z, nb * Z
        H = None
        if m * n <= 4_000_000:  # attach dense H only at debug-tool sizes
            H = np.zeros((m, n), np.uint8)
            H[rows, cols] = 1
        self.graph = TannerGraph.from_edges(rows, cols, m, n, H=H)
        self.terms = terms
        self.group = (gl, gm)
        self.Z = Z
        self.m, self.n = m, n
        self.per = float(per)
        self.max_iters = int(max_iters)
        layered, sumprod = qc_modes(schedule, algorithm, dtype)
        self.schedule, self.algorithm, self.dtype = schedule, algorithm, dtype
        self.alpha = float(alpha) if alpha is not None else (
            0.8 if layered and not sumprod else 1.0)
        self.beta = float(beta)
        self.backend = "cuda" if backend == "auto" else backend
        if self.backend == "cuda":
            self.qc_terms = QCTerms.build(terms, mb, nb, (gl, gm))
            self.L0 = float(per_to_llr(self.per, 1))
            self.register_buffer("table", torch.as_tensor(self.qc_terms.table(),
                                                          device=self.device))
            if self.device.type == "cuda":
                # refuse here, not at the first decode, what no block can hold
                qc_launch_shape(self.qc_terms, 4 if dtype == torch.float32 else 2, layered,
                                sumprod)
        elif self.backend == "lifted":
            if sumprod:
                if layered:
                    raise ValueError("layered sum-product is only available on the cuda "
                                     "backend (the lifted layered path is min-sum)")
                self.lifted = BPDecode(self.graph, self.per, self.max_iters, device=self.device)
            elif layered:
                self.lifted = LayeredMinSumDecode(self.graph, self.per, self.max_iters,
                                                  device=self.device, alpha=self.alpha,
                                                  beta=self.beta, dtype=dtype)
            else:
                self.lifted = MinSumDecode(self.graph, self.per, self.max_iters,
                                           device=self.device, alpha=self.alpha,
                                           beta=self.beta, dtype=dtype)
        else:
            raise ValueError(f"unknown backend {backend!r} (want 'cuda' or 'lifted')")

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        if self.backend == "lifted":
            prior = None if per is None else self.lifted.as_prior(per)
            err, converged, iters, soft = self.lifted(syndromes, prior)
            key = "log_probabs" if self.algorithm == "sumproduct" else "llrs"
            return err, converged, iters, {key: soft}
        priors = None
        if per is not None:
            priors = torch.as_tensor(per_to_llr(per, self.n), dtype=torch.float32,
                                     device=self.device)
            if priors.ndim == 0:
                priors = priors.expand(self.n)
        err, converged, iters, llrs = qc_minsum_cuda(
            syndromes, self.qc_terms, self.table, self.L0, self.max_iters, alpha=self.alpha,
            beta=self.beta, schedule=self.schedule, algorithm=self.algorithm, dtype=self.dtype,
            priors=priors)
        return err, converged, iters, {"llrs": llrs}
