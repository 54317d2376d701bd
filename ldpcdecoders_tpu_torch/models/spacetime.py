"""Multi-round decoding under measurement noise (phenomenological model).

Counterpart of ``ldpcdecoders_tpu/models/spacetime.py``.
:class:`SpaceTimeDecoder` decodes ``R`` consecutive noisy measurement
rounds jointly over the space-time detector graph built by
``codes/spacetime.py``: one sparse parity-check matrix whose variables are
every round's fresh data errors and every round's readout errors, so the
batched decoders of this package run on it as they are.

It is a full :class:`~.base.Decoder`: its "syndrome" is the ``[B, R*m]``
detector record and its error estimate the ``[B, n]`` cumulative data
correction.  The space-time matrix for ``R`` rounds of an ``[m, n]`` block
has ``R*m`` checks and ``R*n + (R-1)*m`` variables.  For a bivariate
bicycle block that matrix is itself group-circulant, and
:meth:`SpaceTimeDecoder.for_bicycle` decodes it with the whole-decode
kernel (models/qc_minsum.py) in one launch per batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.qc import qc_group_lift_edges
from ..codes.spacetime import detectors_of, spacetime_pcm, spacetime_prior
from .base import Decoder, DecodeStats, resolve_device
from .qc_minsum import QCMinSumDecoder, bicycle_blocks

__all__ = ["SpaceTimeDecoder"]

def _build_inner(kind, H, per, max_iters, device, knobs):
    """The inner decoder, built through :class:`~..config.DecoderConfig`
    (which raises ``NotImplementedError`` for a kind not ported yet)."""
    from ..config import _INNER_KNOBS, DecoderConfig

    unknown = sorted(set(knobs) - set(_INNER_KNOBS))
    if unknown:
        raise TypeError(f"unknown decoder knobs {unknown}")
    return DecoderConfig(kind=kind, per=per, max_iters=max_iters, **knobs).build(
        H, device=device)


class SpaceTimeDecoder(Decoder):
    """Joint decoder for ``R`` noisy syndrome-measurement rounds.

    Args:
      H: ``[m, n]`` stabilizer block (dense or scipy.sparse 0/1).
      rounds: number of measurement rounds ``R >= 1``.  The last round
        is assumed noiseless (``perfect_last=True``; the standard closed
        decoding problem: ``rounds=1`` is then exactly single-shot
        decoding on ``H``).
      per: per-round fresh data-error probability (scalar or ``[n]``).
      max_iters: BP iteration cap of the inner decoder.
      meas_error_rate: readout-flip probability per syndrome bit and
        round (scalar or ``[m]``); defaults to ``per``, the usual
        ``p == q`` phenomenological convention.
      decoder: inner decoder kind, a ported ``DecoderConfig`` kind: "bp",
        "bposd" (default, for syndrome-consistent output), "minsum", ...
      perfect_last: see above; ``False`` leaves the final round noisy
        (open boundary for sliding-window use).
      device: where decoding runs; None is the current CUDA card.
      **knobs: extra arguments of the inner decoder (osd_order, damping,
        alpha, ...).

    Decoder contract: ``m`` is the *detector record* length ``R *
    block_m`` (what ``batch_decode`` consumes), ``n`` the data block
    size (what it returns); the underlying stabilizer block's shape is
    ``(block_m, block_n)``.  The primary entry points take either the
    raw multi-round syndrome history (``decode_history``) or a
    precomputed detector record (``batch_decode``); both return the
    estimated *cumulative* data error: the correction to apply after
    round ``R``.
    """

    def __init__(self, H, rounds: int, per, max_iters: int, *, meas_error_rate=None,
                 decoder: str = "bposd", perfect_last: bool = True, device=None, _inner=None,
                 **knobs):
        super().__init__()
        import scipy.sparse as sp

        Hs = sp.csr_matrix(H).astype(np.uint8)
        self.block_m, self.block_n = Hs.shape
        self.rounds = int(rounds)
        self.perfect_last = bool(perfect_last)
        q = per if meas_error_rate is None else meas_error_rate
        # kept for rounds=1 prior overrides: the perfect-last single-round
        # prior has no measurement columns to slice the default q back out of
        self._q_default = q
        self._prior = spacetime_prior(self.block_n, self.block_m, self.rounds, per, q,
                                      perfect_last=self.perfect_last)
        self.A = spacetime_pcm(Hs, self.rounds, perfect_last=self.perfect_last)
        self.n_meas_rounds = self.rounds - 1 if self.perfect_last else self.rounds
        # Decoder contract: m = input record length, n = output length
        self.m = self.rounds * self.block_m
        self.n = self.block_n
        self.n_cols = self.A.shape[1]  # inner variable count
        if _inner is not None:
            # pre-built inner on the SAME column layout as self.A: the
            # group-circulant path (for_bicycle) injects here
            if (_inner.m, _inner.n) != self.A.shape:
                raise ValueError(f"injected inner is [{_inner.m}, {_inner.n}]; the "
                                 f"space-time model is {self.A.shape}")
            self.inner = _inner
            self.device = _inner.device
        else:
            self.device = resolve_device(device)
            # rounds == 1 && perfect_last: A == H exactly; skip the sparse
            # detour so the inner is bit-identical to single-shot
            self.inner = _build_inner(
                decoder, Hs if (self.rounds == 1 and self.perfect_last) else self.A,
                float(self._prior.mean()), max_iters, self.device, knobs)

    @classmethod
    def for_bicycle(cls, code, block: str, rounds: int, per, max_iters: int, *,
                    meas_error_rate=None, schedule: str = "layered", backend: str = "cuda",
                    alpha: float | None = None, perfect_last: bool = True,
                    verify_lift: bool = True, **knobs):
        """Space-time decoder for a bivariate-bicycle block with the
        whole-decode group-circulant kernel as its inner.

        The space-time matrix of a group-circulant code is itself
        group-circulant: row-block ``r`` holds the stabilizer block at
        data round ``r`` and identity monomials at measurement rounds
        ``r-1``/``r``.  This constructor builds that lift as
        ``QCMinSumDecoder.from_group_terms`` and injects it as the inner,
        with the mixed data/measurement prior (``meas_error_rate != per``)
        carried per column through the kernel's per-bit priors.

        Args:
          code: registry name ("bb72", "bb144", ...) or an
            ``(l, m, a_terms, b_terms)`` tuple (codes/bicycle.py).
          block: 'x' (``Hx = [A | B]``) or 'z' (inverse monomials).
          schedule: 'layered' (default) or 'flooding';
            backend/alpha/knobs (dtype, device, ...) forward to the QC
            decoder.
          verify_lift: check that the QC lift equals ``spacetime_pcm``
            element-wise before returning (cheap; skip only in tight
            construction loops).
        """
        l, m, blocks = bicycle_blocks(code, block)
        R = int(rounds)
        if R < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        n_meas_rounds = R - 1 if perfect_last else R
        nb = 2 * R + n_meas_rounds
        terms = []
        for r in range(R):
            for j, ts in enumerate(blocks):
                for a, b in ts:
                    terms.append((r, 2 * r + j, a, b))
            if r < n_meas_rounds:  # u_{r+1} flips this round's record
                terms.append((r, 2 * R + r, 0, 0))
            if r >= 1:  # u_r flips it too (XOR-difference detectors)
                terms.append((r, 2 * R + r - 1, 0, 0))

        # the single-round block itself, for the outer wrapper's
        # bookkeeping (A, priors, observables projection)
        r0, c0, mH, nH = qc_group_lift_edges(
            [(0, j, a, b) for j, ts in enumerate(blocks) for a, b in ts], 1, 2, l, m)
        H = np.zeros((mH, nH), np.uint8)
        H[r0, c0] = 1

        q = per if meas_error_rate is None else meas_error_rate
        prior_mean = float(spacetime_prior(nH, mH, R, per, q, perfect_last=perfect_last).mean())
        inner = QCMinSumDecoder.from_group_terms(
            terms, R, nb, (l, m), prior_mean, max_iters, schedule=schedule, backend=backend,
            alpha=alpha, **knobs)
        self = cls(H, R, per, max_iters, meas_error_rate=meas_error_rate,
                   perfect_last=perfect_last, _inner=inner)
        if verify_lift:
            import scipy.sparse as sp

            rows, cols, mA, nA = qc_group_lift_edges(terms, R, nb, l, m)
            A_qc = sp.coo_matrix((np.ones(len(rows), np.uint8), (rows, cols)),
                                 shape=(mA, nA)).tocsr()
            if (A_qc != self.A).nnz != 0:
                raise AssertionError("QC space-time lift does not match spacetime_pcm: "
                                     "term construction bug")
        return self

    def _prior_vec(self, per, q):
        """Full inner prior vector (numpy, float64) for possibly overridden
        rates."""
        if per is None and q is None:
            return self._prior
        p = self._prior[: self.block_n] if per is None else per
        if q is not None:
            qq = q
        elif self.n_meas_rounds > 0:
            qq = self._prior[self.rounds * self.block_n:
                             self.rounds * self.block_n + self.block_m]
        else:
            # rounds=1 with perfect_last has zero measurement columns, so
            # the stored prior can't be sliced for q: fall back to the
            # constructor's default (it is unused downstream anyway)
            qq = self._q_default
        return spacetime_prior(self.block_n, self.block_m, self.rounds, p, qq,
                               perfect_last=self.perfect_last)

    # -- Decoder contract ---------------------------------------------------

    def _decode_batch(self, detectors, seed: int = 0, per=None, q=None):
        """Detector records ``[B, R*m]`` -> cumulative data-error estimate
        ``[B, n]``.

        ``per`` may be the data-error rate (scalar or ``[block_n]``; the
        measurement rate defaults to the constructor's) or the FULL
        ``[n_cols]`` inner prior vector."""
        if per is not None and np.ndim(per) >= 1 and (
                np.shape(per)[-1] == self.n_cols != self.block_n):
            prior = per  # full inner prior vector, passed through
        else:
            prior = self._prior_vec(per, q)
        x, conv, iters, aux = self.inner._decode_batch(detectors, seed, per=prior)
        B = x.shape[0]
        if self.rounds == 1 and self.perfect_last:
            data = x[:, None, :]
            meas = torch.zeros((B, 0, self.block_m), dtype=torch.int8, device=x.device)
            cum = x.to(torch.int8)
        else:
            data = x[:, : self.rounds * self.block_n].reshape(B, self.rounds, self.block_n)
            meas = x[:, self.rounds * self.block_n:].reshape(B, self.n_meas_rounds,
                                                             self.block_m)
            cum = (data.to(torch.int32).sum(dim=1) % 2).to(torch.int8)
        return cum, conv, iters, {"data_rounds": data, "meas": meas, "inner": aux}

    def _call_decode(self, detectors, seed, per, q=None):
        detectors = torch.as_tensor(detectors, device=self.device)
        if detectors.ndim != 2 or detectors.shape[1] != self.m:
            raise ValueError(
                f"expected detectors of shape [B, {self.m}] "
                f"(rounds={self.rounds} x m={self.block_m}), got {tuple(detectors.shape)}")
        return self._decode_batch(detectors, seed, per=per, q=q)

    # -- public API (q-aware wrappers over the Decoder surface) -------------

    def batch_decode(self, detectors, *, seed: int = 0, per=None, q=None):
        """Decode detector records ``[B, R*m]`` (see ``detectors_of``).

        ``per`` / ``q`` optionally override the data / measurement error
        rates for this call.

        Returns ``(errors [B, n] int8, converged [B] bool)`` where
        ``errors`` is the estimated cumulative data error after the last
        round (XOR of every round's fresh-error estimate).
        """
        err, conv, _, _ = self._call_decode(np.asarray(detectors), seed, per, q)
        return err.cpu().numpy(), conv.cpu().numpy()

    def batch_decode_detailed(self, detectors, *, seed: int = 0, per=None, q=None):
        """Like :meth:`batch_decode`, also returning iteration counts,
        the per-round split (``aux["data_rounds"]`` ``[B, R, n]``,
        ``aux["meas"]`` ``[B, R_noisy, m]``, ``aux["inner"]`` the inner
        decoder's soft output) and :class:`~.base.DecodeStats`, all as
        numpy arrays."""
        err, conv, iters, aux = self._call_decode(np.asarray(detectors), seed, per, q)
        err, conv, iters = (t.cpu().numpy() for t in (err, conv, iters))

        def host(v):
            if isinstance(v, dict):
                return {k: host(x) for k, x in v.items()}
            # numpy has no bfloat16: such values come back as float32 (exact)
            return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()

        return err, conv, iters, host(aux), DecodeStats.from_arrays(conv, iters)

    def decode_history(self, syndromes, *, seed: int = 0, per=None, q=None):
        """Decode raw measured syndrome histories ``[B, R, m]`` (or a
        single ``[R, m]`` shot): forms the XOR-difference detector record
        and calls :meth:`batch_decode`."""
        s = np.asarray(syndromes)
        single = s.ndim == 2
        d = detectors_of(s)
        err, conv = self.batch_decode(d[None] if single else d, seed=seed, per=per, q=q)
        return (err[0], bool(conv[0])) if single else (err, conv)
