"""Batched BP + Ordered-Statistics-Decoding (OSD) decoder.

Counterpart of ``ldpcdecoders_tpu/models/bposd.py``:

  * the inner soft-output decoder is the batched sum-product decoder
    (models/bp.py) or a min-sum decoder (models/minsum.py); its log
    probability ratios / LLRs (the same quantity, log(p0/p1)) rank column
    reliability;
  * per lane, the columns of H are sorted most-reliable-first and
    bit-packed on the device (:meth:`OSD.sort_and_pack`);
  * OSD-0 runs only on the lanes whose BP output misses the syndrome: the
    host gathers them into a power-of-two bucket, the OSD-0 kernel
    (ops/cuda_gf2.py ``gf2_osd0_cuda``) decodes them, and the result is
    scattered back;
  * OSD-w (w > 0) runs on every lane, or with ``osd_scope="failed"`` on
    the failing lanes only: the Gauss–Jordan kernel
    (``gf2_eliminate_cuda``) reduces each system and a sweep over its
    completions picks the lightest: the exhaustive 2^w sweep (ops/gf2.py
    ``osdw_sweep``) or, with ``osd_method="combination_sweep"``, OSD-CS
    (``osd_cs_sweep``: every single flip and the pairs within the first
    ``osd_order`` columns);
  * the native host OSD (native/gf2_osd.cpp) takes the OSD where
    ``osd_impl="host"``.  A lane too large for one block of the
    elimination kernels takes their device-memory body (ops/cuda_gf2.py):
    the device OSD decodes every code size.

Spans and counters (utils/profiling.py): ``ldpc.bposd.inner`` around the
inner decode; ``ldpc.bposd.osd`` around the device OSD of the failing
lanes (their gather, the OSD, the unsort and the splice), closed where the
spliced answers are ready on the device; ``ldpc.osd.pack``,
``ldpc.osd.eliminate`` and ``ldpc.osd.sweep`` inside :class:`OSD`'s
batches; ``osd_dev_lanes`` (the failing lanes) and ``osd_dev_lanes_padded``
(the bucket they are padded to) count the lanes the device OSD takes.  The
read of the converged flags is a counted host read.

``converged`` reports BP convergence; the returned error estimate is
always syndrome-consistent for OSD-0, and for OSD-w whenever H's rows span
the syndrome.

``fused=True`` (:class:`FusedBPOSD`, which :func:`make_fused_bposd_fn`,
the reference's functional core, also builds) makes one decode device work
with no host read: the inner decoder runs all ``max_iters``
iterations (converged lanes freeze their outputs, so these are the eager
loop's), and the OSD runs on every lane, its output kept where the inner
decoder failed (OSD-0, OSD-w under ``osd_scope="failed"``: the
reference's ``lax.cond`` becomes a ``torch.where``) or everywhere (OSD-w
under ``osd_scope="all"``).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..ops.cuda_gf2 import gf2_eliminate_cuda, gf2_osd0_cuda
from ..ops.gf2 import osd_cs_sweep, osdw_sweep, wrap_int32
from ..utils.profiling import count, settle, span, to_device, to_host
from .base import Decoder, resolve_device
from .bp import BPDecode, as_graph
from .minsum import MinSumDecode, MinSumDecoder
from .priors import next_pow2

__all__ = ["BeliefPropagationOSDDecoder", "OSD", "FusedBPOSD", "make_osd_fns",
           "make_fused_bposd_fn"]


def _make_inner(graph, per, max_iters, inner, damping, device):
    """Resolve the OSD's inner soft-output decoder: a module
    ``(syndromes, prior) -> (err, converged, iters, soft)`` whose
    ``as_prior(per)`` builds the per-call override in its own prior domain
    (probability ratio for BP, LLR for min-sum).

    ``inner`` is ``"sumproduct"`` (or None), ``"minsum"``, or a constructed
    :class:`MinSumDecoder` on the same code and device.
    """
    if inner is None or inner == "sumproduct":
        if damping:
            raise ValueError(
                "damping is a min-sum knob; use inner='minsum' (or pass a "
                "damped MinSumDecoder instance)")
        return BPDecode(graph, per, max_iters, device=device)
    if isinstance(inner, str) and inner == "minsum":
        return MinSumDecode(graph, per, max_iters, damping=damping, device=device)
    if not isinstance(inner, MinSumDecoder):
        raise TypeError(
            "inner must be 'sumproduct', 'minsum', or a MinSumDecoder instance, "
            f"got {inner!r}")
    if (inner.m, inner.n) != (graph.m, graph.n):
        raise ValueError(
            f"inner decoder is built on an [{inner.m}, {inner.n}] "
            f"code; this OSD wraps [{graph.m}, {graph.n}]")
    if inner.device != device:
        raise ValueError(f"inner decoder is on {inner.device}; this OSD runs on {device}")
    return inner.minsum


def _gf2_rank(H: np.ndarray) -> int:
    """Rank of a 0/1 matrix over GF(2) (bit-packed elimination on the host)."""
    H = np.asarray(H, dtype=np.uint8)
    m, n = H.shape
    W = (n + 63) // 64
    pad = W * 64 - n
    bits = np.pad(H, [(0, 0), (0, pad)]).reshape(m, W, 64).astype(np.uint64)
    rows = (bits << np.arange(64, dtype=np.uint64)).sum(axis=2, dtype=np.uint64)
    rank = 0
    for j in range(n):
        w, b = divmod(j, 64)
        col = (rows[:, w] >> np.uint64(b)) & np.uint64(1)
        avail = np.flatnonzero(col[rank:]) + rank
        if avail.size == 0:
            continue
        k = avail[0]
        rows[[rank, k]] = rows[[k, rank]]
        elim = np.flatnonzero(
            ((rows[:, w] >> np.uint64(b)) & np.uint64(1)).astype(bool)
        )
        elim = elim[elim != rank]
        rows[elim] ^= rows[rank]
        rank += 1
        if rank == m:
            break
    return rank


class OSD(torch.nn.Module):
    """Batched OSD-0 / OSD-w post-processors over one code.

    ``osd0_batch`` and ``osdw_batch`` take ``(syndromes [B, m], bp_err
    [B, n], logp [B, n])`` in unsorted column order and return the
    ``[B, n]`` int32 0/1 corrected error.
    """

    def __init__(self, graph, osd_order: int, *, device, osd_method: str = "exhaustive"):
        super().__init__()
        H = graph.require_H()
        self.m, self.n, self.osd_order = graph.m, graph.n, int(osd_order)
        self.sweep = osd_cs_sweep if osd_method == "combination_sweep" else osdw_sweep
        self.W = (self.n + 31) // 32
        # H's columns as rows, with a zero row at index n that padded
        # permutation slots gather
        H_cols_z = np.concatenate([H.T, np.zeros((1, self.m), np.uint8)], axis=0)
        self.register_buffer("H_cols_z", torch.as_tensor(H_cols_z.astype(np.int64),
                                                         device=device))
        self.register_buffer("H_cols_f", torch.as_tensor(H.T.astype(np.float32),
                                                         device=device))
        self.register_buffer("shifts", torch.arange(32, dtype=torch.int64,
                                                    device=device)[:, None])

    def sort_and_pack(self, bp_err, logp):
        """Per-lane reliability order and the packed sorted system.

        Returns ``(perm [B, n], Ht [B, W, m] int32, bp_sorted [B, n] int32)``;
        ``Ht`` holds the columns of ``H[:, perm]``.  The columns are packed
        one 32-column word at a time: gathering the whole permuted H at
        once would take ``B * n * m`` words.
        """
        n, W = self.n, self.W
        B = bp_err.shape[0]
        probs = torch.exp(logp.to(torch.float32))
        reliability = torch.maximum(probs, 1.0 - probs)
        perm = torch.argsort(-reliability, dim=1, stable=True)
        permp = perm
        if W * 32 != n:
            permp = torch.cat([perm, perm.new_full((B, W * 32 - n), n)], dim=1)
        permp = permp.reshape(B, W, 32)
        words = [
            wrap_int32((self.H_cols_z[permp[:, w]] << self.shifts).sum(dim=1))
            for w in range(W)
        ]  # each [B, m]
        Ht = torch.stack(words, dim=1).contiguous()
        bp_sorted = bp_err.to(torch.int32).gather(1, perm).contiguous()
        return perm, Ht, bp_sorted

    @staticmethod
    def unsort(perm, corr_sorted):
        return torch.zeros_like(corr_sorted).scatter_(1, perm, corr_sorted)

    def osd0_batch(self, syndromes, bp_err, logp):
        with span("ldpc.osd.pack"):
            perm, Ht, bp_sorted = self.sort_and_pack(bp_err, logp)
            # residual syndrome of bp_err; small-integer row sums are exact in f32
            hb = bp_err.to(torch.float32) @ self.H_cols_f
            resid = (syndromes.to(torch.int32) ^ (hb.to(torch.int32) & 1)).contiguous()
        with span("ldpc.osd.eliminate"):
            corr = gf2_osd0_cuda(Ht, resid, bp_sorted, self.n)
        return self.unsort(perm, corr)

    def osdw_batch(self, syndromes, bp_err, logp):
        with span("ldpc.osd.pack"):
            perm, Ht, bp_sorted = self.sort_and_pack(bp_err, logp)
        with span("ldpc.osd.eliminate"):
            s = syndromes.to(torch.int32).contiguous()
            Ht2, s2, piv = gf2_eliminate_cuda(Ht, s, self.n)
        with span("ldpc.osd.sweep"):
            r = (piv != self.n).sum(dim=1)
            corr = self.sweep(Ht2, s2, piv, r, bp_sorted, self.osd_order, self.n)
        return self.unsort(perm, corr)


def make_osd_fns(graph, osd_order: int, *, device, osd_method: str = "exhaustive"):
    """``(osd0_batch, osdw_batch)`` for ``graph`` (counterpart of the
    reference's ``make_osd_fns``)."""
    osd = OSD(graph, osd_order, device=device, osd_method=osd_method)
    return osd.osd0_batch, osd.osdw_batch


class FusedBPOSD(torch.nn.Module):
    """``forward(syndromes [B, m], ratio=None) -> (err int8, converged bool,
    iters int32, logp)``: BP+OSD as device work with no host read, the one
    fused decode of :func:`make_fused_bposd_fn` and of
    ``BeliefPropagationOSDDecoder(fused=True)``.

    ``inner`` (a :class:`BPDecode` or :class:`MinSumDecode`) runs all its
    ``max_iters`` iterations; ``ratio`` is its prior override.  The OSD runs
    on every lane: with ``osd.osd_order > 0`` and ``osd_scope="all"`` its
    output is kept everywhere, otherwise only where the inner decoder failed
    (the reference's ``lax.cond`` on ``all(converged)`` becomes a
    ``torch.where``; the outputs are the same).
    """

    def __init__(self, inner, osd: OSD, osd_scope: str = "all"):
        super().__init__()
        self.inner, self.osd, self.osd_scope = inner, osd, osd_scope

    def forward(self, syndromes, ratio=None):
        bp_err, converged, iters, logp = self.inner(syndromes, ratio, early_exit=False)
        if self.osd.osd_order > 0 and self.osd_scope == "all":
            corr = self.osd.osdw_batch(syndromes, bp_err, logp)
            return corr.to(torch.int8), converged, iters, logp
        post = self.osd.osd0_batch if self.osd.osd_order == 0 else self.osd.osdw_batch
        corr = post(syndromes, bp_err, logp).to(torch.int8)
        return torch.where(converged[:, None], bp_err, corr), converged, iters, logp


def make_fused_bposd_fn(graph, per, max_iters: int, osd_order: int, *, use_pallas: bool = False,
                        osd_scope: str = "all", inner=None, osd_method: str = "exhaustive",
                        damping: float = 0.0, device=None):
    """Build ``decode(syndromes [B, m], ratio=None) -> (err int8, converged
    bool, iters int32, logp)``, the reference's functional core: one
    :class:`FusedBPOSD` on ``device`` (None: the current CUDA card).  On a
    CUDA device the OSD runs the hand-written elimination kernels (OSD-0:
    ``gf2_osd0``; OSD-w: ``gf2_eliminate``).

    ``inner`` is ``"sumproduct"`` (or None), ``"minsum"`` (with
    ``damping``), or a :class:`MinSumDecoder` on the same code and device;
    ``ratio`` is a prior in its domain (probability ratio for sum-product,
    LLR for min-sum).  ``use_pallas`` is the reference's TPU knob, accepted
    and ignored.  As in the reference, ``osd_order`` is not clamped to the
    information-set size (the decoder class clamps it).  ``syndromes`` and
    ``ratio`` may be numbers, numpy arrays or tensors; they are moved to
    ``device``.
    """
    del use_pallas
    if osd_method not in ("exhaustive", "combination_sweep"):
        raise ValueError(
            f"osd_method must be 'exhaustive' or 'combination_sweep', got {osd_method!r}")
    device = resolve_device(device)
    fused = FusedBPOSD(_make_inner(graph, per, max_iters, inner, damping, device),
                       OSD(graph, osd_order, device=device, osd_method=osd_method), osd_scope)

    def decode(syndromes, ratio=None):
        return fused(torch.as_tensor(syndromes, device=device), ratio)

    return decode


class BeliefPropagationOSDDecoder(Decoder):
    """BP with OSD post-processing; output is always syndrome-consistent.

    Args:
      H: ``[m, n]`` parity-check matrix, or a compiled TannerGraph.
      per: physical error rate.
      max_iters: maximum BP iterations.
      osd_order: OSD order w (default 0); the exhaustive sweep scales as
        2^w, OSD-CS as ``1 + (n-r) + w*(w-1)/2`` candidates.
      osd_method: ``"exhaustive"`` (the reference's 2^w sweep) or
        ``"combination_sweep"`` (OSD-CS: the base completion, every single
        non-pivot flip and every pair within the first ``osd_order``
        most-reliable non-pivot columns; no rank clamp applies).
      osd_scope: ``"all"`` (default): with osd_order > 0 the sweep runs on
        every lane, and may return a lower-weight solution even where the
        inner decoder converged.  ``"failed"``: OSD-w goes through the same
        failing-lane compaction as OSD-0 and converged lanes keep the
        inner decoder's output.
      osd_impl: ``"device"`` (default: the elimination kernels on the
        card, the plain versions on the CPU) or ``"host"`` (the threaded
        C++ eliminator of native/, for OSD-0 or OSD-CS).  A lane too large
        for one block of the elimination kernels takes their device-memory
        body.
      osd_triples: with ``osd_impl="host"`` and OSD-CS, the triple-sweep
        depth (order-3 combinations; 0 disables).
      fused: one device program without a host read: the inner decoder
        runs all ``max_iters`` iterations (no early exit: at low noise
        this costs the iterations the eager loop skips) and the OSD runs on
        every lane, selected by ``converged`` (OSD-0 and ``osd_scope=
        "failed"``) or kept (OSD-w, ``osd_scope="all"``); the outputs are
        the eager path's.  Not with ``osd_impl="host"``.
      inner: the soft-output decoder whose LLRs rank the OSD column
        reliabilities: ``"sumproduct"`` (default), ``"minsum"``, or a
        constructed :class:`MinSumDecoder` on the same code and device.
      damping: message damping of ``inner="minsum"``.
      device: where the graph tables live and decoding runs; None is the
        current CUDA card.  On a CUDA device the OSD eliminations and the
        min-sum message updates run in the hand-written kernels.
    """

    def __init__(
        self,
        H,
        per: float,
        max_iters: int,
        *,
        osd_order: int = 0,
        osd_method: str = "exhaustive",
        osd_scope: str = "all",
        osd_impl: str = "device",
        fused: bool = False,
        inner=None,
        damping: float = 0.0,
        osd_triples: int = 0,
        device=None,
    ):
        super().__init__()
        if osd_scope not in ("all", "failed"):
            raise ValueError("osd_scope must be 'all' or 'failed'")
        if osd_method not in ("exhaustive", "combination_sweep"):
            raise ValueError(
                f"osd_method must be 'exhaustive' or 'combination_sweep', got {osd_method!r}")
        if osd_impl not in ("device", "host"):
            raise ValueError("osd_impl must be 'device' or 'host'")
        if osd_order < 0:
            raise ValueError("osd_order must be >= 0")
        self.device = resolve_device(device)
        self.graph = as_graph(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = float(per)
        self.max_iters = int(max_iters)
        H_dense = self.graph.require_H()  # OSD always needs dense rows
        if osd_order > 0 and osd_method == "combination_sweep":
            # pair indices past the information set are masked inside the
            # sweep, so lam needs no rank clamp, only a bound on n
            osd_order = min(osd_order, self.n)
        elif osd_order > 0:
            max_order = self.n - _gf2_rank(H_dense)
            if osd_order > max_order:
                # the reference warns and clamps (information-set size)
                warnings.warn(
                    f"osd_order {osd_order} exceeds information-set size "
                    f"{max_order}; clamping.", stacklevel=2)
                osd_order = int(max_order)
        self.osd_order = int(osd_order)
        self.osd_scope = osd_scope
        self.osd_method = osd_method
        self.osd_impl = osd_impl
        self.damping = float(damping)
        if osd_triples and not (osd_impl == "host" and osd_method == "combination_sweep"):
            raise ValueError(
                "osd_triples (order-3 combination sweep) is a host "
                "combination_sweep extension: set osd_impl='host', "
                "osd_method='combination_sweep'")
        self.osd_triples = int(osd_triples)
        self.fused = bool(fused)
        self._Hcols = None
        if osd_impl == "host":
            from ..native import gf2_pack_cols, native_available

            if self.osd_order != 0 and osd_method != "combination_sweep":
                raise ValueError(
                    "osd_impl='host' supports osd_order=0 (exhaustive) or "
                    "any order with osd_method='combination_sweep'")
            if self.fused:
                raise ValueError(
                    "osd_impl='host' is a host round-trip; fused=True cannot trace it")
            if not native_available():
                raise RuntimeError(
                    "the host OSD needs the native library (g++); "
                    "build failed or unavailable on this system")
            self._Hcols = gf2_pack_cols(H_dense)
        self.bp = _make_inner(self.graph, self.per, self.max_iters, inner, self.damping,
                              self.device)
        # the device OSD's tables: the host route packs its own columns
        self.osd = (None if osd_impl == "host" else
                    OSD(self.graph, self.osd_order, device=self.device, osd_method=osd_method))
        self.fused_decode = FusedBPOSD(self.bp, self.osd, osd_scope) if self.fused else None

    def _host_osd0(self, syn_np, bp_np, logp_np):
        """Native OSD on a compacted lane subset (original-order I/O):
        OSD-0 column reduction, or the OSD-CS combination sweep when
        ``osd_method='combination_sweep'`` with ``osd_order`` as the pair
        depth.  The per-lane column order is sort_and_pack's: float32
        reliability max(p, 1-p), stable descending argsort."""
        from ..native import gf2_osd0_host, gf2_osd_cs_host

        with np.errstate(over="ignore"):
            # large LLRs overflow exp to inf exactly as the device path's
            # float32 exp does; inf reliabilities tie and break by index
            probs = np.exp(logp_np.astype(np.float32))
            rel = np.maximum(probs, 1.0 - probs)
        order = np.argsort(-rel, axis=1, kind="stable").astype(np.int32)
        if self.osd_method == "combination_sweep":
            out, _ = gf2_osd_cs_host(self._Hcols, self.m, self.osd_order, order,
                                     bp_np.astype(np.uint8), syn_np.astype(np.uint8),
                                     lam3=self.osd_triples)
        else:
            out, _ = gf2_osd0_host(self._Hcols, self.m, order, bp_np.astype(np.uint8),
                                   syn_np.astype(np.uint8))
        return out.astype(np.int8)

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        prior = None if per is None else self.bp.as_prior(per)
        if self.fused:
            err, converged, iters, logp = self.fused_decode(syndromes, prior)
            return err, converged, iters, {"log_probabs": logp}
        with span("ldpc.bposd.inner"):
            bp_err, converged, iters, logp = self.bp(syndromes, prior)
        aux = {"log_probabs": logp}
        host = self.osd_impl == "host"
        if self.osd_order > 0 and self.osd_scope == "all" and not host:
            corr = self.osd.osdw_batch(syndromes, bp_err, logp)
            return corr.to(torch.int8), converged, iters, aux

        # OSD-0 (and OSD-w under osd_scope="failed"): only lanes whose inner
        # output misses the syndrome need work; the converged flag is
        # exactly that test
        if host and self.osd_order > 0 and self.osd_scope == "all":
            need = np.arange(syndromes.shape[0])
        else:
            (conv_np,) = to_host(converged)
            need = np.flatnonzero(~conv_np)
        if need.size == 0:
            return bp_err, converged, iters, aux
        if host:
            # OSD-0 leaves a lane with nothing to correct as it is, so the
            # converged lanes need no host round trip
            idx = torch.as_tensor(need, device=self.device)
            corr = self._host_osd0(*to_host(syndromes[idx], bp_err[idx], logp[idx].float()))
            out = bp_err.clone()
            out[idx] = to_device(corr, self.device)
            return out, converged, iters, aux
        # pad to a power-of-two bucket (repeats of the first failing lane)
        # so the OSD sees few distinct batch sizes
        bucket = next_pow2(need.size)
        count("osd_dev_lanes", need.size)
        count("osd_dev_lanes_padded", bucket)
        with span("ldpc.bposd.osd"):
            idx = np.concatenate([need, np.repeat(need[:1], bucket - need.size)])
            idx = torch.as_tensor(idx, device=self.device)
            post = self.osd.osd0_batch if self.osd_order == 0 else self.osd.osdw_batch
            corr = post(syndromes[idx], bp_err[idx], logp[idx])
            out = bp_err.clone()
            out[idx[: need.size]] = corr[: need.size].to(torch.int8)
            settle(self.device)
        return out, converged, iters, aux
