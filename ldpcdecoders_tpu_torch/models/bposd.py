"""Batched BP + Ordered-Statistics-Decoding (OSD) decoder.

Counterpart of ``ldpcdecoders_tpu/models/bposd.py``:

  * inner BP is the batched sum-product decoder (models/bp.py), whose log
    probabilities rank column reliability;
  * per lane, the columns of H are sorted most-reliable-first and
    bit-packed on the device (:meth:`OSD.sort_and_pack`);
  * OSD-0 runs only on the lanes whose BP output misses the syndrome: the
    host gathers them into a power-of-two bucket, the OSD-0 kernel
    (ops/cuda_gf2.py ``gf2_osd0_cuda``) decodes them, and the result is
    scattered back;
  * OSD-w (w > 0) runs on every lane: the Gauss–Jordan kernel
    (``gf2_eliminate_cuda``) reduces each system and the 2^w sweep
    (ops/gf2.py ``osdw_sweep``) picks the lightest completion.

``converged`` reports BP convergence; the returned error estimate is
always syndrome-consistent for OSD-0, and for OSD-w whenever H's rows span
the syndrome.

Not carried over yet: ``fused``, ``osd_scope="failed"``,
``osd_method="combination_sweep"``, ``osd_impl="host"``, ``inner=`` and
``damping``; they raise ``NotImplementedError``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..ops.cuda_gf2 import gf2_eliminate_cuda, gf2_osd0_cuda
from ..ops.gf2 import osdw_sweep, wrap_int32
from .base import Decoder, resolve_device
from .bp import BPDecode, as_graph
from .priors import next_pow2

__all__ = ["BeliefPropagationOSDDecoder", "OSD", "make_osd_fns"]


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

    def __init__(self, graph, osd_order: int, *, device):
        super().__init__()
        H = graph.require_H()
        self.m, self.n, self.osd_order = graph.m, graph.n, int(osd_order)
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
        perm, Ht, bp_sorted = self.sort_and_pack(bp_err, logp)
        # residual syndrome of bp_err; small-integer row sums are exact in f32
        hb = bp_err.to(torch.float32) @ self.H_cols_f
        resid = (syndromes.to(torch.int32) ^ (hb.to(torch.int32) & 1)).contiguous()
        corr = gf2_osd0_cuda(Ht, resid, bp_sorted, self.n)
        return self.unsort(perm, corr)

    def osdw_batch(self, syndromes, bp_err, logp):
        perm, Ht, bp_sorted = self.sort_and_pack(bp_err, logp)
        s = syndromes.to(torch.int32).contiguous()
        Ht2, s2, piv = gf2_eliminate_cuda(Ht, s, self.n)
        r = (piv != self.n).sum(dim=1)
        corr = osdw_sweep(Ht2, s2, piv, r, bp_sorted, self.osd_order, self.n)
        return self.unsort(perm, corr)


def make_osd_fns(graph, osd_order: int, *, device):
    """``(osd0_batch, osdw_batch)`` for ``graph`` (counterpart of the
    reference's ``make_osd_fns``)."""
    osd = OSD(graph, osd_order, device=device)
    return osd.osd0_batch, osd.osdw_batch


class BeliefPropagationOSDDecoder(Decoder):
    """BP with OSD post-processing; output is always syndrome-consistent.

    Args:
      H: ``[m, n]`` parity-check matrix, or a compiled TannerGraph.
      per: physical error rate.
      max_iters: maximum BP iterations.
      osd_order: OSD order w (default 0); the sweep scales as 2^w.
      osd_method: only ``"exhaustive"`` (the reference's 2^w sweep).
      osd_scope: only ``"all"``: with osd_order > 0 the sweep runs on
        every lane.
      device: where the graph tables live and decoding runs.  On a CUDA
        device the OSD eliminations run in the hand-written kernels.
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
        device="cpu",
    ):
        super().__init__()
        if osd_scope not in ("all", "failed"):
            raise ValueError("osd_scope must be 'all' or 'failed'")
        if osd_method not in ("exhaustive", "combination_sweep"):
            raise ValueError(
                f"osd_method must be 'exhaustive' or 'combination_sweep', got {osd_method!r}")
        if osd_impl not in ("device", "host"):
            raise ValueError("osd_impl must be 'device' or 'host'")
        unported = {
            "fused=True": fused,
            "osd_scope='failed'": osd_scope != "all",
            "osd_method='combination_sweep'": osd_method != "exhaustive",
            "osd_impl='host'": osd_impl != "device",
            "inner=": inner not in (None, "sumproduct"),
            "damping": bool(damping),
        }
        missing = [k for k, v in unported.items() if v]
        if missing:
            raise NotImplementedError(
                f"{', '.join(missing)}: not ported to ldpcdecoders_tpu_torch yet")
        if osd_order < 0:
            raise ValueError("osd_order must be >= 0")
        self.device = resolve_device(device)
        self.graph = as_graph(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = float(per)
        self.max_iters = int(max_iters)
        H_dense = self.graph.require_H()  # OSD always needs dense rows
        if osd_order > 0:
            max_order = self.n - _gf2_rank(H_dense)
            if osd_order > max_order:
                # the reference warns and clamps (information-set size)
                warnings.warn(
                    f"osd_order {osd_order} exceeds information-set size "
                    f"{max_order}; clamping.", stacklevel=2)
                osd_order = int(max_order)
        self.osd_order = int(osd_order)
        self.bp = BPDecode(self.graph, self.per, self.max_iters, device=self.device)
        self.osd = OSD(self.graph, self.osd_order, device=self.device)

    def _decode_batch(self, syndromes, per=None):
        ratio = None if per is None else self.bp.as_ratio(per)
        bp_err, converged, iters, logp = self.bp(syndromes, ratio)
        aux = {"log_probabs": logp}
        if self.osd_order > 0:
            corr = self.osd.osdw_batch(syndromes, bp_err, logp)
            return corr.to(torch.int8), converged, iters, aux

        # OSD-0: only lanes whose BP output misses the syndrome need work;
        # BP's converged flag is exactly that test
        need = np.flatnonzero(~converged.cpu().numpy())
        if need.size == 0:
            return bp_err, converged, iters, aux
        # pad to a power-of-two bucket (repeats of the first failing lane)
        # so the OSD sees few distinct batch sizes
        bucket = next_pow2(need.size)
        idx = np.concatenate([need, np.repeat(need[:1], bucket - need.size)])
        idx = torch.as_tensor(idx, device=self.device)
        corr = self.osd.osd0_batch(syndromes[idx], bp_err[idx], logp[idx])
        out = bp_err.clone()
        out[idx[: need.size]] = corr[: need.size].to(torch.int8)
        return out, converged, iters, aux
