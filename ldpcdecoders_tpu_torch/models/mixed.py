"""Combined erasure + bit-flip channel decoder (peel, then prior-BP).

Counterpart of ``ldpcdecoders_tpu/models/mixed.py``.  A fraction of the
bits arrive erased (known location, unknown value) while the rest see
bit flips.  Two stages:

1. parallel leaf peeling (models/peeling.py): a lane whose syndrome is
   explained inside its erasure finishes here;
2. lanes peeling cannot finish (a stopping set, or a residual syndrome
   from real flips) go through belief propagation with per-lane ``[B, n]``
   priors, the erased bits neutral (LLR 0 / probability ratio 1):
   ``MinSumDecode`` (the K3/K4 kernels on a card) or ``BPDecode``.  With
   ``osd_order``, lanes BP cannot close get the OSD of ``models/bposd.py``
   on BP's soft output: K1 (OSD-0) or K2 and the sweep, each with its
   device-memory body for lanes past a block.

The reference gates the BP stage and the OSD behind ``lax.cond``; here
each gate is one host read ("every lane peeled clean", "every BP lane
converged"), and the stage runs on the whole batch as there, so the
outputs are the reference's.

API note: decoding needs the erasure mask beside the syndrome, so this
class does not subclass ``Decoder``: ``batch_decode(syndromes, erasures)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.graph import TannerGraph
from ..ops.syndrome import SyndromeCheck
from .base import resolve_device
from .bp import BPDecode
from .bposd import make_osd_fns
from .minsum import MinSumDecode
from .peeling import PeelCore, graph_of
from .priors import validate_per

__all__ = ["MixedChannelDecoder", "MixedDecode", "make_mixed_decode_fn"]

_ALGORITHMS = ("minsum", "sumproduct")
_STRATEGIES = ("peel+bp", "bp")


class MixedDecode(torch.nn.Module):
    """``forward(syndromes [B, m], erasures [B, n], prior [B, n]) -> (err
    int8, ok bool, peel_rounds int32 [B], bp_iters int)`` (the reference's
    ``make_mixed_decode_fn``).

    ``prior`` is in the BP algorithm's native domain (LLR for min-sum,
    probability ratio for sum-product) with the erased positions already
    neutral.  ``peel_rounds`` is 0 under ``strategy="bp"``; ``bp_iters``
    (the most iterations of any lane) is 0 for a batch that peeled clean.
    ``osd_ran`` records whether the last call ran the OSD.
    """

    def __init__(self, graph: TannerGraph, p_flip, max_iters: int, *, device,
                 algorithm: str = "minsum", strategy: str = "peel+bp", alpha: float = 1.0,
                 beta: float = 0.0, dtype=torch.float32, max_rounds: int | None = None,
                 osd_order: int | None = None):
        super().__init__()
        if algorithm not in _ALGORITHMS:
            raise ValueError(f"algorithm must be one of {_ALGORITHMS}, got {algorithm!r}")
        if strategy not in _STRATEGIES:
            raise ValueError(f"strategy must be one of {_STRATEGIES}, got {strategy!r}")
        device = resolve_device(device)
        self.n = graph.n
        self.strategy = strategy
        self.dtype = dtype
        if algorithm == "minsum":
            self.bp = MinSumDecode(graph, p_flip, max_iters, device=device, alpha=alpha,
                                   beta=beta, dtype=dtype)
        else:
            self.bp = BPDecode(graph, p_flip, max_iters, device=device, dtype=dtype)
        self.peel = PeelCore(graph, max_rounds, device=device) if strategy == "peel+bp" else None
        self.osd_post = None
        if osd_order is not None:
            osd0_batch, osdw_batch = make_osd_fns(graph, int(osd_order), device=device)
            self.osd_post = osd0_batch if int(osd_order) == 0 else osdw_batch
            self.syndrome_from = SyndromeCheck(graph, device)
        self.osd_ran = False

    def run_bp(self, syndromes, prior):
        err_b, ok_b, iters, soft = self.bp(syndromes, prior)
        err_b = err_b.to(torch.int8)
        if self.osd_post is not None and not bool(ok_b.all()):  # the gate
            self.osd_ran = True
            # min-sum's soft output is the LLR log(p0/p1), sum-product's
            # log(1/total): the same quantity, one reliability sort for both
            corr = self.osd_post(syndromes, err_b, soft.to(torch.float32)).to(torch.int8)
            merged = torch.where(ok_b[:, None], err_b, corr)
            ok_b = (self.syndrome_from(merged.to(torch.float32))
                    == syndromes.to(torch.float32)).all(dim=1)
            err_b = merged
        return err_b, ok_b, int(iters.max()) if iters.numel() else 0

    def forward(self, syndromes, erasures, prior):
        B, n, device = syndromes.shape[0], self.n, syndromes.device
        prior = torch.broadcast_to(torch.as_tensor(prior, device=device).to(self.dtype), (B, n))
        self.osd_ran = False
        if self.strategy == "bp":
            err, ok, it = self.run_bp(syndromes, prior)
            return err, ok, torch.zeros((B,), dtype=torch.int32, device=device), it
        err_p, eps_left, s_res, depth = self.peel(syndromes, erasures)
        # a lane is done iff peeling consumed its whole erasure AND the
        # residual syndrome closed: any real flip leaves s_res != 0
        ok_p = ~eps_left.any(dim=1) & (s_res == 0).all(dim=1)
        if bool(ok_p.all()):  # the gate: a batch that peeled clean skips BP
            err_b = torch.zeros((B, n), dtype=torch.int8, device=device)
            ok_b = torch.zeros((B,), dtype=torch.bool, device=device)
            bp_iters = 0
        else:
            err_b, ok_b, bp_iters = self.run_bp(syndromes, prior)
        err = torch.where(ok_p[:, None], err_p.to(torch.int8), err_b)
        return err, ok_p | ok_b, depth, bp_iters


def make_mixed_decode_fn(graph: TannerGraph, p_flip, max_iters: int, *, device=None, **kw):
    """The mixed-channel decode (reference ``make_mixed_decode_fn``)."""
    return MixedDecode(graph, p_flip, max_iters, device=device, **kw)


class MixedChannelDecoder(torch.nn.Module):
    """Decoder for the mixed erasure + bit-flip channel.

    Args:
      H: parity-check matrix (dense 0/1, scipy.sparse, or ``TannerGraph``;
        dense-free ``from_edges`` graphs work without ``osd_order``).
      p_flip: bit-flip probability of non-erased bits (scalar or ``[n]``).
      max_iters: BP iteration cap of the fallback stage.
      algorithm: ``"minsum"`` (default; ``alpha``/``beta``/``dtype``
        apply) or ``"sumproduct"``.
      strategy: ``"peel+bp"`` (default) or ``"bp"`` (prior-BP only).
      max_rounds: cap on peeling rounds (default n).
      osd_order: if set (needs a dense H), the OSD completes the lanes BP
        cannot close (0 = OSD-0).
      device: where decoding runs; None is the current CUDA card.
    """

    def __init__(self, H, p_flip, max_iters: int, *, algorithm: str = "minsum",
                 strategy: str = "peel+bp", alpha: float = 1.0, beta: float = 0.0,
                 dtype=torch.float32, max_rounds: int | None = None,
                 osd_order: int | None = None, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.graph = graph_of(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.p_flip = p_flip if np.ndim(p_flip) else float(p_flip)
        self.max_iters = int(max_iters)
        self.algorithm = algorithm
        self.strategy = strategy
        self.osd_order = osd_order
        self.mixed = MixedDecode(self.graph, self.p_flip, self.max_iters, device=self.device,
                                 algorithm=algorithm, strategy=strategy, alpha=alpha, beta=beta,
                                 dtype=dtype, max_rounds=max_rounds, osd_order=osd_order)

    def _native_prior(self, erasures: np.ndarray, per) -> np.ndarray:
        """Flip probabilities -> per-lane prior in the BP-native domain,
        with the erased positions neutral (LLR 0 / ratio 1)."""
        p = validate_per(self.p_flip if per is None else per, self.n)
        p = np.broadcast_to(p, erasures.shape).astype(np.float64)
        if self.algorithm == "minsum":
            native = np.where(erasures, 0.0, np.log((1.0 - p) / p))
        else:
            native = np.where(erasures, 1.0, p / (1.0 - p))
        return native.astype(np.float32)  # the decode casts to the BP dtype

    def batch_decode_detailed(self, syndromes, erasures, *, per=None):
        """``(errors [B, n] int8, ok [B] bool, peel_rounds [B], bp_iters)``."""
        syndromes, erasures = np.asarray(syndromes), np.asarray(erasures)
        if syndromes.ndim != 2 or syndromes.shape[1] != self.m:
            raise ValueError(
                f"expected syndromes of shape [B, {self.m}], got {syndromes.shape}")
        if erasures.shape != (syndromes.shape[0], self.n):
            raise ValueError(
                f"expected erasures of shape [B={syndromes.shape[0]}, {self.n}], "
                f"got {erasures.shape}")
        prior = self._native_prior(erasures.astype(bool), per)
        dev = self.device
        err, ok, rounds, bp_iters = self.mixed(torch.as_tensor(syndromes, device=dev),
                                               torch.as_tensor(erasures, device=dev),
                                               torch.as_tensor(prior, device=dev))
        return err.cpu().numpy(), ok.cpu().numpy(), rounds.cpu().numpy(), int(bp_iters)

    def batch_decode(self, syndromes, erasures, *, per=None):
        """Decode ``[B, m]`` syndromes with ``[B, n]`` erasure masks; ``per``
        optionally overrides the flip probability (scalar, ``[n]`` or
        ``[B, n]``).  Returns ``(errors [B, n] int8, ok [B] bool)``."""
        err, ok, _, _ = self.batch_decode_detailed(syndromes, erasures, per=per)
        return err, ok

    def decode(self, syndrome, erasure, *, per=None):
        """Single-syndrome convenience; returns ``(error [n] int8, ok)``."""
        err, ok = self.batch_decode(np.asarray(syndrome)[None], np.asarray(erasure)[None],
                                    per=per)
        return err[0], bool(ok[0])
