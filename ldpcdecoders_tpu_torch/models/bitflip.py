"""Batched hard-decision iterative bit-flip decoder.

Counterpart of ``ldpcdecoders_tpu/models/bitflip.py`` (the Julia
package's Gallager-B-style decoder, iterative_bitflip.jl:116-157), in
plain torch with the same semantics:

  * each iteration, every variable of an unmatched lane adds its checks'
    votes (+1 for an unsatisfied check, -1 for a satisfied one), and the
    votes accumulate across iterations (the Julia package zeroes them only
    in ``reset!``, iterative_bitflip.jl:84-88: a quirk kept here);
  * the bit with the most votes flips; ties break by one uniform draw per
    (lane, bit, iteration), the first argmax among the tied votes winning;
  * "all votes negative" stops the lane and counts as converged even though
    its syndrome is unmatched (iterative_bitflip.jl:150-153), so
    ``converged`` does not imply a syndrome match.

The reference draws its uniforms with ``jax.random.uniform(fold_in(key,
it))``, which torch cannot reproduce: the port draws ``torch.rand(B, n)``
each iteration from a ``torch.Generator`` that ``seed`` seeds on the
decoder's device.  :class:`BitFlipDecode` also takes the draws from a
caller (``uniforms=``, a callable ``it -> [B, n]``), which is how the tests
feed it the reference's.  The loop stops once every lane is done, which
costs one host read per iteration on a card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.graph import TannerGraph
from ..ops.syndrome import SyndromeCheck
from .base import Decoder, resolve_device
from .bp import as_graph

__all__ = ["BitFlipDecoder", "BitFlipDecode", "make_bitflip_decode_fn"]


class BitFlipDecode(torch.nn.Module):
    """``forward(syndromes [B, m], seed=0, uniforms=None) -> (err int8,
    converged bool, iters int32)`` with the graph's tables as buffers on
    ``device`` (the counterpart of the reference's decode function).

    ``uniforms``, where given, is a callable ``it -> [B, n]`` returning the
    tie-break draws of iteration ``it``; otherwise they come from a
    ``torch.Generator`` on ``device`` seeded with ``seed``.
    """

    def __init__(self, graph: TannerGraph, max_iters: int, *, device):
        super().__init__()
        device = resolve_device(device)
        self.m, self.n, self.max_dv = graph.m, graph.n, graph.max_dv
        self.max_iters = int(max_iters)
        # votes[b, j] sums +/-1 over j's checks: a gather over the
        # variable-side adjacency (slot-major [dv, n]) and a masked sum
        var_chks = np.ascontiguousarray(graph.var_chks.T).reshape(-1)
        self.register_buffer("var_chks", torch.as_tensor(var_chks.astype(np.int64),
                                                         device=device))
        self.register_buffer("var_mask", torch.as_tensor(
            np.ascontiguousarray(graph.var_mask.T), device=device))
        self.syndrome_from = SyndromeCheck(graph, device)

    def votes_from(self, signed_mismatch: torch.Tensor) -> torch.Tensor:
        B = signed_mismatch.shape[0]
        g = signed_mismatch.index_select(1, self.var_chks).reshape(B, self.max_dv, self.n)
        g = torch.where(self.var_mask, g, torch.zeros((), dtype=g.dtype, device=g.device))
        return g.sum(dim=1)  # integer-valued: exact in any order

    def forward(self, syndromes: torch.Tensor, seed: int = 0, uniforms=None):
        B, n, device = syndromes.shape[0], self.n, syndromes.device
        syn_f = syndromes.to(torch.float32)
        if uniforms is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(seed))

            def uniforms(it):
                return torch.rand((B, n), generator=gen, device=device)

        err = torch.zeros((B, n), dtype=torch.float32, device=device)
        votes = torch.zeros((B, n), dtype=torch.float32, device=device)
        done = torch.zeros((B,), dtype=torch.bool, device=device)
        iters = torch.zeros((B,), dtype=torch.int32, device=device)
        cols = torch.arange(n, device=device)
        it = 0
        while it < self.max_iters and not bool(done.all()):
            active = ~done
            syn_hat = self.syndrome_from(err)
            match = (syn_hat == syn_f).all(dim=-1)
            mismatch = (syn_hat != syn_f).to(torch.float32)
            update = active & ~match
            votes = torch.where(update[:, None], votes + self.votes_from(2.0 * mismatch - 1.0),
                                votes)
            maxv = votes.amax(dim=-1)
            stuck = maxv < 0
            r = torch.as_tensor(uniforms(it), dtype=torch.float32, device=device)
            score = torch.where(votes == maxv[:, None], r, -1.0)
            flip = (cols == score.argmax(dim=-1)[:, None]).to(torch.float32)
            do_flip = update & ~stuck
            err = torch.where(do_flip[:, None], (err - flip).abs(), err)
            newly_done = active & (match | stuck)
            iters = torch.where(newly_done, it + 1, iters)
            done = done | newly_done
            it += 1
        iters = torch.where(done, iters, it).to(torch.int32)
        return err.to(torch.int8), done, iters


def make_bitflip_decode_fn(graph: TannerGraph, max_iters: int, *, device=None) -> BitFlipDecode:
    """The decode module: ``(syndromes [B, m], seed=0, uniforms=None) ->
    (err, converged, iters)``."""
    return BitFlipDecode(graph, max_iters, device=device)


class BitFlipDecoder(Decoder):
    """Iterative bit-flip decoder with stochastic argmax tie-breaking.

    Args:
      H: ``[m, n]`` parity-check matrix, or a compiled TannerGraph.
      per: physical error rate (kept for API parity with the Julia
        constructor, iterative_bitflip.jl:61; the algorithm never reads it).
      max_iters: maximum flip iterations.
      device: where decoding runs; None is the current CUDA card.

    ``converged`` is True when the syndrome matched *or* when no bit had a
    non-negative vote ("nothing worth flipping"); decoding is stochastic,
    so exact outputs depend on ``seed``.  Per-call prior overrides are
    refused: the algorithm has no prior.
    """

    converged_implies_syndrome_match = False
    supports_per_override = False
    supports_vector_prior = False

    def __init__(self, H, per: float = 0.0, max_iters: int = 100, *, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.graph = as_graph(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = float(per)
        self.max_iters = int(max_iters)
        self.bitflip = make_bitflip_decode_fn(self.graph, self.max_iters, device=self.device)

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        err, converged, iters = self.bitflip(syndromes, seed)
        return err, converged, iters, {}
