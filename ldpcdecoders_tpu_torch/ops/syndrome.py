"""Batched GF(2) syndrome computation.

Counterpart of ``ldpcdecoders_tpu/ops/syndrome.py``.  Two forms, both exact
(LDPC row weights are tiny integers, far inside float32's exact range):

  * dense ``[B, n] @ [n, m]`` float32 matmul, where a dense H is at hand;
  * O(edges) gather + degree-axis sum over the padded adjacency, which
    never materializes H.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["syndrome_of", "SyndromeCheck"]

# Dense-H cutoff: 16M entries is a 64 MB float32 H^T, small beside the
# card's memory and the [B, E] message state, while the matmul replaces a
# max_dc-deep padded gather.  Larger (production-scale) codes never
# densify and take the gather.
_DENSE_SYNDROME_MAX_ELEMS = 16_000_000


def syndrome_of(err: torch.Tensor, Ht: torch.Tensor) -> torch.Tensor:
    """``(err @ H^T) mod 2`` for a ``[B, n]`` float 0/1 batch; ``Ht`` is the
    ``[n, m]`` float 0/1 transpose of H.  Returns ``[B, m]`` float 0/1."""
    return torch.remainder(err @ Ht, 2.0)


class SyndromeCheck(torch.nn.Module):
    """``err [B, n] float 0/1 -> syndrome [B, m] float 0/1`` (the counterpart
    of the reference's ``make_syndrome_fn``).

    Dense matmul for graphs with a dense H up to the cutoff, O(edges)
    gather otherwise.
    """

    def __init__(self, graph, device):
        super().__init__()
        self.m, self.max_dc = graph.m, graph.max_dc
        self.dense = graph.H is not None and graph.m * graph.n <= _DENSE_SYNDROME_MAX_ELEMS
        if self.dense:
            self.register_buffer(
                "Ht", torch.as_tensor(graph.H.T.astype(np.float32), device=device))
        else:
            chk_vars = np.ascontiguousarray(graph.chk_vars.T).reshape(-1)
            self.register_buffer(
                "chk_vars", torch.as_tensor(chk_vars.astype(np.int64), device=device))
            self.register_buffer(
                "chk_mask", torch.as_tensor(np.ascontiguousarray(graph.chk_mask.T),
                                            device=device))

    def forward(self, err: torch.Tensor) -> torch.Tensor:
        if self.dense:
            return syndrome_of(err, self.Ht)
        B = err.shape[0]
        g = err.index_select(1, self.chk_vars).reshape(B, self.max_dc, self.m)
        g = torch.where(self.chk_mask, g, torch.zeros((), dtype=g.dtype, device=g.device))
        return torch.remainder(g.sum(dim=1), 2.0)

