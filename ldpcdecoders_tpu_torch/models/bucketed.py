"""Bucketed serving wrapper: arbitrary batch sizes, few distinct shapes.

Counterpart of ``ldpcdecoders_tpu/models/bucketed.py``.  The reference pads
each request to a power-of-two bucket so that XLA compiles one program per
bucket.  PyTorch compiles nothing per shape, but the wrapper is public API
and serving code depends on its behaviour: each request is padded up to the
next power-of-two bucket (at least ``min_bucket``; requests past
``max_bucket`` run in ``max_bucket`` chunks), the pad lanes decode the
all-zero syndrome and are stripped, and chunk ``k`` decodes with seed
``seed + k``.  Its outputs equal the inner decoder's on the same lanes
wherever the inner decodes lanes independently.
"""

from __future__ import annotations

import torch

from .base import Decoder
from .priors import next_pow2

__all__ = ["BucketedDecoder"]


class BucketedDecoder(Decoder):
    """Wrap a decoder with power-of-two batch bucketing.

    Args:
      inner: any decoder of this package.
      min_bucket: smallest bucket (small requests pad up to this).
      max_bucket: largest single-call batch; bigger requests run in
        ``max_bucket`` chunks.
    """

    def __init__(self, inner: Decoder, *, min_bucket: int = 32, max_bucket: int = 4096):
        super().__init__()
        self.inner = inner
        self.graph = inner.graph
        self.m, self.n = inner.m, inner.n
        self.device = inner.device
        self.converged_implies_syndrome_match = inner.converged_implies_syndrome_match
        self.supports_per_override = inner.supports_per_override
        self.supports_vector_prior = inner.supports_vector_prior
        if min_bucket < 1 or max_bucket < min_bucket:
            raise ValueError("need 1 <= min_bucket <= max_bucket")
        self.min_bucket = next_pow2(min_bucket)
        self.max_bucket = next_pow2(max_bucket)

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        B, device = syndromes.shape[0], syndromes.device
        errs = torch.zeros((B, self.n), dtype=torch.int8, device=device)
        conv = torch.zeros((B,), dtype=torch.bool, device=device)
        iters = torch.zeros((B,), dtype=torch.int32, device=device)
        aux_parts: list[dict] = []
        start = chunk_idx = 0
        while start < B:
            size = min(B - start, self.max_bucket)
            bucket = min(max(self.min_bucket, next_pow2(size)), self.max_bucket)
            chunk = syndromes[start:start + size]
            if bucket > size:
                pad = torch.zeros((bucket - size, self.m), dtype=chunk.dtype, device=device)
                chunk = torch.cat([chunk, pad], dim=0)
            e, c, it, aux = self.inner._call_decode(chunk, seed + chunk_idx, per)
            errs[start:start + size] = e[:size].to(torch.int8)
            conv[start:start + size] = c[:size]
            iters[start:start + size] = it[:size].to(torch.int32)
            aux_parts.append({k: v[:size] for k, v in aux.items()})
            start += size
            chunk_idx += 1
        merged = {}
        if aux_parts and aux_parts[0]:
            merged = {k: torch.cat([p[k] for p in aux_parts], dim=0) for k in aux_parts[0]}
        return errs, conv, iters, merged
