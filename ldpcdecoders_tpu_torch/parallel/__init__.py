"""SPMD and multi-process decoding on ``torch.distributed`` (counterpart of
``ldpcdecoders_tpu/parallel``): process meshes, batch-, check- and
QC-sharded decodes, the staged tier across ranks, and reduced counts."""

from .mesh import batch_sharding, make_mesh, shard_batch
from .multihost import allreduce_counts, global_mesh, initialize_multihost
from .spmd import (
    decode_with_stats,
    make_check_sharded_minsum_fn,
    make_check_sharded_sumproduct_fn,
    make_qc_sharded_decode_fn,
    sharded_batch_decode,
    sharded_mixed_decode,
)
from .staged import sharded_staged_decode, staged_local_eval

__all__ = [
    "make_mesh",
    "batch_sharding",
    "shard_batch",
    "sharded_batch_decode",
    "decode_with_stats",
    "sharded_mixed_decode",
    "make_check_sharded_minsum_fn",
    "make_check_sharded_sumproduct_fn",
    "make_qc_sharded_decode_fn",
    "initialize_multihost",
    "global_mesh",
    "allreduce_counts",
    "sharded_staged_decode",
    "staged_local_eval",
]
