"""ldpcdecoders_tpu_torch — the LDPC decoders on PyTorch and CUDA (NVIDIA Hopper).

A port of ``ldpcdecoders_tpu`` (JAX on a TPU), which stays the reference it
is tested against.  This package imports torch and numpy, never jax.  It
carries the sum-product BP, min-sum and BP+OSD decode paths: Gallager
codes, Tanner-graph compilation, batched BP in plain torch, and the
min-sum message updates and the OSD eliminations as hand-written CUDA
kernels (``csrc/``, built with nvcc at first use on a CUDA device).
Decoders run on the current CUDA card unless built with ``device="cpu"``.
"""

from .codes import TannerGraph, parity_check_matrix
from .models import (
    BeliefPropagationDecoder,
    BeliefPropagationOSDDecoder,
    DecodeStats,
    Decoder,
    MinSumDecode,
    MinSumDecoder,
    batchdecode,
    decode,
    decode_soft,
)

__all__ = [
    "parity_check_matrix",
    "TannerGraph",
    "Decoder",
    "DecodeStats",
    "decode",
    "batchdecode",
    "decode_soft",
    "BeliefPropagationDecoder",
    "BeliefPropagationOSDDecoder",
    "MinSumDecoder",
    "MinSumDecode",
]

__version__ = "0.1.0"
