"""ldpcdecoders_tpu_torch — the LDPC decoders on PyTorch and CUDA (NVIDIA Hopper).

A port of ``ldpcdecoders_tpu`` (JAX on a TPU), which stays the reference it
is tested against.  This package imports torch and numpy, never jax.  It
carries the sum-product BP, min-sum, BP+OSD (OSD-0, OSD-w, OSD-CS, and the
native host OSD of ``native/``), quasi-cyclic, space-time and circuit-level
decode paths (detector error models, the ensemble and the staged
production decoder), with ``DecoderConfig``: Gallager, quasi-cyclic and
bivariate bicycle codes, Tanner-graph compilation, batched BP in plain
torch, and the min-sum message updates, the OSD eliminations and the whole
decode of a group-circulant code as hand-written CUDA kernels (``csrc/``,
built with nvcc at first use on a CUDA device).  Decoders run on the
current CUDA card unless built with ``device="cpu"``.
"""

from .codes import (
    TannerGraph,
    bivariate_bicycle_code,
    css_code_k,
    detectors_of,
    load_base_matrix,
    named_bicycle_code,
    parity_check_matrix,
    qc_lift,
    qc_lift_edges,
    random_qc_base_matrix,
    save_base_matrix,
    spacetime_pcm,
    spacetime_prior,
)
from .config import DecoderConfig
from .models import (
    BeliefPropagationDecoder,
    BeliefPropagationOSDDecoder,
    DecodeStats,
    Decoder,
    DetectorGraphDecoder,
    EnsembleDecoder,
    MinSumDecode,
    MinSumDecoder,
    QCMinSumDecoder,
    SpaceTimeDecoder,
    StagedDemDecoder,
    batchdecode,
    decode,
    decode_soft,
    load_dem,
)

__all__ = [
    "parity_check_matrix",
    "TannerGraph",
    "qc_lift",
    "qc_lift_edges",
    "random_qc_base_matrix",
    "save_base_matrix",
    "load_base_matrix",
    "bivariate_bicycle_code",
    "css_code_k",
    "named_bicycle_code",
    "spacetime_pcm",
    "spacetime_prior",
    "detectors_of",
    "Decoder",
    "DecodeStats",
    "decode",
    "batchdecode",
    "decode_soft",
    "BeliefPropagationDecoder",
    "BeliefPropagationOSDDecoder",
    "MinSumDecoder",
    "MinSumDecode",
    "QCMinSumDecoder",
    "SpaceTimeDecoder",
    "DetectorGraphDecoder",
    "load_dem",
    "EnsembleDecoder",
    "StagedDemDecoder",
    "DecoderConfig",
]

__version__ = "0.1.0"
