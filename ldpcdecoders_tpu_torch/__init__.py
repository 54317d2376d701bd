"""ldpcdecoders_tpu_torch — the LDPC decoders on PyTorch and CUDA (NVIDIA Hopper).

A port of ``ldpcdecoders_tpu`` (JAX on a TPU), which stays the reference it
is tested against.  This package imports torch and numpy, never jax.  It
carries the sum-product BP, min-sum, BP+OSD (OSD-0, OSD-w, OSD-CS, and the
native host OSD of ``native/``), bit-flip, BP-OTS, quasi-cyclic, CSS,
space-time and circuit-level decode paths (detector error models, the
ensemble and the staged production decoder), with ``DecoderConfig``, and
the evaluation harness (``harness.py``: FER sweeps with checkpoints, CSS,
space-time and detector-model logical-error sweeps): Gallager,
quasi-cyclic, bivariate bicycle and CSS codes, syndrome-extraction circuits
and their detector error models, Tanner-graph compilation, batched BP in
plain torch, and the min-sum message updates, the OSD eliminations and the whole
decode of a group-circulant code as hand-written CUDA kernels (``csrc/``,
built with nvcc at first use on a CUDA device).  Decoders run on the
current CUDA card unless built with ``device="cpu"``.
"""

from .codes import (
    BICYCLE_CODES,
    StabilizerCircuit,
    TannerGraph,
    bb_poly_matrix,
    bivariate_bicycle_code,
    circuit_dem,
    css_code_k,
    css_memory_circuit,
    cycle_matrix,
    dem_text,
    detectors_of,
    hamming_code,
    hypergraph_product,
    hypergraph_product_edges,
    load_base_matrix,
    named_bicycle_code,
    parity_check_matrix,
    qc_lift,
    qc_lift_edges,
    random_qc_base_matrix,
    repetition_code,
    sample_circuit,
    save_base_matrix,
    spacetime_pcm,
    spacetime_prior,
    surface_code_x,
    surface_code_z,
    toric_code_x,
    toric_code_z,
)
from .config import DecoderConfig
from .models import (
    BeliefPropagationDecoder,
    BeliefPropagationOSDDecoder,
    BitFlipDecoder,
    BPOTSDecoder,
    CSSDecoder,
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
    "toric_code_x",
    "toric_code_z",
    "surface_code_x",
    "surface_code_z",
    "repetition_code",
    "cycle_matrix",
    "hamming_code",
    "hypergraph_product",
    "hypergraph_product_edges",
    "bb_poly_matrix",
    "BICYCLE_CODES",
    "bivariate_bicycle_code",
    "css_code_k",
    "named_bicycle_code",
    "spacetime_pcm",
    "spacetime_prior",
    "detectors_of",
    "StabilizerCircuit",
    "css_memory_circuit",
    "circuit_dem",
    "dem_text",
    "sample_circuit",
    "Decoder",
    "DecodeStats",
    "decode",
    "batchdecode",
    "decode_soft",
    "BeliefPropagationDecoder",
    "BeliefPropagationOSDDecoder",
    "BitFlipDecoder",
    "BPOTSDecoder",
    "CSSDecoder",
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
