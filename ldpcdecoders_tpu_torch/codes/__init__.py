from .bicycle import (
    BICYCLE_CODES,
    bb_poly_matrix,
    bivariate_bicycle_code,
    css_code_k,
    named_bicycle_code,
)
from .circuit import (
    StabilizerCircuit,
    circuit_dem,
    css_memory_circuit,
    dem_text,
    sample_circuit,
)
from .css import (
    cycle_matrix,
    hamming_code,
    hypergraph_product,
    hypergraph_product_edges,
    repetition_code,
    surface_code_x,
    surface_code_z,
    toric_code_x,
    toric_code_z,
)
from .gallager import parity_check_matrix
from .graph import TannerGraph
from .qc import (
    load_base_matrix,
    qc_group_lift_edges,
    qc_lift,
    qc_lift_edges,
    random_qc_base_matrix,
    save_base_matrix,
)
from .spacetime import detectors_of, spacetime_pcm, spacetime_prior

__all__ = [
    "parity_check_matrix",
    "TannerGraph",
    "qc_lift",
    "qc_lift_edges",
    "qc_group_lift_edges",
    "random_qc_base_matrix",
    "save_base_matrix",
    "load_base_matrix",
    "BICYCLE_CODES",
    "bb_poly_matrix",
    "bivariate_bicycle_code",
    "css_code_k",
    "named_bicycle_code",
    "spacetime_pcm",
    "spacetime_prior",
    "detectors_of",
    "toric_code_x",
    "toric_code_z",
    "surface_code_x",
    "surface_code_z",
    "repetition_code",
    "cycle_matrix",
    "hamming_code",
    "hypergraph_product",
    "hypergraph_product_edges",
    "StabilizerCircuit",
    "css_memory_circuit",
    "circuit_dem",
    "dem_text",
    "sample_circuit",
]
