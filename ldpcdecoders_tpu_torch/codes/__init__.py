from .bicycle import (
    BICYCLE_CODES,
    bb_poly_matrix,
    bivariate_bicycle_code,
    css_code_k,
    named_bicycle_code,
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
]
