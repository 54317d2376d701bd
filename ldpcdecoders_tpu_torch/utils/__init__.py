from .debug import check_decode_invariants, validate_inputs
from .io import (
    atomic_write_json,
    load_code_npz,
    load_graph_npz,
    read_json,
    save_code_npz,
    save_graph_npz,
)
from .metrics import (
    css_logical_operators,
    exact_recovery_ler,
    gf2_kernel_basis,
    gf2_rowspan_reducer,
    logical_failure_rate,
    syndrome_match_rate,
    wilson_interval,
)
from .noise import (
    sample_errors,
    sample_errors_device,
    sample_mixed_channel,
    syndromes_from_edges,
    syndromes_of,
    verify_decodes,
)
from .profiling import annotate, trace

__all__ = [
    "sample_errors",
    "syndromes_of",
    "syndromes_from_edges",
    "sample_errors_device",
    "sample_mixed_channel",
    "verify_decodes",
    "exact_recovery_ler",
    "syndrome_match_rate",
    "wilson_interval",
    "gf2_rowspan_reducer",
    "gf2_kernel_basis",
    "css_logical_operators",
    "logical_failure_rate",
    "save_code_npz",
    "load_code_npz",
    "save_graph_npz",
    "load_graph_npz",
    "atomic_write_json",
    "read_json",
    "validate_inputs",
    "check_decode_invariants",
    "trace",
    "annotate",
]
