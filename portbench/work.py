"""The yardstick of the roofline metrics: the card's peaks and the least work
one lane-iteration of min-sum needs, whatever the implementation.

Peaks are NVIDIA's data sheet for one H100 SXM at its full power limit of
700 W (dense, no sparsity): 3.35 TB/s of HBM and 67 TFLOP/s of float32 off
the tensor cores.

One lane-iteration of min-sum on a code of ``E`` edges, ``n`` variables and
``m`` checks carries its state from one iteration to the next: a message per
edge and a total per variable, each read once and written once at the
message dtype, and the syndrome read once (a byte a check).  Its operations
are counted per edge as the kernels' bounds count them: 19 for the damped
check update (the rebuild ``total - mu``, the damping mix, the two-minimum
and sign sweep, the output) and 1 for the variable sum; 14 and 4 undamped.
The least time is the larger of the bytes over the bandwidth and the
operations over the float32 rate.
"""

from __future__ import annotations

__all__ = ["PEAK_BYTES_PER_S", "PEAK_F32_OPS_PER_S", "minsum_lane_iteration"]

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def minsum_lane_iteration(edges: int, n: int, m: int, dtype_bytes: int, damped: bool):
    """``(bytes, operations, least seconds)`` of one lane-iteration."""
    nbytes = 2 * (edges + n) * dtype_bytes + m
    ops = (19 + 1 if damped else 14 + 4) * edges
    return nbytes, ops, max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S)
