"""Device-memory budgets for batch and bucket sizing.

Counterpart of ``ldpcdecoders_tpu/utils/hbm.py``.  The staged decoder
(models/staged.py) derives its stage-0 batch and straggler-bucket ceilings
from the card's memory instead of fixed constants:

  * :func:`device_hbm_bytes`: the card's memory, from
    ``torch.cuda.mem_get_info``; half of host RAM for the CPU.
    ``hbm_bytes=`` forces the answer.
  * :func:`minsum_bytes_per_lane`: the peak-memory model of one batch lane
    of a min-sum decode: the variable-side messages ``[max_dv, n]`` and the
    check-side ``[max_dc, m]`` in the message dtype, times a headroom
    factor for what else is alive (the state, the syndrome check's
    temporaries), measured on the card (3.25; the reference's is 1.25).
  * :func:`max_lanes_for`: the largest power-of-two lane count a budget
    fraction admits;
  * :func:`gf2_workspace_lanes`: how many lanes of the OSD-0 elimination's
    device-memory body one workspace may hold (``ops/cuda_gf2.py``: a lane
    past a block is copied into device memory, ``4 * W * m`` bytes, beside
    a pivot column a row, ``4 * m``).
"""

from __future__ import annotations

import os

import torch

__all__ = [
    "device_hbm_bytes",
    "minsum_bytes_per_lane",
    "max_lanes_for",
    "gf2_workspace_lanes",
]

#: live memory of a min-sum decode over the model's two message arrays.
#: The reference's 1.25 (its compiler fuses the iteration) underestimates
#: the port's decode.  On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
#: PERF.md) the bb144 R=6 DEM peaked at 1.80x the message bytes for a
#: float32 stage-0 batch of 2048 lanes and 3.01x for a bfloat16 deep bucket
#: of 6 x 256 lanes (check layout: mu and nu, the totals, and the syndrome
#: check's float32 gathers, which do not shrink with the message type).
#: The fused iteration dropped the damping's temporaries: 2.66x and 3.86x
#: before, when this was 4.0
_HEADROOM = 3.25


def device_hbm_bytes(device=None, *, hbm_bytes: int | None = None) -> int:
    """Memory in bytes of ``device`` (None: the current CUDA card).
    ``hbm_bytes`` forces the answer."""
    if hbm_bytes is not None:
        return int(hbm_bytes)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return int(total)
    # half of host RAM: the CPU's memory is shared with everything else
    return int(0.5 * os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


def minsum_bytes_per_lane(graph, dtype_bytes: int = 4) -> float:
    """Peak-memory estimate of ONE batch lane of a min-sum decode over
    ``graph`` (see the module docstring)."""
    return _HEADROOM * dtype_bytes * (graph.max_dv * graph.n + graph.max_dc * graph.m)


def max_lanes_for(graph, *, dtype_bytes: int = 4, fraction: float = 0.85,
                  device=None, hbm_bytes: int | None = None,
                  lo: int = 32, hi: int = 16384) -> int:
    """Largest power-of-two lane count whose modeled peak fits within
    ``fraction`` of the device budget, clamped to ``[lo, hi]``.

    ``fraction`` < 1 leaves room for the decode's other residents.
    Returns at least ``lo`` even when the model says otherwise (a too-small
    cap deadlocks batching; a too-big ``lo`` runs out of memory loudly).
    """
    budget = device_hbm_bytes(device, hbm_bytes=hbm_bytes) * float(fraction)
    per = minsum_bytes_per_lane(graph, dtype_bytes)
    lanes = int(budget / per) if per > 0 else hi
    p = lo
    while p * 2 <= min(lanes, hi):
        p *= 2
    return p


#: share of the device budget the OSD-0 elimination's device-memory
#: workspace may take: a quarter leaves the decoder's own tensors (the BP
#: messages, the sorted and packed system the workspace copies) room
GF2_WORKSPACE_FRACTION = 0.25


def gf2_workspace_lanes(W: int, m: int, *, device=None, hbm_bytes: int | None = None) -> int:
    """Lanes of ``4 * W * m`` bytes that fit ``GF2_WORKSPACE_FRACTION`` of
    the device budget (at least one): the chunk of the OSD-0 elimination's
    device-memory body (1024 lanes of the bb144 R=6 DEM take 3.5 GB)."""
    budget = device_hbm_bytes(device, hbm_bytes=hbm_bytes) * GF2_WORKSPACE_FRACTION
    return max(1, int(budget // (4 * W * m)))
