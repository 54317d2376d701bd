"""Hand-written CUDA kernels for the OSD eliminations, and their plain versions.

Counterpart of ``ldpcdecoders_tpu/ops/pallas_gf2.py``.  The kernels live in
``csrc/gf2_elim.cu`` (built by ``_build.py``):

  * :func:`gf2_osd0_cuda` replaces ``gf2_osd0_pallas`` (``_osd0_kernel``);
  * :func:`gf2_eliminate_cuda` replaces ``gf2_eliminate_pallas``
    (``_elim_kernel``).

Each wrapper takes the same shapes and returns the same values as its
Pallas counterpart, with int32 tensors carrying the uint32 bit patterns.
For tensors on the CPU a wrapper runs its plain torch version
(:func:`gf2_osd0_ref`, :func:`gf2_eliminate_ref`); for CUDA tensors it
launches the kernel or raises.  ``<wrapper>.launches`` counts the kernel
launches of each wrapper.

The kernels eliminate by panels of P columns (one block per lane, the lane
in shared memory): P column trips on the panel's bits alone, which give
every row a code; a table of the 2^P XORs of the panel's pivot rows; and
one full-width pass ``row ^= table[code]``.  For lanes of at most 1024 rows
one warp makes the trips on bit slices in its registers, a panel ahead of
the other warps' apply pass; other lanes keep their rows in shared memory
and meet at a block barrier per trip.  The launcher picks P for a shape: the
widest panel whose table fits the 232,448 bytes of a block beside the lane.
:func:`launcher_plan` asks the built library for that choice, and the
wrappers route by it; :func:`launch_plan` is the same sum in Python, for
where there is no library, and the card's tests hold the two together.
``ops/gf2.py`` has the same algorithm in plain torch (``gf2_osd0_blocked``,
``gf2_eliminate_blocked``).

A lane that fits no block (``launch_plan(...).panel == 0``) takes the
device-memory body, ``gf2_cluster_kernel``: the lane stays in device memory
(the elimination works in its output ``Ht'``, OSD-0 in a workspace of its
own, allocated per chunk of lanes under ``utils/hbm.py``'s budget) and a
thread-block cluster takes each lane by panels of 32 columns: one CTA makes
a panel's trips on bit slices in its shared memory, the others apply the
panel to the later words through XOR tables.  :func:`cluster_plan` asks the
built library for its cluster size.  :func:`route` names the body a shape
takes; ``<wrapper>.routes`` counts the launches of each body.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .gf2 import gf2_eliminate, gf2_osd0

__all__ = [
    "gf2_osd0_cuda",
    "gf2_eliminate_cuda",
    "gf2_osd0_ref",
    "gf2_eliminate_ref",
    "launch_plan",
    "launcher_plan",
    "route",
    "body_of",
    "global_smem_bytes",
    "cluster_plan",
    "row_stride",
    "smem_bytes",
    "MAX_SMEM_BYTES",
]

#: dynamic shared memory one Hopper block can opt in to (227 KB)
MAX_SMEM_BYTES = 232_448


class LaunchPlan(NamedTuple):
    """What the launcher of ``csrc/gf2_elim.cu`` picks for a lane shape."""

    panel: int  #: columns per panel (8, 4, 2 or 1); 0 where the lane does not fit
    pad: bool  #: rows stored at a stride of 4 mod 8 words (no bank conflicts)
    bp_bits: bool  #: OSD-0: ``bp_err`` packed into W words of shared memory
    bytes: int  #: dynamic shared memory of the block


def _round4(x):
    return (x + 3) & ~3


def row_stride(m: int, pad: bool) -> int:
    """Words between two packed words of a row in shared memory: ``m``
    rounded up to 4 mod 8 (16-byte accesses down a column of four rows and
    32 words across a row both meet no bank conflict), or bare ``m``."""
    if not pad:
        return m
    m4 = _round4(m)
    return m4 if m4 % 8 == 4 else m4 + 4


def _smem_words(W, m, panel, pad, bp_bits):
    nwarps = min(max((m + 31) // 32, 2), 32)
    words = _round4(m) + W * row_stride(m, pad) + (W if bp_bits else 0)  # state, lane, bp_err
    if panel > 1:
        words += _round4(panel * W) + (W << panel)  # pivot rows, table
    if panel > 1 and m <= 1024:  # the pipelined kernel: loop state, bit slices, table offsets
        return words + 16 + 32 * (2 * panel + 2) + _round4(m)
    trip_slots = 2 if panel == 1 else panel  # the panel kernel: two words per warp and slot
    return words + _round4(2 * trip_slots * nwarps)


def launch_plan(W: int, m: int, *, osd0: bool, panel: int = 8) -> LaunchPlan:
    """The widest panel, at most ``panel``, whose table fits a Hopper block
    beside the lane (the same choice as ``plan`` in ``csrc/gf2_elim.cu``).

    A block holds, in 32-bit words, each part rounded up to 4: one state
    word per row (pivot column, panel code, syndrome bit); the packed system
    at :func:`row_stride`; for OSD-0 ``W`` words of packed ``bp_err``; at
    P > 1 the panel's pivot rows, ``P * W``, and the table, ``2^P * W``.
    The pipelined kernel (P > 1, at most 1024 rows) adds 16 words of loop
    state, ``2 P + 2`` bit slices of 32 words and one table offset per row;
    the other kernel two words per warp and trip slot (one slot per panel
    column; two at P = 1).  Where not even P = 1 fits so, the bare lane is
    tried: stride ``m``, ``bp_err`` read from device memory; every lane of
    8 or more rows that fitted the column-by-column kernels fits that.  At
    m=900, n=1000 a block takes 158,688 bytes for OSD-0 and 158,560 for the
    elimination at P = 8, of the 232,448 it may take.
    """
    if panel not in (1, 2, 4, 8):
        raise ValueError(f"panel must be 1, 2, 4 or 8, got {panel}")
    P = panel
    while P >= 1:
        need = 4 * _smem_words(W, m, P, True, osd0)
        if need <= MAX_SMEM_BYTES:
            return LaunchPlan(P, True, osd0, need)
        P >>= 1
    need = 4 * _smem_words(W, m, 1, False, False)
    return LaunchPlan(1 if need <= MAX_SMEM_BYTES else 0, False, False, need)


def launcher_plan(W: int, m: int, *, osd0: bool, panel: int = 8, lib=None) -> LaunchPlan:
    """The plan the launcher of the built library takes for a ``[W, m]``
    lane (needs nvcc; ``lib``: a library other than the plain build)."""
    import ctypes

    from .._build import load_library

    out = (ctypes.c_int * 4)()
    (lib or load_library()).ldpc_gf2_plan(W, m, int(osd0), panel, out)
    return LaunchPlan(out[0], bool(out[2]), bool(out[3]), out[1])


def body_of(plan: LaunchPlan) -> str:
    """The body a plan launches: ``"shared"`` where a block holds the lane
    (the pipelined or panel kernel), ``"global"`` (the lane in device
    memory) where the plan has no panel.  The wrappers route by it."""
    return "global" if plan.panel == 0 else "shared"


def route(W: int, m: int, *, osd0: bool) -> str:
    """The body a ``[W, m]`` lane takes: :func:`body_of` its
    :func:`launch_plan` (the card's tests hold that plan to the
    launcher's, which the wrappers read)."""
    return body_of(launch_plan(W, m, osd0=osd0))


#: words an applier CTA of the device-memory body tabulates at once
_TILE_WORDS = 32


def global_smem_bytes(m: int) -> int:
    """Shared memory of a CTA of the device-memory body for ``m`` rows
    (``cluster_smem_bytes`` in ``csrc/gf2_elim.cu``): the larger of the
    leader's (8 words of loop flags, 64 of pivot rows, 32 of M, 32 + 128 of
    the next word's starts and tables, 32 bit slices and the free rows and
    syndrome bits over ``(m + 31) // 32`` chunks at an odd stride, and two
    code words a row) and an applier's (a code word a row, 32 pivot rows,
    a word of live flags, and the starts and tables of 32 words)."""
    mr, cs = _round4(m), ((m + 31) // 32) | 1
    leader = 8 + 64 + 32 + 32 + 128 + _round4(32 * cs) + 2 * _round4(cs) + 2 * mr
    applier = mr + 32 + 4 + 32 * _TILE_WORDS + 128 * _TILE_WORDS
    return 4 * max(leader, applier)


class ClusterPlan(NamedTuple):
    """What the launcher of the device-memory body takes for B lanes."""

    size: int  #: CTAs of a cluster (2, 4 or 8)
    bytes: int  #: dynamic shared memory of each CTA
    active: int  #: clusters of that size the card holds at once


def cluster_plan(B: int, m: int, *, osd0: bool, lib=None) -> ClusterPlan:
    """The cluster the built library's launcher takes for ``B`` lanes of
    ``m`` rows in the device-memory body: the largest of 8, 4 and 2 CTAs
    whose clusters the card holds all at once (2 where none does), by
    ``cudaOccupancyMaxActiveClusters`` on the current card."""
    import ctypes

    from .._build import load_library

    lib = lib or load_library()
    out = (ctypes.c_int * 3)()
    _raise_on(lib, lib.ldpc_gf2_cluster_plan(B, m, int(osd0), out), "gf2 cluster plan")
    return ClusterPlan(out[0], out[1], out[2])


def smem_bytes(W: int, m: int, *, osd0: bool) -> int:
    """Shared memory the block of one ``[W, m]`` lane takes under
    :func:`launch_plan` (the least it could take where it does not fit)."""
    return launch_plan(W, m, osd0=osd0).bytes


def gf2_osd0_ref(Ht, resid, bp_err, n):
    """Plain torch version of the OSD-0 kernel (see ops/gf2.py ``gf2_osd0``)."""
    return gf2_osd0(Ht, resid, bp_err, n)


def gf2_eliminate_ref(Ht, s, n):
    """Plain torch version of the elimination kernel: ``(Ht', s', pivcol)``."""
    Ht2, s2, piv, _ = gf2_eliminate(Ht, s, n)
    return Ht2, s2, piv


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 (uint32 bit patterns), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _prepare(Ht, n, osd0, panel, lib, cluster):
    """Validate the packed system; return ``(lib, B, W, m, stream, plan)``."""
    from .._build import load_library

    if Ht.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {Ht.device}")
    if Ht.ndim != 3:
        raise ValueError(f"Ht must be [B, W, m], got shape {tuple(Ht.shape)}")
    B, W, m = Ht.shape
    if W != (n + 31) // 32:
        raise ValueError(f"Ht has {W} words per row; {n} columns need {(n + 31) // 32}")
    _check("Ht", Ht, (B, W, m), Ht.device)
    if m < 1 or n >= 1 << 23:
        raise ValueError(f"a lane needs at least one row and fewer than 2^23 columns, "
                         f"got [{m}, {n}]")
    if panel not in (1, 2, 4, 8):
        raise ValueError(f"panel must be 1, 2, 4 or 8, got {panel}")
    if cluster not in (0, 2, 4, 8):
        raise ValueError(f"cluster must be 0, 2, 4 or 8, got {cluster}")
    lib = lib or load_library()
    plan = launcher_plan(W, m, osd0=osd0, panel=panel, lib=lib)
    need = global_smem_bytes(m)
    if body_of(plan) == "global" and need > MAX_SMEM_BYTES:
        raise ValueError(f"a lane of {m} rows takes {need} bytes of shared memory in the "
                         f"device-memory body; a block holds {MAX_SMEM_BYTES}")
    stream = torch.cuda.current_stream(Ht.device).cuda_stream
    return lib, B, W, m, stream, plan


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.ldpc_cuda_error_string(rc).decode()}")


def gf2_osd0_cuda(Ht, resid, bp_err, n, *, _max_panel=8, _lib=None, _cluster=0):
    """Batched OSD-0 elimination; returns the ``[B, n]`` int32 correction.

    Args:
      Ht: ``[B, W, m]`` int32 transposed packed rows (sorted columns).
      resid: ``[B, m]`` int32 0/1 residual syndrome of ``bp_err``.
      bp_err: ``[B, n]`` int32 0/1 BP hard decisions (sorted order).
      n: column count.

    ``_max_panel`` (8, 4, 2 or 1) caps the launcher's panel width, ``_lib``
    names another build of the library, and for a lane past a block
    ``_cluster`` (2, 4 or 8; 0 the launcher's choice) sets the cluster: for
    the tests and timings of every instantiation; the result depends on none
    of them.
    """
    if Ht.device.type == "cpu":
        return gf2_osd0_ref(Ht, resid, bp_err, n)
    lib, B, W, m, stream, plan = _prepare(Ht, n, True, _max_panel, _lib, _cluster)
    _check("resid", resid, (B, m), Ht.device)
    _check("bp_err", bp_err, (B, n), Ht.device)
    corr = torch.empty((B, n), dtype=torch.int32, device=Ht.device)
    if B == 0:
        return corr
    if body_of(plan) == "global":
        # the device-memory body works in a copy of each lane (and its pivot
        # columns): by chunks of lanes whose workspace the memory budget admits
        from ..utils.hbm import gf2_workspace_lanes

        chunk = min(B, gf2_workspace_lanes(W, m, device=Ht.device))
        work = torch.empty((chunk, W, m), dtype=torch.int32, device=Ht.device)
        pivw = torch.empty((chunk, m), dtype=torch.int32, device=Ht.device)
        for b0 in range(0, B, chunk):
            b = min(chunk, B - b0)
            with torch.cuda.device(Ht.device):
                rc = lib.ldpc_gf2_osd0_cluster(Ht[b0].data_ptr(), resid[b0].data_ptr(),
                                               bp_err[b0].data_ptr(), corr[b0].data_ptr(),
                                               work.data_ptr(), pivw.data_ptr(), b, W, m, n,
                                               _cluster, stream)
            _raise_on(lib, rc, "gf2_osd0 (device-memory body)")
            gf2_osd0_cuda.launches += 1
            gf2_osd0_cuda.routes["global"] += 1
        return corr
    with torch.cuda.device(Ht.device):  # the launch goes to the current device
        rc = lib.ldpc_gf2_osd0(Ht.data_ptr(), resid.data_ptr(), bp_err.data_ptr(),
                               corr.data_ptr(), B, W, m, n, _max_panel, stream)
    _raise_on(lib, rc, "gf2_osd0")
    gf2_osd0_cuda.launches += 1
    gf2_osd0_cuda.routes["shared"] += 1
    return corr


def gf2_eliminate_cuda(Ht, s, n, *, _max_panel=8, _lib=None, _cluster=0):
    """Batched Gauss–Jordan RREF of packed columns.

    Args:
      Ht: ``[B, W, m]`` int32 transposed packed rows.
      s: ``[B, m]`` int32 0/1 syndromes, co-transformed.
      n: column count.

    Returns ``(Ht' [B, W, m], s' [B, m], pivcol [B, m])`` (int32) with
    ``pivcol[b, i]`` = row i's pivot column or the sentinel ``n``.
    ``_max_panel``, ``_lib``, ``_cluster``: as in :func:`gf2_osd0_cuda`.
    """
    if Ht.device.type == "cpu":
        return gf2_eliminate_ref(Ht, s, n)
    lib, B, W, m, stream, plan = _prepare(Ht, n, False, _max_panel, _lib, _cluster)
    _check("s", s, (B, m), Ht.device)
    Ht2 = torch.empty_like(Ht)
    s2 = torch.empty_like(s)
    piv = torch.empty((B, m), dtype=torch.int32, device=Ht.device)
    if B == 0:
        return Ht2, s2, piv
    body = body_of(plan)
    with torch.cuda.device(Ht.device):
        if body == "global":  # the lane in device memory: the kernel works in Ht2
            rc = lib.ldpc_gf2_eliminate_cluster(Ht.data_ptr(), s.data_ptr(), Ht2.data_ptr(),
                                                s2.data_ptr(), piv.data_ptr(), B, W, m, n,
                                                _cluster, stream)
        else:
            rc = lib.ldpc_gf2_eliminate(Ht.data_ptr(), s.data_ptr(), Ht2.data_ptr(),
                                        s2.data_ptr(), piv.data_ptr(), B, W, m, n, _max_panel,
                                        stream)
    _raise_on(lib, rc, "gf2_eliminate")
    gf2_eliminate_cuda.launches += 1
    gf2_eliminate_cuda.routes[body] += 1
    return Ht2, s2, piv


gf2_osd0_cuda.launches = 0
gf2_eliminate_cuda.launches = 0
#: launches per body: "shared" (a block holds the lane), "global" (device
#: memory, the cluster body)
gf2_osd0_cuda.routes = {"shared": 0, "global": 0}
gf2_eliminate_cuda.routes = {"shared": 0, "global": 0}
