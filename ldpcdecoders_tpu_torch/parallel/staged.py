"""Multi-device forms of the staged production decoder.

Counterpart of ``ldpcdecoders_tpu/parallel/staged.py``.
:class:`~..models.staged.StagedDemDecoder` has three stages of different
parallel shapes:

  * stage 0 (damped min-sum on every shot: K3/K4 on a card) carries about
    99% of the lanes and splits over the ``data`` axis: each rank decodes
    its slice and the stage-0 outputs are gathered;
  * stages 1-2 (deep ensemble buckets, relay legs, the native host OSD)
    touch a few percent of the shots: every rank runs the single-device
    tail (``_post_stage0``) on the whole batch.  Under several processes
    :func:`staged_local_eval` runs each process's own slice of the shots
    end to end and sums the counts.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import batch_sharding
from .multihost import allreduce_counts, world
from .spmd import _gather_batch

__all__ = ["sharded_staged_decode", "staged_local_eval"]


def sharded_staged_decode(dec, detectors, mesh, *, data_axis: str = "data", per=None):
    """Data-sharded staged decode: stage 0 on each rank's slice, the tail on
    the whole batch.

    ``detectors`` is ``[B, D]`` with ``B`` divisible by the mesh's ``data``
    extent.  Returns ``(errors, solved)`` as numpy with the single-device
    semantics: BP-converged lanes (stage 0, deep, relay) report
    ``solved=True``; OSD-repaired lanes report False but reproduce their
    syndrome whenever it is in the column span.
    """
    syn = np.asarray(detectors, np.uint8)
    rows = batch_sharding(mesh, 2, data_axis).bounds(syn.shape[0])
    L0, llr0_np, llr0_d = dec._channel(per)
    dev = dec.device
    local = torch.as_tensor(syn[rows], device=dev)
    cap = dec._max_stage0_batch  # the largest batch one stage-0 decode carries
    parts = [dec.stage0(local[lo:lo + cap], L0)[:3] for lo in range(0, local.shape[0], cap)]
    err0, conv0, it0 = (torch.cat(p) for p in zip(*parts))
    err0, conv0, it0 = (torch.as_tensor(a, device=dev)
                        for a in _gather_batch([err0, conv0, it0], mesh, data_axis))
    out, solved, _, _ = dec._post_stage0(torch.as_tensor(syn, device=dev), err0, conv0, it0,
                                         L0, llr0_np, llr0_d)
    return out.cpu().numpy(), solved.cpu().numpy()


def staged_local_eval(dec, shots: int, mesh=None, *, seed: int = 0, batch: int = 1024,
                      per=None, **eval_kw) -> dict:
    """Per-process staged evaluation with globally reduced statistics.

    Each process runs ``dec.run_eval`` on its own ``ceil(shots /
    processes)`` shots, its noise seed ``seed * 1000003 + rank``; then the
    shot, failure, deep and OSD counts are summed over the processes.  With
    one process this is ``run_eval`` with the reduced-statistics envelope.
    """
    from ..utils.metrics import wilson_interval

    procs, pid = world()
    local_shots = -(-shots // procs)
    st = dec.run_eval(local_shots, batch=batch, per=per, seed=(seed * 1000003 + pid),
                      **eval_kw)
    red = allreduce_counts(
        {"shots": st["shots"], "fails": st["fails"],
         "deep_shots": st["profile"]["deep_shots"],
         "osd_shots": st["profile"]["osd_shots"]}, mesh)
    lo, hi = wilson_interval(red["fails"], red["shots"])
    return {
        "shots": red["shots"],
        "fails": red["fails"],
        "logical_rate": red["fails"] / red["shots"] if red["shots"] else 0.0,
        "logical_ci95": [lo, hi],
        "deep_shots": red["deep_shots"],
        "osd_shots": red["osd_shots"],
        "processes": procs,
        "local": st,
    }
