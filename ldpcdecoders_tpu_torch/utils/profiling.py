"""Tracing helpers: a device trace of a region, and labelled host regions.

Counterpart of ``ldpcdecoders_tpu/utils/profiling.py`` on
``torch.profiler``.  :func:`trace` records the CPU and, where a CUDA card
is present, its kernels, and writes a Chrome trace (readable in Perfetto)
into ``log_dir``; :func:`annotate` labels a host region in it.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a trace of the block into ``log_dir`` as
    ``trace.<pid>.<ms>.pt.trace.json``.  ``None`` or ``""`` disables tracing
    (a no-op)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    name = f"trace.{os.getpid()}.{int(time.time() * 1e3)}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def annotate(name: str):
    """Context manager labelling a host-side region in profiler traces."""
    return torch.profiler.record_function(name)
