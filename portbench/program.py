"""What the program recorded of the traced calls: its own spans and counters.

While a ``torch.profiler`` session runs, the program records the spans and
counters of its decode path (``ldpcdecoders_tpu_torch.utils.profiling``)
and keeps the latest session's record in memory (``profiled()``): one
entry per decoder-contract call (``ldpc.call``), each with its spans
(``time.time_ns()`` at entry and exit) and its counters.  The traced calls
of a run are that session.  Where the program keeps no such record, or
its record is not one entry per traced call, :func:`record` gives None and
the readers report nothing.
"""

from __future__ import annotations

import sys

__all__ = ["record", "seconds", "totals"]


def record(ctx):
    """The program's record of the run's traced calls, or None."""
    t = ctx["trace"]
    if not t or t["window_s"] <= 0 or not t["calls"]:
        return None
    mod = sys.modules.get("ldpcdecoders_tpu_torch.utils.profiling")
    get = getattr(mod, "profiled", None)
    rec = get() if get is not None else None
    if rec is None or len(rec.calls) != t["calls"]:
        return None
    return rec


def seconds(rec, *names) -> float:
    """Seconds covered by the calls' spans of the given names (their union:
    a span nested in another of the names counts once)."""
    merged: list[list[int]] = []
    for s, e in sorted((sp.start_ns, sp.end_ns) for c in rec.calls for sp in c.spans
                       if sp.name in names):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) * 1e-9


def totals(rec) -> dict:
    """Each counter summed over the calls."""
    out: dict = {}
    for c in rec.calls:
        for k, v in c.counters.items():
            out[k] = out.get(k, 0) + v
    return out
