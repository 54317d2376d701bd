"""What the profiler saw: device intervals, host spans and idle gaps.

The traced calls run under ``torch.profiler`` (CPU and CUDA activities);
its Chrome trace is read back here.  Device operations are the events of
the categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``, matched by no
name; host spans are ``record_function`` ranges (category
``user_annotation``).  All times are the trace's microseconds.
"""

from __future__ import annotations

import json
from collections import defaultdict

__all__ = ["Trace", "union", "overlap", "gaps"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, merged ``(start, end)`` intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> float:
    """Total length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def gaps(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that ``merged`` does not cover."""
    out, t = [], lo
    for s, e in merged:
        if e <= lo:
            continue
        if s >= hi:
            break
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


class Trace:
    """A Chrome trace of ``torch.profiler``, reduced to what the metrics read."""

    def __init__(self, path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.device = []  # (start, end, name, category)
        self.host = []  # (start, end, name, tid)
        self.spans = defaultdict(list)  # record_function name -> [(start, end)]
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            s = float(ev["ts"])
            e = s + float(ev["dur"])
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append((s, e, ev.get("name", ""), cat))
            elif not cat.startswith("gpu"):
                self.host.append((s, e, ev.get("name", ""), ev.get("tid")))
                if cat == "user_annotation":
                    self.spans[ev["name"]].append((s, e))
        self.busy = union((s, e) for s, e, _, _ in self.device)

    def launches(self, lo: float, hi: float) -> int:
        """Kernels that start inside ``[lo, hi]``."""
        return sum(1 for s, _, _, cat in self.device if cat == "kernel" and lo <= s <= hi)

    def top_ops(self, lo: float, hi: float, k: int = 10):
        """The ``k`` device operations that took most time in ``[lo, hi]``,
        by name: ``[[name, seconds], ...]``."""
        by = defaultdict(float)
        for s, e, name, _ in self.device:
            if lo <= s <= hi:
                by[name] += (e - s) * 1e-6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_by_host(self, lo: float, hi: float, tid, k: int = 10):
        """The device's idle stretches in ``[lo, hi]``, each named by the
        innermost host range of thread ``tid`` running at its middle, summed
        by name: the ``k`` largest ``[[name, seconds], ...]``."""
        holes = gaps(self.busy, lo, hi)
        host = sorted((s, e, n) for s, e, n, t in self.host if t == tid)
        by = defaultdict(float)
        stack: list[tuple[float, float, str]] = []
        h = 0
        for gs, ge in sorted(holes):
            mid = (gs + ge) / 2
            while h < len(host) and host[h][0] <= mid:
                while stack and stack[-1][1] <= host[h][0]:
                    stack.pop()
                stack.append(host[h])
                h += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            inner = [x for x in stack if x[0] <= mid < x[1]]
            by[inner[-1][2] if inner else "no host range"] += (ge - gs) * 1e-6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]
