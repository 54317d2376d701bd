"""Tracing: the decode path's spans and counters, and a device trace of a region.

Counterpart of ``ldpcdecoders_tpu/utils/profiling.py`` on
``torch.profiler``, and the port's one tracing system:

* :func:`span` names a region of the decode path (the names start with
  ``ldpc.``; :func:`call_span` is the decoder contract's ``ldpc.call``);
  :func:`count` adds to a counter of the call; :func:`to_host`,
  :func:`host_int` and :func:`to_device` are the path's copies between
  the host and the decoder's device, counted as ``host_reads``,
  ``d2h_bytes`` and ``h2d_bytes``.  The decoders count their own work
  beside them, as the min-sum loop's ``minsum_lane_iters_launched`` (lanes
  launched times iterations) and ``minsum_lane_iters_tiled`` (the part of
  it that ran on lane tiles), and the check wrappers'
  ``minsum_check_lane_iters_packed`` (the lanes of each bfloat16 K3 launch
  on lane tiles); :func:`count_sum` counts the sum of a device tensor, read
  only while recording; :func:`call_counters` reads the current call's
  counters back (the windowed decoder's per-window increments).
* Recording is on inside :func:`recording`, which yields its
  :class:`Recorder`, and while a ``torch.profiler`` session runs, whose
  record :func:`profiled` returns.  Off, :func:`span` returns one shared
  no-op context and :func:`count` returns at once: a flag test each.
* On, each span is a :class:`Span` stamped with ``time.time_ns()`` (the
  clock of the profiler's Chrome trace: its ``ts`` plus the file's
  ``baseTimeNanoseconds``) and, where a profiler runs, also a
  ``record_function`` range, so the trace shows it beside the kernels.
  Spans nest by a per-thread stack; a span opened on a thread outside any
  ``ldpc.call`` (``run_eval``'s OSD worker) belongs to no call.
* :func:`trace` writes a Chrome trace of a block (readable in Perfetto) and
  the block's counters per call; :func:`annotate` labels a host region.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from collections import defaultdict

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["trace", "annotate", "recording", "profiled", "span", "call_span", "count",
           "count_sum", "call_counters", "to_host", "host_int", "to_device", "settle",
           "Recorder", "Span", "Call"]


@dataclasses.dataclass
class Span:
    """A region of the decode path: ``time.time_ns()`` at entry and exit,
    the index of the enclosing span in :attr:`Recorder.spans` and of its
    call in :attr:`Recorder.calls` (None: none)."""

    name: str
    start_ns: int
    end_ns: int = 0
    parent: int | None = None
    call: int | None = None


@dataclasses.dataclass
class Call:
    """One ``ldpc.call``: its spans (itself first) and its counters."""

    spans: list
    counters: dict


class Recorder:
    """What one recording saw, kept in memory until read: every span in
    order of entry (:attr:`spans`), one :class:`Call` per decoder-contract
    call (:attr:`calls`), and the counts made outside any call
    (:attr:`counters`)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.calls: list[Call] = []
        self.counters: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def _open(self, name: str, parent: int | None, call: int | None, new_call: bool):
        with self._lock:
            index = len(self.spans)
            s = Span(name, 0, parent=parent, call=call)
            self.spans.append(s)
            if new_call:
                s.call = call = len(self.calls)
                self.calls.append(Call([], defaultdict(int)))
            if call is not None:
                self.calls[call].spans.append(s)
        return s, index

    def _count(self, name: str, n: int, call: int | None):
        with self._lock:
            (self.counters if call is None else self.calls[call].counters)[name] += n

    def totals(self) -> dict[str, int]:
        """Each counter summed over the calls."""
        out: dict[str, int] = defaultdict(int)
        for c in self.calls:
            for k, v in c.counters.items():
                out[k] += v
        return dict(out)


# -- the switch ---------------------------------------------------------------

_recorder: Recorder | None = None  # recording()'s
_profiled: Recorder | None = None  # the latest profiler session's
_profiler_seen = False  # whether the last ldpc.call found a profiler running
_tls = threading.local()
_OFF = contextlib.nullcontext()

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _profiler_on() -> bool:
        return _autograd_profiler._is_profiler_enabled
else:
    _profiler_on = torch.autograd._profiler_enabled


@contextlib.contextmanager
def recording():
    """Record the block's spans and counters; yields the :class:`Recorder`."""
    global _recorder
    outer, _recorder = _recorder, Recorder()
    try:
        yield _recorder
    finally:
        _recorder = outer


def profiled() -> Recorder | None:
    """The record of the latest ``torch.profiler`` session that a decoder
    call ran under (outside :func:`recording`): a call that finds a
    profiler running after one that found none starts a new record."""
    return _profiled


def _active(new_call: bool = False) -> Recorder | None:
    global _profiled, _profiler_seen
    if _recorder is not None:
        return _recorder
    on = _profiler_on()
    if new_call:
        if on and (_profiled is None or not _profiler_seen):
            _profiled = Recorder()
        _profiler_seen = on
    elif on and _profiled is None:
        _profiled = Recorder()
    return _profiled if on else None


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _Open:
    """A span being recorded: entry and exit of :func:`span`."""

    __slots__ = ("rec", "name", "new_call", "span", "index", "call", "range")

    def __init__(self, rec: Recorder, name: str, new_call: bool):
        self.rec, self.name, self.new_call = rec, name, new_call

    def __enter__(self):
        st = _stack()
        top = st[-1] if st and st[-1].rec is self.rec else None
        parent, call = (None, None) if top is None else (top.index, top.call)
        self.span, self.index = self.rec._open(self.name, parent, call,
                                               self.new_call and call is None)
        self.call = self.span.call
        st.append(self)
        self.range = None
        if _profiler_on():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.span.start_ns = time.time_ns()
        return self.span

    def __exit__(self, *exc):
        self.span.end_ns = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        st = _stack()
        if self in st:
            st.remove(self)
        return False


def span(name: str):
    """A context naming a region of the decode path; the shared no-op when
    recording is off."""
    rec = _active()
    return _OFF if rec is None else _Open(rec, name, False)


def call_span():
    """``ldpc.call``, around a decoder-contract call: it opens a
    :class:`Call` unless the thread is inside one already."""
    rec = _active(new_call=True)
    return _OFF if rec is None else _Open(rec, "ldpc.call", True)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the thread's current call (of
    the recording where outside any call)."""
    rec = _active()
    if rec is not None:
        _add(rec, name, n)


def count_sum(name: str, t: torch.Tensor) -> None:
    """Add the sum of the integer tensor ``t`` to the counter ``name``.
    Only while recording: the sum is then read back (a wait for the device,
    as :func:`settle`'s, and none of the path's ``host_reads``); off, ``t``
    is not touched, so the path reads nothing more."""
    rec = _active()
    if rec is not None:
        _add(rec, name, int(t.sum(dtype=torch.int64)))


def _top_call(rec: Recorder) -> int | None:
    st = _stack()
    top = st[-1] if st and st[-1].rec is rec else None
    return None if top is None else top.call


def _add(rec: Recorder, name: str, n: int) -> None:
    rec._count(name, int(n), _top_call(rec))


def call_counters() -> dict[str, int] | None:
    """A copy of the counters of the thread's current call (of the
    recording where outside any call); None when recording is off."""
    rec = _active()
    if rec is None:
        return None
    call = _top_call(rec)
    with rec._lock:
        return dict(rec.counters if call is None else rec.calls[call].counters)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else np.asarray(t).nbytes


def to_host(*tensors) -> tuple:
    """numpy copies of tensors, one host read each; the first waits for the
    device, the others find it idle."""
    rec = _active()
    if rec is not None:
        _add(rec, "host_reads", len(tensors))
        _add(rec, "d2h_bytes", sum(_nbytes(t) for t in tensors))
    return tuple(t.cpu().numpy() for t in tensors)


def host_int(t: torch.Tensor) -> int:
    """``int(t)`` of a one-element tensor: a host read (a wait for the
    device on a card)."""
    rec = _active()
    if rec is not None:
        _add(rec, "host_reads", 1)
        _add(rec, "d2h_bytes", _nbytes(t))
    return int(t)


def to_device(a, device) -> torch.Tensor:
    """``torch.as_tensor(a, device=device)``; unless ``a`` is a tensor on
    that device already, its bytes count as ``h2d_bytes``."""
    t = torch.as_tensor(a, device=device)
    rec = _active()
    if rec is not None and not (isinstance(a, torch.Tensor) and a.device == t.device):
        _add(rec, "h2d_bytes", _nbytes(t))
    return t


def settle(device) -> None:
    """Where recording is on, wait for the work queued on ``device`` (a CUDA
    card; nothing on the CPU), so that the enclosing span ends when the
    device's work does; nothing when off."""
    if _active() is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# -- the profiler -----------------------------------------------------------------


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a trace of the block into ``log_dir`` as
    ``trace.<pid>.<ms>.pt.trace.json``, with the block's counters per
    decoder call beside it as ``trace.<pid>.<ms>.counters.json``.  ``None``
    or ``""`` disables tracing (a no-op)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording() as rec, profile(activities=activities) as prof:
        yield
    stem = os.path.join(log_dir, f"trace.{os.getpid()}.{int(time.time() * 1e3)}")
    prof.export_chrome_trace(stem + ".pt.trace.json")
    calls = [{"start_ns": c.spans[0].start_ns, "end_ns": c.spans[0].end_ns,
              "counters": dict(c.counters)} for c in rec.calls]
    with open(stem + ".counters.json", "w") as f:
        json.dump({"calls": calls, "outside_calls": dict(rec.counters)}, f, indent=1)


def annotate(name: str):
    """Context manager labelling a host-side region in profiler traces."""
    return torch.profiler.record_function(name)
