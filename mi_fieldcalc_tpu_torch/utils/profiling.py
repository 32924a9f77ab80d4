"""Profiling on an NVIDIA GPU: traces, the program's own spans and
counters, and the card's published rates.

Port of :mod:`mi_fieldcalc_tpu.utils.profiling` (``profiling.py:1-84``):
``trace`` wraps ``torch.profiler`` instead of ``jax.profiler``, and the
rates are NVIDIA's published ones.  Usage::

    from mi_fieldcalc_tpu_torch.utils import trace, device_busy_ms

    with trace("trace-dir") as prof:        # a Chrome trace lands there
        out = step(*args)
        torch.cuda.synchronize()
    busy = device_busy_ms(prof.trace_path)  # ms the device was busy

``event_times_ms`` times a function on the card with CUDA events.

**Spans.**  The program marks its layers with :func:`span` (a context
manager or a decorator) and counts work with :func:`count`.  Both record
only while a ``torch.profiler`` session is on, so profiling is the one
switch; with none on, a span reads one flag and returns a shared object
that does nothing.  A record holds the span's name, its id, the id of the
span it was opened in and of the outermost one (one top-level call), its
host start and end on the clock of the profiler's host events, and its
device time where its work runs: two CUDA events on the card's current
stream for work on a card (a decorated function's tensors tell), the host
clock for work on the host.  :func:`recorded` returns the records and
counters of the newest session, :func:`take` returns them and clears::

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        ensemble_derived_summary(..., fused=True)
    for s in recorded().spans:
        print(s.name, s.ms, s.self_ms)

A span opened with ``count_allocs`` on a card adds the caching
allocator's ``cudaMalloc`` calls made inside it to the counter
``allocator.device_allocs``.  A kernel counts on the card itself into
:func:`device_count`'s slot, which the session reads with its records.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "device_hbm_gbps", "device_f32_flops", "device_events",
           "device_busy_ms", "event_times_ms", "span", "count",
           "device_count", "recorded", "take", "SpanRecord", "Recording"]

#: NVIDIA's published device-memory rates (bytes/s) by the name
#: ``torch.cuda.get_device_properties`` gives: H100 SXM and H200 SXM
_HBM_TABLE = {"NVIDIA H100 80GB HBM3": 3.35e12, "NVIDIA H200": 4.8e12}
#: their published float32 rates outside the tensor cores (operations/s,
#: a fused multiply-add counted as two)
_F32_TABLE = {"NVIDIA H100 80GB HBM3": 67e12, "NVIDIA H200": 67e12}
#: the trace categories of device work: kernels, copies and fills
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _published(table: dict, what: str, device) -> float:
    device = torch.device("cuda", 0) if device is None else \
        torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no published {what} for a {device.type} device")
    name = torch.cuda.get_device_properties(device).name
    if name not in table:
        raise ValueError(f"no published {what} for {name!r}; known: "
                         f"{', '.join(table)}")
    return table[name]


def device_hbm_gbps(device=None) -> float:
    """Published device-memory rate (bytes/s) of the CUDA ``device``
    (default ``cuda:0``).  Raises for the CPU and for a card whose rate
    this table does not hold."""
    return _published(_HBM_TABLE, "memory rate", device)


def device_f32_flops(device=None) -> float:
    """Published float32 rate (operations/s, outside the tensor cores) of
    the CUDA ``device``; raises as :func:`device_hbm_gbps` does."""
    return _published(_F32_TABLE, "float32 rate", device)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, host and CUDA activity; on exit
    the Chrome trace is written to ``log_dir/trace.json`` and its path is
    the profiler's ``trace_path``."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.trace_path = str(Path(log_dir) / "trace.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


def device_events(trace_path) -> list:
    """The device's work in a Chrome trace: ``(name, category, start_us,
    duration_us)`` of every kernel, copy and fill, in start order."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    return sorted(((e["name"], e["cat"], float(e["ts"]), float(e["dur"]))
                   for e in events if e.get("cat") in DEVICE_CATEGORIES
                   and "dur" in e), key=lambda e: e[2])


def device_busy_ms(trace_path) -> float:
    """Milliseconds in which the device ran at least one kernel, copy or
    fill of the trace: the union of their intervals."""
    busy, end = 0.0, float("-inf")
    for _, _, start, dur in device_events(trace_path):
        stop = start + dur
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


def event_times_ms(fn, reps: int, warmup: bool = True,
                   queued: bool = False) -> list:
    """Per-run device times of ``fn`` in ms, each between two CUDA events
    on the current stream, after one warm-up run unless ``warmup`` is
    False.  ``queued`` puts a ~1 ms busy wait on the stream before each
    run, so that the host's time to enqueue ``fn`` falls outside the
    events: the device's own time for what ``fn`` launches."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        if queued:
            torch.cuda.synchronize()
            torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


#: the clock of the profiler's host events: kineto stamps them in
#: ``CLOCK_REALTIME`` nanoseconds, which is ``time.time_ns``
_clock = time.time_ns


class SpanRecord(NamedTuple):
    """One finished span.  ``ms`` is its device time (CUDA events on the
    stream of the card its work ran on, or the host clock where that work
    was on the host) and ``self_ms`` that time less what its child spans
    cover."""
    name: str
    id: int
    parent: Optional[int]     # the span it was opened in
    root: int                 # the outermost span of its call
    start_ns: int             # host clock, as the profiler's events
    end_ns: int
    ms: float
    self_ms: float


class Recording(NamedTuple):
    """The spans (in the order they opened) and counters of a session."""
    spans: list
    counters: dict


class _Recorder:
    """The newest session's open and finished spans, its counters and
    the device slots its kernels count into.  A span or count that finds
    the profiler on, after a span found it off or the records were read
    with it off, begins a new session."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()     # each thread's open spans
        self.ids = itertools.count(1)
        self.spans, self.counters, self.slots = [], {}, {}
        self.pool = {}      # every slot made, by (name, device), kept
        self.sealed = True

    def _begin(self) -> None:
        if self.sealed:
            self.spans, self.counters, self.slots = [], {}, {}
            self.sealed = False

    def open(self, s) -> None:
        with self.lock:
            self._begin()
            self.spans.append(s)

    def add(self, name: str, n) -> None:
        with self.lock:
            self._begin()
            self.counters[name] = self.counters.get(name, 0) + n

    def slot(self, name: str, device: torch.device) -> torch.Tensor:
        """The session's slot of ``name`` on ``device``: made once a
        process, zeroed on the current stream once a session."""
        key = (name, device)
        with self.lock:
            self._begin()
            t = self.slots.get(key)
            if t is None:
                t = self.pool.get(key)
                if t is None:
                    t = self.pool[key] = torch.zeros((), dtype=torch.int64,
                                                     device=device)
                else:
                    t.zero_()
                self.slots[key] = t
            return t

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def finish(self, take: bool) -> Recording:
        if not _autograd_profiler._is_profiler_enabled:
            self.sealed = True
        with self.lock:
            spans, counters = self.spans, dict(self.counters)
            slots = dict(self.slots)
            if take:
                self.spans, self.counters, self.slots = [], {}, {}
        for (name, device), t in slots.items():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            counters[name] = counters.get(name, 0) + int(t.item())
        done = [s for s in spans if s.end_ns is not None]
        ms = {s.id: s.device_ms() for s in done}
        children = {}
        for s in done:
            if s.parent in ms:
                children[s.parent] = children.get(s.parent, 0.0) + ms[s.id]
        return Recording(
            [SpanRecord(s.name, s.id, s.parent, s.root, s.start_ns, s.end_ns,
                        ms[s.id], ms[s.id] - children.get(s.id, 0.0))
             for s in done], counters)


_RECORDER = _Recorder()


def _device_allocs(device) -> Optional[int]:
    """The caching allocator's ``cudaMalloc`` calls so far on the CUDA
    ``device``, where this PyTorch counts them."""
    return torch.cuda.memory_stats_as_nested_dict(device).get(
        "num_device_alloc")


def _device_of(obj, depth: int = 4):
    """The device of the first tensor in ``obj``, looked for through a
    Field's values, tuples (NamedTuples of Fields), lists and dicts; None
    if it holds none."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    values = getattr(obj, "values", None)       # a Field
    if isinstance(values, torch.Tensor):
        return values.device
    if depth:
        if isinstance(obj, dict):
            obj = obj.values()
        elif not isinstance(obj, (tuple, list)):
            return None
        for x in obj:
            d = _device_of(x, depth - 1)
            if d is not None:
                return d
    return None


def _decorate(name: str, count_allocs: bool, fn):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        if not _autograd_profiler._is_profiler_enabled:
            _RECORDER.sealed = True
            return fn(*args, **kwargs)
        device = _device_of(args) or _device_of(kwargs)
        with _on(name, device, count_allocs):
            return fn(*args, **kwargs)
    return spanned


class _Span:
    """A span that records: while a profiler session is on."""
    __slots__ = ("name", "device", "count_allocs", "id", "parent", "root",
                 "start_ns", "end_ns", "events", "allocs")

    def __init__(self, name: str, device, count_allocs: bool):
        self.name = name
        self.device = device
        self.count_allocs = count_allocs
        self.end_ns = None

    def __enter__(self):
        rec = _RECORDER
        self.id = next(rec.ids)
        rec.open(self)
        stack = rec.stack()
        if stack:
            parent = stack[-1]
            self.parent, self.root = parent.id, parent.root
            if self.device is None:         # a block takes its parent's
                self.device = parent.device
        else:
            self.parent, self.root = None, self.id
        self.events = self.allocs = None
        if self.device is not None and self.device.type == "cuda":
            if self.count_allocs:
                self.allocs = _device_allocs(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        stack.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        self.end_ns = _clock()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
            if self.allocs is not None:
                count("allocator.device_allocs",
                      _device_allocs(self.device) - self.allocs)
        stack = _RECORDER.stack()
        if stack and stack[-1] is self:
            stack.pop()
        return False

    def __call__(self, fn):
        return _decorate(self.name, self.count_allocs, fn)

    def device_ms(self) -> float:
        if self.events is None:
            return (self.end_ns - self.start_ns) / 1e6
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


class _Off:
    """What :func:`span` returns with no profiler session on: one shared
    object a name, which records nothing."""
    __slots__ = ("name", "count_allocs")

    def __init__(self, name: str, count_allocs: bool = False):
        self.name = name
        self.count_allocs = count_allocs

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorate(self.name, self.count_allocs, fn)


class _OffSpans(dict):
    """The shared no-op spans by name."""

    def __init__(self, count_allocs: bool):
        super().__init__()
        self.count_allocs = count_allocs

    def __missing__(self, name):
        off = self[name] = _Off(name, self.count_allocs)
        return off


#: the no-op spans, without and with ``count_allocs``
_OFF = (_OffSpans(False), _OffSpans(True))


def _on(name: str, device, count_allocs: bool):
    """A recording span, or the shared no-op inside a CUDA graph's
    capture, where no event may be recorded."""
    if device is not None and not isinstance(device, torch.device):
        device = torch.device(device)
    if device is not None and device.type == "cuda" and \
            torch.cuda.is_current_stream_capturing():
        return _OFF[count_allocs][name]
    return _Span(name, device, count_allocs)


def span(name: str, device=None, count_allocs: bool = False):
    """A span named ``name`` over a ``with`` block, or, as a decorator,
    over every call of the function.  It records only while a
    ``torch.profiler`` session is on, and not inside a CUDA graph's
    capture; otherwise it costs one flag read.

    Its device time is timed where its work runs: by CUDA events on the
    card's current stream for a CUDA ``device``, by the host clock for any
    other.  A decorated function's device is that of the first tensor of
    its arguments; a ``with`` block's is ``device``, else its parent
    span's, else the host.  With ``count_allocs``, a span on a card adds
    the caching allocator's ``cudaMalloc`` calls made inside it to the
    counter ``allocator.device_allocs``."""
    if not _autograd_profiler._is_profiler_enabled:
        _RECORDER.sealed = True
        return _OFF[count_allocs][name]
    return _on(name, device, count_allocs)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` of the session, while a
    ``torch.profiler`` session is on."""
    if _autograd_profiler._is_profiler_enabled:
        _RECORDER.add(name, n)


def device_count(name: str, device) -> Optional[torch.Tensor]:
    """A slot on ``device`` for a kernel to add the count ``name`` to, while
    a ``torch.profiler`` session is on and outside a CUDA graph's capture:
    a 0-d int64 tensor, zeroed once a session and made once a process,
    whose value joins the session's counter ``name`` when its records are
    read (:func:`recorded`), so the count stays on the card until then.
    None otherwise, for a launch to pass as a null pointer."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return None
    return _RECORDER.slot(name, device)


def recorded() -> Recording:
    """The finished spans and the counters of the newest session, which
    stay readable until the next session records.  On CUDA this waits for
    each span's end on the device."""
    return _RECORDER.finish(take=False)


def take() -> Recording:
    """:func:`recorded`, and forget it."""
    return _RECORDER.finish(take=True)
