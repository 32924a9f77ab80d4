"""Layer spans and the device trace of a traced run.

A span is a pair of CUDA events that the benchmark records on the current
stream around one of its own calls into a public function of the program
(on the CPU, the host clock): the device time from the moment the stream
reaches the call's work to the moment it finishes it.  :func:`patched`
puts the recorder in place of the named module attributes for the traced
window, so a function the program calls through its module (such as
``models.ensemble.ensemble_member_fields`` inside
``ensemble_derived_summary``) is spanned where it is called.

:func:`read_trace` turns a ``torch.profiler`` session into the device's
busy time (the union of its kernels, copies and fills), the device
operations that took most time and the longest idle gaps, each named by
the CUDA runtime call that overlapped it most (a launch: the host is
behind; a synchronize: the host waits for the device).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time
from collections import defaultdict

import numpy as np
import torch


class Spans:
    """Spans by layer name, each ``(start, end)``: CUDA events on a card,
    host clock readings on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = defaultdict(list)

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wrap(self, name: str, fn):
        @functools.wraps(fn)    # keeps the attributes the program reads
        def spanned(*args, **kwargs):
            start = self._mark()
            out = fn(*args, **kwargs)
            self.marks[name].append((start, self._mark()))
            return out
        return spanned

    def ms(self, name: str) -> list:
        """Each span's milliseconds (after the device has finished)."""
        if self.cuda:
            return [a.elapsed_time(b) for a, b in self.marks.get(name, ())]
        return [(b - a) * 1e3 for a, b in self.marks.get(name, ())]

    def as_ms(self) -> dict:
        return {name: self.ms(name) for name in self.marks}


@contextlib.contextmanager
def replaced(table: dict):
    """Within the block, each ``"module:attr"`` of ``table`` is what its
    function makes of the original (``lambda original: replacement``)."""
    saved = []
    try:
        for target, make in table.items():
            modname, attr = target.split(":")
            mod = importlib.import_module(modname)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, make(fn))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def patched(spans: Spans, table: dict):
    """Within the block, ``module.attr`` of each ``name: "module:attr"`` of
    ``table`` records a span named ``name`` around every call."""
    return replaced({target: (lambda fn, name=name: spans.wrap(name, fn))
                     for name, target in table.items()})


def profiler(device: torch.device):
    """``torch.profiler`` over the device's activity and the CUDA runtime
    calls that launch it; no host operator is recorded, because recording
    each one slows the host's dispatch several times over, and a cell whose
    pace the host sets would read a device far idler than it is."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    return profile(activities=acts)


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(prof, top: int = 10) -> dict:
    """``busy_s``, ``device_ops`` and ``idle_gaps`` of a finished
    profiler session (times in seconds, as measured)."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if d > 0:
                host.append((s, s + d, e.name()))
        elif d > 0:
            device.append((s, s + d, e.name()))
    busy = _union((s, e) for s, e, _ in device)
    by_name = defaultdict(float)
    for s, e, name in device:
        by_name[name[:96]] += (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:top]
    hs = np.array([h[0] for h in host], dtype=np.int64)
    he = np.array([h[1] for h in host], dtype=np.int64)
    named = []
    for length, a, b in gaps:
        best = "none"
        if len(host):
            over = np.minimum(he, b) - np.maximum(hs, a)
            # the host operation that overlaps the gap most; of equals,
            # the innermost (shortest)
            key = over.astype(np.float64) - (he - hs) / (2.0 * (he - hs).max())
            i = int(np.argmax(key))
            if over[i] > 0:
                best = host[i][2]
        named.append([best[:96], length / 1e9])
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
