"""Profiling and roofline accounting on an NVIDIA GPU.

Port of :mod:`mi_fieldcalc_tpu.utils.profiling` (``profiling.py:1-84``):
``trace`` wraps ``torch.profiler`` instead of ``jax.profiler``, and the
memory rates are NVIDIA's published ones.  Usage::

    from mi_fieldcalc_tpu_torch.utils import trace, device_busy_ms

    with trace("trace-dir") as prof:        # a Chrome trace lands there
        out = step(*args)
        torch.cuda.synchronize()
    busy = device_busy_ms(prof.trace_path)  # ms the device was busy

    rl = roofline_for_op(n_inputs=2, n_outputs=1, points=719 * 929,
                         device=torch.device("cuda", 0))
    print(rl.points_per_sec, rl.seconds)    # speed of light for this op

``event_times_ms`` times a function on the card with CUDA events.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from pathlib import Path

import torch

__all__ = ["trace", "Roofline", "roofline_for_op", "device_hbm_gbps",
           "device_f32_flops", "device_events", "device_busy_ms",
           "event_times_ms"]

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


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Speed-of-light estimate for a memory-bound field operator."""
    bytes_accessed: int
    hbm_bytes_per_sec: float
    points: int

    @property
    def seconds(self) -> float:
        return self.bytes_accessed / self.hbm_bytes_per_sec

    @property
    def points_per_sec(self) -> float:
        return self.points / self.seconds

    def fraction(self, measured_seconds: float) -> float:
        """Measured fraction of speed-of-light (1.0 = at the roofline)."""
        return self.seconds / measured_seconds


def roofline_for_op(n_inputs: int, n_outputs: int, points: int,
                    bytes_per_value: int = 4, bytes_per_mask: int = 1,
                    device=None) -> Roofline:
    """Roofline for a fused mask-aware field operator: every input field
    (values+mask) read once, every output written once, at the CUDA
    ``device``'s published memory rate.  Field operators have trivial
    arithmetic intensity, so device memory is the bound."""
    per_field = points * (bytes_per_value + bytes_per_mask)
    return Roofline(
        bytes_accessed=(n_inputs + n_outputs) * per_field,
        hbm_bytes_per_sec=device_hbm_gbps(device),
        points=points,
    )
