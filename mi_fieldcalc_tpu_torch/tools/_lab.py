"""What the four labs share (they launch through :func:`.._build.call`):
the device dispatch of a wrapper, timing on the device the lab runs on, and
the command line."""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from ..utils.profiling import event_times_ms


def route(fn: str, t: torch.Tensor) -> bool:
    """True where ``t`` lies on a CUDA device (launch the kernel), False
    on the CPU (run the plain version); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{fn}: no kernel for {t.device}")


def assert_same(got, ref, label: str) -> None:
    """Raise unless the tensors of ``got`` equal those of ``ref`` bit for
    bit (shapes, dtypes and every element)."""
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    ref = (ref,) if isinstance(ref, torch.Tensor) else tuple(ref)
    if len(got) != len(ref) or not all(
            g.dtype == r.dtype and torch.equal(g, r)
            for g, r in zip(got, ref)):
        raise AssertionError(f"{label}: the kernel differs from its plain "
                             "version")


def median_ms(fn, dev: torch.device, reps: int = 10,
              queued: bool = True) -> float:
    """Median time of ``fn`` in ms: on a CUDA device between CUDA events,
    ``queued`` behind a busy wait so that the time is the device's own
    (:func:`..utils.profiling.event_times_ms`); the host clock on the
    CPU, at most 3 runs."""
    if dev.type == "cuda":
        return statistics.median(event_times_ms(fn, reps, queued=queued))
    fn()
    out = []
    for _ in range(min(reps, 3)):
        t = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def device_from_args(description: str, argv=None) -> torch.device:
    """The lab's ``--device`` (``cuda`` unless the caller asks for
    ``cpu``); raises where CUDA is asked for and not available."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain versions at a small size")
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"{description}: no CUDA device; pass "
                             "--device cpu for the plain versions")
        dev = torch.device("cuda", 0)
    return dev


def device_label(dev: torch.device) -> str:
    """The device's name, and on the CPU that the times are the plain
    versions' on the host clock."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu (plain versions, host clock)"
