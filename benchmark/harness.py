"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, and the result's line.

The cell, its configuration and its traffic mix are found by name:
``BENCHMARK.json`` names the cell's ``config`` and ``traffic``, which are
``configs/<config>.json`` and ``traffic/<traffic>.json``; the traffic file
names its driver, ``entries/<entry>.py``; each metric is read by
``metrics/<metric>.py``, or, where there is no file of that name, by
``metrics/<head>.py`` for the part of the name before its first dot (one
reader serves ``device_idle_pct.ens`` and ``device_idle_pct.steps``).  A
later cell, mix or metric is new files and entries; this file does not
change.  A configuration is added as a new ``configs/<config>.json`` with
its own ``cpu_test`` (the keys the CPU tests override and their small
values, :mod:`benchmark.tests._small`; no run on the card reads it), plus
its entries in ``BENCHMARK.json``.  A new cell joins an end-to-end time
metric it reports, such as ``step_ms``, by adding its name to that
metric's ``workloads``.

An entry module defines ``Entry(config, traffic, seed, device)``, whose
construction is the cell's set-up (inputs drawn on the device), with:

* ``step(i)``: enqueue unit of work ``i`` (a summary, a step, a request)
  and keep what the check needs of it;
* ``reset()``: forget what the warm-up kept;
* ``spans``: ``{layer: "module:attr"}``, the public functions of the
  program spanned in a traced run;
* ``check()``: ``{number: (value, limit)}``, the program's outputs held to
  the plain reference;
* ``work(units)``: the counts the per-layer readers divide (bytes and
  operations a span's work needs), read after the check.
* ``control()``: ``{"module:attr": stand_in}``, the plain reference in
  the program's place at a lower precision (:mod:`benchmark.readings`).

The window is a closed loop: unit ``i`` is enqueued only once unit
``i - in_flight`` has finished on the device.  Its time is all the time
from its start until every unit enqueued has finished.

A cell whose ``chips`` is N > 1 runs as N processes, one a card
(:mod:`benchmark.ranks`): each rank builds its own ``Entry`` on
``cuda:<LOCAL_RANK>`` under torchrun's environment, and the entry joins
the process group itself (the port's ``parallel.distributed.initialize``).
Every rank warms up, then waits at a host barrier; ``setup_s`` ends there,
on rank 0.  In the window rank 0 alone reads the clock and tells every
other rank on the harness's host channel whether unit ``i`` runs, so every
rank runs the same units; each keeps its own ``in_flight`` markers, and
the window ends when every rank has finished its units on its card and
passed a second barrier (its seconds are rank 0's).  Each rank then checks
its own outputs; rank 0 merges the reports (the same ``attempted`` on
every rank, the largest peak, each compared number's largest value, the
limits equal) and alone makes the line, its metrics read from its own
spans and trace.  The one rule for an entry of such a cell: every rank
runs the same units and the same collectives in the same order, the
warm-up and the check included.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import torch

from .spans import Spans, patched, profiler, read_trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "mi_fieldcalc_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def resolve(spec: dict, cell: str) -> dict:
    """The cell's ``workloads`` entry with its configuration and traffic
    files loaded, and the metrics it reports: ``{"cell", "config",
    "traffic", "end_to_end", "per_layer"}``."""
    work = {w["name"]: w for w in spec["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    w = work[cell]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]

    def applies(m):
        return "workloads" not in m or cell in m["workloads"]

    return {"cell": w,
            "config": load_json(ROOT / conf["file"]),
            "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            "end_to_end": [m for m in spec["end_to_end"] if applies(m)],
            "per_layer": [m for m in spec["per_layer"] if applies(m)]}


def entry_module(traffic: dict):
    return importlib.import_module(f"benchmark.entries.{traffic['entry']}")


def metric_file(name: str) -> Path:
    """``metrics/<name>.py``, else ``metrics/<head>.py`` for the part of
    the name before its first dot."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return path


def metric_reader(name: str):
    """The ``read`` of the metric's file (:func:`metric_file`)."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _done_marker(device: torch.device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def memory_peak(device: torch.device) -> int:
    """The most the run held: the caching allocator's peak on a card; on
    the CPU the process's peak resident bytes (``VmHWM``, else
    ``ru_maxrss``, which may keep the launching process's peak)."""
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    try:
        status = Path("/proc/self/status").read_text()
    except OSError:
        status = ""
    kb = [line.split()[1] for line in status.splitlines()
          if line.startswith("VmHWM:")]
    if not kb:
        import resource
        kb = [resource.getrusage(resource.RUSAGE_SELF).ru_maxrss]
    return int(kb[0]) * 1024


def window(entry, seconds: float, in_flight: int, device,
           group=None) -> tuple:
    """Units of work back to back for ``seconds``: ``(units, seconds)``.
    With ``group`` (a rank of an N-card run) rank 0's clock decides for
    every rank whether each unit runs, and the window closes at a host
    barrier once every rank's card has finished."""
    pending = deque()
    units = 0
    t0 = time.perf_counter()
    while True:
        if len(pending) >= in_flight:
            ev = pending.popleft()
            if ev is not None:
                ev.synchronize()
        stop = time.perf_counter() - t0 >= seconds and units > 0
        if group is not None:
            stop = group.decide(units, stop)
        if stop:
            break
        entry.step(units)
        pending.append(_done_marker(device))
        units += 1
    synchronize(device)
    if group is not None:
        group.barrier("window")
    return units, time.perf_counter() - t0


def run_cell(spec: dict, cell: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = None,
             overrides: dict = None, group=None) -> dict:
    """One run of ``cell``; returns the result's line as a dict.
    ``overrides`` replaces keys of the configuration (the CPU tests run a
    cell at a small size).  ``group`` is this process's rank of an N-card
    run (:class:`benchmark.ranks.Group`): rank 0 returns the line merged
    over the ranks, every other rank ``None``."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    r = resolve(spec, cell)
    config = dict(r["config"], **(overrides or {}))
    traffic = r["traffic"]
    mod = entry_module(traffic)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    marks = [("start", time.perf_counter())]
    entry = mod.Entry(config, traffic, seed, dev)
    synchronize(dev)
    marks.append(("inputs", time.perf_counter()))
    for i in range(int(traffic["warmup"])):
        entry.step(i)
        synchronize(dev)
        marks.append((f"warm-up {i + 1}", time.perf_counter()))
    entry.reset()
    if group is not None:
        group.barrier("ready")
        marks.append(("every rank ready", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    print(("" if group is None else f"rank {group.rank}: ")
          + "set-up split, s: process start to card ready "
          f"{marks[0][1] - t_start:.3f}; " + "; ".join(
              f"{name} {t - marks[j][1]:.3f}"
              for j, (name, t) in enumerate(marks[1:])), file=sys.stderr)

    in_flight = int(traffic["in_flight"])
    spans = Spans(dev)
    trace_out = None
    if trace:
        secs = min(seconds, float(traffic["trace_seconds"]))
        with patched(spans, entry.spans):
            prof = profiler(dev)
            prof.start()
            units, window_s = window(entry, secs, in_flight, dev, group)
            prof.stop()
        trace_out = read_trace(prof)
        del prof
    else:
        units, window_s = window(entry, seconds, in_flight, dev, group)

    peak = memory_peak(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check = entry.check()
    busy_s = trace_out["busy_s"] if trace else None
    count = 1
    if group is not None:
        merged = group.merge({"units": units, "peak": peak, "check": check,
                              "busy_s": busy_s})
        if merged is None:
            return None
        peak, check, busy_s = (merged["peak"], merged["check"],
                               merged["busy_s"])
        count = group.world
    failed = sum(1 for v, lim in check.values() if not v <= lim)

    # what the metric readers see
    run = SimpleNamespace(units=units, window_s=window_s, setup_s=setup_s,
                          spans=spans.as_ms(), trace=trace_out,
                          work=entry.work(units) if trace else {})
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    metrics = {}
    for m in (r["per_layer"] if trace else r["end_to_end"]):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind,
                   "count": count, "memory_peak_bytes": int(peak)}
    out = {"correct": failed == 0, "attempted": units, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = busy_s
        device_info["window_s"] = window_s
        out["breakdown"] = {"device_ops": trace_out["device_ops"],
                            "idle_gaps": trace_out["idle_gaps"]}
    out["check"] = {name: {"value": v, "limit": lim}
                    for name, (v, lim) in check.items()}
    return out
