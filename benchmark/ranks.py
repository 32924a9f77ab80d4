"""A cell on N cards: N processes, one a card, reported as one run.

:func:`launch` is the launcher that ``run.py`` and ``readings.py`` call
for a cell whose ``chips`` is N > 1.  It hosts the harness's host channel
(a ``torch.distributed.TCPStore`` on ``127.0.0.1``, apart from the entry's
own process group) and starts N processes of this file, rank ``r`` with
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` on a free port)
on ``cuda:<r>``, or on the CPU under gloo for the tests.  Each rank runs
:func:`benchmark.harness.run_cell` (or :func:`benchmark.readings.readings`)
with its :class:`Group`; the entry joins the process group itself.  The
ranks' standard output goes to the launcher's standard error: only the
caller prints on standard output, once every rank has ended well.

Faults end the run; they never hang it.  Every rank's process is in a
session of its own, and is killed with whatever it started when the
launcher returns.  The launcher gives up and returns non-zero when

* a rank exits non-zero (a rank that raises exits 1);
* a rank waits more than ``Limits.wait_s`` at a barrier, for rank 0's
  decision on a unit, or (rank 0) for the other ranks' reports: it raises;
* the ranks pass no mark of progress (a barrier or a merge, counted by
  rank 0) for ``Limits.setup_s`` from the launch, or for the window's
  seconds plus ``Limits.after_s`` after their last mark: a rank that hangs
  inside a collective leaves the others waiting there, not at a barrier.

A rank dies with its launcher (``PR_SET_PDEATHSIG``).

    python3 benchmark/ranks.py '<job as JSON>'     # one rank; launch() runs it
"""

from __future__ import annotations

import datetime
import json
import math
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
HOST = "127.0.0.1"


class Limits(NamedTuple):
    """The launcher's time limits, in seconds."""
    #: a rank's longest wait at a barrier, for a decision or for reports
    wait_s: float = 120.0
    #: from the launch until the first mark of progress (every rank warmed
    #: up; the first run in a checkout builds the kernels)
    setup_s: float = 1100.0
    #: from one mark of progress until the next, besides the window
    after_s: float = 300.0


class Group:
    """One rank's end of the harness's host channel.

    Rank 0 reads the clock and sets ``<seq>/go/<unit>``; every other rank
    waits for that key, so all run the same units, none ahead of rank 0.
    Barriers and merges are keyed by a sequence number that every rank
    advances alike; rank 0 counts each under ``progress`` for the
    launcher."""

    def __init__(self, port: int, rank: int, world: int, wait_s: float):
        from torch.distributed import TCPStore
        self.rank, self.world = rank, world
        self.store = TCPStore(HOST, port, None, False,
                              timeout=datetime.timedelta(seconds=wait_s))
        self.seq = 0
        #: host seconds spent in :meth:`decide`, and its calls
        self.channel_s, self.decisions = 0.0, 0
        #: forbidden modules any rank had loaded when it reported
        self.forbidden = []

    def _next(self, name: str) -> str:
        self.seq += 1
        return f"{self.seq}/{name}"

    def _progress(self) -> None:
        if self.rank == 0:
            self.store.add("progress", 1)

    def decide(self, unit: int, stop: bool) -> bool:
        """Rank 0's ``stop`` for ``unit``, on every rank."""
        t = time.perf_counter()
        key = f"{self.seq}/go/{unit}"
        if self.rank == 0:
            self.store.set(key, "0" if stop else "1")
        else:
            stop = self.store.get(key) == b"0"
        self.channel_s += time.perf_counter() - t
        self.decisions += 1
        return stop

    def barrier(self, name: str) -> None:
        """Return once every rank has called it; raise after ``wait_s``."""
        key = self._next(name)
        if self.store.add(f"{key}/arrived", 1) == self.world:
            self.store.set(f"{key}/all", "1")
        self.store.wait([f"{key}/all"])
        self._progress()

    def gather(self, name: str, payload) -> list | None:
        """Every rank's ``payload`` (JSON) in rank order on rank 0;
        ``None`` on the others."""
        key = self._next(name)
        self.store.set(f"{key}/{self.rank}", json.dumps(payload))
        if self.rank:
            return None
        keys = [f"{key}/{r}" for r in range(self.world)]
        self.store.wait(keys)
        out = [json.loads(self.store.get(k)) for k in keys]
        self._progress()
        return out

    def merge(self, mine: dict) -> dict | None:
        """Every rank's ``units``, ``check`` and, where given, ``peak`` and
        ``busy_s``, merged on rank 0 (:func:`merge`); ``None`` on the
        others.  Each rank adds the forbidden modules it has loaded."""
        from benchmark.harness import forbidden_modules
        mine_check = {k: v for k, (v, _) in mine["check"].items()}
        _say(f"rank {self.rank}: attempted {mine['units']} "
             f"memory_peak_bytes {mine.get('peak')} check "
             f"{json.dumps(mine_check)}")
        reports = self.gather("report",
                              dict(mine, forbidden=forbidden_modules()))
        if reports is None:
            return None
        self.forbidden = sorted({m for r in reports for m in r["forbidden"]}
                                | set(self.forbidden))
        return merge(reports)


def merge(reports: list) -> dict:
    """One report of the ranks': ``units`` equal on every rank (else the
    run fails), each compared number's largest value (NaN where any rank
    reads NaN) under a limit that every rank gives alike (else the run
    fails), the largest ``peak`` and the mean ``busy_s``."""
    units = [r["units"] for r in reports]
    if len(set(units)) != 1:
        raise RuntimeError(f"the ranks attempted different units: {units}")
    limits = [{k: lim for k, (_, lim) in r["check"].items()}
              for r in reports]
    if any(lim != limits[0] for lim in limits):
        raise RuntimeError(f"the ranks' checks disagree on their limits: "
                           f"{limits}")
    check = {}
    for k, lim in limits[0].items():
        values = [float(r["check"][k][0]) for r in reports]
        check[k] = (math.nan if any(map(math.isnan, values))
                    else max(values), lim)
    out = {"units": units[0], "check": check}
    if "peak" in reports[0]:
        out["peak"] = max(int(r["peak"]) for r in reports)
    busy = [r.get("busy_s") for r in reports]
    out["busy_s"] = None if None in busy else sum(busy) / len(busy)
    return out


def _say(line: str) -> None:
    """One line on standard error in one write, whole among the ranks'."""
    sys.stderr.write(line + "\n")
    sys.stderr.flush()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def _stop(procs) -> None:
    """Kill each rank's session (the rank and whatever it started) and
    wait for each rank."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    for p in procs:
        p.wait()


def _watch(procs, store, seconds: float, limits: Limits) -> str | None:
    """Wait for every rank; why the run failed, or ``None``."""
    t0 = time.monotonic()
    deadline, seen = t0 + limits.setup_s, 0
    while True:
        for r, p in enumerate(procs):
            code = p.poll()
            if code not in (None, 0):
                return f"rank {r} exited with {code}"
        if all(p.poll() == 0 for p in procs):
            return None
        now = time.monotonic()
        marks = store.add("progress", 0)
        if marks != seen:
            seen, deadline = marks, now + seconds + limits.after_s
        if now > deadline:
            return (f"no progress in {now - t0:.1f} s (limit "
                    f"{limits.setup_s:g} s to the first mark, then the "
                    f"window's {seconds:g} s + {limits.after_s:g} s a mark)")
        time.sleep(0.05)


def launch(job: dict, chips: int, device: str = "cuda",
           limits: Limits = Limits()) -> tuple:
    """Run ``job`` (``mode`` ``"run"`` or ``"readings"``, and the
    arguments of that mode) on ``chips`` ranks; ``(code, out,
    forbidden)``: 0, rank 0's result (the run's line, or the readings'
    lines) and the forbidden modules any rank loaded; or non-zero with
    the reason on standard error, and nothing."""
    from torch.distributed import TCPStore

    from benchmark import harness
    store = TCPStore(HOST, 0, None, True,
                     timeout=datetime.timedelta(seconds=limits.wait_s),
                     wait_for_workers=False)
    job = dict(job, port=store.port, device=device, wait_s=limits.wait_s,
               parent=os.getpid(),
               t_start=job.get("t_start", time.monotonic()))
    master_port = _free_port()
    procs = []
    try:
        for r in range(chips):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(chips), LOCAL_WORLD_SIZE=str(chips),
                       MASTER_ADDR=HOST, MASTER_PORT=str(master_port))
            procs.append(subprocess.Popen(
                [sys.executable, str(harness.HERE / "ranks.py"),
                 json.dumps(job)],
                env=env, stdin=subprocess.DEVNULL, stdout=2,
                start_new_session=True))
        _say(f"ranks: {chips} ranks, pids "
             f"{' '.join(str(p.pid) for p in procs)}")
        why = _watch(procs, store, float(job.get("seconds", 0)), limits)
        if why is None:
            try:    # rank 0's last message may still be on its way
                store.wait(["result"], datetime.timedelta(seconds=10))
            except RuntimeError:
                why = "rank 0 ended without a result"
        if why is not None:
            _say(f"ranks: {why}; every rank stopped")
            return 1, None, []
        result = json.loads(store.get("result"))
        return 0, result["out"], result["forbidden"]
    finally:
        _stop(procs)


def _die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when its launcher dies."""
    if sys.platform.startswith("linux"):
        import ctypes
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)    # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(1)


def _rank(job: dict) -> int:
    """One rank of ``job``: its run or readings; rank 0 leaves the result
    in the channel."""
    _die_with_parent(job["parent"])
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness, readings

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    t_start = time.perf_counter() - (time.monotonic() - job["t_start"])
    dev = (torch.device("cuda", int(os.environ["LOCAL_RANK"]))
           if job["device"] == "cuda" else torch.device("cpu"))
    group = Group(job["port"], rank, world, job["wait_s"])
    overrides = job.get("overrides")
    if job["mode"] == "run":
        out = harness.run_cell(harness.benchmark_spec(), job["cell"],
                               job["seed"], job["seconds"],
                               bool(job["trace"]), dev, t_start, overrides,
                               group)
    else:
        out = list(readings.readings(job["cell"], job["seeds"],
                                     job["control_seeds"], job["seconds"],
                                     dev, overrides, group))
    per_unit = group.channel_s * 1e6 / max(1, group.decisions)
    _say(f"rank {rank}: channel {per_unit:.1f} us a unit over "
         f"{group.decisions} decisions")
    if rank == 0:
        bad = sorted(set(group.forbidden) | set(harness.forbidden_modules()))
        group.store.set("result", json.dumps({"out": out, "forbidden": bad}))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank(json.loads(sys.argv[1])))
