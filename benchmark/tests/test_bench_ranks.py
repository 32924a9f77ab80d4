"""A cell on four chips runs as four ranks through the launcher that
``run.py`` uses (:mod:`benchmark.ranks`), here on the CPU under gloo: one
line, merged over the ranks; a rank that raises or stalls ends the run
non-zero within the launcher's limits, with no rank left alive; a cell on
one chip keeps its line and its one process.

The four-chip cells are a toy, written into a copy of ``benchmark/``
(new files and entries alone): each rank holds its own block of points,
a unit all-reduces one lead time's block over the group, and the check
holds the sum to the plain sum of every rank's block."""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import harness, ranks
from benchmark.tests._small import SPEC

ROOT = Path(__file__).resolve().parents[2]

TOY_ENTRY = '''"""The launcher's toy: one all-reduce a unit."""

import time

import torch
import torch.distributed as dist

from ..compare import Gap


class Entry:
    spans = {}

    def __init__(self, config, traffic, seed, device):
        from mi_fieldcalc_tpu_torch.parallel import distributed
        distributed.initialize(device=device.type)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.traffic, self.fault = traffic, traffic.get("fault", {})
        self.leads = int(traffic["lead_times"])
        g = torch.Generator().manual_seed(seed)
        self.x = torch.rand((self.world, self.leads, config["points"]),
                            generator=g)
        self.mine = self.x[self.rank].to(device)
        # rank r holds r * 64 MiB more, so the peaks differ
        self.ballast = torch.ones(self.rank << 26, dtype=torch.uint8,
                                  device=device)
        self.kept, self.due, self.armed = {}, set(), False
        print(f"toy rank {self.rank} says this on its standard output",
              flush=True)

    def _planted(self, at):
        return self.fault.get("at") == at and \\
            self.fault.get("rank") == self.rank

    def _fault(self, at):
        if self._planted(at):
            if self.fault["kind"] == "raise":
                raise RuntimeError(f"planted in rank {self.rank}'s {at}")
            time.sleep(self.fault["sleep_s"])

    def step(self, i):
        if self.armed:
            self.armed = False
            self._fault("step")
        k = i % self.leads
        buf = self.mine[k].clone()
        dist.all_reduce(buf)
        self.kept[k] = buf
        self.due.add(k)

    def reset(self):
        self._fault("reset")
        self.kept.clear()
        self.due.clear()
        self.armed = True

    def check(self):
        gap = Gap()
        gap.missing(len(self.due - set(self.kept)))
        one = torch.ones((), dtype=torch.bool)
        for k, got in sorted(self.kept.items()):
            got = got.cpu()
            if self._planted("check"):
                got = got * 1.01
            gap.add("sum", got, one, self.x[:, k].sum(0), one)
        return {"sum_gap": (gap.value(), self.traffic["limits"]["sum_gap"])}

    def work(self, units):
        return {}

    def control(self):
        """The plain sum in the all-reduce's place, rounded to bfloat16."""
        entry = self

        def stand_in(tensor, *args, **kwargs):
            k = next(k for k in range(entry.leads)
                     if torch.equal(tensor, entry.mine[k]))
            ref = entry.x[:, k].sum(0).to(torch.bfloat16).float()
            tensor.copy_(ref.to(tensor.device))

        return {"torch.distributed:all_reduce": stand_in}
'''

#: each toy cell's fault: none, a check that reads wrong on rank 2 alone,
#: rank 2 raising in its first step of the window, sleeping before the
#: barrier that ends set-up, or sleeping inside the window's collectives
FAULTS = {
    "clean": {},
    "alters": {"kind": "alter", "at": "check", "rank": 2},
    "raises": {"kind": "raise", "at": "step", "rank": 2},
    "sleeps_at_barrier": {"kind": "sleep", "at": "reset", "rank": 2,
                          "sleep_s": 120},
    "sleeps_in_collective": {"kind": "sleep", "at": "step", "rank": 2,
                             "sleep_s": 120},
}
CHIPS = 4
SMALL = {"points": 64}
#: the launcher's limits for a run that should end well (its defaults
#: are for the card), and for a run with a fault planted in it
SURE = ranks.Limits(wait_s=60.0, setup_s=300.0, after_s=120.0)
QUICK = ranks.Limits(wait_s=3.0, setup_s=90.0, after_s=6.0)
#: a whole faulty run: four processes start (torch's import) and every
#: limit that can end it expires
FAULT_BOUND_S = 60.0
#: a rank's report on standard error (the ranks share it, so a line of one
#: may start after another's last character)
REPORT = re.compile(r"rank (\d+): attempted (\d+) memory_peak_bytes (\d+) "
                    r"check (\{[^}]*\})")
PIDS = re.compile(r"^ranks: \d+ ranks, pids ([\d ]+)$", re.M)


def _toy_spec(chips: int) -> dict:
    cells = [f"toy4.{f}" for f in FAULTS]
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "toy4", "source": "a test fixture",
                            "file": "benchmark/configs/toy4.json",
                            "reduced": [], "why": "one all-reduce a unit"})
    spec["workloads"] += [{"name": c, "config": "toy4", "traffic": f,
                           "chips": chips, "why": "the launcher's test"}
                          for c, f in zip(cells, FAULTS)]
    for m in spec["end_to_end"]:
        if m["name"] == "step_ms":
            m["workloads"] += cells
    spec["per_layer"].append({"name": "device_idle_pct.toy4", "unit": "%",
                              "better": "lower", "source": "device_trace",
                              "layer": "device", "moves": "step_ms",
                              "workloads": cells})
    return spec


def _copy(dst: Path, chips: int) -> Path:
    """A checkout at ``dst``: ``benchmark/`` copied, the toy's files added,
    and ``BENCHMARK.json`` with the toy's entries."""
    here = dst / "benchmark"
    shutil.copytree(ROOT / "benchmark", here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (here / "configs" / "toy4.json").write_text(json.dumps(
        {"name": "toy4", "points": 1 << 20, "cpu_test": SMALL}))
    (here / "entries" / "allreduce.py").write_text(TOY_ENTRY)
    for name, fault in FAULTS.items():
        (here / "traffic" / f"{name}.json").write_text(json.dumps(
            {"entry": "allreduce", "lead_times": 3, "in_flight": 2,
             "warmup": 2, "trace_seconds": 1, "fault": fault,
             "limits": {"sum_gap": 1e-4}}))
    (dst / "BENCHMARK.json").write_text(json.dumps(_toy_spec(chips),
                                                   indent=1))
    return here


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy's checkout; the launcher starts its ranks there, and they
    import the port from this one."""
    here = _copy(tmp_path, CHIPS)
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return tmp_path


def _run(cell: str, trace: int = 0, device: str = "cpu",
         chips: int = CHIPS, overrides=SMALL, limits=SURE) -> tuple:
    job = {"mode": "run", "cell": cell, "seed": 2 ** 31 + 77,
           "seconds": 0.3, "trace": trace, "overrides": overrides}
    t0 = time.monotonic()
    code, out, bad = ranks.launch(job, chips, device, limits)
    return code, out, bad, time.monotonic() - t0


def _reports(err: str) -> dict:
    return {int(m[1]): {"attempted": int(m[2]), "peak": int(m[3]),
                        "check": json.loads(m[4])}
            for m in REPORT.finditer(err)}


def _gone(err: str) -> None:
    """Every rank the launcher started has ended and been reaped."""
    pids = [int(p) for p in PIDS.search(err)[1].split()]
    assert len(pids) >= 2
    assert not [p for p in pids if Path(f"/proc/{p}").exists()]


@pytest.mark.parametrize("cell,trace", [("toy4.clean", 0),
                                        ("toy4.alters", 1)])
def test_four_ranks_make_one_line(toy, capfd, cell, trace):
    """One result from four ranks: ``count`` 4, ``attempted`` each rank's,
    the largest rank's peak, each number the largest rank's value; the
    ranks print nothing on standard output; a fault planted in rank 2's
    check alone makes the line not correct."""
    code, out, bad, _ = _run(cell, trace)
    cap = capfd.readouterr()
    assert code == 0 and bad == [], cap.err[-3000:]
    assert cap.out == ""
    assert cap.err.count("says this on its standard output") == CHIPS
    reports = _reports(cap.err)
    assert sorted(reports) == list(range(CHIPS))
    assert out["device"]["count"] == CHIPS
    assert out["attempted"] >= 1
    assert {r["attempted"] for r in reports.values()} == {out["attempted"]}
    peaks = [r["peak"] for r in reports.values()]
    assert out["device"]["memory_peak_bytes"] == max(peaks) > min(peaks)
    gaps = [r["check"]["sum_gap"] for r in reports.values()]
    assert out["check"]["sum_gap"] == {"value": max(gaps), "limit": 1e-4}
    if cell == "toy4.alters":
        assert max(gaps) == reports[2]["check"]["sum_gap"] > 1e-4
        assert all(reports[r]["check"]["sum_gap"] <= 1e-4 for r in (0, 1, 3))
        assert not out["correct"] and out["failed"] == 1
    else:
        assert out["correct"] and out["failed"] == 0
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device"] + (["breakdown"] if trace else []) + [
                             "check"]
    if trace:
        assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]
        assert set(out["metrics"]) <= {"device_idle_pct.toy4"}
    else:
        assert set(out["metrics"]) == {"step_ms", "setup_s"}
        assert all(m["value"] > 0 for m in out["metrics"].values())
    _gone(cap.err)


@pytest.mark.parametrize("cell,why", [
    ("toy4.raises", r"rank 2 exited with 1"),
    ("toy4.sleeps_at_barrier", r"rank [013] exited with 1"),
    ("toy4.sleeps_in_collective", r"no progress in")])
def test_a_rank_that_fails_or_stalls_ends_the_run(toy, capfd, cell, why):
    """Rank 2 raises in its first step of the window, misses the barrier
    that ends set-up (the others wait ``wait_s`` there, raise and exit
    1), or sleeps inside the window's all-reduce (the others wait inside
    it; the launcher's ``after_s`` ends the run): each run ends non-zero
    with no result, within its limits, and no rank is left alive."""
    code, out, bad, secs = _run(cell, limits=QUICK)
    err = capfd.readouterr().err
    assert code != 0 and out is None and bad == []
    assert re.search(why, err), err[-3000:]
    assert secs < FAULT_BOUND_S
    _gone(err)


def test_readings_run_on_four_ranks(toy, capfd):
    """``readings.py``'s seeds on four ranks: rank 0's lines, each number
    the largest over the ranks; the program reads correct and the control
    (the plain sum in the all-reduce's place, in bfloat16) not."""
    code, lines, _ = ranks.launch(
        {"mode": "readings", "cell": "toy4.clean", "seeds": [5],
         "control_seeds": [6, 7], "seconds": 0.1, "overrides": SMALL},
        CHIPS, "cpu", SURE)
    err = capfd.readouterr().err
    assert code == 0, err[-3000:]
    assert [x["kind"] for x in lines] == ["program", "control", "control"]
    for x in lines:
        over = x["check"]["sum_gap"] > x["limits"]["sum_gap"]
        assert over == (x["kind"] == "control"), x
    assert len(re.findall(r"rank \d+: attempted", err)) == 3 * CHIPS


@pytest.mark.parametrize("reports,error", [
    ([{"units": 3, "check": {"g": [0.1, 1.0]}},
      {"units": 4, "check": {"g": [0.1, 1.0]}}], "different units"),
    ([{"units": 3, "check": {"g": [0.1, 1.0]}},
      {"units": 3, "check": {"g": [0.1, 2.0]}}], "disagree on their limits"),
])
def test_a_merge_of_ranks_that_disagree_fails(reports, error):
    with pytest.raises(RuntimeError, match=error):
        ranks.merge(reports)


def test_a_merge_takes_the_largest_value_and_any_nan():
    out = ranks.merge([
        {"units": 2, "check": {"a": [0.5, 1.0], "b": [0.1, 1.0]},
         "peak": 7, "busy_s": 1.0},
        {"units": 2, "check": {"a": [0.25, 1.0], "b": [math.nan, 1.0]},
         "peak": 9, "busy_s": 3.0}])
    assert out["units"] == 2 and out["peak"] == 9 and out["busy_s"] == 2.0
    assert out["check"]["a"] == (0.5, 1.0)
    assert math.isnan(out["check"]["b"][0])


def test_a_cell_on_one_chip_keeps_its_line_and_its_process():
    """A one-chip cell runs in its own process and loads nothing of the
    launcher; its line has exactly the keys it had before cells on four
    chips, traced and not."""
    code = (
        "import json, sys\n"
        "from benchmark import harness\n"
        "from benchmark.tests._small import SPEC, small\n"
        "cell = 'arome_l65.steps'\n"
        "outs = [harness.run_cell(SPEC, cell, 2 ** 31 + 79, 0.05, t, 'cpu',\n"
        "                         overrides=small(SPEC, cell))\n"
        "        for t in (False, True)]\n"
        "print(json.dumps([[list(o), sorted(o['device'])] for o in outs]\n"
        "                 + ['benchmark.ranks' in sys.modules]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    (plain, plain_dev), (traced, traced_dev), loaded = json.loads(
        p.stdout.splitlines()[-1])
    assert plain == ["correct", "attempted", "failed", "metrics", "device",
                     "check"]
    assert traced == ["correct", "attempted", "failed", "metrics", "device",
                      "breakdown", "check"]
    assert plain_dev == ["count", "kind", "memory_peak_bytes", "platform"]
    assert traced_dev == sorted(plain_dev + ["busy_s", "window_s"])
    assert not loaded


@pytest.mark.cuda
def test_the_toy_over_nccl_on_every_card(tmp_path, monkeypatch, capfd):
    """On a host with two cards or more: the toy on every card over NCCL,
    through ``run.py`` (one line on standard output, the last) and through
    the launcher with a rank that raises or stalls in the window."""
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two CUDA cards or more")
    here = _copy(tmp_path, n)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for trace in (0, 1):
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", "toy4.clean",
             "--seed", str(2 ** 32 + trace), "--seconds", "2", "--trace",
             str(trace)], cwd=tmp_path, env=env, capture_output=True,
            text=True, timeout=600)
        with capfd.disabled():
            print(p.stderr[-4000:], p.stdout, sep="\n")
        assert p.returncode == 0, p.stderr[-3000:]
        lines = p.stdout.splitlines()
        assert len(lines) == 1
        out = json.loads(lines[0])
        assert out["correct"] and out["device"]["count"] == n
        assert out["device"]["platform"] == "gpu"
        _gone(p.stderr)
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setenv("PYTHONPATH", env["PYTHONPATH"])
    for cell in ("toy4.raises", "toy4.sleeps_in_collective"):
        code, out, _, secs = _run(cell, device="cuda", chips=n,
                                  overrides=None, limits=QUICK)
        err = capfd.readouterr().err
        with capfd.disabled():
            print(cell, code, secs, err[-2000:], sep="\n")
        assert code != 0 and out is None and secs < FAULT_BOUND_S
        _gone(err)
