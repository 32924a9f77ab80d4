"""The cell ``meps30_l65.ens30`` on four gloo ranks through the launcher
that ``run.py`` uses (:mod:`benchmark.ranks`), at its configuration's
``cpu_test`` size (30 members, 3 levels, a 21x19 grid cut into ragged 2 x
2 blocks): a sound run reads correct, traced and not; the control (the
block reference in the program's place, rounded to bfloat16) reads not
correct; and a fault planted in one rank, or in every rank, reads not
correct: one rank's stale lead time, one seam row altered on one rank,
one member left out of every rank's summary.

The faults are an entry of the test's own, written into a copy of
``benchmark/`` beside the cell's files (new files and entries alone): the
cell's entry with the fault in its ``step``."""

import json
import os
import shutil
from pathlib import Path

import pytest

from benchmark import harness, ranks
from benchmark.tests._small import SPEC, small

ROOT = Path(__file__).resolve().parents[2]
CELL = "meps30_l65.ens30"
CHIPS = 4
SURE = ranks.Limits(wait_s=60.0, setup_s=300.0, after_s=120.0)

FAULTY_ENTRY = '''"""The cell's entry with a fault planted in its step."""

import torch.distributed as dist

from .ensemble_sharded import Entry as _Entry


class Entry(_Entry):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.fault = self.traffic["fault"]
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.last = None

    def lead(self, k):
        out = super().lead(k)
        if self.fault == "member_left_out":
            out = {n: (v[:-1], m[:-1]) for n, (v, m) in out.items()}
        return out

    def step(self, i):
        super().step(i)
        k = i % self.leads
        if self.fault == "stale" and self.rank == 2:
            self.kept[k], self.last = (self.last or self.kept[k]), \\
                self.kept[k]
        elif self.fault == "seam_row" and self.rank == 1:
            # rank 1's last row borders rank 3's block
            v = self.kept[k].mean.vort.values
            v[:, -1, :] += 0.1 * float(v.abs().max())
'''
FAULTS = ("stale", "seam_row", "member_left_out")


def _launch(job: dict) -> tuple:
    return ranks.launch(dict(job, overrides=small(SPEC, CELL)), CHIPS,
                        "cpu", SURE)


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    """A checkout whose ``benchmark/`` has the faulty entry and one mix a
    fault, each the cell's mix with its ``entry`` and ``fault`` (and 2
    warm-ups, so that the stale rank's first unit of the window, lead 0,
    hands back lead 1's summary), and a cell a fault in
    ``BENCHMARK.json``."""
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (here / "entries" / "ensemble_faulty.py").write_text(FAULTY_ENTRY)
    spec = json.loads(json.dumps(SPEC))
    mix = json.loads((here / "traffic" / "ens30.json").read_text())
    for fault in FAULTS:
        (here / "traffic" / f"ens30_{fault}.json").write_text(json.dumps(
            dict(mix, entry="ensemble_faulty", fault=fault, warmup=2)))
        spec["workloads"].append({"name": f"meps30_l65.{fault}",
                                  "config": "meps30_l65",
                                  "traffic": f"ens30_{fault}", "chips": 4,
                                  "why": "a planted fault"})
        for m in spec["end_to_end"]:
            if m["name"] == "summary_ms":
                m["workloads"].append(f"meps30_l65.{fault}")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return tmp_path


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_on_four_ranks_and_is_correct(capfd, trace):
    """One line from four ranks, ``count`` 4, correct; traced, the halo
    exchange's and the member stack's metrics read on rank 0's spans (the
    rooflines and the idle share need a card)."""
    code, out, bad = _launch({"mode": "run", "cell": CELL,
                              "seed": 2 ** 33 + 30, "seconds": 0.2,
                              "trace": trace})
    err = capfd.readouterr().err
    assert code == 0 and bad == [], err[-3000:]
    assert out["correct"] and out["device"]["count"] == CHIPS, out["check"]
    assert out["attempted"] >= 1
    if trace:
        assert set(out["metrics"]) == {"halo_ms.ens30",
                                       "halo_wire_gbps.ens30",
                                       "member_stack_ms.ens30"}
        assert all(m["value"] > 0 for m in out["metrics"].values())
    else:
        assert set(out["metrics"]) == {"summary_ms", "setup_s"}


def test_the_control_comes_out_not_correct_on_four_ranks(capfd):
    """:mod:`benchmark.readings` on four ranks: the program reads correct,
    the control not on either seed, by at least half a bfloat16 ulp at
    the top of some field's binade."""
    code, lines, _ = _launch({"mode": "readings", "cell": CELL,
                              "seeds": [2 ** 32 + 5],
                              "control_seeds": [2 ** 32 + 6, 2 ** 32 + 7],
                              "seconds": 0.1})
    err = capfd.readouterr().err
    assert code == 0, err[-3000:]
    assert [x["kind"] for x in lines] == ["program", "control", "control"]
    for x in lines:
        gap, limit = x["check"]["summary_gap"], x["limits"]["summary_gap"]
        assert (gap > limit) == (x["kind"] == "control"), x
        if x["kind"] == "control":
            assert gap > 2.0 ** -10, x


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_comes_out_not_correct(checkout, capfd, fault):
    code, out, _ = _launch({"mode": "run", "cell": f"meps30_l65.{fault}",
                            "seed": 2 ** 31 + 5, "seconds": 0.2,
                            "trace": 0})
    err = capfd.readouterr().err
    assert code == 0, err[-3000:]
    assert not out["correct"], (fault, out["check"])
    assert out["check"]["summary_gap"]["value"] > 1e-4
