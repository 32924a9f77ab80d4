"""The benchmark's cells resolve to their files by name and run end to end
on the CPU at their configuration's ``cpu_test`` size (the program's kernel
wrappers run their plain versions there); a configuration, mix, cell and
metrics added as new files and entries alone run and are held to their
control; ``BENCHMARK.json`` keeps to its format; nothing a run loads is JAX
or the JAX package."""

import json
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.tests._small import SPEC, small

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    r = harness.resolve(SPEC, cell)
    assert r["traffic"]["entry"]
    mod = harness.entry_module(r["traffic"])
    assert hasattr(mod, "Entry")
    for m in r["end_to_end"] + r["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    assert any(m["name"] == "setup_s" for m in r["end_to_end"])
    assert len(r["end_to_end"]) >= 2 and r["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_on_the_cpu_and_is_correct(cell, trace):
    out = harness.run_cell(SPEC, cell, 2 ** 31 + 11, 0.05, trace, "cpu",
                           overrides=small(SPEC, cell))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "check"
    assert all(c["value"] <= c["limit"] for c in out["check"].values())
    r = harness.resolve(SPEC, cell)
    if trace:
        assert set(out["metrics"]) <= {m["name"] for m in r["per_layer"]}
        assert out["device"]["window_s"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {m["name"] for m in r["end_to_end"]}
        assert all(v["value"] > 0 for v in out["metrics"].values())


#: a configuration, a traffic mix, a cell and two per-layer metrics that
#: no cell of BENCHMARK.json has: new files and entries only.  The CPU runs
#: the configuration at its own ``cpu_test``, never at its own size.
NEW_CELL = "hybrid_l40.scattered"
NEW_FILES = {
    "configs/hybrid_l40.json": json.dumps(
        {"name": "hybrid_l40", "levels": 40, "ny": 301, "nx": 257,
         "alevel": ["linspace", 0.0, 30.0], "blevel": ["linspace", 1.0, 0.7],
         "xmapr": 4.0e-7, "ymapr": 3.6e-7, "fcoriolis": 1.2e-4,
         "cpu_test": {"levels": 3, "ny": 13, "nx": 19}}),
    "traffic/scattered.json": json.dumps(
        {"entry": "pipeline_steps", "lead_times": 3, "in_flight": 1,
         "warmup": 3, "trace_seconds": 10, "undef": 0.05,
         "fields": {"tk": ["normal", 270.0, 10.0],
                    "q": ["uniform", 1e-4, 5e-3],
                    "u": ["normal", 0.0, 8.0], "v": ["normal", 0.0, 8.0],
                    "ps": ["normal", 990.0, 10.0]},
         "limits": {"step_gap": 1e-4}}),
    "metrics/b1_ms.scattered.py":
        "from benchmark.metrics._common import span_ms\n\n\n"
        "def read(run):\n"
        "    total = span_ms(run, 'b1')\n"
        "    return None if total is None else total / run.units\n",
}
NEW_ENTRIES = {
    "configs": [{"name": "hybrid_l40", "source": "a test fixture",
                 "file": "benchmark/configs/hybrid_l40.json", "reduced": [],
                 "why": "forty levels"}],
    "workloads": [{"name": NEW_CELL, "config": "hybrid_l40",
                   "traffic": "scattered", "chips": 1,
                   "why": "undefined points scattered over every field"}],
    "per_layer": [{"name": n, "unit": u, "better": "lower", "source": src,
                   "layer": layer, "moves": "step_ms",
                   "workloads": [NEW_CELL]}
                  for n, u, src, layer in (
                      ("b1_ms.scattered", "ms", "program_span",
                       "pipeline kernel"),
                      ("device_idle_pct.scattered", "%", "device_trace",
                       "device"))]}


def _written(root: Path) -> dict:
    """Every file under ``root`` outside ``__pycache__``: its size and the
    time it was last written."""
    return {p: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def added(tmp_path, monkeypatch):
    """A copy of the benchmark's configurations, mixes, readers and
    reference with the new files added and no file edited, beside a copy
    of ``BENCHMARK.json`` with the new entries and the new cell added to
    ``step_ms``'s ``workloads``; the harness reads both.  Yields the
    spec, and what the checkout's ``benchmark/`` held before."""
    before = _written(ROOT / "benchmark")
    here = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "reference"):
        shutil.copytree(harness.HERE / sub, here / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in NEW_FILES.items():
        assert not (harness.HERE / rel).exists()
        (here / rel).write_text(text)
    spec = {k: (v + NEW_ENTRIES[k] if k in NEW_ENTRIES else v)
            for k, v in SPEC.items()}
    spec["end_to_end"] = [
        dict(m, workloads=m["workloads"] + [NEW_CELL])
        if m["name"] == "step_ms" else m for m in spec["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    yield harness.benchmark_spec(), before


@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_and_its_metrics_are_added_as_files_and_entries_alone(
        added, trace):
    """A new configuration, mix, cell and per-layer metrics run over the
    existing pipeline driver at the configuration's own ``cpu_test``
    (:func:`small`), the cell reports ``step_ms`` by its name in that
    metric's ``workloads``, and ``device_idle_pct`` serves the new cell's
    idle share by the part of its name before the dot; no file of the
    checkout's ``benchmark/`` is written."""
    spec, before = added
    assert small(spec, NEW_CELL) == {"levels": 3, "ny": 13, "nx": 19}
    out = harness.run_cell(spec, NEW_CELL, 2 ** 32 + 3, 0.05, trace, "cpu",
                           overrides=small(spec, NEW_CELL))
    assert out["correct"] and out["check"]["step_gap"]["value"] == 0.0
    if trace:
        # the CPU has no device trace, so the idle share reads nothing
        assert set(out["metrics"]) == {"b1_ms.scattered"}
        assert harness.metric_file("device_idle_pct.scattered") == \
            harness.HERE / "metrics" / "device_idle_pct.py"
    else:
        assert set(out["metrics"]) == {"step_ms", "setup_s"}
    assert _written(ROOT / "benchmark") == before


def test_an_added_cell_is_held_to_its_control(added):
    """:func:`benchmark.readings.readings` finds the new cell in the
    copied ``BENCHMARK.json``: the program reads correct and the control
    not correct on every seed."""
    from benchmark.readings import readings
    spec, before = added
    lines = list(readings(NEW_CELL, [5], [6, 7, 8], 0.05, "cpu",
                          small(spec, NEW_CELL)))
    assert [x["kind"] for x in lines] == ["program"] + ["control"] * 3
    for x in lines:
        bad = [k for k, v in x["check"].items() if v > x["limits"][k]]
        assert bool(bad) == (x["kind"] == "control"), x
    assert _written(ROOT / "benchmark") == before


@pytest.mark.parametrize("fault", ["missing", "unknown_key"])
def test_a_configuration_without_a_sound_cpu_test_is_named(
        tmp_path, monkeypatch, fault):
    """:func:`small` names the configuration's file and the key."""
    cell = CELLS[0]
    name = {w["name"]: w["config"] for w in SPEC["workloads"]}[cell]
    file = {c["name"]: c["file"] for c in SPEC["configs"]}[name]
    config = harness.load_json(ROOT / file)
    if fault == "missing":
        del config["cpu_test"]
        expect = f"{file} has no key 'cpu_test'"
    else:
        config["cpu_test"] = dict(config["cpu_test"], nz=3)
        expect = f"{file}: 'cpu_test' overrides ['nz']"
    (tmp_path / file).parent.mkdir(parents=True)
    (tmp_path / file).write_text(json.dumps(config))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    with pytest.raises(LookupError, match=re.escape(expect)):
        small(SPEC, cell)


def test_same_seed_same_inputs():
    from benchmark.entries.pipeline_steps import Entry
    r = harness.resolve(SPEC, "arome_l65.steps")
    cfg = dict(r["config"], **small(SPEC, "arome_l65.steps"))
    a = Entry(cfg, r["traffic"], 2 ** 33 + 1, torch.device("cpu"))
    b = Entry(cfg, r["traffic"], 2 ** 33 + 1, torch.device("cpu"))
    c = Entry(cfg, r["traffic"], 2 ** 33 + 2, torch.device("cpu"))
    for name in a.fields:
        assert torch.equal(a.fields[name][0], b.fields[name][0])
        assert torch.equal(a.fields[name][1], b.fields[name][1])
    assert not torch.equal(a.fields["tk"][0], c.fields["tk"][0])


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mi_fieldcalc_tpu_torch_extra",
                        types.ModuleType("mi_fieldcalc_tpu_torch_extra"))
    assert "mi_fieldcalc_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mi_fieldcalc_tpu.fake",
                        types.ModuleType("mi_fieldcalc_tpu.fake"))
    assert "mi_fieldcalc_tpu.fake" in harness.forbidden_modules()


def _fresh(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_no_jax_and_the_reference_none_of_the_port():
    code = (
        "import importlib, json, sys\n"
        "from benchmark import harness\n"
        "mods = [p.stem for p in (harness.HERE / 'reference').glob('*.py')]\n"
        "for m in mods:\n"
        "    importlib.import_module('benchmark.reference.' + m)\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
        "from benchmark.tests._small import SPEC, small\n"
        "for cell in [w['name'] for w in SPEC['workloads']]:\n"
        "    harness.run_cell(SPEC, cell, 3, 0.02, True, 'cpu',\n"
        "                     overrides=small(SPEC, cell))\n"
        "print(json.dumps([mods, ref, harness.forbidden_modules()]))\n")
    p = _fresh(code)
    assert p.returncode == 0, p.stderr[-3000:]
    mods, ref, bad = json.loads(p.stdout.splitlines()[-1])
    assert mods
    assert "mi_fieldcalc_tpu_torch" not in ref
    assert "jax" not in ref and "mi_fieldcalc_tpu" not in ref
    assert bad == []


def test_run_refuses_without_a_card():
    """With the card hidden, a run exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_json_keeps_its_format():
    b = harness.benchmark_spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    # a cell on four chips where what it measures exists only across
    # chips: at most a quarter of the cells, rounded down, and always one
    four = [w["name"] for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(b["workloads"]) // 4), four
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for cell in m["workloads"]:
            reports = [e["name"] for e in b["end_to_end"]
                       if cell in e.get("workloads", [cell])]
            assert m["moves"] in reports
