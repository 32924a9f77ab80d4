"""The check decides ``correct``: the control (the plain reference in the
program's place, its output values rounded to bfloat16 and its masks
exact) and the faults that a cell can have, each planted under a whole
run on the CPU, come out as not correct; a sound run comes out correct
(``test_bench_cells.py``)."""

import pytest
import torch

from benchmark import harness
from benchmark.readings import readings
from benchmark.spans import replaced
from benchmark.tests._small import SPEC, small

FUSED = "mi_fieldcalc_tpu_torch.ops.fused:derived_fields_fused"
SUMMARY = "mi_fieldcalc_tpu_torch.models.ensemble:ensemble_derived_summary"
CELLS = [w["name"] for w in SPEC["workloads"]]


def _stale(fn):
    """A step that hands back the previous step's output, as if its state
    were left unchanged."""
    last = []

    def step(*args, **kwargs):
        out = fn(*args, **kwargs)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return step


def _altered(fn):
    """One answer altered where it is produced: one defined value of each
    output moved by a tenth of its plane's largest magnitude."""
    def step(*args, **kwargs):
        out = fn(*args, **kwargs)
        v = out.values
        plane = v[min(6, v.shape[0] - 1)] if v.dim() > 2 else v
        mask = getattr(out, "mask", None)
        flat = plane.reshape(-1)
        i = 0 if mask is None else int(mask.reshape(-1).nonzero()[0, 0])
        flat[i] += 0.1 * float(plane.abs().max())
        return out
    return step


def _half(fn):
    """Half of the members left out, the summary taken over the rest."""
    def step(tk, q, u, v, ps, *rest, **kwargs):
        n = max(1, tk.values.shape[0] // 2)
        cut = [type(f)(f.values[:n], f.mask[:n]) for f in (tk, q, u, v, ps)]
        return fn(*cut, *rest, **kwargs)
    return step


FAULTS = [("arome_l65.steps", "stale", {FUSED: _stale}),
          ("arome_l65.steps", "altered", {FUSED: _altered}),
          ("arome_l65.ens10", "half", {SUMMARY: _half}),
          ("arome_l65.ens10", "altered", {FUSED: _altered})]


@pytest.mark.parametrize("cell,fault,table", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_a_planted_fault_comes_out_not_correct(cell, fault, table):
    with replaced(table):
        out = harness.run_cell(SPEC, cell, 2 ** 31 + 5, 0.05, False, "cpu",
                               overrides=small(SPEC, cell))
    assert not out["correct"], (fault, out["check"])
    assert any(c["value"] > c["limit"] for c in out["check"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(cell):
    """Every cell of ``BENCHMARK.json``: its entry's ``control()`` reads
    as not correct on every control seed."""
    lines = list(readings(cell, [7], [8, 9, 10], 0.05, "cpu",
                          small(SPEC, cell)))
    program = [x for x in lines if x["kind"] == "program"]
    control = [x for x in lines if x["kind"] == "control"]
    assert all(v <= x["limits"][k] for x in program
               for k, v in x["check"].items())
    assert len(control) == 3
    for x in control:
        assert any(v > x["limits"][k] for k, v in x["check"].items()), x
        # the gap of rounding alone, at least half a bfloat16 ulp at the
        # top of some field's binade
        assert max(x["check"].values()) > 2.0 ** -10, x


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run_cell(SPEC, cell, 1, 1.0, False, "cuda")
    assert out["correct"], out["check"]
