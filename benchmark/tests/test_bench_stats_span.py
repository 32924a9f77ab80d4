"""``stats_ms.ens``: a traced CPU run of the ensemble cell at a small size
reads the program's ``ensemble.stats`` spans (the reductions' wrapper runs
its plain version there), one a field of every summary, inside the
reductions' ``ensemble.reduce`` span and taking no more time than it."""

from benchmark import harness
from benchmark.metrics import _program
from benchmark.tests._small import SPEC, small

CELL = "arome_l65.ens10"


def test_a_traced_cpu_run_reads_the_stats_spans():
    out = harness.run_cell(SPEC, CELL, 2 ** 31 + 37, 0.05, True, "cpu",
                           overrides=small(SPEC, CELL))
    assert out["correct"]
    stats = out["metrics"]["stats_ms.ens"]["value"]
    assert stats > 0
    rec = _program.recording()
    by_id = {s.id: s for s in rec.spans}
    spans = [s for s in rec.spans if s.name == "ensemble.stats"]
    assert len(spans) == 12 * out["attempted"]
    assert all(by_id[s.parent].name == "ensemble.reduce" for s in spans)
    assert stats <= _program.spans_ms("ensemble.reduce") / out["attempted"]
