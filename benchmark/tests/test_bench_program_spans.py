"""The per-layer metrics that read the program's own spans and counters
(``mi_fieldcalc_tpu_torch.utils.profiling``): a traced CPU run of each
cell at a small size reports each one that the CPU can give, the parts a
span is made of take no more time than the span, and a program that
records no spans makes each reader read nothing."""

import pytest

from benchmark import harness
from benchmark.metrics import _program
from benchmark.tests._small import SPEC, small

#: the program's span metrics of each cell: on the CPU each reads a time,
#: the allocator's counter (CUDA only) and the roofline (no published
#: peak for a CPU) read nothing
SPAN_METRICS = {
    "arome_l65.ens10": ("b1_member_ms.ens", "member_stack_ms.ens",
                        "stats_ms.ens"),
    "arome_l65.steps": ()}
SILENT_ON_CPU = {"arome_l65.ens10": ("device_allocs.ens",),
                 "arome_l65.steps": ("b1_kernel_roofline.steps",)}


def _traced(cell: str) -> dict:
    return harness.run_cell(SPEC, cell, 2 ** 31 + 29, 0.05, True, "cpu",
                            overrides=small(SPEC, cell))


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_traced_cpu_run_reads_the_program_spans(cell):
    out = _traced(cell)
    assert out["correct"]
    got = out["metrics"]
    for name in SPAN_METRICS[cell]:
        assert got[name]["value"] > 0, name
    for name in SILENT_ON_CPU[cell]:
        assert name not in got
    rec = _program.recording()
    assert rec.spans
    names = {s.name for s in rec.spans}
    if cell == "arome_l65.steps":
        assert names == {"b1.kernel"}
        assert len(rec.spans) == out["attempted"]


def test_the_parts_of_a_span_take_no_more_than_the_span():
    out = _traced("arome_l65.ens10")
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert got["b1_member_ms.ens"] + got["member_stack_ms.ens"] <= \
        got["member_fields_ms.ens"]
    rec = _program.recording()
    per_unit = _program.spans_ms("ensemble.reduce") / out["attempted"]
    assert got["stats_ms.ens"] <= per_unit
    assert all(s.self_ms >= 0 for s in rec.spans)
    assert sum(s.name == "ensemble.summary" for s in rec.spans) == \
        out["attempted"]


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """A program older than its spans has no ``profiling.recorded``: its
    traced runs leave these metrics out, and raise nothing."""
    from mi_fieldcalc_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "recorded")
    out = _traced("arome_l65.ens10")
    assert out["correct"]
    for names in list(SPAN_METRICS.values()) + list(SILENT_ON_CPU.values()):
        for name in names:
            assert name not in out["metrics"]
    assert "member_fields_ms.ens" in out["metrics"]
