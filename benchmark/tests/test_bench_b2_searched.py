"""``b2_searched_pct.iso``, the share of the interpolation kernel's columns
that took its binary search (the program's counters
``b2.searched_columns`` over ``b2.columns``): silent in a traced CPU run
of iso (the CPU route runs the plain version and counts neither), the
counters' share where the program counts them (here the CPU run's records
with the counters a card's would add), and nothing from a program that
records no spans or counts no searched column."""

import pytest

from benchmark import harness
from benchmark.tests._small import SPEC, small

CELL, METRIC = "era5_l137.iso", "b2_searched_pct.iso"


def _traced() -> dict:
    return harness.run_cell(SPEC, CELL, 2 ** 31 + 37, 0.05, True, "cpu",
                            overrides=small(SPEC, CELL))


def _with_counters(monkeypatch, counters: dict) -> None:
    from mi_fieldcalc_tpu_torch.utils import profiling
    recorded = profiling.recorded

    def on_a_card():
        rec = recorded()
        return rec._replace(counters={**rec.counters, **counters})

    monkeypatch.setattr(profiling, "recorded", on_a_card)


def test_a_traced_cpu_run_counts_no_searched_column():
    out = _traced()
    assert out["correct"]
    assert METRIC not in out["metrics"]
    assert "isobaric_self_ms.iso" in out["metrics"]


@pytest.mark.parametrize("searched,columns,share", [
    (2 * 721 * 1440, 2 * 721 * 1440, 100.0), (0, 1000, 0.0),
    (250, 1000, 25.0)])
def test_the_counters_read_as_a_share_of_the_columns(monkeypatch, searched,
                                                     columns, share):
    _with_counters(monkeypatch, {"b2.searched_columns": searched,
                                 "b2.columns": columns})
    out = _traced()
    assert out["correct"]
    assert out["metrics"][METRIC] == {"value": share, "unit": "%"}


@pytest.mark.parametrize("counters", [{"b2.columns": 1000}, {}])
def test_a_program_that_counts_no_searched_column_reads_nothing(
        monkeypatch, counters):
    """The parent's program counts the launches' columns at most: no
    searched column, no share."""
    _with_counters(monkeypatch, counters)
    out = _traced()
    assert out["correct"]
    assert METRIC not in out["metrics"]


def test_a_program_without_spans_reads_nothing(monkeypatch):
    from mi_fieldcalc_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "recorded")
    out = _traced()
    assert out["correct"]
    assert METRIC not in out["metrics"]
