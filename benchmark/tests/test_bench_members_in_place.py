"""``members_in_place.ens``, the program's counter
``ensemble.members_in_place`` a summary: silent in a traced CPU run of
ens10 (the CPU route copies each member into the stack and counts none),
the members of a summary where the program counts them (here the CPU run's
records with the counter a card's would add), and nothing from a program
that records no spans."""

from benchmark import harness
from benchmark.tests._small import SPEC, small

CELL, METRIC = "arome_l65.ens10", "members_in_place.ens"


def _traced() -> dict:
    return harness.run_cell(SPEC, CELL, 2 ** 31 + 31, 0.05, True, "cpu",
                            overrides=small(SPEC, CELL))


def test_a_traced_cpu_run_counts_no_member_in_place():
    out = _traced()
    assert out["correct"]
    assert METRIC not in out["metrics"]
    assert "b1_member_ms.ens" in out["metrics"]


def test_the_in_place_route_reads_the_members_of_a_summary(monkeypatch):
    """The program's records as a card's would read: the counter at the
    members of each summary the session recorded."""
    from mi_fieldcalc_tpu_torch.utils import profiling
    members = small(SPEC, CELL)["members"]
    recorded = profiling.recorded

    def on_a_card():
        rec = recorded()
        n = sum(s.name == "ensemble.summary" for s in rec.spans)
        return rec._replace(counters={**rec.counters,
                                      "ensemble.members_in_place":
                                      members * n})

    monkeypatch.setattr(profiling, "recorded", on_a_card)
    out = _traced()
    assert out["correct"]
    assert out["metrics"][METRIC] == {"value": float(members),
                                      "unit": "count"}


def test_a_program_without_spans_reads_nothing(monkeypatch):
    from mi_fieldcalc_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "recorded")
    out = _traced()
    assert out["correct"]
    assert METRIC not in out["metrics"]
