"""Device time a summary spends stacking each member's 12 fields and
their masks into the member stack (the program's ``ensemble.member_stack``
spans), ms."""

from benchmark.metrics._program import per_unit_ms


def read(run):
    return per_unit_ms(run, "ensemble.member_stack")
