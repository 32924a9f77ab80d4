"""Device time a summary spends in the pipeline kernel's launches inside
the member loop (the program's ``b1.kernel`` spans under
``ensemble.member_fields``), ms."""

from benchmark.metrics._program import per_unit_ms


def read(run):
    return per_unit_ms(run, "b1.kernel", under="ensemble.member_fields")
