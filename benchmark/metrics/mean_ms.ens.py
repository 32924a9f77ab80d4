"""Device time a summary spends in its 12 ensemble means (the program's
``ensemble.mean`` spans, ``ops.ensemble.mean_value``, under its
reductions' ``ensemble.reduce``), ms."""

from benchmark.metrics._program import per_unit_ms


def read(run):
    return per_unit_ms(run, "ensemble.mean", under="ensemble.reduce")
