"""Device time a summary spends in its 2 exceedance probabilities (the
program's ``ensemble.probability`` spans, ``ops.ensemble.probability``,
under its reductions' ``ensemble.reduce``), ms."""

from benchmark.metrics._program import per_unit_ms


def read(run):
    return per_unit_ms(run, "ensemble.probability", under="ensemble.reduce")
