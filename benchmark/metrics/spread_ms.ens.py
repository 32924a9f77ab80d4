"""Device time a summary spends in its 12 ensemble spreads (the program's
``ensemble.spread`` spans, ``ops.ensemble.stddev_value``, under its
reductions' ``ensemble.reduce``), ms."""

from benchmark.metrics._program import per_unit_ms


def read(run):
    return per_unit_ms(run, "ensemble.spread", under="ensemble.reduce")
