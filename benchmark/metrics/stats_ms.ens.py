"""Device time a summary spends in its ensemble reductions' kernel (the
program's ``ensemble.stats`` spans, ``ops.ensemble_fused.
ensemble_stats_fused``, one a field, under its reductions'
``ensemble.reduce``), ms; nothing for a program without that span."""

from benchmark.metrics._program import per_unit_ms


def read(run):
    return per_unit_ms(run, "ensemble.stats", under="ensemble.reduce")
