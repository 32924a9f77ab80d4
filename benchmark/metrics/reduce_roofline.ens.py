"""The ensemble reductions (``models.ensemble.ensemble_summary``) against
their bytes: the 12 member-stacked fields read once and the 26 outputs
written once at the published HBM rate, over the spans' device time, %."""

from benchmark.metrics._common import roofline_pct


def read(run):
    return roofline_pct(run, "reduce_bound_s", "reduce")
