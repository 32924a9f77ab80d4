"""The pipeline kernel's calls (``ops.fused.derived_fields_fused``) against
their bytes (inputs read once, the 12 value and 9 mask planes written
once) or operations at the published rates, over the spans' device
time, %."""

from benchmark.metrics._common import roofline_pct


def read(run):
    return roofline_pct(run, "b1_bound_s", "b1")
