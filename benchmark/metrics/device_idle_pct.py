"""The share of the traced window in which the device ran nothing (the
profiler's kernels, copies and fills, their union).  It serves
every ``device_idle_pct.<tag>``."""

from benchmark.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
