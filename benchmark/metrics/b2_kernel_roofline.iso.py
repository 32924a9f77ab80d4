"""The interpolation kernel's bytes (each field's two bracket levels and
ps read once, the interpolated planes and their shared mask written once)
at the published rate, over the device time of its launches alone (the
program's ``b2.kernel`` spans), %."""

from benchmark.metrics._program import spans_ms


def read(run):
    bound = run.work.get("b2_bound_s")
    ms = spans_ms("b2.kernel")
    if bound is None or not ms:
        return None
    return 100.0 * bound * 1e3 / ms
