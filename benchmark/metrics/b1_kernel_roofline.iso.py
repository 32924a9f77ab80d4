"""The pipeline kernel's bytes or operations on the pressure surfaces at
the published rates, over the device time of its launches inside the
isobaric steps (the program's ``b1.kernel`` spans under
``isobaric.step``), %."""

from benchmark.metrics._program import spans_ms


def read(run):
    bound = run.work.get("b1_bound_s")
    ms = spans_ms("b1.kernel", under="isobaric.step")
    if bound is None or not ms:
        return None
    return 100.0 * bound * 1e3 / ms
