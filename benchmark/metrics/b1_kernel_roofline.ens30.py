"""The pipeline kernel's bytes or operations on this card's block padded
with the stencils' ring, once a member, at the published rates, over the
device time of its launches inside the member loop (the program's
``b1.kernel`` spans under ``ensemble.member_fields``), %."""

from benchmark.metrics._program import spans_ms


def read(run):
    bound = run.work.get("b1_bound_s")
    ms = spans_ms("b1.kernel", under="ensemble.member_fields")
    if bound is None or not ms:
        return None
    return 100.0 * bound * 1e3 / ms
