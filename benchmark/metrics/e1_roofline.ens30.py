"""The ensemble reductions' bytes on this card's block (the 12
member-stacked fields read once, the 26 outputs written once;
``counts.reduce_bytes``) at the published rate, over the device time of
the reductions' kernel (the program's ``ensemble.stats`` spans under
``ensemble.reduce``, with the probabilities' member flags reduced over the
cards), %."""

from benchmark.metrics._program import spans_ms


def read(run):
    bound = run.work.get("reduce_bound_s")
    ms = spans_ms("ensemble.stats", under="ensemble.reduce")
    if bound is None or not ms:
        return None
    return 100.0 * bound * 1e3 / ms
