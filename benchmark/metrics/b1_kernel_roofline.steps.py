"""The pipeline kernel's bytes (inputs read once, the 12 value and 9 mask
planes written once) or operations at the published rates, over the
device time of its launches alone (the program's ``b1.kernel`` spans), %.
``b1_roofline.steps`` reads the same bound over the wrapper's whole
call."""

from benchmark.metrics._program import spans_ms


def read(run):
    bound = run.work.get("b1_bound_s")
    ms = spans_ms("b1.kernel")
    if bound is None or not ms:
        return None
    return 100.0 * bound * 1e3 / ms
