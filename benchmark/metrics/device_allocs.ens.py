"""The caching allocator's ``cudaMalloc`` calls a summary in the traced
window (the program's counter ``allocator.device_allocs``, which the
``ensemble.summary`` span adds to on a card); nothing off CUDA."""

from benchmark.metrics._program import counter


def read(run):
    n = counter("allocator.device_allocs")
    return None if n is None else n / run.units
