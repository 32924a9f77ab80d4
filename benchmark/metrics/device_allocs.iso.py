"""The caching allocator's ``cudaMalloc`` calls a step in the traced
window (the program's counter ``allocator.device_allocs``, which the
``isobaric.step`` span adds to on a card); nothing off CUDA."""

from benchmark.metrics._program import counter


def read(run):
    n = counter("allocator.device_allocs")
    return None if n is None else n / run.units
