"""Device time a summary spends in the halo exchange (the program's
``halo.exchange`` spans, ``parallel.fused._exchange``: the strips packed,
both legs on the wire, the inputs padded with the ring), ms."""

from benchmark.metrics._program import per_unit_ms


def read(run):
    return per_unit_ms(run, "halo.exchange")
