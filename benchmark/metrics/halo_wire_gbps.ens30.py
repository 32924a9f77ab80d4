"""The bytes this card posts to send in the halo exchange (the program's
counter ``halo.bytes``) over the device time of its legs on the wire (its
``halo.wire`` spans: from the post of a leg's messages to the current
stream's wait for them), GB/s."""

from benchmark.metrics._program import counter, spans_ms


def read(run):
    nbytes = counter("halo.bytes")
    ms = spans_ms("halo.wire")
    if not nbytes or not ms:
        return None
    return nbytes / (ms * 1e6)
