"""Arithmetic the metric readers share."""

from __future__ import annotations


def per_unit_ms(run) -> float:
    """All the window's time over all the units of work completed in it."""
    return run.window_s * 1e3 / run.units


def idle_pct(run):
    """The share of the traced window in which no kernel, copy or fill ran
    on the device; nothing without a trace or with no device work."""
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.window_s)


def span_ms(run, layer: str):
    """The device time of all of a layer's spans, ms; nothing where the
    run recorded none."""
    spans = run.spans.get(layer)
    return sum(spans) if spans else None


def roofline_pct(run, bound_key: str, *layers):
    """The least time the layers' work needs (``run.work[bound_key]``,
    seconds) over the device time of their spans, in %."""
    bound = run.work.get(bound_key)
    times = [span_ms(run, layer) for layer in layers]
    if bound is None or None in times or sum(times) <= 0:
        return None
    return 100.0 * bound * 1e3 / sum(times)
