"""Observability utilities of the port: profiling traces, device busy
time, the program's spans and counters, and the card's published rates
(port of :mod:`mi_fieldcalc_tpu.utils`)."""

from .profiling import (  # noqa: F401
    Recording, SpanRecord, count, device_busy_ms, device_events,
    device_f32_flops, device_hbm_gbps, event_times_ms, recorded, span, take,
    trace,
)
