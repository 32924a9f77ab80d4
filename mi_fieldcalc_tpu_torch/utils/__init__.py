"""Observability utilities of the port: profiling traces, device busy time
and device-memory roofline accounting (port of
:mod:`mi_fieldcalc_tpu.utils`)."""

from .profiling import (  # noqa: F401
    Roofline, device_busy_ms, device_events, device_f32_flops,
    device_hbm_gbps, event_times_ms, roofline_for_op, trace,
)
