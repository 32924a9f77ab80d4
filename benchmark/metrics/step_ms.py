"""All the window's time over the steps completed in it (host clock;
the window ends when the device has finished every one)."""

from benchmark.metrics._common import per_unit_ms as read  # noqa: F401
