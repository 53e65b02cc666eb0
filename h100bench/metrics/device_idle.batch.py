"""device_idle.batch: 1 − device busy time ÷ wall of the traced window, in %."""

from h100bench.metrics._shared import device_idle as read  # noqa: F401
