"""The device's idle share of the profiled training steps: 1 - (union of device
operation intervals) / (the span's wall time), in %."""
from portbench.readers import idle_share_pct as read  # noqa: F401
