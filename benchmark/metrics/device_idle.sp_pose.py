"""Share of the traced window in which no kernel ran on the device."""
from benchmark.readers import device_idle_pct as read  # noqa: F401
