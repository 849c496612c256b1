"""Share of the traced window's timed steps in which no kernel ran on the
device."""
from benchmark.readers_gs import SPANS, device_idle_pct as read  # noqa: F401
