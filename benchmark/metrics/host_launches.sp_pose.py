"""Kernel launch API calls (runtime and driver) per image."""
from benchmark.readers import launches_per


def read(trace):
    return launches_per(trace, "images")
