"""The program's explicit device-to-host reads (``host.reads``) over its
training steps (``train.step`` calls) in the spans-only window, the
validation's reads included."""
from benchmark.program_spans import snapshot


def read(trace):
    snap = snapshot(trace, "window")
    steps = snap and snap["spans"].get("train.step", {}).get("calls")
    return snap["counters"].get("host.reads", 0) / steps if steps else None
