"""Host ms per call of the program's training forward (``train.forward``:
the ray MLP and the batch's image loop) in the spans-only window."""
from benchmark.program_spans import host_ms_per_call


def read(trace):
    return host_ms_per_call(trace, "train.forward")
