"""Host ms per call of the program's validation image preparation
(``val.prepare``: the uint8 photograph to float image and mask) in the
spans-only window."""
from benchmark.program_spans import host_ms_per_call


def read(trace):
    return host_ms_per_call(trace, "val.prepare")
