"""Host ms per call of the program's loss stage (``pose.loss``: the score
loss and recall@k of a request) in the spans-only window."""
from benchmark.program_spans import host_ms_per_call


def read(trace):
    return host_ms_per_call(trace, "pose.loss")
