"""Host ms per call of the program's backbone stage (``pose.backbone``:
preprocessing, the ViT's launches, mask, position encoding) in the
spans-only window."""
from benchmark.program_spans import host_ms_per_call


def read(trace):
    return host_ms_per_call(trace, "pose.backbone")
