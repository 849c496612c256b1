"""B2's share of its roofline: its bound (counts/flops.py) over the
device time launched inside attention_scores_bwd, per call."""
from benchmark.counts import flops
from benchmark.readers import BWD, roofline_pct

SPANS = (BWD,)


def read(trace):
    return roofline_pct(trace, BWD, flops.b2_flops, flops.b2_bytes)
