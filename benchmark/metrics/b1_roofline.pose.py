"""B1's share of its roofline: its bound (counts/flops.py) over the
device time launched inside attention_scores_fwd, per call."""
from benchmark.counts import flops
from benchmark.readers import FWD, roofline_pct

SPANS = (FWD,)


def read(trace):
    return roofline_pct(trace, FWD, flops.b1_flops, flops.b1_bytes)
