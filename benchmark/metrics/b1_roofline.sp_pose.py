"""B1's share of its roofline at the configuration's shape (784 x 256):
the bound of the function's own work (counts/flops.py) over the device
time launched inside attention_scores_fwd, per call: its four padded
launches and the wrapper's padding, sums and concatenations."""
from benchmark.counts import flops
from benchmark.readers import FWD, roofline_pct

SPANS = (FWD,)


def read(trace):
    return roofline_pct(trace, FWD, flops.b1_flops, flops.b1_bytes)
