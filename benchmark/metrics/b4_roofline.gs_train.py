"""B4's share of its roofline: its bound per call (counts/gs.py, on the
traced steps' cameras) over the device time launched inside
pallas_composite_bwd, per timed call."""
from benchmark import readers_gs

SPANS = readers_gs.SPANS + ("sixdgs_torch.ops.rasterizer.pallas_tiles.pallas_composite_bwd",)


def read(trace):
    return readers_gs.roofline_pct(trace, SPANS[-1], "b4_bound_s")
