"""B5's share of its roofline: its bound per call (counts/gs.py, on the
traced steps' cameras) over the device time launched inside
_align_compact, per timed call."""
from benchmark import readers_gs

SPANS = readers_gs.SPANS + ("sixdgs_torch.ops.rasterizer.pallas_tiles._align_compact",)


def read(trace):
    return readers_gs.roofline_pct(trace, SPANS[-1], "b5_bound_s")
