"""Device ms per timed step launched inside the rasterizer's binning
(_compact_layout: depth order, records, pair keys, key sort, starts)."""
from benchmark import readers_gs

SPANS = readers_gs.SPANS + ("sixdgs_torch.ops.rasterizer.pallas_tiles._compact_layout",)


def read(trace):
    return readers_gs.device_ms_per_step(trace, SPANS[-1])
