"""Segment layouts for the aligned-layout gather (B5), shared by its CPU
parity test (tests/test_torch_rasterizer.py), its card test
(tests/test_torch_cuda_kernels.py) and chip_smoke.py's phase 2.

Each layout is per-tile pair counts and the compact budget nc (a multiple
of 1024, as the rasterizer's). numpy only: no JAX, no torch.
"""

import numpy as np

KB = 128

ALIGN_LAYOUTS = {
    # empty tiles between full ones
    "empty_between_full": ([128, 0, 0, 256, 0, 128, 0, 0, 384], 2048),
    # every count an exact multiple of 128: no padding lane
    "exact_multiples": ([128, 256, 128, 384], 1024),
    # a tile of 300 pairs spans three chunks, between two short ones
    "three_chunks": ([3, 300, 5], 1024),
    # the aligned demand is exactly nc: no tail
    "demand_exactly_nc": ([300, 100, 257, 127], 1024),
    # the aligned demand (1,408) exceeds nc: tile 2 is cut to 384 of its
    # 400 pairs by the clamp, tiles 3 and 4 to nothing
    "demand_over_nc": ([300, 200, 400, 70, 5], 1024),
    "one_tile": ([77], 1024),
    "no_tiles": ([], 1024),
}


def align_layout(counts, nc: int, P: int = 1000, seed: int = 0, junk: int = -7):
    """(gidx [nc], starts [n+1], starts_al [n+1]) as int32 numpy arrays:
    random gaussian ids in [0, P) for the real pairs and ``junk`` past
    them (which no output lane may carry), the segment starts, and the
    KB-aligned starts clamped to nc (the rasterizer's _aligned_starts)."""
    counts = np.asarray(counts, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    if starts[-1] > nc:
        raise ValueError(f"{starts[-1]} real pairs exceed nc {nc}")
    gidx = np.full(nc, junk, np.int32)
    gidx[:starts[-1]] = np.random.default_rng(seed).integers(0, P, starts[-1])
    aligned = -(-counts // KB) * KB
    starts_al = np.minimum(np.concatenate([[0], np.cumsum(aligned)]), nc).astype(np.int32)
    return gidx, starts, starts_al
