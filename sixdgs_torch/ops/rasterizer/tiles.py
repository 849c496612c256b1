"""Tile binning of depth-ordered Gaussians (the kernel path's front end).

Port of the binning half of sixdgs_tpu/ops/rasterizer/tiles.py: the
clipped tile rect of each Gaussian's screen radius, the three-tier slot
budgets (``t_max`` tiles for most Gaussians, ``t_max_mid`` for the
``mid_k`` next-largest rects, ``t_max_big`` for the ``overflow_k``
largest), conic-precise tile culling, the fused (tile, depth-rank) pair
keys, the ``binning_saturation`` telemetry and ``_permute``.
``rasterize_tiled`` and its VJPs (``_pair_gather``, ``_window``) are not
ported yet.

The port packs pair keys into int64 where the JAX package uses uint32:
``torch.sort`` sorts int64 on every device, and since real pairs' keys are
unique the sorted compact layout is the same. Sentinel slots (tile id =
n_tiles) may come back in another order, which the aligned layout masks.
One non-negative int64 key holds tile and depth-rank fields of up to 62
bits together, so the port has no counterpart of the two-key sort that
the JAX package takes past 32 bits.
"""

from __future__ import annotations

import torch

from sixdgs_torch.ops.rasterizer.compositing import ALPHA_MIN

RECORD = 9  # means2d(2) conic(3) color(3) opacity(1)


class _Permute(torch.autograd.Function):
    """x[perm] for a permutation ``perm``, with the gather g[inv_perm] as
    its backward (the JAX package's scatter-free VJP)."""

    @staticmethod
    def forward(ctx, x, perm):
        ctx.save_for_backward(perm)
        return x[perm]

    @staticmethod
    def backward(ctx, g):
        (perm,) = ctx.saved_tensors
        inv_perm = torch.empty_like(perm)
        inv_perm[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
        return g[inv_perm], None


def _permute(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return _Permute.apply(x, perm)


def _emit_counts(x0, y0, x1, y1, valid, budget: int):
    """Exact number of (tile, gaussian) pairs ``_rect_pairs`` emits per
    gaussian: the centered sub-rect area capped to ``budget``, zero for empty
    rects (a rect fully clipped off-screen emits nothing — same as the CUDA
    getRect binning)."""
    rw = torch.clamp_min(x1 - x0, 0)
    rh = torch.clamp_min(y1 - y0, 0)
    max_w = torch.clamp_max(rw, budget)
    max_h = torch.clamp_min(torch.minimum(rh, budget // torch.clamp_min(max_w, 1)), 1)
    nv = torch.where(valid & (rw > 0) & (rh > 0), max_w * max_h, torch.zeros_like(rw))
    return nv, max_w, max_h


def _tile_min_quadratic(tx, ty, mx, my, conA, conB, conC, tile: int):
    """Exact min over tile (tx, ty)'s pixel rect of the conic quadratic
    Q(d) = 0.5*conA*dx^2 + conB*dx*dy + 0.5*conC*dy^2 (power = -Q).

    tx/ty: [G, S] tile coords; mx/my/con*: [G] per-gaussian. The continuous
    min over the pixel box lower-bounds every integer pixel's Q, so a cull
    on it is conservative: 0 if the mean lies inside, else the min of the
    four edges (1D quadratic, clamped vertex)."""
    ax = tx.to(torch.float32) * tile - mx[:, None]
    bx = ax + (tile - 1)
    ay = ty.to(torch.float32) * tile - my[:, None]
    by = ay + (tile - 1)
    cA = conA[:, None]
    cB = conB[:, None]
    cC = conC[:, None]

    def q(dx, dy):
        return 0.5 * cA * dx * dx + cB * dx * dy + 0.5 * cC * dy * dy

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    def edge_x(dx):  # min over dy in [ay, by] at fixed dx
        return q(dx, clip(-cB * dx / torch.clamp_min(cC, 1e-12), ay, by))

    def edge_y(dy):
        return q(clip(-cB * dy / torch.clamp_min(cA, 1e-12), ax, bx), dy)

    inside = (ax <= 0.0) & (0.0 <= bx) & (ay <= 0.0) & (0.0 <= by)
    edge_min = torch.minimum(torch.minimum(edge_x(ax), edge_x(bx)),
                             torch.minimum(edge_y(ay), edge_y(by)))
    return torch.where(inside, torch.zeros_like(edge_min), edge_min)


def _rect_pairs(x0, y0, x1, y1, cx, cy, valid, nx, ny, budget: int,
                cull=None, tile: int = 16):
    """(tile ids [G, budget], emitted counts [G]) of a centered sub-rect
    capped to ``budget`` tiles. Slots [0, counts[g]) of row g carry real tile
    ids, the rest the n_tiles sentinel.

    ``cull``: optional (mx, my, conA, conB, conC, qmax) per-gaussian
    tensors; slots whose exact tile-rect quadratic minimum exceeds
    qmax = log(opac/ALPHA_MIN) are dropped (those pairs fail the
    compositor's live test on every pixel)."""
    nv, max_w, max_h = _emit_counts(x0, y0, x1, y1, valid, budget)
    sx0 = torch.minimum(torch.maximum(cx - max_w // 2, x0), torch.maximum(x1 - max_w, x0))
    sy0 = torch.minimum(torch.maximum(cy - max_h // 2, y0), torch.maximum(y1 - max_h, y0))
    p = torch.arange(budget, dtype=torch.int32, device=x0.device)
    w1 = torch.clamp_min(max_w, 1)[:, None]
    tx = sx0[:, None] + p[None, :] % w1
    ty = sy0[:, None] + p[None, :] // w1
    pair_valid = p[None, :] < nv[:, None]
    if cull is not None:
        mx, my, conA, conB, conC, qmax = cull
        qmin = _tile_min_quadratic(tx, ty, mx, my, conA, conB, conC, tile)
        # small margin: the compositor evaluates Q at integer pixels in f32;
        # the continuous min is a strict lower bound, the margin absorbs
        # rounding
        pair_valid = pair_valid & (qmin <= qmax[:, None] + 1e-4)
        nv = torch.sum(pair_valid, dim=1).to(nv.dtype)
    n_tiles = nx * ny
    return torch.where(pair_valid, ty * nx + tx, torch.full_like(tx, n_tiles)), nv


def _rect_bounds(means2d, radii_f, nx: int, ny: int, tile: int):
    """Clipped tile-rect bounds + centers + area per gaussian (int32)."""
    def bound(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int32)

    x0 = bound(torch.floor((means2d[:, 0] - radii_f) / tile), nx)
    y0 = bound(torch.floor((means2d[:, 1] - radii_f) / tile), ny)
    x1 = bound(torch.ceil((means2d[:, 0] + radii_f + 1) / tile), nx)
    y1 = bound(torch.ceil((means2d[:, 1] + radii_f + 1) / tile), ny)
    # truncation toward zero, as astype(int32)
    cx = torch.minimum(torch.maximum((means2d[:, 0] / tile).to(torch.int32), x0),
                       torch.maximum(x1 - 1, x0))
    cy = torch.minimum(torch.maximum((means2d[:, 1] / tile).to(torch.int32), y0),
                       torch.maximum(y1 - 1, y0))
    area = torch.clamp_min(x1 - x0, 0) * torch.clamp_min(y1 - y0, 0)
    return x0, y0, x1, y1, cx, cy, area


def _select_tiers(area, vis, t_max: int, mid_k: int, overflow_k: int):
    """Pick the overflow tiers: top-(overflow_k) rects by area get the GIANT
    budget, the next mid_k get the MID budget. Ties go to the lower index,
    as lax.top_k breaks them (a stable descending sort). Returns
    (giant_idx, giant_ok, mid_idx, mid_ok, in_tier)."""
    score = torch.where(vis & (area > t_max), area, torch.full_like(area, -1))
    vals, idx = torch.sort(score, descending=True, stable=True)
    vals, idx = vals[:overflow_k + mid_k], idx[:overflow_k + mid_k]
    ok = vals > 0
    in_tier = torch.zeros(area.shape[0], dtype=torch.bool, device=area.device)
    in_tier[idx] = ok
    return idx[:overflow_k], ok[:overflow_k], idx[overflow_k:], ok[overflow_k:], in_tier


def _tier_sizes(P: int, overflow_k: int, mid_k: int):
    overflow_k = min(overflow_k, P)
    return overflow_k, min(mid_k, max(P - overflow_k, 0))


def binning_saturation(means2d, radii_f, vis, nx: int, ny: int, tile: int,
                       t_max: int, overflow_k: int = 256,
                       t_max_big: int = 1024, mid_k: int = 4096,
                       t_max_mid: int = 64):
    """Pairs dropped by the static binning caps (telemetry), as 0-d
    tensors: dropped_main (tiles cut from untiered gaussians), dropped_mid /
    dropped_big (tiles cut past the mid/giant budgets), overflow_spill
    (gaussians that needed a tier but both were full), narrow_demand,
    total_area and real_pairs (the emitted count before conic culling)."""
    overflow_k, mid_k = _tier_sizes(means2d.shape[0], overflow_k, mid_k)
    x0, y0, x1, y1, _, _, area = _rect_bounds(means2d, radii_f, nx, ny, tile)
    area = torch.where(vis, area, torch.zeros_like(area))
    giant_idx, giant_ok, mid_idx, mid_ok, in_tier = _select_tiers(
        area, area > t_max, t_max, mid_k, overflow_k)
    def cut(ok, a, budget):
        return torch.sum(torch.where(ok, torch.clamp_min(a - budget, 0), torch.zeros_like(a)))

    main_n, _, _ = _emit_counts(x0, y0, x1, y1, vis & ~in_tier, t_max)
    mid_n, _, _ = _emit_counts(x0[mid_idx], y0[mid_idx], x1[mid_idx], y1[mid_idx],
                               mid_ok, t_max_mid)
    big_n, _, _ = _emit_counts(x0[giant_idx], y0[giant_idx], x1[giant_idx],
                               y1[giant_idx], giant_ok, t_max_big)
    return {
        "dropped_main": cut(vis & ~in_tier, area, t_max),
        "dropped_mid": cut(mid_ok, area[mid_idx], t_max_mid),
        "dropped_big": cut(giant_ok, area[giant_idx], t_max_big),
        "overflow_spill": torch.sum(((area > t_max) & ~in_tier).to(torch.int32)),
        "narrow_demand": torch.sum((area > (t_max // 2)).to(torch.int32)),
        "total_area": torch.sum(area),
        "real_pairs": torch.sum(main_n) + torch.sum(mid_n) + torch.sum(big_n),
    }


def _fused_pair_keys(means2d, radii_f, vis, nx: int, ny: int, tile: int,
                     t_max: int, overflow_k: int = 256, t_max_big: int = 1024,
                     mid_k: int = 4096, t_max_mid: int = 64,
                     conics=None, opac=None):
    """Pre-sort pair data of depth-ordered gaussians, three-tier budgets.

    Returns (key, counts_g, gbits):
      * key: [N_slots] int64 (tile << gbits) | depth-rank;
      * counts_g: [P] int32 exact emitted pair count per depth-ranked
        gaussian;
      * gbits: bits of the depth-rank field.
    Slot blocks: [P*t_max main | mid_k*t_max_mid mid | overflow_k*t_max_big
    giant]; invalid slots carry tile id n_tiles.
    """
    P = means2d.shape[0]
    dev = means2d.device
    n_tiles = nx * ny
    gbits = max(1, (P - 1).bit_length())
    tbits = max(1, n_tiles.bit_length())  # tile ids go up to the sentinel
    if tbits + gbits > 62:
        raise ValueError(f"{n_tiles} tiles x {P} gaussians need {tbits + gbits} key "
                         "bits, more than the 62 of a non-negative int64 key")
    overflow_k, mid_k = _tier_sizes(P, overflow_k, mid_k)
    x0, y0, x1, y1, cx, cy, area = _rect_bounds(means2d, radii_f, nx, ny, tile)
    giant_idx, giant_ok, mid_idx, mid_ok, in_tier = _select_tiers(
        area, vis & (area > t_max), t_max, mid_k, overflow_k)
    cull = cull_mid = cull_big = None
    if conics is not None:
        # conic-precise tile culling (see _rect_pairs): qmax in Q units
        qmax = torch.log(torch.clamp_min(opac, 1e-12) / ALPHA_MIN)
        cull = (means2d[:, 0], means2d[:, 1], conics[:, 0], conics[:, 1],
                conics[:, 2], qmax)
        cull_mid = tuple(c[mid_idx] for c in cull)
        cull_big = tuple(c[giant_idx] for c in cull)
    main_ids, main_n = _rect_pairs(x0, y0, x1, y1, cx, cy, vis & ~in_tier, nx, ny,
                                   t_max, cull=cull, tile=tile)
    mid_ids, mid_n = _rect_pairs(x0[mid_idx], y0[mid_idx], x1[mid_idx], y1[mid_idx],
                                 cx[mid_idx], cy[mid_idx], mid_ok, nx, ny, t_max_mid,
                                 cull=cull_mid, tile=tile)
    big_ids, big_n = _rect_pairs(x0[giant_idx], y0[giant_idx], x1[giant_idx],
                                 y1[giant_idx], cx[giant_idx], cy[giant_idx], giant_ok,
                                 nx, ny, t_max_big, cull=cull_big, tile=tile)

    # tiered gaussians emit 0 in the main block, so add == set. The tier
    # indices are distinct and index_add_ on int32 is exact on every device
    counts_g = main_n.clone()
    counts_g.index_add_(0, mid_idx, torch.where(mid_ok, mid_n, torch.zeros_like(mid_n)))
    counts_g.index_add_(0, giant_idx, torch.where(giant_ok, big_n, torch.zeros_like(big_n)))

    g_main = torch.arange(P, dtype=torch.int32, device=dev)[:, None].expand(P, t_max)
    g_mid = mid_idx.to(torch.int32)[:, None].expand(mid_ids.shape)
    g_big = giant_idx.to(torch.int32)[:, None].expand(big_ids.shape)
    tile_ids = torch.cat([main_ids.reshape(-1), mid_ids.reshape(-1), big_ids.reshape(-1)])
    gidx = torch.cat([g_main.reshape(-1), g_mid.reshape(-1), g_big.reshape(-1)])
    key = (tile_ids.to(torch.int64) << gbits) | gidx.to(torch.int64)
    return key, counts_g, gbits
