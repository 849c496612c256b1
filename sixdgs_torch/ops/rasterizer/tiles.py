"""Tile-binned rasterization: binning of depth-ordered Gaussians (the
kernel path's front end) and ``rasterize_tiled``, the tile rasterizer in
plain PyTorch.

Port of sixdgs_tpu/ops/rasterizer/tiles.py: the clipped tile rect of each
Gaussian's screen radius, the three-tier slot budgets (``t_max`` tiles for
most Gaussians, ``t_max_mid`` for the ``mid_k`` next-largest rects,
``t_max_big`` for the ``overflow_k`` largest), conic-precise tile culling,
the (tile, depth-rank) pair keys, the ``binning_saturation`` telemetry and
``_permute``; then ``rasterize_tiled``: one stable sort of the pair keys
gives per-tile depth-ordered segments, laid out into a dense
[n_tiles, k_max] window and composited by a scan over depth slots with the
golden model's early-stop arithmetic. It reaches no kernel: the JAX package
computes it in XLA, and so does this in plain PyTorch on any device.

Its data movements are bijections, so their backward passes are gathers
(``torch.autograd.Function``s, as the JAX package's custom VJPs): the depth
permutation gathers by its inverse; the pair gather (``_PairGather``) sums
the regular per-gaussian slot blocks and adds the tier rows, which go to
distinct rows that are zero in the main block, so the add is an exact,
deterministic assignment (no float ``index_add_``); the window
(``_Window``) gathers each pair's (tile, rank) cell. The slot scan runs
each block of slots under activation checkpointing, so autograd keeps only
the carries (transmittance, colour, done) between blocks, as the JAX
package's ``jax.remat`` of the scan body does.

The port packs pair keys into int64 where the JAX package uses uint32 or
int32: ``torch.sort`` sorts int64 on every device, and since real pairs'
keys are unique the sorted layout is the same. Sentinel slots (tile id =
n_tiles) may come back in another order, which the layouts mask. One
non-negative int64 key holds tile and depth-rank fields of up to 62 bits
together, so the port has no counterpart of the two-key sort that the JAX
package takes past 32 (or 31) bits, and raises past 62.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from sixdgs_torch.ops.rasterizer.compositing import ALPHA_MAX, ALPHA_MIN, T_EPS
from sixdgs_torch.ops.rasterizer.projection import ProjectedGaussians

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


def _tier_pairs(means2d, radii_f, vis, nx: int, ny: int, tile: int, t_max: int,
                overflow_k: int, t_max_big: int, mid_k: int, t_max_mid: int,
                conics=None, opac=None):
    """Tile ids and emitted counts of the three slot blocks, and the tier
    tables: ((main_ids [P, t_max], main_n), (mid_ids, mid_n, mid_idx,
    mid_ok), (big_ids, big_n, giant_idx, giant_ok)). ``overflow_k`` and
    ``mid_k`` are already clamped to P (``_tier_sizes``)."""
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
    main = _rect_pairs(x0, y0, x1, y1, cx, cy, vis & ~in_tier, nx, ny, t_max,
                       cull=cull, tile=tile)
    mid = _rect_pairs(x0[mid_idx], y0[mid_idx], x1[mid_idx], y1[mid_idx],
                      cx[mid_idx], cy[mid_idx], mid_ok, nx, ny, t_max_mid,
                      cull=cull_mid, tile=tile)
    big = _rect_pairs(x0[giant_idx], y0[giant_idx], x1[giant_idx], y1[giant_idx],
                      cx[giant_idx], cy[giant_idx], giant_ok, nx, ny, t_max_big,
                      cull=cull_big, tile=tile)
    return main, (*mid, mid_idx, mid_ok), (*big, giant_idx, giant_ok)


def _slot_gaussians(P: int, t_max: int, mid_idx, mid_ids, giant_idx, big_ids):
    """The owning depth-ranked gaussian of every pre-sort slot [N_slots]
    int32: iota arithmetic for the main block, the tier tables for the
    others."""
    g_main = torch.arange(P, dtype=torch.int32, device=mid_idx.device)[:, None]
    return torch.cat([g_main.expand(P, t_max).reshape(-1),
                      mid_idx.to(torch.int32)[:, None].expand(mid_ids.shape).reshape(-1),
                      giant_idx.to(torch.int32)[:, None].expand(big_ids.shape).reshape(-1)])


def _key_bits(n_tiles: int, P: int) -> int:
    """Bits of the depth-rank field of a pair key; raises when tile and
    depth-rank fields need more than the 62 of a non-negative int64 key."""
    gbits = max(1, (P - 1).bit_length())
    tbits = max(1, n_tiles.bit_length())  # tile ids go up to the sentinel
    if tbits + gbits > 62:
        raise ValueError(f"{n_tiles} tiles x {P} gaussians need {tbits + gbits} key "
                         "bits, more than the 62 of a non-negative int64 key")
    return gbits


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
    gbits = _key_bits(nx * ny, P)
    overflow_k, mid_k = _tier_sizes(P, overflow_k, mid_k)
    (main_ids, main_n), (mid_ids, mid_n, mid_idx, mid_ok), (
        big_ids, big_n, giant_idx, giant_ok) = _tier_pairs(
        means2d, radii_f, vis, nx, ny, tile, t_max, overflow_k, t_max_big, mid_k,
        t_max_mid, conics, opac)

    # tiered gaussians emit 0 in the main block, so add == set. The tier
    # indices are distinct and index_add_ on int32 is exact on every device
    counts_g = main_n.clone()
    counts_g.index_add_(0, mid_idx, torch.where(mid_ok, mid_n, torch.zeros_like(mid_n)))
    counts_g.index_add_(0, giant_idx, torch.where(giant_ok, big_n, torch.zeros_like(big_n)))

    tile_ids = torch.cat([main_ids.reshape(-1), mid_ids.reshape(-1), big_ids.reshape(-1)])
    gidx = _slot_gaussians(P, t_max, mid_idx, mid_ids, giant_idx, big_ids)
    key = (tile_ids.to(torch.int64) << gbits) | gidx.to(torch.int64)
    return key, counts_g, gbits


def _make_pair_keys(means2d, radii_f, vis, nx: int, ny: int, tile: int,
                    t_max: int, overflow_k: int = 256, t_max_big: int = 1024,
                    mid_k: int = 4096, t_max_mid: int = 64,
                    conics=None, opac=None):
    """Pre-sort pair keys of ``rasterize_tiled``:
    (tile_ids, pair_gidx, mid_idx, mid_ok, giant_idx, giant_ok).

    Slot blocks: [P*t_max main | mid_k*t_max_mid mid | overflow_k*t_max_big
    giant]. tile_ids: the tile of each pre-sort slot (n_tiles sentinel =
    invalid); pair_gidx: its owning gaussian (depth rank), int32."""
    P = means2d.shape[0]
    overflow_k, mid_k = _tier_sizes(P, overflow_k, mid_k)
    (main_ids, _), (mid_ids, _, mid_idx, mid_ok), (big_ids, _, giant_idx, giant_ok) = (
        _tier_pairs(means2d, radii_f, vis, nx, ny, tile, t_max, overflow_k, t_max_big,
                    mid_k, t_max_mid, conics, opac))
    tile_ids = torch.cat([main_ids.reshape(-1), mid_ids.reshape(-1), big_ids.reshape(-1)])
    pair_gidx = _slot_gaussians(P, t_max, mid_idx, mid_ids, giant_idx, big_ids)
    return tile_ids, pair_gidx, mid_idx, mid_ok, giant_idx, giant_ok


def _fused_tile_key(tile_ids, pair_gidx, n_tiles: int, P: int):
    """Pack (tile major, depth-rank minor) into one int64 sort key:
    (key, gbits). The JAX package packs into int32 and falls back to a
    two-key sort past 31 bits; the port raises past 62 (``_key_bits``)."""
    gbits = _key_bits(n_tiles + 1, max(P, 2))
    return (tile_ids.to(torch.int64) << gbits) | pair_gidx.to(torch.int64), gbits


def _bin_pairs(means2d, radii_f, vis, nx: int, ny: int, tile: int, t_max: int,
               overflow_k: int = 256, t_max_big: int = 1024,
               mid_k: int = 4096, t_max_mid: int = 64,
               conics=None, opac=None):
    """(tile, pair) assignment for depth-ordered gaussians; 3-tier budgets.

    Returns (pair_order, sorted_tiles, starts, pair_rank, gidx_sorted,
    mid_idx, mid_ok, big_idx, big_ok), all index tensors (int64): the sort
    permutation of the pre-sort slots, their tile ids in sorted order, the
    [n_tiles + 1] segment starts, each sorted slot's rank within its tile
    (1 << 30 for sentinel slots), each sorted slot's depth-ranked gaussian,
    and the tier tables. One stable sort of the fused key (tile major,
    depth rank minor): gaussians are depth-ordered, so each tile's segment
    comes out front to back."""
    n_tiles = nx * ny
    tile_ids, pair_gidx, mid_idx, mid_ok, big_idx, big_ok = _make_pair_keys(
        means2d, radii_f, vis, nx, ny, tile, t_max, overflow_k=overflow_k,
        t_max_big=t_max_big, mid_k=mid_k, t_max_mid=t_max_mid, conics=conics, opac=opac)
    key, gbits = _fused_tile_key(tile_ids, pair_gidx, n_tiles, means2d.shape[0])
    sorted_key, pair_order = torch.sort(key, stable=True)
    sorted_tiles = sorted_key >> gbits
    gidx_sorted = sorted_key & ((1 << gbits) - 1)
    starts = torch.searchsorted(
        sorted_tiles, torch.arange(n_tiles + 1, dtype=torch.int64, device=key.device))
    rank = torch.arange(sorted_tiles.shape[0], device=key.device) - starts[
        torch.clamp_max(sorted_tiles, n_tiles - 1)]
    pair_rank = torch.where(sorted_tiles < n_tiles, rank, torch.full_like(rank, 1 << 30))
    return (pair_order, sorted_tiles, starts, pair_rank, gidx_sorted,
            mid_idx, mid_ok, big_idx, big_ok)


def _invert_perm_payload(perm: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """out[perm[s]] = payload[s]: a permutation scatter, exact and
    deterministic (each target written once). With payload = iota it is the
    inverse permutation."""
    out = torch.empty_like(payload)
    out[perm] = payload
    return out


class _PairGather(torch.autograd.Function):
    """records[gidx_sorted]: the per-gaussian records broadcast to their
    pair slots in sorted order, over the three-tier slot layout (P*t_max
    main + K2*t_max_mid mid + K*t_max_big giant slots).

    Backward (the JAX package's custom VJP): the cotangent back in pre-sort
    slot order (a gather by the inverse sort permutation), summed over each
    gaussian's regular slot block, then the tier rows added. The tier
    indices are distinct and those gaussians' main-block rows are zero, so
    the adds are exact assignments."""

    @staticmethod
    def forward(ctx, records, gidx_sorted, inv_order, mid_idx, mid_ok, big_idx, big_ok,
                t_max, t_max_mid, t_max_big):
        ctx.save_for_backward(inv_order, mid_idx, mid_ok, big_idx, big_ok)
        ctx.sizes = (records.shape[0], t_max, t_max_mid, t_max_big)
        return records[gidx_sorted]

    @staticmethod
    def backward(ctx, g):
        inv_order, mid_idx, mid_ok, big_idx, big_ok = ctx.saved_tensors
        P, t_max, t_max_mid, t_max_big = ctx.sizes
        K2, K, R = mid_idx.shape[0], big_idx.shape[0], g.shape[-1]
        d_pair = g[inv_order]  # pre-sort slot order
        n_main, n_mid = P * t_max, K2 * t_max_mid
        d = d_pair[:n_main].reshape(P, t_max, R).sum(1)
        d_mid = d_pair[n_main:n_main + n_mid].reshape(K2, t_max_mid, R).sum(1)
        d_big = d_pair[n_main + n_mid:].reshape(K, t_max_big, R).sum(1)
        d[mid_idx] = d[mid_idx] + torch.where(mid_ok[:, None], d_mid, torch.zeros_like(d_mid))
        d[big_idx] = d[big_idx] + torch.where(big_ok[:, None], d_big, torch.zeros_like(d_big))
        return (d,) + (None,) * 9


class _Window(torch.autograd.Function):
    """[N_pairs, R] sorted pair rows -> the dense zero-padded
    [n_tiles, k_max, R] window: row k of tile t is pair starts[t] + k while
    k < the tile's count. Backward: each pair gathers its (tile, rank)
    cell; sentinel pairs and ranks past k_max get zero."""

    @staticmethod
    def forward(ctx, x, starts, pair_tile, pair_rank, k_max):
        n_tiles = starts.shape[0] - 1
        counts = starts[1:] - starts[:-1]
        k = torch.arange(k_max, device=x.device)
        idx = torch.clamp_max(starts[:-1, None] + k[None, :], x.shape[0] - 1)
        rows = x[idx.reshape(-1)].reshape(n_tiles, k_max, x.shape[-1])
        valid = k[None, :] < counts[:, None]
        ctx.save_for_backward(pair_tile, pair_rank)
        ctx.k_max = k_max
        return torch.where(valid[..., None], rows, torch.zeros_like(rows))

    @staticmethod
    def backward(ctx, g):
        pair_tile, pair_rank = ctx.saved_tensors
        k_max, n_tiles = ctx.k_max, g.shape[0]
        ok = (pair_tile < n_tiles) & (pair_rank < k_max)
        cell = torch.where(ok, pair_tile * k_max + pair_rank, torch.zeros_like(pair_tile))
        dx = g.reshape(-1, g.shape[-1])[cell]
        return torch.where(ok[:, None], dx, torch.zeros_like(dx)), None, None, None, None


SB_SCAN = 4  # depth slots composited per checkpointed block of the scan


def _composite_slots(T, C, done, recs, k0: int, counts, px, py):
    """SB_SCAN depth slots [n_tiles, SB_SCAN, 9] (slot index k0 on) into the
    carries: transmittance T and colour C per tile pixel, and done (the
    pixel has stopped). The golden model's arithmetic: alpha from the conic
    power, clamped to ALPHA_MAX, zero below ALPHA_MIN or at positive power;
    a pixel stops at the first pair whose T (1 - alpha) falls under T_EPS,
    without taking it."""
    k = k0 + torch.arange(recs.shape[1], device=recs.device)
    op = torch.where(k[None, :] < counts[:, None], recs[:, :, 8], torch.zeros_like(recs[:, :, 8]))
    dx = px[:, None] - recs[:, :, 0, None, None]  # [T, SB, t, t]
    dy = py[:, None] - recs[:, :, 1, None, None]
    power = (-0.5 * (recs[:, :, 2, None, None] * dx * dx + recs[:, :, 4, None, None] * dy * dy)
             - recs[:, :, 3, None, None] * dx * dy)
    alpha = torch.clamp_max(op[:, :, None, None] * torch.exp(power), ALPHA_MAX)
    alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN), torch.zeros_like(alpha), alpha)
    for i in range(recs.shape[1]):
        a = alpha[:, i]
        test_t = T * (1.0 - a)
        stop = test_t < T_EPS
        contribute = ~done & ~stop
        w = torch.where(contribute, a * T, torch.zeros_like(a))
        C = C + recs[:, i, 5:8, None, None] * w[:, None]
        T = torch.where(contribute, test_t, T)
        done = done | stop
    return T, C, done


def rasterize_tiled(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    bg_color,
    tile: int = 16,
    t_max: int = 16,
    k_max: int = 512,
    kb: int = 32,  # kept for API compatibility; the slot scan does not block
    overflow_k: int = 256,
    t_max_big: int = 1024,
    mid_k: int = 4096,
    t_max_mid: int = 64,
) -> torch.Tensor:
    """Tile-binned rasterization -> [3, H, W], differentiable in the
    projection's means, conics, colours and opacities and in ``bg_color``
    (the binning sees detached values). Each tile composites at most
    ``k_max`` pairs of its depth-ordered segment."""
    dev = proj.means2d.device
    nx, ny = -(-width // tile), -(-height // tile)
    n_tiles = nx * ny
    P = proj.means2d.shape[0]
    k_max = min(k_max, P * t_max)
    overflow_k, mid_k = _tier_sizes(P, overflow_k, mid_k)

    visible = proj.radii > 0
    order = torch.argsort(torch.where(visible, proj.depths,
                                      torch.full_like(proj.depths, float("inf"))),
                          stable=True)  # jnp.argsort is stable
    opac_all = torch.where(visible, proj.opacities, torch.zeros_like(proj.opacities))
    records = _permute(torch.cat([proj.means2d, proj.conics, proj.colors,
                                  opac_all[:, None]], dim=-1), order)  # [P, 9]
    rec_ng = records.detach()
    (pair_order, sorted_tiles, starts, pair_rank, gidx_sorted,
     mid_idx, mid_ok, big_idx, big_ok) = _bin_pairs(
        rec_ng[:, 0:2], proj.radii[order].to(rec_ng.dtype), visible[order], nx, ny, tile,
        t_max, overflow_k=overflow_k, t_max_big=t_max_big, mid_k=mid_k,
        t_max_mid=t_max_mid, conics=rec_ng[:, 2:5], opac=rec_ng[:, 8])
    inv_order = _invert_perm_payload(pair_order, torch.arange(pair_order.shape[0],
                                                              device=dev))
    sorted_records = _PairGather.apply(records, gidx_sorted, inv_order, mid_idx, mid_ok,
                                       big_idx, big_ok, t_max, t_max_mid, t_max_big)
    windowed = _Window.apply(sorted_records, starts, sorted_tiles, pair_rank, k_max)
    counts = starts[1:] - starts[:-1]
    k_pad = (-k_max) % SB_SCAN
    if k_pad:
        windowed = torch.cat([windowed, windowed.new_zeros(n_tiles, k_pad, RECORD)], dim=1)
    blocks = windowed.reshape(n_tiles, -1, SB_SCAN, RECORD).unbind(1)

    # absolute pixel coordinates per tile [n_tiles, tile, tile]
    t_idx = torch.arange(n_tiles, device=dev)
    lx = torch.arange(tile, device=dev, dtype=rec_ng.dtype)
    px = ((t_idx % nx) * tile).to(rec_ng.dtype)[:, None, None] + lx[None, None, :]
    py = ((t_idx // nx) * tile).to(rec_ng.dtype)[:, None, None] + lx[None, :, None]
    px = px.expand(n_tiles, tile, tile)
    py = py.expand(n_tiles, tile, tile)

    T = torch.ones(n_tiles, tile, tile, dtype=rec_ng.dtype, device=dev)
    C = torch.zeros(n_tiles, 3, tile, tile, dtype=rec_ng.dtype, device=dev)
    done = torch.zeros(n_tiles, tile, tile, dtype=torch.bool, device=dev)
    remat = torch.is_grad_enabled() and windowed.requires_grad
    for b, recs in enumerate(blocks):
        if remat:
            T, C, done = checkpoint(_composite_slots, T, C, done, recs, b * SB_SCAN, counts,
                                    px, py, use_reentrant=False)
        else:
            T, C, done = _composite_slots(T, C, done, recs, b * SB_SCAN, counts, px, py)
    bg = torch.as_tensor(bg_color, dtype=C.dtype, device=dev)
    out_tiles = C + T[:, None] * bg[None, :, None, None]
    img = out_tiles.reshape(ny, nx, 3, tile, tile).permute(2, 0, 3, 1, 4)
    return img.reshape(3, ny * tile, nx * tile)[:, :height, :width]
