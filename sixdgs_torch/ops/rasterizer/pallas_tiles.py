"""Tile rasterizer on hand-written CUDA kernels: forward (inference) path.

Port of sixdgs_tpu/ops/rasterizer/pallas_tiles.py. It keeps that file's
name and public names so that the ``"pallas"`` rasterizer and the tests
map one to one, but its kernels are CUDA C++ for sm_90a:

  * ``_align_compact`` (B5, ``csrc/align_compact.cu``) replaces the TPU
    kernel ``_align_kernel``: it moves the tile-sorted compact gaussian
    indices into the layout where every tile segment starts at a multiple
    of KB = 128;
  * ``pallas_composite_fwd`` (B3, ``csrc/composite_fwd.cu``) replaces the
    TPU kernel ``_fwd_kernel`` (store_t=False): per 16x16 tile,
    front-to-back alpha compositing of its depth-ordered segment with the
    background composited in-kernel, out [n_tiles, 256, 3].

On a CUDA tensor each wrapper launches its kernel (and counts the launch in
its ``.launches``); on a CPU tensor it runs its plain PyTorch version
(``align_compact_plain``, ``composite_fwd_plain``). A build or launch
failure raises; nothing falls back to the plain version on the card.

``rasterize_pallas`` is the whole forward path: depth argsort and record
permute, three-tier binning with conic culling, one sort of the pair keys
cut to the first ``nc`` slots, segment and aligned starts, B5, the record
row gather into [16, NC], B3 and the tile-to-image relayout. It is forward
only: the backward kernel (B4), B3's stored-transmittance variant and the
custom VJPs come with the training slice, and until then it refuses inputs
that require grad.

Record planes (rows of the [16, NC] matrix; 9 live + 7 padding):
0:x 1:y 2:conA 3:conB 4:conC 5:r 6:g 7:b 8:opacity, means in absolute
pixel coordinates.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sixdgs_torch.ops import _build
from sixdgs_torch.ops.rasterizer.compositing import ALPHA_MAX, ALPHA_MIN, T_EPS
from sixdgs_torch.ops.rasterizer.projection import ProjectedGaussians
from sixdgs_torch.ops.rasterizer.tiles import (
    RECORD,
    _fused_pair_keys,
    _permute,
    _tier_sizes,
)

COLS = 16  # padded record planes
KB = 128  # pairs per chunk; aligned segments start at KB multiples
TILE = 16
NPIX = TILE * TILE
DEFAULT_NC = 1 << 20  # default compact pair budget
ALIGN_CPB = 8  # nc is a multiple of ALIGN_CPB * KB, as in the JAX package

_SIGNATURES = {
    "align_compact": {
        "b5_align_compact_launch": (ctypes.c_int, [ctypes.c_void_p] * 3
                                    + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2),
    },
    "composite_fwd": {
        "b3_composite_fwd_launch": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_longlong]
                                    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                                    + [ctypes.c_void_p] * 3),
    },
}


def _library(name: str) -> ctypes.CDLL:
    """csrc/<name>.cu, built and loaded at first use."""
    return _build.bound_library(name, _SIGNATURES[name])


def _check_device(name: str, ref: torch.Tensor, *tensors) -> None:
    for t in tensors:
        if t.device != ref.device:
            raise ValueError(f"{name}: inputs on {t.device} and {ref.device}")
    if ref.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: no path for device {ref.device}")


# ------------------------------------------------------------------ B5


def align_compact_plain(gidx_c, starts, starts_al, n_tiles: int, sentinel: int):
    """The aligned-layout gather in plain PyTorch: [nc] int32 with tile t's
    first min(count_t, aligned width) indices at starts_al[t] and
    ``sentinel`` everywhere else."""
    nc = gidx_c.shape[0]
    dev = gidx_c.device
    starts = starts.to(torch.int64)
    starts_al = starts_al.to(torch.int64)
    c = torch.arange(nc, dtype=torch.int64, device=dev)
    # owning tile of each KB chunk: #{t : starts_al[t + 1] <= chunk start}
    t = torch.searchsorted(starts_al[1:].contiguous(), c // KB * KB, right=True)
    tt = torch.clamp_max(t, max(n_tiles - 1, 0))
    k = c - starts_al[tt]
    valid = (t < n_tiles) & (k < starts[tt + 1] - starts[tt])
    src = torch.clamp(starts[tt] + k, 0, max(nc - 1, 0))
    return torch.where(valid, gidx_c.to(torch.int32)[src],
                       torch.full_like(src, sentinel, dtype=torch.int32))


def _align_compact(gidx_c, starts, starts_al, n_tiles: int, sentinel: int):
    """[nc] unaligned compact gaussian indices -> [nc] KB-aligned layout.

    ``starts``: real per-tile segment starts [n_tiles+1]; ``starts_al``: the
    KB-aligned starts (clamped to nc). Padding lanes and lanes beyond the
    aligned total carry ``sentinel``. B5 on CUDA tensors, the plain version
    on CPU tensors."""
    _check_device("_align_compact", gidx_c, starts, starts_al)
    if gidx_c.device.type == "cpu":
        return align_compact_plain(gidx_c, starts, starts_al, n_tiles, sentinel)
    nc = gidx_c.shape[0]
    if starts.shape != (n_tiles + 1,) or starts_al.shape != (n_tiles + 1,):
        raise ValueError(f"starts {tuple(starts.shape)} / starts_al "
                         f"{tuple(starts_al.shape)} must be [{n_tiles + 1}]")
    out = torch.empty(nc, dtype=torch.int32, device=gidx_c.device)
    if nc == 0:
        return out
    ins = [x.to(torch.int32).contiguous() for x in (gidx_c, starts, starts_al)]
    _build.launch(_library("align_compact").b5_align_compact_launch, *ins,
                  n_tiles, sentinel, nc, out)
    _align_compact.launches += 1
    return out


_align_compact.launches = 0  # B5 launches on CUDA tensors


def _aligned_starts(starts: torch.Tensor, nc: int):
    """KB-aligned per-tile segment starts (clamped to the nc budget, int32)
    and the UNCLAMPED aligned total (0-d int64)."""
    counts = (starts[1:] - starts[:-1]).to(torch.int64)
    aligned = -(-counts // KB) * KB
    starts_al = torch.cat([torch.zeros(1, dtype=torch.int64, device=starts.device),
                           torch.cumsum(aligned, 0)])
    return torch.clamp_max(starts_al, nc).to(torch.int32), torch.sum(aligned)


def _segment_starts(tiles_c: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """starts[t] = first index of tile t in the SORTED compact tile ids
    (t = n_tiles gives the real-pair count; sentinels sort last), int32:
    searchsorted on the sorted ids, the same answer as the JAX package's
    dense block-compare form."""
    q = torch.arange(n_tiles + 1, dtype=torch.int64, device=tiles_c.device)
    return torch.searchsorted(tiles_c.to(torch.int64).contiguous(), q).to(torch.int32)


# ------------------------------------------------------------------ B3


def composite_fwd_plain(records, starts, counts, nx: int, ny: int, bg,
                        return_work: bool = False):
    """The tile compositor in plain PyTorch: out [n_tiles, NPIX, 3].

    A tile-batched loop over KB-pair chunks of every segment that is still
    open: a cumulative product of (1 - alpha) along the chunk gives each
    pixel's transmittance, a cumulative-sum latch the early stop, carried
    across chunks (as ``rasterize_scan`` does over the whole scene).

    ``return_work``: also return (evaluations, contributions), the numbers
    of (pixel, pair) evaluations up to each pixel's stop and of
    contributing pairs — the work a serial compositor of these inputs
    needs."""
    dev = records.device
    n_tiles = nx * ny
    nc = records.shape[1]
    starts = starts[:n_tiles].to(torch.int64)
    counts = counts.to(torch.int64)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    lin = torch.arange(NPIX, device=dev)
    px = (lin % TILE).to(torch.float32)[None, :, None]
    py = (lin // TILE).to(torch.float32)[None, :, None]
    tid = torch.arange(n_tiles, device=dev)
    ox = ((tid % nx) * TILE).to(torch.float32)
    oy = ((tid // nx) * TILE).to(torch.float32)
    lane = torch.arange(KB, device=dev)

    T = torch.ones(n_tiles, NPIX, device=dev)
    C = torch.zeros(n_tiles, NPIX, 3, device=dev)
    done = torch.zeros(n_tiles, NPIX, dtype=torch.bool, device=dev)
    evals = torch.zeros((), dtype=torch.int64, device=dev)
    contribs = torch.zeros((), dtype=torch.int64, device=dev)
    max_count = int(counts.max()) if n_tiles else 0
    for k0 in range(0, max_count, KB):
        # tiles whose segment reaches this chunk and that have an open pixel
        act = torch.nonzero((counts > k0) & ~done.all(dim=1)).flatten()
        if act.numel() == 0:
            break
        inb = (k0 + lane)[None, :] < counts[act, None]  # [A, KB]
        idx = torch.clamp_max(starts[act, None] + k0 + lane[None, :], nc - 1)
        rec = records[:RECORD, idx]  # [9, A, KB]
        dx = px - (rec[0] - ox[act, None])[:, None, :]  # [A, NPIX, KB]
        dy = py - (rec[1] - oy[act, None])[:, None, :]
        power = (-0.5 * (rec[2][:, None] * dx * dx + rec[4][:, None] * dy * dy)
                 - rec[3][:, None] * dx * dy)
        alpha = torch.clamp_max(rec[8][:, None] * torch.exp(power), ALPHA_MAX)
        live = (power <= 0.0) & (alpha >= ALPHA_MIN) & inb[:, None, :]
        alpha = torch.where(live, alpha, torch.zeros_like(alpha))
        one_minus = 1.0 - alpha
        cum = torch.cumprod(one_minus, dim=2)
        T_before = T[act, :, None] * torch.cat([torch.ones_like(cum[..., :1]),
                                                cum[..., :-1]], dim=2)
        stopped = torch.cumsum((T_before * one_minus < T_EPS).to(torch.int32), dim=2) > 0
        dead = stopped | done[act, :, None]
        w = torch.where(dead, torch.zeros_like(alpha), alpha * T_before)
        C[act] += torch.einsum("apk,cak->apc", w, rec[5:8])
        T[act] = T[act] * torch.prod(torch.where(dead, torch.ones_like(one_minus),
                                                 one_minus), dim=2)
        if return_work:
            reached = ~torch.cat([done[act, :, None], dead[..., :-1]], dim=2)
            evals += (reached & inb[:, None, :]).sum()
            contribs += (live & ~dead).sum()
        done[act] = dead[..., -1]
    out = C + T[..., None] * bg
    if return_work:
        return out, (int(evals), int(contribs))
    return out


def pallas_composite_fwd(records, starts, counts, nx: int, ny: int, bg,
                         store_t: bool = False):
    """records: [16, NC] sorted compact pair record planes (9 live rows);
    starts [n_tiles(+1)] and counts [n_tiles] int32 with
    starts[t] + counts[t] <= NC; bg [3]. Returns the composited tile images
    out [n_tiles, NPIX, 3] (out = C + T*bg). B3 on CUDA tensors, the plain
    version on CPU tensors.

    ``store_t`` (the per-(pixel, pair) transmittance for the stored-T
    backward) comes with the training slice."""
    if store_t:
        raise NotImplementedError(
            "store_t comes with the backward kernel (B4) in the training slice")
    _check_device("pallas_composite_fwd", records, starts, counts)
    n_tiles = nx * ny
    if records.dim() != 2 or records.shape[0] != COLS:
        raise ValueError(f"records must be [{COLS}, NC], got {tuple(records.shape)}")
    if starts.shape[0] < n_tiles or counts.shape != (n_tiles,):
        raise ValueError(f"starts {tuple(starts.shape)} / counts {tuple(counts.shape)} "
                         f"do not cover {n_tiles} tiles")
    if records.device.type == "cpu":
        return composite_fwd_plain(records.to(torch.float32), starts, counts, nx, ny, bg)
    out = torch.empty(n_tiles, NPIX, 3, dtype=torch.float32, device=records.device)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=records.device).reshape(3)
    ins = (records.to(torch.float32).contiguous(), records.shape[1],
           starts.to(torch.int32).contiguous(), counts.to(torch.int32).contiguous(),
           n_tiles, nx, bg.contiguous(), out)
    _build.launch(_library("composite_fwd").b3_composite_fwd_launch, *ins)
    pallas_composite_fwd.launches += 1
    return out


pallas_composite_fwd.launches = 0  # B3 launches on CUDA tensors


# ------------------------------------------------------------- full wrapper


class CompactLayout(NamedTuple):
    """The binned, sorted and counted pairs of one render: everything
    ``rasterize_pallas`` computes before B5."""

    nx: int
    ny: int
    n_tiles: int
    P: int
    nc: int  # compact pair budget (slots kept after the key sort)
    order: torch.Tensor  # [P] depth order (stable)
    records: torch.Tensor  # [P, 9] depth-ordered per-gaussian records
    counts_g: torch.Tensor  # [P] emitted pairs per depth-ranked gaussian
    gidx_c: torch.Tensor  # [nc] int32 compact depth ranks, tile-sorted
    tiles_c: torch.Tensor  # [nc] int32 their tile ids (n_tiles: sentinel)
    starts: torch.Tensor  # [n_tiles + 1] int32 segment starts
    starts_al: torch.Tensor  # [n_tiles + 1] int32 KB-aligned starts (<= nc)
    al_total: torch.Tensor  # 0-d int64 unclamped aligned demand
    counts_k: torch.Tensor  # [n_tiles] int32 pairs B3 composites per tile


def _compact_layout(proj: ProjectedGaussians, width: int, height: int, t_max: int,
                    overflow_k: int, t_max_big: int, mid_k: int, t_max_mid: int,
                    nc_pairs: int) -> CompactLayout:
    """Depth order, depth-ordered per-gaussian records [P, 9], binning, the
    key sort cut to ``nc`` slots, segment and aligned starts."""
    dev = proj.means2d.device
    nx = -(-width // TILE)
    ny = -(-height // TILE)
    n_tiles = nx * ny
    P = proj.means2d.shape[0]

    visible = proj.radii > 0
    order = torch.argsort(torch.where(visible, proj.depths,
                                      torch.full_like(proj.depths, float("inf"))),
                          stable=True)  # jnp.argsort is stable
    opac_all = torch.where(visible, proj.opacities, torch.zeros_like(proj.opacities))
    records = _permute(torch.cat([proj.means2d, proj.conics, proj.colors,
                                  opac_all[:, None]], dim=-1), order)  # [P, 9]
    overflow_k, mid_k = _tier_sizes(P, overflow_k, mid_k)
    key, counts_g, gbits = _fused_pair_keys(
        records[:, 0:2], proj.radii[order].to(torch.float32), visible[order],
        nx, ny, TILE, t_max, overflow_k=overflow_k, t_max_big=t_max_big,
        mid_k=mid_k, t_max_mid=t_max_mid, conics=records[:, 2:5], opac=records[:, 8])
    n_slots = P * t_max + mid_k * t_max_mid + overflow_k * t_max_big
    ncb = ALIGN_CPB * KB
    nc = min(-(-(nc_pairs or DEFAULT_NC) // ncb) * ncb, -(-n_slots // ncb) * ncb)
    pad = max(-(-n_slots // KB) * KB, nc) - n_slots
    if pad:
        key = torch.cat([key, torch.full((pad,), n_tiles << gbits, dtype=torch.int64,
                                         device=dev)])
    skey = torch.sort(key).values[:nc]
    gidx_c = (skey & ((1 << gbits) - 1)).to(torch.int32)
    tiles_c = (skey >> gbits).to(torch.int32)

    starts = _segment_starts(tiles_c, n_tiles)
    starts_al, al_total = _aligned_starts(starts, nc)
    counts_k = torch.minimum(starts[1:] - starts[:-1], starts_al[1:] - starts_al[:-1])
    return CompactLayout(nx, ny, n_tiles, P, nc, order, records, counts_g, gidx_c,
                         tiles_c, starts, starts_al, al_total, counts_k)


def _gather_records(records: torch.Tensor, gidx_al: torch.Tensor) -> torch.Tensor:
    """records[gidx_al] as the plane-major [16, NC] matrix (rows 9-15 zero).
    Padding lanes carry the sentinel P, one past the last gaussian: JAX's
    gather clamps it to the last record row, and so does this one (an
    unclamped index P would be an out-of-bounds fault on the card)."""
    P = records.shape[0]
    rows = records[torch.clamp_max(gidx_al.to(torch.int64), P - 1)]  # [NC, 9]
    out = torch.zeros(COLS, rows.shape[0], dtype=torch.float32, device=records.device)
    out[:RECORD] = rows.T
    return out


def _tiles_to_image(out: torch.Tensor, nx: int, ny: int, width: int, height: int):
    """[n_tiles, NPIX, 3] tile images -> [3, H, W], edge tiles cropped."""
    img = out.reshape(ny, nx, TILE, TILE, 3).permute(4, 0, 2, 1, 3)
    return img.reshape(3, ny * TILE, nx * TILE)[:, :height, :width].contiguous()


def rasterize_pallas(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    bg_color,
    t_max: int = 16,
    overflow_k: int = 256,
    t_max_big: int = 1024,
    mid_k: int = 4096,
    t_max_mid: int = 64,
    nc_pairs: int = 0,
    return_stats: bool = False,
):
    """Tile-binned rasterization through B5 and B3 -> [3, H, W].

    ``nc_pairs``: compact pair budget (0 = min(DEFAULT_NC, slot count));
    when the aligned demand exceeds it, trailing tiles are cut and render
    wrong, as in the JAX package. ``return_stats``: also return
    {nc_demand (aligned slots the scene wants), nc_real (post-cull emitted
    pairs that survived the cut), grad_dropped (1 when the aligned demand
    overflowed nc)} as 0-d int32 tensors.

    Forward only: raises when an input requires grad (the backward kernel,
    B4, comes with the training slice)."""
    if any(t.requires_grad for t in proj) or (
            isinstance(bg_color, torch.Tensor) and bg_color.requires_grad):
        raise RuntimeError(
            "rasterize_pallas is forward-only until the backward kernel (B4) is "
            "ported: call it under torch.no_grad() or on detached tensors")
    lay = _compact_layout(proj, width, height, t_max, overflow_k, t_max_big, mid_k,
                          t_max_mid, nc_pairs)
    gidx_al = _align_compact(lay.gidx_c, lay.starts, lay.starts_al, lay.n_tiles, lay.P)
    records_t = _gather_records(lay.records, gidx_al)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=records_t.device)
    out = pallas_composite_fwd(records_t, lay.starts_al, lay.counts_k, lay.nx, lay.ny, bg)
    img = _tiles_to_image(out, lay.nx, lay.ny, width, height)
    if return_stats:
        stats = {
            "nc_demand": lay.al_total.to(torch.int32),
            "nc_real": lay.starts[lay.n_tiles],
            "grad_dropped": (lay.al_total > lay.nc).to(torch.int32),
        }
        return img, stats
    return img
