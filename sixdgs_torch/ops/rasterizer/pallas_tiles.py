"""Tile rasterizer on hand-written CUDA kernels: forward and backward.

Port of sixdgs_tpu/ops/rasterizer/pallas_tiles.py. It keeps that file's
name and public names so that the ``"pallas"`` rasterizer and the tests
map one to one, but its kernels are CUDA C++ for sm_90a:

  * ``_align_compact`` (B5, ``csrc/align_compact.cu``) replaces the TPU
    kernel ``_align_kernel``: it moves the tile-sorted compact gaussian
    indices into the layout where every tile segment starts at a multiple
    of KB = 128;
  * ``pallas_composite_fwd`` (B3, ``csrc/composite_fwd.cu``) replaces the
    TPU kernel ``_fwd_kernel``: per 16x16 tile, front-to-back alpha
    compositing of its depth-ordered segment with the background
    composited in-kernel, out [n_tiles, 256, 3]; with ``store_t`` it also
    writes every pixel's transmittance before every pair;
  * ``pallas_composite_bwd`` (B4, ``csrc/composite_bwd.cu``) replaces the
    TPU kernel ``_bwd_kernel``: the per-pair gradients [16, NC] of the
    compositor, with the transmittance replayed or reread from the store.

On a CUDA tensor each wrapper launches its kernel and counts the launch in
a counter of ``utils.profiling`` (``kernel.b5``; ``kernel.b3``, or
``kernel.b3_store`` with the transmittance store; ``kernel.b4``); on a CPU
tensor it runs its plain PyTorch version (``align_compact_plain``,
``composite_fwd_plain``, ``composite_bwd_plain``). A build or launch
failure raises; nothing falls back to the plain version on the card.

``rasterize_pallas`` is the whole path: depth argsort and record permute,
three-tier binning with conic culling (on detached inputs), one sort of
the pair keys cut to the first ``nc`` slots, segment and aligned starts,
B5, the record row gather into [16, NC] (``_gather_pairs``), the
compositor (``_composite``) and the tile-to-image relayout. Gradients flow
through three ``torch.autograd.Function``s: ``_composite`` (B3 with the
store forward, B4 backward), ``_gather_pairs`` (a deterministic
per-gaussian segment sum of the pair cotangents) and ``tiles._permute``.

Record planes (rows of the [16, NC] matrix; 9 live + 7 padding):
0:x 1:y 2:conA 3:conB 4:conC 5:r 6:g 7:b 8:opacity, means in absolute
pixel coordinates.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sixdgs_torch.ops import _build
from sixdgs_torch.utils.profiling import count
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
                                    + [ctypes.c_void_p] * 4),
    },
    "composite_bwd": {
        "b4_composite_bwd_launch": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_longlong]
                                    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                                    + [ctypes.c_void_p] * 5),
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
    if n_tiles == 0:  # no tile owns a chunk
        return torch.full((nc,), sentinel, dtype=torch.int32, device=dev)
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
    on CPU tensors. The kernel needs nc a multiple of KB (the rasterizer's
    is a multiple of ALIGN_CPB * KB) and 16-byte aligned int32 storage of
    ``gidx_c`` and the output; it raises otherwise."""
    _check_device("_align_compact", gidx_c, starts, starts_al)
    if gidx_c.device.type == "cpu":
        return align_compact_plain(gidx_c, starts, starts_al, n_tiles, sentinel)
    nc = gidx_c.shape[0]
    if starts.shape != (n_tiles + 1,) or starts_al.shape != (n_tiles + 1,):
        raise ValueError(f"starts {tuple(starts.shape)} / starts_al "
                         f"{tuple(starts_al.shape)} must be [{n_tiles + 1}]")
    if nc % KB:
        raise ValueError(f"_align_compact: nc {nc} is not a multiple of {KB}")
    out = torch.empty(nc, dtype=torch.int32, device=gidx_c.device)
    if nc == 0:
        return out
    # no copy where the inputs are int32 and contiguous already (the
    # rasterizer's are)
    ins = [x if x.dtype == torch.int32 and x.is_contiguous() else
           x.to(torch.int32).contiguous() for x in (gidx_c, starts, starts_al)]
    if ins[0].data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("_align_compact: gidx_c and out must be 16-byte aligned")
    _build.launch(_library("align_compact").b5_align_compact_launch, *ins,
                  n_tiles, sentinel, nc, out)
    count("kernel.b5")
    return out


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


# ------------------------------------------------------------ B3 and B4


class _Chunk(NamedTuple):
    """One KB-pair round of ``_SegmentWalk`` over the A tiles still open."""

    act: torch.Tensor  # [A] tile ids
    idx: torch.Tensor  # [A, KB] lanes of ``records`` (clamped to nc - 1)
    inb: torch.Tensor  # [A, KB] lane lies inside the tile's segment
    rec: torch.Tensor  # [9, A, KB] record rows
    dx: torch.Tensor  # [A, NPIX, KB] pixel minus mean
    dy: torch.Tensor
    g_raw: torch.Tensor  # [A, NPIX, KB] exp(power)
    alpha: torch.Tensor  # [A, NPIX, KB], 0 where the pair is not live
    T_before: torch.Tensor  # [A, NPIX, KB] transmittance before each pair
    contrib: torch.Tensor  # [A, NPIX, KB] live pair before the pixel's stop
    reached: torch.Tensor  # [A, NPIX, KB] real pair up to and with the stop
    texcl: torch.Tensor  # [A, NPIX, KB] T_before, frozen from the stop on


class _SegmentWalk:
    """The serial front-to-back walk of every tile's segment, tile-batched:
    KB pairs of every open tile per round, the carried transmittance ``T``
    [n_tiles, NPIX] and stop latch ``done`` updated after each round. A
    cumulative product of (1 - alpha) along the chunk gives each pixel's
    transmittance and a cumulative-sum latch the early stop (as
    ``rasterize_scan`` does over the whole scene). Given ``texcl`` (the
    forward's store) the transmittance is reread instead. The plain
    versions of B3 and B4 are both loops over this walk, which is what
    makes their two modes agree bitwise."""

    def __init__(self, records, starts, counts, nx: int, ny: int, texcl=None):
        dev = records.device
        self.records = records
        self.n_tiles = nx * ny
        self.nc = records.shape[1]
        self.starts = starts[:self.n_tiles].to(torch.int64)
        self.counts = counts.to(torch.int64)
        self.texcl = texcl
        lin = torch.arange(NPIX, device=dev)
        self.px = (lin % TILE).to(torch.float32)[None, :, None]
        self.py = (lin // TILE).to(torch.float32)[None, :, None]
        tid = torch.arange(self.n_tiles, device=dev)
        self.ox = ((tid % nx) * TILE).to(torch.float32)
        self.oy = ((tid // nx) * TILE).to(torch.float32)
        self.lane = torch.arange(KB, device=dev)
        self.T = torch.ones(self.n_tiles, NPIX, device=dev)
        self.done = torch.zeros(self.n_tiles, NPIX, dtype=torch.bool, device=dev)

    def __iter__(self):
        starts, counts, lane = self.starts, self.counts, self.lane
        max_count = int(counts.max()) if self.n_tiles else 0
        for k0 in range(0, max_count, KB):
            # tiles whose segment reaches this chunk and that have an open pixel
            act = torch.nonzero((counts > k0) & ~self.done.all(dim=1)).flatten()
            if act.numel() == 0:
                break
            T, done = self.T[act, :, None], self.done[act, :, None]
            inb = (k0 + lane)[None, :] < counts[act, None]  # [A, KB]
            idx = torch.clamp_max(starts[act, None] + k0 + lane[None, :], self.nc - 1)
            rec = self.records[:RECORD, idx]  # [9, A, KB]
            dx = self.px - (rec[0] - self.ox[act, None])[:, None, :]  # [A, NPIX, KB]
            dy = self.py - (rec[1] - self.oy[act, None])[:, None, :]
            power = (-0.5 * (rec[2][:, None] * dx * dx + rec[4][:, None] * dy * dy)
                     - rec[3][:, None] * dx * dy)
            g_raw = torch.exp(power)
            alpha = torch.clamp_max(rec[8][:, None] * g_raw, ALPHA_MAX)
            live = (power <= 0.0) & (alpha >= ALPHA_MIN) & inb[:, None, :]
            alpha = torch.where(live, alpha, torch.zeros_like(alpha))
            one_minus = 1.0 - alpha
            if self.texcl is None:
                cum = torch.cumprod(one_minus, dim=2)
                T_before = T * torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]],
                                         dim=2)
            else:
                T_before = self.texcl[(starts[act] + k0) // KB]
            stopped = torch.cumsum((T_before * one_minus < T_EPS).to(torch.int32),
                                   dim=2) > 0
            dead = stopped | done
            before = ~torch.cat([done, dead[..., :-1]], dim=2)  # no stop before the lane
            # the pixel's transmittance stays as it was at its stop
            first = torch.argmax(stopped.to(torch.int8), dim=2, keepdim=True)
            frozen = torch.where(done, T, torch.gather(T_before, 2, first))
            texcl = torch.where(before, T_before, frozen)
            yield _Chunk(act, idx, inb, rec, dx, dy, g_raw, alpha, T_before,
                         live & ~dead, before & inb[:, None, :], texcl)
            self.T[act] = self.T[act] * torch.prod(
                torch.where(dead, torch.ones_like(one_minus), one_minus), dim=2)
            self.done[act] = dead[..., -1]


def _check_aligned(name: str, starts, n_tiles: int) -> None:
    if bool((starts[:n_tiles] % KB != 0).any()):
        raise ValueError(f"{name}: the stored transmittance needs the aligned layout "
                         f"(every segment start a multiple of {KB})")


def composite_fwd_plain(records, starts, counts, nx: int, ny: int, bg,
                        store_t: bool = False, return_work: bool = False):
    """The tile compositor in plain PyTorch: out [n_tiles, NPIX, 3], a loop
    over ``_SegmentWalk``.

    ``store_t``: also return Texcl [NC / KB, NPIX, KB], each pixel's
    transmittance before each pair (frozen from the pixel's stop on; blocks
    the walk never reached stay zero). Needs the aligned layout.

    ``return_work``: also return (evaluations, contributions), the numbers
    of (pixel, pair) evaluations up to each pixel's stop and of
    contributing pairs — the work a serial compositor of these inputs
    needs."""
    dev = records.device
    n_tiles = nx * ny
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    walk = _SegmentWalk(records, starts, counts, nx, ny)
    C = torch.zeros(n_tiles, NPIX, 3, device=dev)
    texcl = None
    if store_t:
        _check_aligned("composite_fwd_plain", starts, n_tiles)
        texcl = torch.zeros(records.shape[1] // KB, NPIX, KB, device=dev)
    evals = torch.zeros((), dtype=torch.int64, device=dev)
    contribs = torch.zeros((), dtype=torch.int64, device=dev)
    for k, c in enumerate(walk):
        w = torch.where(c.contrib, c.alpha * c.T_before, torch.zeros_like(c.alpha))
        C[c.act] += torch.einsum("apk,cak->apc", w, c.rec[5:8])
        if store_t:
            texcl[walk.starts[c.act] // KB + k] = c.texcl
        if return_work:
            evals += c.reached.sum()
            contribs += c.contrib.sum()
    res = (C + walk.T[..., None] * bg,)
    if store_t:
        res += (texcl,)
    if return_work:
        res += ((int(evals), int(contribs)),)
    return res if len(res) > 1 else res[0]


def _check_composite_inputs(name: str, records, starts, counts, n_tiles: int) -> None:
    _check_device(name, records, starts, counts)
    if records.dim() != 2 or records.shape[0] != COLS:
        raise ValueError(f"records must be [{COLS}, NC], got {tuple(records.shape)}")
    if starts.shape[0] < n_tiles or counts.shape != (n_tiles,):
        raise ValueError(f"starts {tuple(starts.shape)} / counts {tuple(counts.shape)} "
                         f"do not cover {n_tiles} tiles")


def pallas_composite_fwd(records, starts, counts, nx: int, ny: int, bg,
                         store_t: bool = False):
    """records: [16, NC] sorted compact pair record planes (9 live rows);
    starts [n_tiles(+1)] and counts [n_tiles] int32 with
    starts[t] + counts[t] <= NC; bg [3]. Returns the composited tile images
    out [n_tiles, NPIX, 3] (out = C + T*bg). B3 on CUDA tensors, the plain
    version on CPU tensors.

    ``store_t``: also return the per-(pixel, pair) serial transmittance
    Texcl as [NC // KB, NPIX, KB] f32 blocks, for the stored-T backward.
    The caller promises the KB-aligned segment layout (one owner tile per
    block; NC a KB multiple). ``out`` is bitwise the same either way.
    Blocks past a tile's early exit are left unwritten (``torch.empty``)
    on the card."""
    n_tiles = nx * ny
    _check_composite_inputs("pallas_composite_fwd", records, starts, counts, n_tiles)
    nc = records.shape[1]
    if store_t and nc % KB:
        raise ValueError(f"store_t needs NC a multiple of {KB}, got {nc}")
    if records.device.type == "cpu":
        return composite_fwd_plain(records.to(torch.float32), starts, counts, nx, ny, bg,
                                   store_t=store_t)
    dev = records.device
    out = torch.empty(n_tiles, NPIX, 3, dtype=torch.float32, device=dev)
    texcl = (torch.empty(nc // KB, NPIX, KB, dtype=torch.float32, device=dev)
             if store_t else None)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev).reshape(3)
    ins = (records.to(torch.float32).contiguous(), nc,
           starts.to(torch.int32).contiguous(), counts.to(torch.int32).contiguous(),
           n_tiles, nx, bg.contiguous(), out, texcl)
    _build.launch(_library("composite_fwd").b3_composite_fwd_launch, *ins)
    if store_t:
        count("kernel.b3_store")
        return out, texcl
    count("kernel.b3")
    return out


def composite_bwd_plain(records, starts, counts, nx: int, ny: int, out, dout,
                        texcl=None):
    """The compositor's per-pair gradients [16, NC] in plain PyTorch: the
    analytic front-to-back formula (see ``csrc/composite_bwd.cu``), chunk by
    chunk over ``_SegmentWalk``, with the transmittance replayed
    (``texcl=None``) or reread from the forward's store (aligned layout).
    Lanes outside the walked segments stay zero."""
    dev = records.device
    n_tiles = nx * ny
    if texcl is not None:
        _check_aligned("composite_bwd_plain", starts, n_tiles)
    dpairs = torch.zeros(COLS, records.shape[1], device=dev)
    S = torch.sum(dout * out, dim=-1)  # [n_tiles, NPIX]
    acc = torch.zeros(n_tiles, NPIX, device=dev)
    zero = torch.zeros((), device=dev)
    for c in _SegmentWalk(records, starts, counts, nx, ny, texcl):
        dC = dout[c.act]  # [A, NPIX, 3]
        w = torch.where(c.contrib, c.alpha * c.T_before, zero)
        col = c.rec[5:8]
        dbuf = (dC[..., 0:1] * col[0][:, None] + dC[..., 1:2] * col[1][:, None]
                + dC[..., 2:3] * col[2][:, None])  # [A, NPIX, KB]
        acc_i = acc[c.act, :, None] + torch.cumsum(dbuf * w, dim=2)
        da = dbuf * c.T_before - (S[c.act, :, None] - acc_i) / torch.clamp_min(
            1.0 - c.alpha, 1e-6)
        opac = c.rec[8]
        clamped = opac[:, None] * c.g_raw > ALPHA_MAX  # the clamp is flat
        s = torch.where(c.contrib & ~clamped, da * c.g_raw, zero)
        sdx, sdy = s * c.dx, s * c.dy
        m_x, m_y = sdx.sum(1), sdy.sum(1)  # [A, KB]
        m_xx, m_xy, m_yy = (sdx * c.dx).sum(1), (sdx * c.dy).sum(1), (sdy * c.dy).sum(1)
        conA, conB, conC = c.rec[2], c.rec[3], c.rec[4]
        dcol = torch.einsum("apc,apk->cak", dC, w)
        g = torch.stack([opac * (conA * m_x + conB * m_y),
                         opac * (conC * m_y + conB * m_x),
                         -0.5 * opac * m_xx, -opac * m_xy, -0.5 * opac * m_yy,
                         dcol[0], dcol[1], dcol[2], s.sum(1)])  # [9, A, KB]
        dpairs[:RECORD, c.idx[c.inb]] = g[:, c.inb]
        acc[c.act] = acc_i[..., -1]
    return dpairs


def pallas_composite_bwd(records, starts, counts, nx: int, ny: int, out, dout,
                         aligned: bool = False, texcl=None):
    """Per-pair gradients [16, NC] (rows as the records; rows 9-15 and every
    lane outside the walked segments zero). ``out`` is the forward's own
    output, ``dout`` the upstream cotangent, both [n_tiles, NPIX, 3]. B4 on
    CUDA tensors, the plain version on CPU tensors.

    ``texcl``: the forward's stored transmittance; the backward then rereads
    it instead of replaying, with bitwise the same result. ``aligned``:
    promise that every tile segment starts at a KB boundary, which the
    stored mode requires."""
    n_tiles = nx * ny
    _check_composite_inputs("pallas_composite_bwd", records, starts, counts, n_tiles)
    nc = records.shape[1]
    if texcl is not None and not aligned:
        raise ValueError("stored-T backward requires the aligned layout")
    for name, t, shape in (("out", out, (n_tiles, NPIX, 3)), ("dout", dout, (n_tiles, NPIX, 3)),
                           ("texcl", texcl, (nc // KB, NPIX, KB))):
        if t is None:
            continue
        _check_device("pallas_composite_bwd", records, t)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")
    out, dout = out.to(torch.float32).contiguous(), dout.to(torch.float32).contiguous()
    if texcl is not None:
        texcl = texcl.to(torch.float32).contiguous()
    if records.device.type == "cpu":
        return composite_bwd_plain(records.to(torch.float32), starts, counts, nx, ny, out,
                                   dout, texcl)
    dpairs = torch.zeros(COLS, nc, dtype=torch.float32, device=records.device)
    ins = (records.to(torch.float32).contiguous(), nc,
           starts.to(torch.int32).contiguous(), counts.to(torch.int32).contiguous(),
           n_tiles, nx, out, dout, texcl, dpairs)
    _build.launch(_library("composite_bwd").b4_composite_bwd_launch, *ins)
    count("kernel.b4")
    return dpairs


class _Composite(torch.autograd.Function):
    """The compositor with its analytic backward. With the aligned layout a
    forward whose records need a gradient stores the transmittance for B4
    to reread; a forward without grad never pays the store. ``bg`` gets no
    gradient (the reference CUDA rasterizer returns none either)."""

    @staticmethod
    def forward(ctx, records, starts, counts, bg, nx, ny, aligned):
        texcl = None
        if ctx.needs_input_grad[0] and aligned:
            out, texcl = pallas_composite_fwd(records, starts, counts, nx, ny, bg,
                                              store_t=True)
        else:
            out = pallas_composite_fwd(records, starts, counts, nx, ny, bg)
        ctx.save_for_backward(records, starts, counts, out, texcl)
        ctx.geometry = (nx, ny, aligned)
        return out

    @staticmethod
    def backward(ctx, dout):
        records, starts, counts, out, texcl = ctx.saved_tensors
        nx, ny, aligned = ctx.geometry
        dpairs = pallas_composite_bwd(records, starts, counts, nx, ny, out, dout,
                                      aligned=aligned, texcl=texcl)
        # no lane past the last segment's end carries a gradient
        lane = torch.arange(dpairs.shape[1], device=dpairs.device)
        dpairs = torch.where((lane < starts[-1])[None, :], dpairs,
                             torch.zeros((), device=dpairs.device))
        return dpairs, None, None, None, None, None, None


def _composite(records, starts, counts, bg, nx: int, ny: int, aligned: bool = False):
    """out [n_tiles, NPIX, 3] of B3, differentiable in ``records`` through B4.
    ``starts`` is [n_tiles + 1]: its last entry ends the last segment."""
    return _Composite.apply(records, starts, counts, bg, nx, ny, aligned)


class _GatherPairs(torch.autograd.Function):
    """records[gidx]^T: the one flat row gather that builds the sorted
    compact pair records [9, NC] from per-gaussian records [P, 9]. Sentinel
    lanes (index P) read the last row, which the compositor masks.

    The backward is a per-gaussian segment sum of the [9, NC] pair
    cotangents: one stable sort of the lanes by gaussian (sentinels past
    every segment), a float64 running sum, and the difference at the
    segment boundaries, which are the exact emitted counts of the binning
    (``ends_g`` inclusive ends, ``counts_g``). The running sum is
    deterministic and, in float64, leaves each segment's sum rounded once
    to float32; the JAX package takes the same difference of a float32
    running sum, which cancels. A step whose pairs were cut
    (``ends_g[-1] > NC``) gets zero gradients."""

    @staticmethod
    def forward(ctx, records, gidx, ends_g, counts_g):
        P = records.shape[0]
        ctx.save_for_backward(gidx, ends_g, counts_g)
        ctx.P = P
        return records[torch.clamp_max(gidx.to(torch.int64), P - 1)].T.contiguous()

    @staticmethod
    def backward(ctx, d):
        gidx, ends_g, counts_g = ctx.saved_tensors
        nc = d.shape[1]
        perm = torch.sort(gidx, stable=True).indices
        # plane-major: the running sum goes along the contiguous axis
        cum = torch.cumsum(d[:, perm].to(torch.float64), dim=1)  # [9, NC]
        cum0 = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)
        ends = ends_g.to(torch.int64)
        hi = cum0[:, torch.clamp_max(ends, nc)]
        lo = cum0[:, torch.clamp(ends - counts_g.to(torch.int64), 0, nc)]
        d_rec = (hi - lo).T.to(d.dtype)  # [P, 9]
        d_rec = torch.where(ends[-1] <= nc, d_rec, torch.zeros((), device=d.device))
        return d_rec, None, None, None


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
    """Depth order, depth-ordered per-gaussian records [P, 9] (which carry
    the gradient), binning on their detached values, the key sort cut to
    ``nc`` slots, segment and aligned starts."""
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
    rec_ng = records.detach()
    key, counts_g, gbits = _fused_pair_keys(
        rec_ng[:, 0:2], proj.radii[order].to(torch.float32), visible[order],
        nx, ny, TILE, t_max, overflow_k=overflow_k, t_max_big=t_max_big,
        mid_k=mid_k, t_max_mid=t_max_mid, conics=rec_ng[:, 2:5], opac=rec_ng[:, 8])
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


def _gather_records(lay: CompactLayout, gidx_al: torch.Tensor) -> torch.Tensor:
    """The layout's records gathered by ``gidx_al`` as the plane-major
    [16, NC] matrix (rows 9-15 zero), differentiable in ``lay.records``.
    Padding lanes carry the sentinel P, one past the last gaussian: JAX's
    gather clamps it to the last record row, and so does this one (an
    unclamped index P would be an out-of-bounds fault on the card). When
    the aligned demand overflows nc, trailing tiles were cut: the segment
    ends are then set past nc, which zeroes the step's gradients."""
    ends_g = torch.cumsum(lay.counts_g, 0).to(torch.int32)  # [P] inclusive
    ends_g = torch.where(lay.al_total <= lay.nc, ends_g,
                         torch.full_like(ends_g, lay.nc + 1))
    recs_c = _GatherPairs.apply(lay.records, gidx_al, ends_g, lay.counts_g)  # [9, NC]
    return torch.cat([recs_c, torch.zeros(COLS - RECORD, lay.nc, dtype=recs_c.dtype,
                                          device=recs_c.device)])


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
    """Tile-binned rasterization through B5, B3 and (backward) B4 -> [3, H, W].

    Differentiable in the projection's means, conics, colours and
    opacities; the binning sees detached values, and ``bg_color`` gets no
    gradient.

    ``nc_pairs``: compact pair budget (0 = min(DEFAULT_NC, slot count));
    when the aligned demand exceeds it, trailing tiles are cut and render
    wrong, and that step's gradients are zeroed, as in the JAX package.
    ``return_stats``: also return {nc_demand (aligned slots the scene
    wants), nc_real (post-cull emitted pairs that survived the cut),
    grad_dropped (1 when the aligned demand overflowed nc)} as 0-d int32
    tensors."""
    lay = _compact_layout(proj, width, height, t_max, overflow_k, t_max_big, mid_k,
                          t_max_mid, nc_pairs)
    gidx_al = _align_compact(lay.gidx_c, lay.starts, lay.starts_al, lay.n_tiles, lay.P)
    records_t = _gather_records(lay, gidx_al)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=records_t.device).detach()
    out = _composite(records_t, lay.starts_al, lay.counts_k, bg, lay.nx, lay.ny, True)
    img = _tiles_to_image(out, lay.nx, lay.ny, width, height)
    if return_stats:
        stats = {
            "nc_demand": lay.al_total.to(torch.int32),
            "nc_real": lay.starts[lay.n_tiles],
            "grad_dropped": (lay.al_total > lay.nc).to(torch.int32),
        }
        return img, stats
    return img
