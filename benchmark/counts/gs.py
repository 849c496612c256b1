"""Work, operations and bytes of a 3DGS training step, counted from the
scene and the camera by the benchmark's own arithmetic.

Per camera (``camera_work``): the reference's projection and binning at
the program's tiers; the pairs the program keeps after its conic cull (a
pair whose tile lies wholly where opacity exp(-Q) < 1/255, Q the conic's
quadratic, copied from the port's ``tiles._tile_min_quadratic`` with its
1e-4 margin); the evaluations of those pairs up to and with each pixel's
stop and the contributing pairs, from the reference compositor's walk.

Per call (``b3_bound_s``, ``b4_bound_s``, ``b5_bound_s``): as the port's
``chip_smoke.py`` reckons them (``b3_bound``, ``b4_bound``, ``b5_bound``),
the larger of the operations the inputs need at the float32 peak (14 an
evaluation and 14 a contribution forward; 14 and 50 backward) and the
bytes read and written once at HBM's rate: records (9 floats a real pair),
starts and counts, the image (and, with the transmittance store, one float
an evaluation written by B3 and read by B4; B4 writes [16, nc] pair
gradients); B5 reads the real indices and both start arrays and writes nc.

A step's counted flops (``step_flops``): projection, covariance and SH-3
colour of every Gaussian (forward and twice that backward), the
compositor's operations as above, the loss over the image, and Adam's per
parameter.
"""

from __future__ import annotations

import math

import torch

from benchmark.counts.flops import HBM_BYTES
from benchmark.reference import gaussians as ref

F32_FLOPS = 67e12
B3_OPS_PER_EVAL, B3_OPS_PER_CONTRIB = 14, 14
B4_OPS_PER_EVAL, B4_OPS_PER_CONTRIB = 14, 50
KB = 128  # the port's aligned chunk: nc is a multiple of 8 KB
DEFAULT_NC = 1 << 20
# per Gaussian, forward: 3D covariance from quaternion and scale (~60), view
# transform, Jacobian and 2D covariance (~70), conic, radius and pixel mean
# (~30), SH degree 3 (16 basis terms ~40, 3 x 16 multiply-adds 96)
GAUSSIAN_FWD = 296
ADAM_PER_PARAM = 12  # two moments (5), bias corrections, sqrt, divide, step
LOSS_PER_VALUE = 250  # L1, and SSIM's five 11 x 11 separable blurs and its map
FLOATS_PER_GAUSSIAN = 59  # xyz 3, SH 48, opacity 1, scale 3, rotation 4


def _survive(rec, tile, rank, nx):
    """The port's conic cull: the pair survives unless the quadratic's
    least value over its tile's pixel box exceeds log(opacity * 255)."""
    g = rec[rank]
    mx, my, a, b, c, op = g[:, 0], g[:, 1], g[:, 2], g[:, 3], g[:, 4], g[:, 8]
    ax = (tile % nx).to(torch.float32) * ref.TILE - mx
    bx = ax + (ref.TILE - 1)
    ay = (tile // nx).to(torch.float32) * ref.TILE - my
    by = ay + (ref.TILE - 1)

    def q(dx, dy):
        return 0.5 * a * dx * dx + b * dx * dy + 0.5 * c * dy * dy

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    def edge_x(dx):
        return q(dx, clip(-b * dx / torch.clamp_min(c, 1e-12), ay, by))

    def edge_y(dy):
        return q(clip(-b * dy / torch.clamp_min(a, 1e-12), ax, bx), dy)

    inside = (ax <= 0.0) & (0.0 <= bx) & (ay <= 0.0) & (0.0 <= by)
    qmin = torch.where(inside, torch.zeros_like(ax),
                       torch.minimum(torch.minimum(edge_x(ax), edge_x(bx)),
                                     torch.minimum(edge_y(ay), edge_y(by))))
    return qmin <= torch.log(torch.clamp_min(op, 1e-12) / ref.ALPHA_MIN) + 1e-4


def camera_work(params, cam, width, height, sh_degree, tiers):
    """{"real", "evals", "contribs", "visible", "demand"} of one camera:
    ``demand`` the aligned slots the kept pairs take (each tile's count
    rounded up to KB)."""
    with torch.no_grad():
        rec, radius, _ = ref.project(params, cam, width, height, sh_degree)
        tile, rank, starts = ref.pairs(rec, radius, width, height, tiers)
        nx = -(-width // ref.TILE)
        kept = _survive(rec, tile, rank, nx)
        _, (real, evals, contribs) = ref.walk(rec, rank, starts, nx, counted=kept)
        per_tile = torch.bincount(tile[kept], minlength=starts.shape[0] - 1)
        demand = int((-(-per_tile // KB) * KB).sum())
    return {"real": real, "evals": evals, "contribs": contribs, "visible": int(rec.shape[0]),
            "demand": demand}


def nc_budget(nc_pairs, gaussians, tiers):
    """The compact pair budget the port's rasterizer takes for ``nc_pairs``
    (0: its default): a multiple of 8 KB, at most the key slots."""
    t_max, mid_k, t_max_mid, overflow_k, t_max_big = tiers
    overflow_k = min(overflow_k, gaussians)
    mid_k = min(mid_k, max(gaussians - overflow_k, 0))
    slots = gaussians * t_max + mid_k * t_max_mid + overflow_k * t_max_big
    ncb = 8 * KB
    return min(-(-(nc_pairs or DEFAULT_NC) // ncb) * ncb, -(-slots // ncb) * ncb)


def b3_bound_s(w, n_tiles):
    ops = B3_OPS_PER_EVAL * w["evals"] + B3_OPS_PER_CONTRIB * w["contribs"]
    nbytes = 4 * (9 * w["real"] + 2 * n_tiles + 3 + n_tiles * ref.NPIX * 3 + w["evals"])
    return max(ops / F32_FLOPS, nbytes / HBM_BYTES)


def b4_bound_s(w, n_tiles, nc):
    ops = B4_OPS_PER_EVAL * w["evals"] + B4_OPS_PER_CONTRIB * w["contribs"]
    nbytes = 4 * (9 * w["real"] + 2 * n_tiles + 2 * n_tiles * ref.NPIX * 3 + 16 * nc
                  + w["evals"])
    return max(ops / F32_FLOPS, nbytes / HBM_BYTES)


def b5_bound_s(w, n_tiles, nc):
    return 4 * (w["real"] + 2 * (n_tiles + 1) + nc) / HBM_BYTES


def step_flops(w, gaussians, width, height):
    compositor = ((B3_OPS_PER_EVAL + B4_OPS_PER_EVAL) * w["evals"]
                  + (B3_OPS_PER_CONTRIB + B4_OPS_PER_CONTRIB) * w["contribs"])
    return (3 * GAUSSIAN_FWD * gaussians + compositor
            + 3 * LOSS_PER_VALUE * 3 * width * height
            + ADAM_PER_PARAM * FLOATS_PER_GAUSSIAN * gaussians)


def step_bounds(steps, gaussians, width, height):
    """Means over ``steps`` [(camera work, tiers, nc_pairs)] of each
    kernel's bound per call (seconds) and of a step's flops."""
    n_tiles = -(-width // ref.TILE) * -(-height // ref.TILE)
    rows = []
    for w, tiers, nc_pairs in steps:
        nc = nc_budget(nc_pairs, gaussians, tiers)
        rows.append({"b3_bound_s": b3_bound_s(w, n_tiles), "b4_bound_s": b4_bound_s(w, n_tiles, nc),
                     "b5_bound_s": b5_bound_s(w, n_tiles, nc),
                     "step_flops": step_flops(w, gaussians, width, height),
                     "real": w["real"], "evals": w["evals"], "contribs": w["contribs"],
                     "demand": w["demand"], "nc": nc})
    return {k: math.fsum(r[k] for r in rows) / len(rows) for k in rows[0]}
