"""Depth-sorted front-to-back alpha compositing (exact; the golden model).

Port of sixdgs_tpu/ops/rasterizer/compositing.py. Semantics of the CUDA
renderCUDA loop (diff-gaussian-rasterization, reconstructed from the call
site gaussian_renderer/__init__.py:85-100):

  per pixel, over Gaussians sorted by view depth:
    power = -0.5 (A dx^2 + C dy^2) - B dx dy            (conic = [A, B, C])
    skip if power > 0
    alpha = min(0.99, opacity * exp(power)); skip if alpha < 1/255
    test_T = T * (1 - alpha); if test_T < 1e-4: stop (this Gaussian does NOT
    contribute — matches CUDA's `done` check ordering)
    C += color * alpha * T;  T = test_T
  out = C + T * bg

Every Gaussian is evaluated on every pixel, ``chunk`` of them at a time:
within a chunk the sequential dependence is a cumulative product along the
chunk axis and the early stop a cumulative-sum latch, carried across
chunks. Peak memory is a few [chunk, H, W] tensors. The tests and
``chip_smoke.py`` hold the tile rasterizer against it.
"""

from __future__ import annotations

import torch

from sixdgs_torch.ops.rasterizer.projection import ProjectedGaussians

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def _chunk_alphas(means2d, conics, opac, px, py):
    """Per-pixel alpha of a chunk of Gaussians: [K, H, W]."""
    dx = px[None] - means2d[:, 0][:, None, None]  # [K, H, W]
    dy = py[None] - means2d[:, 1][:, None, None]
    A = conics[:, 0][:, None, None]
    B = conics[:, 1][:, None, None]
    C = conics[:, 2][:, None, None]
    power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
    alpha = torch.clamp_max(opac[:, None, None] * torch.exp(power), ALPHA_MAX)
    alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN), torch.zeros_like(alpha), alpha)
    return alpha


def rasterize_scan(proj: ProjectedGaussians, width: int, height: int,
                   bg_color: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Rasterize projected Gaussians to an image [3, H, W].

    Gaussians are depth-sorted internally (stable, as jnp.argsort);
    culled entries (radii == 0 or opacity 0) are no-ops. ``chunk`` bounds
    peak memory at [chunk, H, W].
    """
    dev = proj.means2d.device
    dtype = proj.means2d.dtype
    P = proj.means2d.shape[0]
    visible = proj.radii > 0
    order = torch.argsort(torch.where(visible, proj.depths,
                                      torch.full_like(proj.depths, float("inf"))),
                          stable=True)
    means2d = proj.means2d[order]
    conics = proj.conics[order]
    colors = proj.colors[order]
    opac = torch.where(visible[order], proj.opacities[order],
                       torch.zeros_like(proj.opacities))

    px = torch.arange(width, dtype=dtype, device=dev)[None, :].expand(height, width)
    py = torch.arange(height, dtype=dtype, device=dev)[:, None].expand(height, width)
    bg = torch.as_tensor(bg_color, dtype=dtype, device=dev)

    T = torch.ones((height, width), dtype=dtype, device=dev)
    C = torch.zeros((3, height, width), dtype=dtype, device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)
    for k0 in range(0, P, chunk):
        sl = slice(k0, min(k0 + chunk, P))
        alpha = _chunk_alphas(means2d[sl], conics[sl], opac[sl], px, py)
        one_minus = 1.0 - alpha
        # transmittance BEFORE each gaussian in this chunk
        cum = torch.cumprod(one_minus, dim=0)
        T_before = T[None] * torch.cat([torch.ones_like(cum[:1]), cum[:-1]], dim=0)
        # early stop: gaussian k is dead once any earlier (or this) one drove
        # test_T below T_EPS; the latch carries across chunks
        test_T = T_before * one_minus
        dead = (torch.cumsum((test_T < T_EPS).to(torch.int32), dim=0) > 0) | done[None]
        w = torch.where(dead, torch.zeros_like(alpha), alpha * T_before)  # [K, H, W]
        C = C + torch.einsum("kc,khw->chw", colors[sl], w)
        # transmittance only advances through live gaussians
        T = T * torch.prod(torch.where(dead, torch.ones_like(one_minus), one_minus), dim=0)
        done = dead[-1]
    return C + T[None] * bg[:, None, None]


def rasterize_brute(proj: ProjectedGaussians, width: int, height: int,
                    bg_color: torch.Tensor) -> torch.Tensor:
    """Tiny-scene reference: single-chunk (exact) compositing, O(P*H*W) memory."""
    return rasterize_scan(proj, width, height, bg_color, chunk=proj.means2d.shape[0])
