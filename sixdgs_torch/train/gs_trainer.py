"""3DGS rendering of a scene through a camera (the render part of
sixdgs_tpu/train/gs_trainer.py).

``render_eval`` is the inference render the JAX package's eval loops and
``apps/render.py`` call per camera. The training loop, its optimizer,
densification and checkpoints come with the training slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sixdgs_torch.ops.rasterizer import rasterize_scan, resolve_rasterizer
from sixdgs_torch.ops.rasterizer.projection import project_gaussians
from sixdgs_torch.ops.transforms import covariance_planes


class CameraArrays(NamedTuple):
    """The render inputs of a Camera. The JAX package's also carries the
    ground-truth image; the training slice adds it with the train step (a
    render does not read it, and a 1232x816 one is 12 MB to copy)."""

    view: torch.Tensor  # [4, 4]
    full_proj: torch.Tensor  # [4, 4]
    camera_center: torch.Tensor  # [3]
    tan_fovx: torch.Tensor  # 0-d float32
    tan_fovy: torch.Tensor  # 0-d float32


def camera_arrays(cam, device="cuda") -> CameraArrays:
    """A host Camera's matrices as tensors on ``device``."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return CameraArrays(
        view=f32(cam.view),
        full_proj=f32(cam.full_proj),
        camera_center=f32(cam.camera_center),
        tan_fovx=f32(math.tan(cam.FoVx * 0.5)),
        tan_fovy=f32(math.tan(cam.FoVy * 0.5)),
    )


# (t_max, mid_k, t_max_mid, overflow_k, t_max_big): per-gaussian tile-slot
# budgets of the binning tiers
DEFAULT_TIERS = (16, 4096, 64, 256, 1024)


def _project_params(params, active, cam: CameraArrays, width, height, sh_degree):
    """The scene's parameters projected through ``cam`` (activations as the
    reference's GaussianModel getters)."""
    cov3d = covariance_planes(torch.exp(params["scaling"]), params["rotation"])
    opacity = torch.sigmoid(params["opacity"]) * active[:, None]
    sh = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
    return project_gaussians(params["xyz"], cov3d, opacity, cam.view, cam.full_proj,
                             cam.camera_center, width, height, cam.tan_fovx,
                             cam.tan_fovy, sh=sh, sh_degree=sh_degree, active=active)


def _render_params(params, active, cam: CameraArrays, width, height, sh_degree,
                   bg, chunk: int = 256, rasterizer: str = "auto",
                   tiers: tuple = DEFAULT_TIERS):
    """Project the scene's parameters through ``cam`` and rasterize:
    (img [3, H, W], proj). ``rasterizer``: "pallas" (the tile
    rasterizer on the CUDA kernels; "auto" resolves to it) or "scan" (the
    golden model)."""
    rasterizer = resolve_rasterizer(rasterizer)
    if rasterizer not in ("pallas", "scan"):
        raise ValueError(f"rasterizer must be 'auto', 'pallas' or 'scan', got {rasterizer!r}")
    t_max, mid_k, t_max_mid, overflow_k, t_max_big = tiers
    proj = _project_params(params, active, cam, width, height, sh_degree)
    if rasterizer == "pallas":
        from sixdgs_torch.ops.rasterizer.pallas_tiles import rasterize_pallas

        img = rasterize_pallas(proj, width, height, bg, t_max=t_max, mid_k=mid_k,
                               t_max_mid=t_max_mid, overflow_k=overflow_k,
                               t_max_big=t_max_big)
    else:
        img = rasterize_scan(proj, width, height, bg, chunk=chunk)
    return img, proj


@torch.no_grad()
def render_eval(scene, cam, bg, sh_degree: int, chunk: int = 256,
                rasterizer: str = "auto", tiers: tuple = DEFAULT_TIERS) -> torch.Tensor:
    """Inference render [3, H, W] of a host Camera, on the scene's device."""
    dev = scene.xyz.device
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    img, _ = _render_params(scene.params(), scene.active, camera_arrays(cam, dev),
                            cam.width, cam.height, sh_degree, bg, chunk, rasterizer,
                            tiers)
    return img
