"""Public differentiable render API (port of sixdgs_tpu/renderer).

Mirrors the reference renderer contract: the rendered image, the
screen-space gradient receptacle, the visibility filter and the
per-Gaussian radii.
"""

from __future__ import annotations

from typing import Optional

import torch

from sixdgs_torch.ops.rasterizer import rasterize_scan
from sixdgs_torch.ops.rasterizer.projection import project_scene


def render(
    viewpoint_camera,
    scene,
    bg_color,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    sh_degree: Optional[int] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    chunk: int = 256,
    rasterizer: str = "scan",
    **tile_kwargs,
):
    """Render a GaussianScene from a Camera, on the scene's device.

    Args:
        viewpoint_camera: scene.cameras.Camera (host struct with matrices).
        scene: GaussianScene.
        bg_color: [3] background.
        scaling_modifier: global scale multiplier.
        override_color: optional [C, 3] precomputed colours.
        sh_degree: active SH degree (defaults to scene.max_sh_degree).
        means2d_offset: optional [C, 2] zeros, the screen-space gradient
            receptacle (the reference's screenspace_points trick).
        chunk: compositing chunk size of the "scan" path.
        rasterizer: "scan" (the golden model), "tiled" (the tile rasterizer
            in plain PyTorch; ``tile_kwargs`` go to ``rasterize_tiled``) or
            "pallas" (the tile rasterizer on the CUDA kernels;
            ``tile_kwargs`` go to ``rasterize_pallas``).

    Returns:
        dict(render=[3, H, W], viewspace_points=means2d_offset or None,
             visibility_filter=[C] bool, radii=[C] int32)
    """
    proj = project_scene(scene, viewpoint_camera, scaling_modifier=scaling_modifier,
                         override_color=override_color, sh_degree=sh_degree,
                         means2d_offset=means2d_offset)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=scene.xyz.device)
    W, H = viewpoint_camera.width, viewpoint_camera.height
    if rasterizer == "tiled":
        from sixdgs_torch.ops.rasterizer.tiles import rasterize_tiled

        image = rasterize_tiled(proj, W, H, bg, **tile_kwargs)
    elif rasterizer == "pallas":
        from sixdgs_torch.ops.rasterizer.pallas_tiles import rasterize_pallas

        image = rasterize_pallas(proj, W, H, bg, **tile_kwargs)
    elif rasterizer == "scan":
        image = rasterize_scan(proj, W, H, bg, chunk=chunk)
    else:
        raise ValueError(f"rasterizer must be 'scan', 'tiled' or 'pallas', got {rasterizer!r}")
    return {
        "render": image,
        "viewspace_points": means2d_offset,
        "visibility_filter": proj.radii > 0,
        "radii": proj.radii,
    }
