"""3DGS rasterizer (port of sixdgs_tpu/ops/rasterizer).

  * projection.py — EWA projection of 3D Gaussians to screen space
    (means2D, conic, radii, depth, SH color).
  * compositing.py — exact depth-sorted front-to-back compositing over the
    whole image (the golden model).
  * tiles.py / pallas_tiles.py — tile binning and the tile rasterizer on
    the hand-written CUDA kernels B5 (aligned-layout gather), B3 (tile
    compositor) and B4 (its backward).
"""

from sixdgs_torch.ops.rasterizer.compositing import rasterize_scan
from sixdgs_torch.ops.rasterizer.projection import ProjectedGaussians, project_gaussians


def resolve_rasterizer(name: str = "auto") -> str:
    """'auto' -> "pallas": the tile rasterizer, whose wrappers launch the CUDA
    kernels on CUDA tensors and run their plain versions on CPU tensors.
    (The JAX package resolves 'auto' to its XLA tiled path off the TPU.)"""
    return "pallas" if name == "auto" else name


__all__ = ["project_gaussians", "ProjectedGaussians", "rasterize_scan",
           "resolve_rasterizer"]
