"""EWA projection of 3D Gaussians to screen space.

Port of sixdgs_tpu/ops/rasterizer/projection.py: world->camera transform,
perspective EWA Jacobian with the 1.3*tan_fov frustum clamp, 2D covariance
with the 0.3-pixel low-pass, conic + radius, pixel-space means and
per-Gaussian SH color. The same plane-by-plane formulas (every intermediate
a flat [P] tensor, the matrix products expanded into scalar products) and
the same sanitising of culled entries, so the two packages round alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from sixdgs_torch.ops.sh import eval_sh_planes
from sixdgs_torch.ops.transforms import covariance_planes

# The CUDA rasterizer culls at view-space depth 0.2 (forward.cu in_frustum).
NEAR_CULL = 0.2
LOW_PASS = 0.3


class ProjectedGaussians(NamedTuple):
    means2d: torch.Tensor  # [P, 2] pixel coords
    depths: torch.Tensor  # [P] view-space z
    conics: torch.Tensor  # [P, 3] inverse 2D covariance (xx, xy, yy)
    radii: torch.Tensor  # [P] int32 screen radius (0 = culled)
    colors: torch.Tensor  # [P, 3]
    opacities: torch.Tensor  # [P]


def project_gaussians(
    means3d: torch.Tensor,
    cov3d,
    opacities: torch.Tensor,
    view: torch.Tensor,
    full_proj: torch.Tensor,
    camera_center: torch.Tensor,
    width: int,
    height: int,
    tan_fovx,
    tan_fovy,
    sh: Optional[torch.Tensor] = None,
    sh_degree: int = 0,
    colors_precomp: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> ProjectedGaussians:
    """Project Gaussians to screen space.

    Args:
        means3d: [P, 3] world-space centers.
        cov3d: [P, 3, 3] world-space covariance, [P, 6] packed upper
            triangle, or the six planes of ``covariance_planes``.
        opacities: [P] or [P, 1] activated opacity.
        view: [4, 4] world->camera.
        full_proj: [4, 4] proj @ view.
        camera_center: [3] world-space camera position.
        width/height: image size.
        tan_fovx/tan_fovy: tangents of half FoV (floats or 0-d tensors).
        sh: [P, n_coeffs, 3] SH coefficients (used if colors_precomp is None).
        sh_degree: active SH degree.
        colors_precomp: [P, 3] precomputed colors (overrides SH).
        active: [P] bool validity mask of padded scenes.

    Returns:
        ProjectedGaussians with radii == 0 for culled entries.
    """
    P = means3d.shape[0]
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)

    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    if isinstance(cov3d, (tuple, list)):
        cxx, cxy, cxz, cyy, cyz, czz = cov3d
    elif cov3d.ndim == means3d.ndim and cov3d.shape[-1] == 6:
        cxx, cxy, cxz, cyy, cyz, czz = (cov3d[..., i] for i in range(6))
    else:
        if tuple(cov3d.shape[-2:]) != (3, 3):
            raise ValueError(
                f"cov3d must be a 6-plane tuple, [P, 6] packed, or "
                f"[P, 3, 3]; got shape {tuple(cov3d.shape)}")
        cxx, cxy, cxz = cov3d[..., 0, 0], cov3d[..., 0, 1], cov3d[..., 0, 2]
        cyy, cyz, czz = cov3d[..., 1, 1], cov3d[..., 1, 2], cov3d[..., 2, 2]

    def _rowdot(M, k):
        # [P] plane of (means3d_hom @ M.T)[:, k]
        return mx * M[k, 0] + my * M[k, 1] + mz * M[k, 2] + M[k, 3]

    tx = _rowdot(view, 0)
    ty = _rowdot(view, 1)
    tz = _rowdot(view, 2)
    in_front = tz > NEAR_CULL

    # frustum-clamped view coords feeding the Jacobian
    safe_tz = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    txz = torch.clamp(tx / safe_tz, -limx, limx) * safe_tz
    tyz = torch.clamp(ty / safe_tz, -limy, limy) * safe_tz
    z2 = torch.square(safe_tz)

    # EWA Jacobian rows J0 = (fx/tz, 0, -fx*txz/z2), J1 = (0, fy/tz,
    # -fy*tyz/z2); T = J @ W expanded against the scalar entries of W
    W = view[:3, :3]
    j00 = focal_x / safe_tz
    j02 = -(focal_x * txz) / z2
    j11 = focal_y / safe_tz
    j12 = -(focal_y * tyz) / z2
    T00 = j00 * W[0, 0] + j02 * W[2, 0]
    T01 = j00 * W[0, 1] + j02 * W[2, 1]
    T02 = j00 * W[0, 2] + j02 * W[2, 2]
    T10 = j11 * W[1, 0] + j12 * W[2, 0]
    T11 = j11 * W[1, 1] + j12 * W[2, 1]
    T12 = j11 * W[1, 2] + j12 * W[2, 2]

    # cov2d = T Sigma T^T + LOW_PASS*I, expanded over the 6 Sigma planes
    a = (T00 * (T00 * cxx + T01 * cxy + T02 * cxz)
         + T01 * (T00 * cxy + T01 * cyy + T02 * cyz)
         + T02 * (T00 * cxz + T01 * cyz + T02 * czz)) + LOW_PASS
    b = (T10 * (T00 * cxx + T01 * cxy + T02 * cxz)
         + T11 * (T00 * cxy + T01 * cyy + T02 * cyz)
         + T12 * (T00 * cxz + T01 * cyz + T02 * czz))
    c = (T10 * (T10 * cxx + T11 * cxy + T12 * cxz)
         + T11 * (T10 * cxy + T11 * cyy + T12 * cyz)
         + T12 * (T10 * cxz + T11 * cyz + T12 * czz)) + LOW_PASS

    det = a * c - b * b
    det_valid = det > 0.0
    safe_det = torch.where(det_valid, det, torch.ones_like(det))
    inv_det = 1.0 / safe_det
    con_a, con_b, con_c = c * inv_det, -b * inv_det, a * inv_det

    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))

    # pixel centers: ndc -> ((ndc + 1) * size - 1) / 2 (CUDA ndc2Pix)
    p0 = _rowdot(full_proj, 0)
    p1 = _rowdot(full_proj, 1)
    p3 = _rowdot(full_proj, 3)
    p_w = 1.0 / (p3 + 1e-7)
    m2x = ((p0 * p_w + 1.0) * width - 1.0) * 0.5
    m2y = ((p1 * p_w + 1.0) * height - 1.0) * 0.5

    # visibility: in frustum, positive-definite cov, overlapping the screen
    on_screen = ((m2x + radius > 0) & (m2x - radius < width)
                 & (m2y + radius > 0) & (m2y - radius < height))
    visible = in_front & det_valid & on_screen
    if active is not None:
        visible = visible & active
    radii = torch.where(visible, radius, torch.zeros_like(radius)).to(torch.int32)

    if colors_precomp is not None:
        colors = colors_precomp
    else:
        if sh is None:
            raise ValueError("project_gaussians needs sh or colors_precomp")
        dirs = means3d - camera_center[None]
        dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-12)
        colors = torch.clamp_min(eval_sh_planes(sh_degree, sh, dirs) + 0.5, 0.0)

    opac = opacities.reshape(P)

    # sanitize culled entries: degenerate projections (behind camera, singular
    # cov, diverged params) can carry NaN/Inf means/conics; zero opacity alone
    # does not stop NaN propagation through alpha = opac * exp(power)
    def _safe(plane, fill):
        fill = torch.full_like(plane, fill)
        plane = torch.where(visible, plane, fill)
        return torch.where(torch.isfinite(plane), plane, fill)

    safe2d = torch.stack([_safe(m2x, 0.0), _safe(m2y, 0.0)], dim=-1)
    safe_con = torch.stack([_safe(con_a, 1.0), _safe(con_b, 0.0), _safe(con_c, 1.0)],
                           dim=-1)
    safe_col = torch.where(torch.isfinite(colors), colors, torch.zeros_like(colors))
    safe_opac = torch.where(visible & torch.isfinite(opac), opac, torch.zeros_like(opac))
    return ProjectedGaussians(means2d=safe2d, depths=tz, conics=safe_con, radii=radii,
                              colors=safe_col, opacities=safe_opac)


def project_scene(scene, camera, scaling_modifier: float = 1.0,
                  override_color: Optional[torch.Tensor] = None,
                  sh_degree: Optional[int] = None,
                  means2d_offset: Optional[torch.Tensor] = None) -> ProjectedGaussians:
    """Project a GaussianScene through a Camera (numpy matrices, moved to
    the scene's device).

    ``means2d_offset`` [C, 2] is added to the projected means: a zero one is
    the gradient receptacle of the reference's screenspace_points trick, so
    its gradient is the screen-space position gradient."""
    dev = scene.xyz.device
    deg = scene.max_sh_degree if sh_degree is None else sh_degree
    cov3d = covariance_planes(scene.get_scaling, scene.rotation, scaling_modifier)
    proj = project_gaussians(
        scene.xyz,
        cov3d,
        scene.get_opacity,
        torch.as_tensor(camera.view, device=dev),
        torch.as_tensor(camera.full_proj, device=dev),
        torch.as_tensor(camera.camera_center, device=dev),
        camera.width,
        camera.height,
        math.tan(camera.FoVx * 0.5),
        math.tan(camera.FoVy * 0.5),
        sh=None if override_color is not None else scene.get_features,
        sh_degree=deg,
        colors_precomp=override_color,
        active=scene.active,
    )
    if means2d_offset is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_offset)
    return proj
