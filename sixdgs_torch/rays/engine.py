"""Ray generation from Gaussian ellipsoid surfaces (fixed ray budget).

Port of sixdgs_tpu/rays/engine.py (reference pose_estimation/sampling.py:
127-267, quadricell.py:322-386):
  1. drop degraded ellipsoids (ring count >= target),
  2. pick <= max_ellipsoids random valid ellipsoids,
  3. estimate normals from the selected centers (k-NN PCA),
  4. quadricell surface points, rotated into world by the Gaussian rotation,
  5. hemisphere mask: keep points with normal . (R p) > 0,
  6. ray direction = normalize(R p) (radial), origin = R p + center,
  7. per-ray RGB: SH at viewdir = -ray_dir with the parent's coefficients.

Random draws are inputs: the ellipsoid pick and the slot compaction each
sort a vector of uniform priorities, which the caller may pass in (the
parity tests pass the JAX package's draws) and which are otherwise drawn
from ``generator``. Both sorts are stable, so the invalid entries, which
all tie at exactly 1e9 in f32, keep their index order as jnp.argsort does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sixdgs_torch.ops.sh import sh_to_color
from sixdgs_torch.rays.normals import estimate_normals
from sixdgs_torch.rays.quadricell import mask_degraded_ellipsoids, quadricell_points
from sixdgs_torch.utils.profiling import span


class Rays(NamedTuple):
    ori: torch.Tensor  # [N, 3]
    dir: torch.Tensor  # [N, 3]
    rgb: torch.Tensor  # [N, 3]
    valid: torch.Tensor  # [N] bool
    gaussian_idx: torch.Tensor  # [N] int32 parent Gaussian (scene index)


def _uniform(n: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    return torch.rand(n, generator=generator, device=device, dtype=torch.float32)


def generate_rays(
    xyz: torch.Tensor,
    scaling: torch.Tensor,
    rotation_mat: torch.Tensor,
    features: torch.Tensor,
    active: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    sh_degree: int,
    target_points: int = 50,
    max_ellipsoids: int = 1000,
    ray_budget: int = 32768,
    k_neighbors: int = 20,
    r_max: int = 50,
    p_max: int = 32,
    select_priority: Optional[torch.Tensor] = None,
    slot_priority: Optional[torch.Tensor] = None,
) -> Rays:
    """Generate rays from a (padded) Gaussian scene.

    Args:
        xyz: [C, 3]; scaling: [C, 3] activated scales; rotation_mat: [C, 3, 3];
        features: [C, n_coeffs, 3] SH; active: [C] bool.
        generator: draws the priorities that are not given (on xyz's device).
        select_priority: [C] uniform draws for the ellipsoid pick.
        slot_priority: [E * r_max * p_max] uniform draws for the compaction,
            E = min(C, max_ellipsoids).
    """
    C = xyz.shape[0]
    dev = xyz.device
    valid = active & mask_degraded_ellipsoids(
        scaling[:, 0], scaling[:, 1], scaling[:, 2], target_points
    )
    # random subset of <= max_ellipsoids valid ellipsoids (sampling.py:145-149)
    if select_priority is None:
        select_priority = _uniform(C, generator, dev)
    priority = select_priority + (~valid).to(torch.float32) * 1e9
    sel = torch.argsort(priority, stable=True)[:max_ellipsoids]  # [E]
    e_valid = valid[sel]
    centers = xyz[sel]
    scales = scaling[sel]
    rots = rotation_mat[sel]

    normals = estimate_normals(centers, k_neighbors, valid=e_valid)

    grid = quadricell_points(
        scales[:, 0], scales[:, 1], scales[:, 2],
        target_points=target_points, r_max=r_max, p_max=p_max,
    )
    E = sel.shape[0]
    pts = grid.points.reshape(E, -1, 3)  # [E, S, 3] local
    slot_valid = grid.valid.reshape(E, -1) & e_valid[:, None]

    world_pts = torch.einsum("eij,esj->esi", rots, pts)  # rotated, not translated
    hemi = torch.einsum("ei,esi->es", normals, world_pts) > 0  # quadricell.py:332-341
    slot_valid = slot_valid & hemi

    dirs = world_pts / torch.clamp_min(
        torch.linalg.norm(world_pts, dim=-1, keepdim=True), 1e-12
    )
    oris = world_pts + centers[:, None, :]

    # compact to the static ray budget: random subset when over budget
    flat_valid = slot_valid.reshape(-1)
    n_slots = flat_valid.shape[0]
    if slot_priority is None:
        slot_priority = _uniform(n_slots, generator, dev)
    pri = slot_priority + (~flat_valid).to(torch.float32) * 1e9
    order = torch.argsort(pri, stable=True)[:ray_budget]
    out_valid = flat_valid[order]

    e_idx = order // pts.shape[1]  # which selected ellipsoid
    ray_ori = oris.reshape(-1, 3)[order]
    ray_dir = dirs.reshape(-1, 3)[order]
    gaussian_idx = sel[e_idx]

    # per-ray color: SH of the parent gaussian at viewdir = -dir
    sh = features[gaussian_idx]  # [N, n_coeffs, 3]
    rgb = sh_to_color(sh_degree, sh.transpose(-1, -2), -ray_dir)

    keep = out_valid[:, None]
    return Rays(
        ori=torch.where(keep, ray_ori, 0.0),
        dir=torch.where(keep, ray_dir, 0.0),
        rgb=torch.where(keep, rgb, 0.0),
        valid=out_valid,
        gaussian_idx=torch.where(out_valid, gaussian_idx, -1).to(torch.int32),
    )


@span("rays.cast")
def generate_rays_from_scene(scene, generator=None, cfg=None, sh_degree=None,
                             **overrides):
    """Rays over a GaussianScene (pose_estimation explore_model,
    pretrain_eval_attention.py:163-169)."""
    from sixdgs_torch.utils.config import PoseEstimationConfig

    cfg = cfg or PoseEstimationConfig()
    kwargs = dict(
        sh_degree=scene.max_sh_degree if sh_degree is None else sh_degree,
        target_points=cfg.quadricell_targets,
        max_ellipsoids=cfg.max_ellipsoids,
        ray_budget=cfg.ray_budget,
        k_neighbors=cfg.knn_normals,
    )
    kwargs.update(overrides)
    return generate_rays(
        scene.xyz,
        scene.get_scaling,
        scene.get_rotation_mat(),
        scene.get_features,
        scene.active,
        generator,
        **kwargs,
    )
