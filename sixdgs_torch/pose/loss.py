"""Distance-based ray score loss.

Port of sixdgs_tpu/pose/loss.py (reference
pose_estimation/distance_based_loss.py):
  * target score per ray = 1 - tanh(d_perp), d_perp = distance from the GT
    camera center to the ray, with the closest point clamped to the origin
    when the camera is behind it (:22-37),
  * zeroed for rays behind the camera image plane (:39-58),
  * scaled so the target sums to the number of masked image patches
    (:221-230),
  * loss = MSE(pred, target) over valid rays (:275-283).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TargetScores(NamedTuple):
    target: torch.Tensor  # [N] scaled target (combined_score)
    target_raw: torch.Tensor  # [N] unscaled 1 - tanh(d_perp) with sign mask
    target_with_distance: torch.Tensor  # [N] auxiliary (x point-distance score)


def target_ray_scores(
    c2w: torch.Tensor,
    rays_ori: torch.Tensor,
    rays_dir: torch.Tensor,
    rays_valid: torch.Tensor,
    n_patches: torch.Tensor,
    tanh_denominator: float = 1.0,
) -> TargetScores:
    """Construct the regression target (best_one_to_one_rays_selector, :5-144).

    One camera (c2w [4, 4], n_patches a scalar) gives [N] targets; a batch
    (c2w [B, 4, 4], n_patches [B]) gives [B, N], a row per camera against
    the same rays."""
    gt_pos = c2w[..., None, :3, 3]  # [..., 1, 3]
    to_cam = gt_pos - rays_ori  # [..., N, 3]
    proj_len = torch.sum(to_cam * rays_dir, dim=-1, keepdim=True)
    closest = torch.where(proj_len < 0, rays_ori, rays_ori + proj_len * rays_dir)
    dist = torch.linalg.norm(closest - gt_pos, dim=-1)
    target = 1.0 - torch.tanh(dist / tanh_denominator)

    cam_z = c2w[..., None, :3, 2]
    cam_proj = torch.sum((rays_ori - gt_pos) * cam_z, dim=-1)
    # (sign + 1) / 2: 1 in front, 0 behind; exact zeros guarded to 0
    sign = torch.where(cam_proj == 0, 0.0, (torch.sign(cam_proj) + 1.0) * 0.5)
    target = target * sign
    target = torch.where(rays_valid, target, 0.0)

    point_dist = torch.linalg.norm(to_cam, dim=-1)
    point_score = 1.0 - torch.tanh(point_dist / tanh_denominator)
    target_with_distance = target * point_score

    # (:225-230)
    scale = n_patches.to(target.dtype)[..., None] / torch.sum(target, dim=-1, keepdim=True)
    return TargetScores(
        target=target * scale,
        target_raw=target,
        target_with_distance=target_with_distance,
    )


def distance_score_loss(
    pred_scores: torch.Tensor,
    c2w: torch.Tensor,
    rays_ori: torch.Tensor,
    rays_dir: torch.Tensor,
    rays_valid: torch.Tensor,
    n_patches: torch.Tensor,
):
    """MSE against the scaled target over valid rays.

    Returns (loss, target) like DistanceBasedScoreLoss.forward (:169-283);
    over a batch (pred_scores [B, N], c2w and n_patches as in
    ``target_ray_scores``), loss [B] and target [B, N].
    """
    tgt = target_ray_scores(c2w, rays_ori, rays_dir, rays_valid, n_patches)
    target = torch.where(rays_valid, tgt.target, 0.0)
    diff = torch.square(pred_scores - target)
    n_valid = torch.clamp_min(torch.sum(rays_valid.to(diff.dtype)), 1.0)
    loss = torch.sum(torch.where(rays_valid, diff, 0.0), dim=-1) / n_valid
    return loss, target


def cam_up_loss(model_up: torch.Tensor, cam_up: torch.Tensor) -> torch.Tensor:
    """-0.5 cos_sim + 0.5 (pose_estimation/train.py:168-171); a batch of
    cam_up [B, 3] gives [B]."""
    mu = model_up / torch.clamp_min(torch.linalg.norm(model_up), 1e-12)
    cu = cam_up / torch.clamp_min(torch.linalg.norm(cam_up, dim=-1, keepdim=True), 1e-12)
    return -0.5 * torch.sum(mu * cu, dim=-1) + 0.5
