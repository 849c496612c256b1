"""Pose solver: top-k rays -> dedup -> LS intersection -> rotation assembly.

Port of sixdgs_tpu/pose/solver.py (reference pose_estimation/test.py:85-218),
with the behavioral quirks that shape the reported metrics:
  * the duplicate-origin filter replicates torch.isin(...).any(dim=1)'s
    COORDINATE-level membership semantics, not a strict row-unique test
    (:157-162),
  * the LS solve is UNWEIGHTED even though weights are computed (:169-179),
    and is re-run unchanged after the negative-ray exclusion,
  * singular rotation (det < 1e-7) -> identity (:194-196),
  * any NaN in the pose -> identity 4x4 (:216-218).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sixdgs_torch.ops.lines import exclude_negatives, line_intersection_wls, make_rotation_mat
from sixdgs_torch.utils.profiling import span


class PoseSolution(NamedTuple):
    c2w: torch.Tensor  # [4, 4]
    center: torch.Tensor  # [3]
    watch_dir: torch.Tensor  # [3]
    topk_idx: torch.Tensor  # [k]
    topk_weights: torch.Tensor  # [k] (post-dedup, pre-normalization values)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


@span("pose.solve")
def solve_pose(
    scores: torch.Tensor,
    rays_ori: torch.Tensor,
    rays_dir: torch.Tensor,
    cam_up: torch.Tensor,
    rays_valid: torch.Tensor,
    k: int = 100,
) -> PoseSolution:
    """Assemble a c2w pose from per-ray scores.

    Args:
        scores: [N] per-ray scores.
        rays_ori/rays_dir: [N, 3].
        cam_up: [3] predicted camera up (unit).
        rays_valid: [N] bool.
        k: top-k rays to use (reference: 100, test.py:91).
    """
    masked_scores = torch.where(rays_valid, scores, float("-inf"))
    weights, idx = torch.topk(masked_scores, k)
    ori = rays_ori[idx]
    dirs = rays_dir[idx]

    # duplicate-origin filter with the reference's exact (loose) semantics
    # (test.py:157-162): a coordinate is marked iff it has an equal at a
    # LATER flattened position of the query, or an equal anywhere in the
    # pool of rows that occur once; a ray survives if any of its 3 origin
    # coordinates is marked.
    finite = torch.isfinite(weights)
    same = torch.all(torch.abs(ori[:, None, :] - ori[None, :, :]) == 0.0, dim=-1)
    counts = torch.sum(same & finite[None, :], dim=-1)
    single = (counts == 1) & finite
    flat = ori.reshape(-1)  # [k*3] query coords, flattened row-major
    pos = torch.arange(flat.shape[0], device=flat.device)
    eq = (flat[:, None] == flat[None, :]) & torch.repeat_interleave(finite, 3)[None, :]
    later_dup = torch.any(eq & (pos[None, :] > pos[:, None]), dim=1)
    in_pool = torch.any(eq & torch.repeat_interleave(single, 3)[None, :], dim=1)
    keep = torch.any((later_dup | in_pool).reshape(-1, 3), dim=1) & finite

    w = torch.where(keep, weights, 0.0)
    w = w / torch.sum(w)
    center = line_intersection_wls(ori, dirs, mask=keep)  # unweighted (quirk)
    w = w * exclude_negatives(center, ori, dirs)
    w = w / torch.sum(w)
    center = line_intersection_wls(ori, dirs, mask=keep)  # re-solve, unchanged

    watch_dir = torch.sum(dirs * w[:, None], dim=0)
    watch_dir = watch_dir / torch.linalg.norm(watch_dir)

    R_w2c = make_rotation_mat(-watch_dir, cam_up)
    det = torch.dot(R_w2c[0], _cross(R_w2c[1], R_w2c[2]))
    eye3 = torch.eye(3, dtype=R_w2c.dtype, device=R_w2c.device)
    R_w2c = torch.where(det < 1e-7, eye3, R_w2c)
    # rows orthonormal by construction -> inverse == transpose
    c2w = torch.eye(4, dtype=scores.dtype, device=scores.device)
    c2w[:3, :3] = R_w2c.T
    c2w[:3, 3] = center
    c2w = torch.where(torch.any(torch.isnan(c2w)),
                      torch.eye(4, dtype=scores.dtype, device=scores.device), c2w)
    return PoseSolution(c2w=c2w, center=center, watch_dir=watch_dir,
                        topk_idx=idx, topk_weights=torch.where(keep, weights, 0.0))


def inv3x3(R: torch.Tensor) -> torch.Tensor:
    """Adjugate inverse with triple-product det."""
    det = torch.dot(R[0], _cross(R[1], R[2]))
    adj = torch.stack(
        [_cross(R[:, 1], R[:, 2]), _cross(R[:, 2], R[:, 0]), _cross(R[:, 0], R[:, 1])],
        dim=0,
    )
    return adj / det


def translation_error(t_gt: torch.Tensor, t_pred: torch.Tensor) -> torch.Tensor:
    """(error_computation.py:3-4)"""
    return torch.linalg.norm(t_gt - t_pred)


def angular_error_deg(R_gt: torch.Tensor, R_est: torch.Tensor) -> torch.Tensor:
    """arccos((tr(R_gt R_est^-1) - 1)/2) in degrees (error_computation.py:6-8)."""
    cos_angle = (torch.trace(R_gt @ inv3x3(R_est)) - 1.0) / 2.0
    return torch.rad2deg(torch.arccos(torch.clamp(cos_angle, -1.0, 1.0)))
