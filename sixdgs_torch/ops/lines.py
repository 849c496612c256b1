"""Least-squares line intersection and pose assembly helpers.

Port of sixdgs_tpu/ops/lines.py (reference
pose_estimation/line_intersection.py): projector normal equations
(sum w (I - d d^T)) p = sum w (I - d d^T) o solved by the adjugate, with the
triple-product determinant and the det < 1e-7 -> NaN sentinel.
"""

from __future__ import annotations

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def line_intersection_wls(points, directions, weights=None, mask=None,
                          det_eps: float = 1.0e-7):
    """LS intersection of N lines (origin o_i, unit direction d_i).

    Args:
        points: [N, 3] origins.
        directions: [N, 3] unit directions.
        weights: optional [N] weights.
        mask: optional [N] bool; masked-out entries contribute nothing.
        det_eps: singular guard threshold (reference: 1e-7).

    Returns:
        [3] intersection, NaN-filled when the normal matrix is singular
        (reference behavior, line_intersection.py:139-142).
    """
    d = directions
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    projs = eye[None] - d[:, :, None] * d[:, None, :]  # [N,3,3]
    w = torch.ones(points.shape[0], dtype=points.dtype, device=points.device)
    if weights is not None:
        w = w * weights
    if mask is not None:
        w = w * mask.to(points.dtype)
    pw = projs * w[:, None, None]
    R = torch.sum(pw, dim=0)  # [3,3]
    q = torch.sum(pw @ points[:, :, None], dim=0)[:, 0]  # [3]

    # explicit triple-product determinant, as the reference package computes
    # it (elementwise, full f32)
    detR = torch.dot(R[0], _cross(R[1], R[2]))
    safe_det = torch.where(torch.abs(detR) < 1e-30, torch.ones_like(detR), detR)
    adj = torch.stack(
        [_cross(R[:, 1], R[:, 2]), _cross(R[:, 2], R[:, 0]), _cross(R[:, 0], R[:, 1])],
        dim=0,
    )
    p = (adj @ q) / safe_det
    return torch.where(detR < det_eps, torch.full_like(p, float("nan")), p)


def exclude_negatives(camera_center, points, directions):
    """1.0 where the solved center lies in front of the ray origin along the
    ray (line_intersection.py:29-34), else 0.0."""
    v = camera_center[None, :] - points
    dproj = torch.sum(v * directions, dim=-1)
    return (dproj > 0).to(points.dtype)


def make_rotation_mat(direction, up):
    """World->camera rotation from a view direction and an up hint via
    Gram-Schmidt (line_intersection.py:236-257). Rows are (x, y, z=direction)
    camera axes expressed in world coordinates."""
    xaxis = _cross(up, direction)
    xaxis = xaxis / torch.linalg.norm(xaxis, dim=-1, keepdim=True)
    yaxis = _cross(direction, xaxis)
    yaxis = yaxis / torch.linalg.norm(yaxis, dim=-1, keepdim=True)
    return torch.stack([xaxis, yaxis, direction], dim=-2)
