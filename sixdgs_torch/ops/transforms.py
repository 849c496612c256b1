"""Quaternion helpers for Gaussian ellipsoids.

Port of sixdgs_tpu/ops/transforms.py (inverse_sigmoid, quat_to_rotmat). The
covariance builders arrive with the rasterizer slice.
"""

from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unnormalized quaternion [..., 4] (w, x, y, z) -> rotation matrix [..., 3, 3].

    Matches reference ``build_rotation`` (general_utils.py:103-126), including
    the normalization of the input quaternion.
    """
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    # guard: a zero/collapsed quaternion (e.g. a diverged padded gaussian)
    # must not poison the batch with NaNs
    q = q / torch.clamp_min(norm, 1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], dim=-1
    )
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], dim=-1
    )
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], dim=-1
    )
    return torch.stack([row0, row1, row2], dim=-2)
