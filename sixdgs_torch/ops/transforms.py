"""Quaternion and covariance builders for Gaussian ellipsoids.

Port of sixdgs_tpu/ops/transforms.py: the same formulas, the same
normalization guard and the same plane-major covariance form that
projection reads.
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


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s): [..., 3, 3] (general_utils.py:151-160)."""
    return quat_to_rotmat(q) * s[..., None, :]


def build_covariance(scaling: torch.Tensor, q: torch.Tensor,
                     scaling_modifier: float = 1.0) -> torch.Tensor:
    """Full 3x3 covariance Sigma = L L^T (gaussian_model.py:37-39)."""
    L = build_scaling_rotation(scaling_modifier * scaling, q)
    return L @ L.transpose(-1, -2)


def strip_symmetric(sym: torch.Tensor) -> torch.Tensor:
    """Upper-triangular 6-vector (xx, xy, xz, yy, yz, zz) of a symmetric 3x3
    (general_utils.py:74-87)."""
    return torch.stack([sym[..., 0, 0], sym[..., 0, 1], sym[..., 0, 2],
                        sym[..., 1, 1], sym[..., 1, 2], sym[..., 2, 2]], dim=-1)


def quat_rotmat_planes(q: torch.Tensor):
    """Rotation-matrix entries of ``quat_to_rotmat`` as nine [...] planes
    (rows of three), with the same normalization guard."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    q = q / torch.clamp_min(norm, 1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)),
        (2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)),
        (2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)),
    )


def covariance_planes(scaling: torch.Tensor, q: torch.Tensor,
                      scaling_modifier: float = 1.0):
    """Sigma = L L^T with L = R diag(s), as six [...] planes
    (xx, xy, xz, yy, yz, zz): the plane-major form of ``build_covariance``
    that projection reads."""
    R = quat_rotmat_planes(q)
    s = scaling_modifier * scaling
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    L = tuple(tuple(R[i][j] * (s0, s1, s2)[j] for j in range(3)) for i in range(3))

    def sig(i, j):
        return L[i][0] * L[j][0] + L[i][1] * L[j][1] + L[i][2] * L[j][2]

    return sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)


def build_covariance_6(scaling: torch.Tensor, q: torch.Tensor,
                       scaling_modifier: float = 1.0) -> torch.Tensor:
    """Covariance as a 6-vector, the rasterizer's packed form
    (gaussian_model.py:30-34)."""
    return torch.stack(covariance_planes(scaling, q, scaling_modifier), dim=-1)


def unpack_covariance_6(cov6: torch.Tensor) -> torch.Tensor:
    """Inverse of strip_symmetric: 6-vector -> symmetric 3x3."""
    xx, xy, xz, yy, yz, zz = (cov6[..., i] for i in range(6))
    return torch.stack([torch.stack([xx, xy, xz], dim=-1),
                        torch.stack([xy, yy, yz], dim=-1),
                        torch.stack([xz, yz, zz], dim=-1)], dim=-2)


def build_a_mat(s: torch.Tensor, q: torch.Tensor,
                scaling_modifier: float = 1.0) -> torch.Tensor:
    """A = R diag(1/s) R^T, the ellipsoid "A-matrix" (general_utils.py:163-172,
    gaussian_model.py:42-43)."""
    R = quat_to_rotmat(q)
    inv_s = 1.0 / (scaling_modifier * s)
    return (R * inv_s[..., None, :]) @ R.transpose(-1, -2)
