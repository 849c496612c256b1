"""Camera matrix builders.

Port of sixdgs_tpu/ops/cameras.py: column-vector counterparts of the
reference's glm-style transposed matrices (graphics_utils.py:34-84,
scene/cameras.py:64-85). Everything is host-side numpy except
``camera_center_from_view``, which takes a tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Z_NEAR = 0.01
Z_FAR = 100.0


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray, translate=None, scale: float = 1.0):
    """4x4 world->camera matrix from the loader convention: ``R`` is the
    transposed w2c rotation (i.e. c2w rotation), ``t`` the w2c translation
    (graphics_utils.py:42-53). Optional recentring like getWorld2View2."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        C2W = np.linalg.inv(Rt)
        cam_center = (C2W[:3, 3] + translate) * scale
        C2W[:3, 3] = cam_center
        Rt = np.linalg.inv(C2W)
    return np.float32(Rt)


def projection_matrix(znear: float, zfar: float, fov_x: float, fov_y: float):
    """OpenGL-style perspective matrix used by the 3DGS rasterizer
    (graphics_utils.py:56-76); z maps to [0, 1] with +z forward."""
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / math.tan(fov_x / 2)
    P[1, 1] = 1.0 / math.tan(fov_y / 2)
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def full_projection(view: np.ndarray, fov_x: float, fov_y: float,
                    znear: float = Z_NEAR, zfar: float = Z_FAR):
    """proj @ view: world -> clip (reference full_proj_transform, cameras.py:80-84)."""
    return projection_matrix(znear, zfar, fov_x, fov_y) @ view


def camera_center_from_view(view) -> torch.Tensor:
    """Camera optical center in world space (cameras.py:85)."""
    return torch.linalg.inv(torch.as_tensor(view))[:3, 3]


def intrinsic_matrix(fov_x: float, fov_y: float, width: int, height: int):
    """Pixel intrinsics used by the pose pipeline (pose_estimation/test.py:57-67)."""
    return np.array(
        [
            [fov2focal(fov_x, width), 0.0, width / 2],
            [0.0, fov2focal(fov_y, height), height / 2],
            [0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )
