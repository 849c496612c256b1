"""Plain-data scene structures (host-side, numpy).

Copy of sixdgs_tpu/scene/structures.py (reference
scene/scene_structure.py:7-25, utils/graphics_utils.py:18-21).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class BasicPointCloud:
    points: np.ndarray  # [N, 3] float
    colors: np.ndarray  # [N, 3] float in [0, 1]
    normals: np.ndarray  # [N, 3] float


@dataclass
class CameraInfo:
    """One training/test view. ``R`` is the *transposed* world->camera rotation
    (i.e. the camera->world rotation) and ``T`` the world->camera translation,
    matching the reference loader convention (scene/colmap.py:33-34)."""

    uid: int
    R: np.ndarray  # [3, 3]
    T: np.ndarray  # [3]
    FovY: float
    FovX: float
    image: Any  # PIL.Image or np.ndarray [H, W, 3|4] uint8
    image_path: str
    image_name: str
    width: int
    height: int

    def image_array(self) -> np.ndarray:
        """Image as uint8 numpy array [H, W, C]."""
        if isinstance(self.image, np.ndarray):
            return self.image
        return np.array(self.image)

    def c2w(self) -> np.ndarray:
        """4x4 camera-to-world matrix (pose_estimation/test.py:47-54)."""
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = self.R.T
        w2c[:3, 3] = self.T
        return np.linalg.inv(w2c)


@dataclass
class SceneInfo:
    point_cloud: Optional[BasicPointCloud]
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: Dict[str, Any]
    ply_path: str


def get_center_and_diag(cam_centers: np.ndarray):
    avg = np.mean(cam_centers, axis=1, keepdims=True)
    dist = np.linalg.norm(cam_centers - avg, axis=0, keepdims=True)
    return avg.flatten(), float(np.max(dist))


def get_nerfpp_norm(cam_infos: List[CameraInfo]):
    """Scene normalization (translate/radius) from camera centers
    (scene/datasets_utils.py get_nerfpp_norm)."""
    centers = []
    for cam in cam_infos:
        centers.append(cam.c2w()[:3, 3:4])
    center, diagonal = get_center_and_diag(np.hstack(centers))
    return {"translate": -center, "radius": diagonal * 1.1}
