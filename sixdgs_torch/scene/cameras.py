"""Render-ready cameras: precomputed matrices + resized ground-truth images.

Port of sixdgs_tpu/scene/cameras.py (reference scene/cameras.py:18-109,
utils/camera_utils.py:20-74). A Camera is a frozen host-side struct of
numpy arrays; ``train.gs_trainer.camera_arrays`` moves it to a device.
``load_camera`` calls ``.resize`` on the PIL image it is given and imports
no image library itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from sixdgs_torch.ops.cameras import (
    Z_FAR,
    Z_NEAR,
    fov2focal,
    full_projection,
    projection_matrix,
    world_to_view,
)
from sixdgs_torch.scene.structures import CameraInfo


@dataclass(frozen=True)
class Camera:
    uid: int
    colmap_id: int
    R: np.ndarray
    T: np.ndarray
    FoVx: float
    FoVy: float
    image: np.ndarray  # [3, H, W] float32 in [0, 1], premultiplied by alpha
    image_name: str
    width: int
    height: int
    view: np.ndarray  # [4, 4] world->camera
    proj: np.ndarray  # [4, 4]
    full_proj: np.ndarray  # [4, 4] proj @ view
    camera_center: np.ndarray  # [3]
    znear: float = Z_NEAR
    zfar: float = Z_FAR


def _pil_to_numpy_chw(pil_image, resolution) -> np.ndarray:
    resized = pil_image.resize(resolution)
    arr = np.array(resized).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return np.transpose(arr, (2, 0, 1))


def load_camera(cam_info: CameraInfo, uid: int, resolution: int = -1,
                resolution_scale: float = 1.0) -> Camera:
    """Resolution policy parity with utils/camera_utils.py:20-45 (including the
    1.6K auto-downscale for -1)."""
    orig_w, orig_h = cam_info.image.size

    if resolution in (1, 2, 4, 8):
        target = (
            round(orig_w / (resolution_scale * resolution)),
            round(orig_h / (resolution_scale * resolution)),
        )
    else:
        if resolution == -1:
            global_down = orig_w / 1600 if orig_w > 1600 else 1
        else:
            global_down = orig_w / resolution
        scale = float(global_down) * float(resolution_scale)
        target = (int(orig_w / scale), int(orig_h / scale))

    rgb = _pil_to_numpy_chw(cam_info.image, target)
    gt_image = np.clip(rgb[:3], 0.0, 1.0)
    if rgb.shape[0] == 4:
        gt_image = gt_image * rgb[3:4]

    view = world_to_view(cam_info.R, cam_info.T)
    return Camera(
        uid=uid,
        colmap_id=cam_info.uid,
        R=cam_info.R,
        T=cam_info.T,
        FoVx=cam_info.FovX,
        FoVy=cam_info.FovY,
        image=gt_image.astype(np.float32),
        image_name=cam_info.image_name,
        width=gt_image.shape[2],
        height=gt_image.shape[1],
        view=view,
        proj=projection_matrix(Z_NEAR, Z_FAR, cam_info.FovX, cam_info.FovY),
        full_proj=full_projection(view, cam_info.FovX, cam_info.FovY),
        camera_center=np.linalg.inv(view)[:3, 3].astype(np.float32),
    )


def camera_list_from_infos(cam_infos, resolution: int = -1,
                           resolution_scale: float = 1.0):
    return [
        load_camera(c, i, resolution, resolution_scale) for i, c in enumerate(cam_infos)
    ]


def camera_to_json(idx: int, camera: Camera):
    """cameras.json entry (utils/camera_utils.py:77-97)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = camera.R.transpose()
    Rt[:3, 3] = camera.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    return {
        "id": idx,
        "img_name": camera.image_name,
        "width": camera.width,
        "height": camera.height,
        "position": W2C[:3, 3].tolist(),
        "rotation": [r.tolist() for r in W2C[:3, :3]],
        "fy": fov2focal(camera.FoVy, camera.height),
        "fx": fov2focal(camera.FoVx, camera.width),
    }


def make_synthetic_camera(width: int, height: int, fovx: float, fovy: float,
                          R: np.ndarray, T: np.ndarray,
                          image: Optional[np.ndarray] = None,
                          uid: int = 0, name: str = "synthetic") -> Camera:
    """Build a Camera directly from matrices (tests / MiniCam-style use,
    scene/cameras.py:88-109)."""
    view = world_to_view(R, T)
    if image is None:
        image = np.zeros((3, height, width), np.float32)
    return Camera(
        uid=uid,
        colmap_id=uid,
        R=R,
        T=T,
        FoVx=fovx,
        FoVy=fovy,
        image=image,
        image_name=name,
        width=width,
        height=height,
        view=view,
        proj=projection_matrix(Z_NEAR, Z_FAR, fovx, fovy),
        full_proj=full_projection(view, fovx, fovy),
        camera_center=np.linalg.inv(view)[:3, 3].astype(np.float32),
    )
