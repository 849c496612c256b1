"""Dataset loaders: COLMAP, Blender (NeRF-synthetic), Tanks&Temples (NSVF).

Port of sixdgs_tpu/scene/loaders.py, with the same split rules (COLMAP
llffhold=8; T&T "0_" = train, "2_" with fallback "1_" = test), the same
OpenGL -> COLMAP axis flip for Blender, the same alpha compositing and the
same random init clouds. Images are decoded on the host: through Pillow
where it is importable, imported lazily as in the JAX package, and
through ``scene.png`` (8-bit PNG only) where it is not. Everything
numeric is numpy.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional

import numpy as np

from sixdgs_torch.ops.cameras import focal2fov, fov2focal
from sixdgs_torch.ops.sh import C0
from sixdgs_torch.scene import colmap_io
from sixdgs_torch.scene.png import PngImage
from sixdgs_torch.scene.ply_io import fetch_point_cloud_ply, store_point_cloud_ply
from sixdgs_torch.scene.structures import (
    BasicPointCloud,
    CameraInfo,
    SceneInfo,
    get_nerfpp_norm,
)


def _pillow():
    """PIL.Image, or None where Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def open_image(path: str):
    """An image file through Pillow, or through ``scene.png`` without it."""
    image_mod = _pillow()
    return image_mod.open(path) if image_mod is not None else PngImage.open(path)


def fromarray(arr: np.ndarray, mode: str):
    """A uint8 array as a Pillow image, or a ``PngImage`` without Pillow."""
    image_mod = _pillow()
    return image_mod.fromarray(arr, mode) if image_mod is not None else PngImage(arr, mode)


def _sh_to_rgb(shs: np.ndarray) -> np.ndarray:
    """DC SH coefficient -> RGB in float32, as the JAX package computes it."""
    return shs.astype(np.float32) * np.float32(C0) + np.float32(0.5)


def _composite_rgba(image, white_background: bool):
    """RGBA -> RGB alpha-composite over white/black (synthetic.py:40-48)."""
    im_data = np.array(image.convert("RGBA"))
    bg = np.array([1, 1, 1]) if white_background else np.array([0, 0, 0])
    norm = im_data / 255.0
    arr = norm[:, :, :3] * norm[:, :, 3:4] + bg * (1 - norm[:, :, 3:4])
    return fromarray(np.array(arr * 255.0, dtype=np.uint8), "RGB")


# ----------------------------------------------------------------- COLMAP


def read_colmap_cameras(cam_extrinsics, cam_intrinsics, images_folder: str,
                        load_images: bool = True) -> List[CameraInfo]:
    cam_infos = []
    for key in cam_extrinsics:
        extr = cam_extrinsics[key]
        intr = cam_intrinsics[extr.camera_id]
        height, width = intr.height, intr.width
        R = np.transpose(colmap_io.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            focal_x = intr.params[0]
            FovY = focal2fov(focal_x, height)
            FovX = focal2fov(focal_x, width)
        elif intr.model == "PINHOLE":
            FovY = focal2fov(intr.params[1], height)
            FovX = focal2fov(intr.params[0], width)
        else:
            raise ValueError(
                f"COLMAP camera model not handled: {intr.model} (only PINHOLE / "
                "SIMPLE_PINHOLE undistorted datasets supported)"
            )
        image_path = os.path.join(images_folder, os.path.basename(extr.name))
        image = open_image(image_path).convert("RGB") if load_images else None
        cam_infos.append(
            CameraInfo(
                uid=intr.id,
                R=R,
                T=T,
                FovY=FovY,
                FovX=FovX,
                image=image,
                image_path=image_path,
                image_name=os.path.basename(image_path).split(".")[0],
                width=width,
                height=height,
            )
        )
    return cam_infos


def read_colmap_scene_info(path: str, images: Optional[str], eval_split: bool,
                           llffhold: int = 8) -> SceneInfo:
    sparse = os.path.join(path, "sparse/0")
    try:
        cam_extrinsics = colmap_io.read_images_binary(os.path.join(sparse, "images.bin"))
        cam_intrinsics = colmap_io.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except (FileNotFoundError, EOFError):
        cam_extrinsics = colmap_io.read_images_text(os.path.join(sparse, "images.txt"))
        cam_intrinsics = colmap_io.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    reading_dir = "images" if images is None else images
    cam_infos = read_colmap_cameras(
        cam_extrinsics, cam_intrinsics, os.path.join(path, reading_dir)
    )
    cam_infos = sorted(cam_infos, key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    nerf_normalization = get_nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap_io.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        except (FileNotFoundError, EOFError):
            xyz, rgb, _ = colmap_io.read_points3d_text(os.path.join(sparse, "points3D.txt"))
        store_point_cloud_ply(ply_path, xyz, rgb)
    try:
        pcd = fetch_point_cloud_ply(ply_path)
    except Exception:
        pcd = None
    return SceneInfo(pcd, train, test, nerf_normalization, ply_path)


# ----------------------------------------------------------------- Blender


def read_cameras_from_transforms(path: str, transformsfile: str,
                                 white_background: bool, extension: str = ".png"):
    cam_infos = []
    with open(os.path.join(path, transformsfile)) as fh:
        contents = json.load(fh)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        # single join (the reference double-joins, synthetic.py:22,36, which
        # only works because it always receives absolute source paths)
        image_path = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"])
        c2w[:3, 1:3] *= -1  # OpenGL/Blender -> COLMAP axes (synthetic.py:27)
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]
        image = _composite_rgba(open_image(image_path), white_background)
        fovy = focal2fov(fov2focal(fovx, image.size[0]), image.size[1])
        cam_infos.append(
            CameraInfo(
                uid=idx,
                R=R,
                T=T,
                FovY=fovy,
                FovX=fovx,
                image=image,
                image_path=image_path,
                image_name=Path(image_path).stem,
                width=image.size[0],
                height=image.size[1],
            )
        )
    return cam_infos


def read_nerf_synthetic_info(path: str, white_background: bool, eval_split: bool,
                             extension: str = ".png") -> SceneInfo:
    train = read_cameras_from_transforms(path, "transforms_train.json", white_background, extension)
    test = read_cameras_from_transforms(path, "transforms_test.json", white_background, extension)
    if not eval_split:
        train = train + test
        test = []
    nerf_normalization = get_nerfpp_norm(train)
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        store_point_cloud_ply(ply_path, xyz, _sh_to_rgb(shs) * 255)
    try:
        pcd = fetch_point_cloud_ply(ply_path)
    except Exception:
        pcd = None
    return SceneInfo(pcd, train, test, nerf_normalization, ply_path)


# ------------------------------------------------------ Tanks&Temples (NSVF)


def read_tt_cameras(path: str, split: str, pose_files, img_files, intrinsics,
                    white_background: bool):
    if split == "train":
        poses = [x for x in pose_files if x.startswith("0_")]
        imgs = [x for x in img_files if x.startswith("0_")]
    else:
        poses = [x for x in pose_files if x.startswith("2_")]
        imgs = [x for x in img_files if x.startswith("2_")]
        if not poses:
            poses = [x for x in pose_files if x.startswith("1_")]
            imgs = [x for x in img_files if x.startswith("1_")]
    cam_infos = []
    for idx, (img_fname, pose_fname) in enumerate(zip(imgs, poses)):
        c2w = np.loadtxt(os.path.join(path, "pose", pose_fname))
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]
        image_path = os.path.join(path, "rgb", img_fname)
        image = _composite_rgba(open_image(image_path), white_background)
        w, h = image.size
        cam_infos.append(
            CameraInfo(
                uid=idx,
                R=R,
                T=T,
                FovY=focal2fov(intrinsics[1, 1], h),
                FovX=focal2fov(intrinsics[0, 0], w),
                image=image,
                image_path=image_path,
                image_name=img_fname,
                width=w,
                height=h,
            )
        )
    return cam_infos


def read_tanksandtemples_scene_info(path: str, white_background: bool = True,
                                    eval_split: bool = True) -> SceneInfo:
    intrinsics = np.loadtxt(os.path.join(path, "intrinsics.txt"))[:3, :3]
    pose_files = sorted(os.listdir(os.path.join(path, "pose")))
    img_files = sorted(os.listdir(os.path.join(path, "rgb")))
    train = read_tt_cameras(path, "train", pose_files, img_files, intrinsics, white_background)
    test = read_tt_cameras(path, "test", pose_files, img_files, intrinsics, white_background)
    nerf_normalization = get_nerfpp_norm(train)
    ply_path = os.path.join(path, "points3d.ply")
    bbox_path = os.path.join(path, "bbox.txt")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        if os.path.exists(bbox_path):
            bbox = np.loadtxt(bbox_path)
            rng = np.random.default_rng()
            xyz = np.stack(
                [rng.uniform(bbox[i], bbox[i + 3], num_pts) for i in range(3)], axis=1
            )
        else:
            xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        store_point_cloud_ply(ply_path, xyz, _sh_to_rgb(shs) * 255)
    try:
        pcd = fetch_point_cloud_ply(ply_path)
    except Exception:
        pcd = None
    return SceneInfo(pcd, train, test, nerf_normalization, ply_path)
