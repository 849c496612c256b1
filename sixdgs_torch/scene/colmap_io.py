"""COLMAP sparse-reconstruction parsers (binary + text).

Copy of sixdgs_tpu/scene/colmap_io.py: numpy readers and writers of the
COLMAP on-disk format (cameras, images, points3D), numpy bulk reads where
the record layout allows (points3D, through the native gsio reader when it
builds), struct unpacking elsewhere.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

CAMERA_MODELS: Dict[int, Tuple[str, int]] = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # [4] (w, x, y, z)
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(fh, fmt: str):
    size = struct.calcsize("<" + fmt)
    data = fh.read(size)
    if len(data) != size:
        raise EOFError("truncated COLMAP file")
    return struct.unpack("<" + fmt, data)


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(fh, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(fh, "d" * n_params))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "Q")
        for _ in range(n):
            vals = _read(fh, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name_chars = []
            while True:
                c = fh.read(1)
                if c == b"\x00":
                    break
                name_chars.append(c)
            name = b"".join(name_chars).decode("utf-8")
            (n_pts,) = _read(fh, "Q")
            raw = fh.read(8 * 3 * n_pts)
            blob = np.frombuffer(raw, dtype=np.float64).reshape(-1, 3)
            xys = blob[:, :2].copy()
            p3d = (
                np.ascontiguousarray(blob[:, 2]).view(np.int64)
                if blob.size
                else np.zeros(0, np.int64)
            )
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name, xys, p3d
            )
    return images


def read_points3d_binary(path: str):
    """Returns (xyz [N,3] f8, rgb [N,3] u8, errors [N] f8).

    Uses the native gsio parser when available (million-point COLMAP
    reconstructions are minutes in pure Python); numpy fallback otherwise.
    """
    from sixdgs_torch.utils.native import get_gsio

    lib = get_gsio()
    if lib is not None:
        import ctypes

        n = lib.gsio_count_points3d(path.encode())
        if n >= 0:
            xyz = np.empty((n, 3), np.float64)
            rgb = np.empty((n, 3), np.uint8)
            err = np.empty(n, np.float64)
            got = lib.gsio_read_points3d(
                path.encode(),
                xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                err.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                n,
            )
            if got == n:
                return xyz, rgb, err
    with open(path, "rb") as fh:
        (n,) = _read(fh, "Q")
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n, np.float64)
        for i in range(n):
            vals = _read(fh, "QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(fh, "Q")
            fh.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb, err


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cams[cam_id] = ColmapCamera(
                cam_id,
                parts[1],
                int(parts[2]),
                int(parts[3]),
                np.array([float(p) for p in parts[4:]]),
            )
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    with open(path) as fh:
        lines = [ln.strip() for ln in fh if ln.strip() and not ln.startswith("#")]
    for meta, pts in zip(lines[0::2], lines[1::2]):
        parts = meta.split()
        image_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        elems = pts.split()
        xys = (
            np.array([float(e) for e in elems]).reshape(-1, 3)[:, :2]
            if elems
            else np.zeros((0, 2))
        )
        p3d = (
            np.array([int(float(e)) for e in elems[2::3]], np.int64)
            if elems
            else np.zeros(0, np.int64)
        )
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name, xys, p3d)
    return images


def read_points3d_text(path: str):
    xyzs, rgbs, errs = [], [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyzs.append([float(p) for p in parts[1:4]])
            rgbs.append([int(p) for p in parts[4:7]])
            errs.append(float(parts[7]))
    return (
        np.array(xyzs, np.float64),
        np.array(rgbs, np.uint8),
        np.array(errs, np.float64),
    )


def write_cameras_binary(cams: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = MODEL_NAME_TO_ID[cam.model]
            fh.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            fh.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_images_binary(images: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(images)))
        for im in images.values():
            fh.write(
                struct.pack(
                    "<idddddddi", im.id, *im.qvec.tolist(), *im.tvec.tolist(), im.camera_id
                )
            )
            fh.write(im.name.encode("utf-8") + b"\x00")
            n = im.xys.shape[0]
            fh.write(struct.pack("<Q", n))
            blob = np.empty((n, 3), np.float64)
            blob[:, :2] = im.xys
            blob[:, 2] = im.point3D_ids.astype(np.int64).view(np.float64)
            blob.tofile(fh)


def write_points3d_binary(xyz: np.ndarray, rgb: np.ndarray, err: np.ndarray, path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", xyz.shape[0]))
        for i in range(xyz.shape[0]):
            fh.write(
                struct.pack(
                    "<QdddBBBd",
                    i,
                    *xyz[i].tolist(),
                    *rgb[i].tolist(),
                    float(err[i]),
                )
            )
            fh.write(struct.pack("<Q", 0))
