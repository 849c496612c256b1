"""VisualSFM .nvm reconstruction parser and Cambridge Landmarks loader:
port of sixdgs_tpu/scene/nvm.py.

The reference declares Cambridge Landmarks as a dataset type (prefix "cl")
but leaves its loader empty; the JAX package completed it, and this module
keeps every rule of that reader.

NVM_V3 format:
    NVM_V3 [optional calibration: FixedK fx cx fy cy]
    <num cameras>
    <name> <focal> <qw qx qy qz> <cx cy cz> <radial distortion> 0
    <num points>
    <x y z> <r g b> <num measurements> <image idx> <feature idx> <px py> ...
Several models may follow one another; a camera count of 0 or the end of
the file ends the list. ``#`` starts a comment.

NVM convention: the quaternion is the world->camera rotation, and the
camera position is given as its CENTRE, not its translation:
t = -R_w2c @ centre. One focal length serves both fields of view.

Images are decoded through ``loaders.open_image``: Pillow where it is
importable, else ``scene.png`` (8-bit PNG only; another format raises with
the file's name).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from sixdgs_torch.ops.cameras import focal2fov
from sixdgs_torch.scene.colmap_io import qvec2rotmat
from sixdgs_torch.scene.loaders import open_image
from sixdgs_torch.scene.ply_io import store_point_cloud_ply
from sixdgs_torch.scene.structures import (
    BasicPointCloud,
    CameraInfo,
    SceneInfo,
    get_nerfpp_norm,
)


@dataclass
class NvmCamera:
    file_name: str
    focal: float
    qvec: np.ndarray  # [4] w, x, y, z (world->camera)
    center: np.ndarray  # [3]
    radial: float


@dataclass
class NvmModel:
    cameras: List[NvmCamera]
    points: np.ndarray  # [N, 3]
    colors: np.ndarray  # [N, 3] uint8


def _token_stream(path: str):
    with open(path) as fh:
        for line in fh:
            if "#" in line:
                line = line[: line.index("#")]
            for tok in line.split():
                yield tok


def read_nvm(path: str) -> List[NvmModel]:
    """Parse all full models of an NVM_V3 file."""
    toks = _token_stream(path)
    version = next(toks)
    if not version.startswith("NVM"):
        raise ValueError(f"{path}: not an NVM file (header {version!r})")
    first = next(toks)
    if first == "FixedK":
        for _ in range(4):
            next(toks)
        first = next(toks)
    models: List[NvmModel] = []
    n_cams_tok: Optional[str] = first
    while n_cams_tok is not None:
        n_cams = int(n_cams_tok)
        if n_cams <= 0:
            break
        cameras = []
        for _ in range(n_cams):
            name = next(toks)
            focal = float(next(toks))
            qvec = np.array([float(next(toks)) for _ in range(4)])
            center = np.array([float(next(toks)) for _ in range(3)])
            radial = float(next(toks))
            next(toks)  # trailing 0
            cameras.append(NvmCamera(name, focal, qvec, center, radial))
        n_pts = int(next(toks))
        xyz = np.zeros((n_pts, 3))
        rgb = np.zeros((n_pts, 3), np.uint8)
        for i in range(n_pts):
            xyz[i] = [float(next(toks)) for _ in range(3)]
            rgb[i] = [int(float(next(toks))) for _ in range(3)]
            n_meas = int(next(toks))
            for _ in range(n_meas * 4):
                next(toks)
        models.append(NvmModel(cameras, xyz, rgb))
        n_cams_tok = next(toks, None)
    return models


def read_cambridge_scene_info(path: str, eval_split: bool = True,
                              llffhold: int = 8,
                              nvm_name: str = "reconstruction.nvm") -> SceneInfo:
    """Cambridge Landmarks scene from its VisualSFM reconstruction: the
    model with the most cameras, its cameras sorted by file name (those
    whose image is missing skipped), every ``llffhold``-th held out for
    test, the model's points as the cloud (colours / 255, zero normals),
    written to ``points3d.ply`` when that file is absent."""
    models = read_nvm(os.path.join(path, nvm_name))
    if not models:
        raise ValueError(f"no models in {path}/{nvm_name}")
    model = max(models, key=lambda m: len(m.cameras))

    cam_infos = []
    for idx, cam in enumerate(sorted(model.cameras, key=lambda c: c.file_name)):
        image_path = os.path.join(path, cam.file_name)
        if not os.path.exists(image_path):
            continue
        image = open_image(image_path).convert("RGB")
        w, h = image.size
        R_w2c = qvec2rotmat(cam.qvec)
        T = -R_w2c @ cam.center  # NVM stores the camera CENTRE
        cam_infos.append(
            CameraInfo(
                uid=idx,
                R=R_w2c.T,
                T=T,
                FovY=focal2fov(cam.focal, h),
                FovX=focal2fov(cam.focal, w),
                image=image,
                image_path=image_path,
                image_name=os.path.splitext(os.path.basename(cam.file_name))[0],
                width=w,
                height=h,
            )
        )
    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []
    pcd = BasicPointCloud(
        points=model.points,
        colors=model.colors.astype(np.float64) / 255.0,
        normals=np.zeros_like(model.points),
    )
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        store_point_cloud_ply(ply_path, model.points, model.colors)
    return SceneInfo(pcd, train, test, get_nerfpp_norm(train), ply_path)
