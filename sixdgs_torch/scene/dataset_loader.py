"""Dataset type dispatch: port of sixdgs_tpu/scene/dataset_loader.py
(reference scene/dataset_loader.py:5-32)."""

from __future__ import annotations

import os

from sixdgs_torch.scene.loaders import (
    read_colmap_scene_info,
    read_nerf_synthetic_info,
    read_tanksandtemples_scene_info,
)
from sixdgs_torch.scene.structures import SceneInfo


def load_data(args) -> SceneInfo:
    """Sniff the directory layout and dispatch to the right loader.

    ``args`` needs: source_path, images, eval, white_background (the subset of
    ModelParams the reference passes, dataset_loader.py:5-20).
    """
    source_path = args.source_path
    if os.path.exists(os.path.join(source_path, "sparse")):
        return read_colmap_scene_info(source_path, getattr(args, "images", None), args.eval)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        return read_nerf_synthetic_info(source_path, args.white_background, args.eval)
    if os.path.exists(os.path.join(source_path, "intrinsics.txt")):
        return read_tanksandtemples_scene_info(
            source_path, args.white_background, args.eval
        )
    if os.path.exists(os.path.join(source_path, "reconstruction.nvm")):
        # Cambridge Landmarks: declared but left unimplemented by the
        # reference (scene/cambridge_loader.py is empty); completed here
        from sixdgs_torch.scene.nvm import read_cambridge_scene_info

        return read_cambridge_scene_info(source_path, args.eval)
    raise ValueError(f"Could not recognize scene type at {source_path}")


def get_dataset_prefix(source_path: str) -> str:
    if os.path.exists(os.path.join(source_path, "sparse")):
        return "mip_360"
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        return "synthetic"
    if os.path.exists(os.path.join(source_path, "intrinsics.txt")):
        return "tt"
    if os.path.exists(os.path.join(source_path, "reconstruction.nvm")):
        return "cl"
    raise ValueError(f"Could not recognize scene type at {source_path}")
