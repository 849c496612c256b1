"""Render the train and test sets of a trained model to PNGs: port of
sixdgs_tpu/apps/render.py (parity with the reference's render.py:25-101).

Usage:
    python -m sixdgs_torch.apps.render --model_path <dir> [--iteration N] [--skip_train]
        [--platform cpu|cuda]

Renders through ``render_eval`` (on the card: B5 and B3). PNGs are written
through Pillow where it imports and through ``scene.png`` where it does
not (the card's machine has no Pillow); both write the same 8-bit values.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from sixdgs_torch.scene.cameras import camera_list_from_infos
from sixdgs_torch.scene.dataset_loader import load_data
from sixdgs_torch.scene.gaussians import load_ply
from sixdgs_torch.scene.loaders import fromarray
from sixdgs_torch.train.gs_trainer import render_eval
from sixdgs_torch.utils.config import dotdict, read_cfg_args


def find_iteration(model_path: str, iteration: int) -> int:
    pc_dir = os.path.join(model_path, "point_cloud")
    iters = []
    for name in os.listdir(pc_dir):
        if name.startswith("iteration_"):
            try:
                iters.append(int(name.split("_")[1]))
            except ValueError:
                continue
    if iteration == -1:
        return max(iters)
    assert iteration in iters, f"iteration {iteration} not found in {pc_dir}"
    return iteration


def save_png(path: str, img: np.ndarray) -> None:
    """[3, H, W] float image in [0, 1] as an 8-bit RGB PNG."""
    arr = (np.clip(np.transpose(img, (1, 2, 0)), 0, 1) * 255).astype(np.uint8)
    fromarray(arr, "RGB").save(path)


def render_set(model_path, name, iteration, cams, scene, bg, sh_degree, chunk):
    render_dir = os.path.join(model_path, name, f"ours_{iteration}", "renders")
    gt_dir = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    os.makedirs(render_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    for idx, cam in enumerate(cams):
        img = render_eval(scene, cam, bg, sh_degree, chunk).cpu().numpy()
        save_png(os.path.join(render_dir, f"{idx:05d}.png"), img)
        save_png(os.path.join(gt_dir, f"{idx:05d}.png"), np.asarray(cam.image))


def main(argv=None):
    parser = argparse.ArgumentParser(description="sixdgs_torch rendering")
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--chunk", type=int, default=256)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--platform", type=str, default="cuda", choices=["cpu", "cuda"])
    args = parser.parse_args(argv)

    cfg = dotdict(read_cfg_args(args.model_path))
    if not args.quiet:
        print(f"Rendering {args.model_path}")
    iteration = find_iteration(args.model_path, args.iteration)
    ply = os.path.join(args.model_path, "point_cloud", f"iteration_{iteration}",
                       "point_cloud.ply")
    scene = load_ply(ply, max_sh_degree=cfg.sh_degree, device=args.platform)
    scene_info = load_data(cfg)
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.white_background else [0.0, 0.0, 0.0],
                      device=args.platform)

    if not args.skip_train:
        cams = camera_list_from_infos(scene_info.train_cameras, cfg.resolution)
        render_set(args.model_path, "train", iteration, cams, scene, bg, cfg.sh_degree,
                   args.chunk)
    if not args.skip_test:
        cams = camera_list_from_infos(scene_info.test_cameras, cfg.resolution)
        render_set(args.model_path, "test", iteration, cams, scene, bg, cfg.sh_degree,
                   args.chunk)


if __name__ == "__main__":
    main()
