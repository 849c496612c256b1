"""Offline image metrics over rendered sets: port of
sixdgs_tpu/apps/metrics.py (parity with the reference's metrics.py:26-131):
SSIM, PSNR and LPIPS per method dir -> results.json and per_view.json.

Usage:
    python -m sixdgs_torch.apps.metrics --model_paths <dir> [<dir> ...]
        [--lpips_weights lpips_vgg.npz] [--platform cpu|cuda]

LPIPS goes through ``pose.lpips`` (VGG16) when converted weights are given
(the JAX package's npz keys, so one file serves both packages); without
them it is reported as null. PNGs are read through Pillow where it imports
and through ``scene.png`` where it does not.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from sixdgs_torch.ops.ssim import psnr, ssim
from sixdgs_torch.scene.loaders import open_image


def read_image(path: str) -> np.ndarray:
    """An image file as [3, H, W] float32 in [0, 1] (RGB)."""
    arr = np.array(open_image(path).convert("RGB")).astype(np.float32) / 255.0
    return np.transpose(arr, (2, 0, 1))


def evaluate_dir(method_dir: str, lpips_fn=None, device="cuda"):
    renders_dir = os.path.join(method_dir, "renders")
    gt_dir = os.path.join(method_dir, "gt")
    names = sorted(os.listdir(renders_dir))
    ssims, psnrs, lpipss, per_view = [], [], [], {}
    for name in names:
        render = torch.tensor(read_image(os.path.join(renders_dir, name)), device=device)
        gt = torch.tensor(read_image(os.path.join(gt_dir, name)), device=device)
        s = float(ssim(render, gt))
        p = float(psnr(render, gt))
        l = float(lpips_fn(render, gt)) if lpips_fn else None
        ssims.append(s)
        psnrs.append(p)
        if l is not None:
            lpipss.append(l)
        per_view[name] = {"SSIM": s, "PSNR": p, "LPIPS": l}
    summary = {
        "SSIM": float(np.mean(ssims)),
        "PSNR": float(np.mean(psnrs)),
        "LPIPS": float(np.mean(lpipss)) if lpipss else None,
    }
    return summary, per_view


def main(argv=None):
    parser = argparse.ArgumentParser(description="sixdgs_torch metrics")
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help="path to converted VGG/LPIPS weights (.npz)")
    parser.add_argument("--platform", type=str, default="cuda", choices=["cpu", "cuda"])
    args = parser.parse_args(argv)

    lpips_fn = None
    if args.lpips_weights:
        from sixdgs_torch.pose.lpips import make_lpips

        lpips_fn = make_lpips(args.lpips_weights, device=args.platform)

    for model_path in args.model_paths:
        full_results, per_view_results = {}, {}
        for split in ("test", "train"):
            split_dir = os.path.join(model_path, split)
            if not os.path.isdir(split_dir):
                continue
            for method in sorted(os.listdir(split_dir)):
                method_dir = os.path.join(split_dir, method)
                if not os.path.isdir(method_dir):
                    continue
                summary, per_view = evaluate_dir(method_dir, lpips_fn, args.platform)
                full_results[f"{split}/{method}"] = summary
                per_view_results[f"{split}/{method}"] = per_view
                print(f"{model_path} {split}/{method}: {summary}")
        with open(os.path.join(model_path, "results.json"), "w") as fh:
            json.dump(full_results, fh, indent=2)
        with open(os.path.join(model_path, "per_view.json"), "w") as fh:
            json.dump(per_view_results, fh, indent=2)


if __name__ == "__main__":
    main()
