"""End-to-end quality workflow: port of the JAX package's
tools/quality_workflow.py.

Builds a ground-truth Gaussian scene, renders GT views with the port's own
renderer into a Blender-format dataset (written FIRST with the standard
OpenGL c2w convention, then read back through the production loader so the
CLI apps see exactly the conventions they expect), then drives the CLI
pipeline: apps.train_gs -> apps.render -> apps.metrics, and prints the
held-out PSNR/SSIM, the adaptation counts, the truncation ratios and the
final Gaussian count as one JSON line, with the JAX tool's keys.

Runs on the card unless ``--platform cpu``, which is passed on to the
three apps. ``--rasterizer auto`` (the default) renders the GT views and
trains through the hand-written kernels (B5, B3, B4); "tiled" is the tile
rasterizer in plain PyTorch. PNGs are written with ``scene.png``, so
Pillow is not needed.

Usage: python -m sixdgs_torch.tools.quality_workflow [--iterations 3000]
    [--size 400] [--platform cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np


def look_at_c2w_opengl(pos, up=(0.0, 1.0, 0.0)):
    """OpenGL/Blender c2w (camera -z looks at the origin)."""
    pos = np.asarray(pos, np.float64)
    z = pos / np.linalg.norm(pos)  # -z points at origin
    up = np.asarray(up, np.float64)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, pos
    return c2w


def sphere_positions(n, radius, seed, z_band=(0.05, 0.75)):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, size=n)
    h = rng.uniform(*z_band, size=n)
    r_xy = np.sqrt(np.maximum(1.0 - h**2, 1e-3)) * radius
    return np.stack([r_xy * np.cos(ang), h * radius, r_xy * np.sin(ang)], axis=1)


def write_dataset(root, n_train, n_test, size, radius, seed=0, width=None,
                  height=None):
    """transforms_{train,test}.json and black placeholder PNGs (the GT
    renders replace them once the loader has read the cameras)."""
    from sixdgs_torch.scene.png import write_png

    width = width or size
    height = height or size
    frames_by_split = {}
    for split, n, s in [("train", n_train, seed), ("test", n_test, seed + 1)]:
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i, pos in enumerate(sphere_positions(n, radius, s)):
            frames.append({
                "file_path": f"./{split}/r_{i}",
                "transform_matrix": look_at_c2w_opengl(pos).tolist(),
            })
            write_png(os.path.join(root, split, f"r_{i}.png"),
                      np.zeros((height, width, 3), np.uint8))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as fh:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, fh)
        frames_by_split[split] = frames
    return frames_by_split


def gt_scene(n, seed=7, logscale_shift=0.0, device="cuda"):
    """A random SH-3 scene of ``n`` Gaussians on ``device`` and its arrays."""
    from sixdgs_torch.scene.gaussians import from_arrays

    rng = np.random.default_rng(seed)
    arrs = {
        "xyz": (rng.normal(size=(n, 3)) * 0.6).astype(np.float32),
        "features_dc": (rng.normal(size=(n, 1, 3)) * 0.8).astype(np.float32),
        "features_rest": (rng.normal(size=(n, 15, 3)) * 0.02).astype(np.float32),
        "opacity": rng.uniform(0.0, 3.0, size=(n, 1)).astype(np.float32),
        "scaling": (rng.uniform(-3.6, -2.2, size=(n, 3))
                    + logscale_shift).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
    }
    cap = 1 << (n - 1).bit_length()
    return from_arrays(arrs, max_sh_degree=3, capacity=cap, device=device), arrs


class LoaderArgs:
    """The subset of ModelConfig that ``load_data`` reads."""

    images = None
    eval = True
    white_background = False

    def __init__(self, source_path):
        self.source_path = source_path


def render_gt_images(gt, infos, chunk: int, rasterizer: str) -> None:
    """Render ``gt`` from each CameraInfo over black and write it as an RGB
    PNG at the info's image path."""
    import torch

    from sixdgs_torch.scene.cameras import camera_list_from_infos
    from sixdgs_torch.scene.png import write_png
    from sixdgs_torch.train.gs_trainer import render_eval

    bg = torch.zeros(3, device=gt.xyz.device)
    for ci in infos:
        cam = camera_list_from_infos([ci])[0]
        img = torch.clamp(render_eval(gt, cam, bg, 3, chunk, rasterizer), 0, 1)
        img = img.cpu().numpy()
        write_png(ci.image_path,
                  (img.transpose(1, 2, 0) * 255).round().astype(np.uint8))


class Tee(io.TextIOBase):
    """Pass stdout through while keeping a copy (the adaptation messages
    of the training run are counted from it)."""

    def __init__(self, base):
        self.base = base
        self.buf = []

    def write(self, s):
        self.base.write(s)
        self.buf.append(s)
        return len(s)

    def flush(self):
        self.base.flush()


def truncation_ratios(metrics_path: str) -> dict:
    """Max and final share of tile coverage dropped by the binning tiers,
    from the binning telemetry train_gs logs to metrics.jsonl."""
    dropped, area = {}, {}
    with open(metrics_path) as fh:
        for line in fh:
            rec = json.loads(line)
            tag, step = rec.get("tag", ""), rec.get("step", 0)
            if tag.startswith("binning_dropped_"):
                dropped[step] = dropped.get(step, 0) + rec["value"]
            elif tag == "binning_total_area":
                area[step] = rec["value"]
    ratios = {s: dropped[s] / max(area[s], 1.0) for s in dropped if s in area}
    if not ratios:
        return {}
    return {"trunc_ratio_max": round(max(ratios.values()), 4),
            "trunc_ratio_final": round(ratios[max(ratios.keys())], 4)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "sixdgs_quality"))
    ap.add_argument("--iterations", type=int, default=3000)
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--n_train", type=int, default=28)
    ap.add_argument("--n_test", type=int, default=6)
    ap.add_argument("--n_gt", type=int, default=3000)
    ap.add_argument("--width", type=int, default=0,
                    help="image width (default: --size)")
    ap.add_argument("--height", type=int, default=0,
                    help="image height (default: --size)")
    ap.add_argument("--gt_logscale_shift", type=float, default=0.0,
                    help="shift GT log-scales (negative = smaller gaussians; "
                    "use ~ -1.2 at Mip-360 resolutions so screen footprints "
                    "match real scenes instead of covering dozens of tiles)")
    ap.add_argument("--n_init", type=int, default=0,
                    help="init cloud size (default: n_gt noisy GT means); "
                    "smaller values exercise the densification growth path")
    ap.add_argument("--radius", type=float, default=3.2)
    ap.add_argument("--rasterizer", default="auto")
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--keep", action="store_true",
                    help="keep the workdir (default: wiped first)")
    ap.add_argument("--extra_train_args", default="",
                    help="extra flags passed through to apps.train_gs, "
                    "space-separated (e.g. '--densify_grad_threshold 1e-4')")
    ap.add_argument("--checkpoint_every", type=int, default=0,
                    help="write full train-state checkpoints every N iters "
                    "and auto-resume from the latest on restart")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from sixdgs_torch.apps import metrics as metrics_app
    from sixdgs_torch.apps import render as render_app
    from sixdgs_torch.apps import train_gs
    from sixdgs_torch.scene.dataset_loader import load_data
    from sixdgs_torch.scene.ply_io import load_gaussian_ply, store_point_cloud_ply

    root = os.path.join(args.workdir, "scene")
    model_path = os.path.join(args.workdir, "out")
    resume_ckpt = None
    if args.checkpoint_every and os.path.isdir(model_path):
        ckpts = glob.glob(os.path.join(model_path, "chkpnt*.npz"))
        if ckpts:
            resume_ckpt = max(
                ckpts, key=lambda p: int("".join(filter(str.isdigit,
                                                        os.path.basename(p)))))
            print(f"resuming from {resume_ckpt}")
    if resume_ckpt is None and not args.keep and os.path.isdir(args.workdir):
        shutil.rmtree(args.workdir)
    os.makedirs(root, exist_ok=True)

    if resume_ckpt is None:
        write_dataset(root, args.n_train, args.n_test, args.size, args.radius,
                      width=args.width or None, height=args.height or None)
    gt, gt_arrs = gt_scene(args.n_gt, logscale_shift=args.gt_logscale_shift,
                           device=args.platform)

    # init cloud: noisy GT means (the reference seeds from SfM points); with
    # --n_init a SPARSE subset so the densify schedule must grow the model
    rng = np.random.default_rng(11)
    pts = gt_arrs["xyz"] + rng.normal(scale=0.05, size=gt_arrs["xyz"].shape)
    if args.n_init and args.n_init < pts.shape[0]:
        pts = pts[rng.choice(pts.shape[0], args.n_init, replace=False)]
    store_point_cloud_ply(
        os.path.join(root, "points3d.ply"), pts,
        rng.uniform(80, 180, size=pts.shape))

    info = load_data(LoaderArgs(root))
    if resume_ckpt is None:
        render_gt_images(gt, info.train_cameras + info.test_cameras, args.chunk,
                         args.rasterizer)
    W = args.width or args.size
    H = args.height or args.size
    print(f"GT: {args.n_gt} gaussians, "
          f"{len(info.train_cameras)}+{len(info.test_cameras)} views "
          f"{W}x{H}, init cloud {pts.shape[0]}")

    ckpt_flags = []
    if args.checkpoint_every:
        iters = list(range(args.checkpoint_every, args.iterations + 1,
                           args.checkpoint_every))
        ckpt_flags = ["--checkpoint_iterations"] + [str(i) for i in iters]
    if resume_ckpt is not None:
        ckpt_flags += ["--start_checkpoint", resume_ckpt]
    platform = ["--platform", args.platform]

    tee = Tee(sys.stdout)
    t_train0 = time.time()
    with contextlib.redirect_stdout(tee):
        train_gs.main(ckpt_flags + [
            "--source_path", root,
            "--model_path", model_path,
            "--eval",
            "--iterations", str(args.iterations),
            "--test_iterations", str(args.iterations),
            "--save_iterations", str(args.iterations),
            "--rasterizer", args.rasterizer,
            "--chunk", str(args.chunk),
            "--quiet",
        ] + platform + (args.extra_train_args.split() if args.extra_train_args else []))
    train_wall_s = time.time() - t_train0
    captured = "".join(tee.buf)
    adapt_events = {
        "tier_widenings": captured.count("widening tiers"),
        "budget_widenings": captured.count("widening nc_pairs"),
        "budget_shrinks": captured.count("shrinking nc_pairs"),
    }
    render_app.main(["--model_path", model_path,
                     "--iteration", str(args.iterations),
                     "--chunk", str(args.chunk)] + platform)
    metrics_app.main(["--model_paths", model_path] + platform)

    with open(os.path.join(model_path, "results.json")) as fh:
        results = json.load(fh)
    key = f"test/ours_{args.iterations}"
    out = {
        "metric": "quality_workflow_psnr",
        "value": round(results[key]["PSNR"], 2),
        "unit": "dB",
        "ssim": round(results[key]["SSIM"], 4),
        "iterations": args.iterations,
        "rasterizer": args.rasterizer,
        "train_wall_s": round(train_wall_s, 1),
        "init_points": int(pts.shape[0]),
        **adapt_events,
    }
    # truncation telemetry over the run (logged to metrics.jsonl by the
    # train_gs callback every log_every iterations)
    try:
        out.update(truncation_ratios(os.path.join(model_path, "metrics.jsonl")))
    except (OSError, json.JSONDecodeError):
        pass
    # final active gaussian count from the saved PLY
    try:
        ply = load_gaussian_ply(os.path.join(
            model_path, "point_cloud", f"iteration_{args.iterations}",
            "point_cloud.ply"), sh_degree=3)
        out["final_gaussians"] = int(ply["xyz"].shape[0])
    except (OSError, ValueError, KeyError):
        pass
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
