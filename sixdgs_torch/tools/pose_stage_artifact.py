"""Full pose-stage artifact: port of the JAX package's
tools/pose_stage_artifact.py.

Runs the paper's main flow end to end through the port's drivers: build a
renderable synthetic scene (the quality-workflow generator), train a 3DGS
model with apps.train_gs, then run apps.pose_eval at the production
configuration (1500 id-module iterations with ray renewal every 10, grad
accumulation batch 32, the 32k ray budget), including both evaluation
passes (target and predicted scores) and the per-image time the driver
prints, for each backbone.

Writes ``--out`` (default ``<workdir>/pose_stage.json``): per-backbone wall
clocks, the driver's printed averages and the results list it dumps, with
the JAX tool's keys. Runs on the card unless ``--platform cpu``, which is
passed on to both apps with ``--fused_attention`` (B1 forward, B2
backward in the pose driver).

Usage: python -m sixdgs_torch.tools.pose_stage_artifact
    [--workdir DIR] [--backbones dino,superpoint] [--gs_iterations 3000]
    [--size 400] [--n_iterations 1500] [--platform cuda|cpu]
    [--fused_attention]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np

from sixdgs_torch.tools.quality_workflow import (
    LoaderArgs,
    Tee,
    gt_scene,
    render_gt_images,
    write_dataset,
)


def _grab(pattern, text, cast=float):
    m = re.search(pattern, text)
    return cast(m.group(1)) if m else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "sixdgs_pose_stage"))
    ap.add_argument("--backbones", default="dino,superpoint")
    ap.add_argument("--gs_iterations", type=int, default=3000)
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--n_gt", type=int, default=20000)
    ap.add_argument("--n_train", type=int, default=24)
    ap.add_argument("--n_test", type=int, default=8)
    ap.add_argument("--n_iterations", type=int, default=1500)
    ap.add_argument("--ray_budget", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out", default=None,
                    help="artifact path (default: <workdir>/pose_stage.json)")
    ap.add_argument("--keep", action="store_true",
                    help="reuse an existing workdir (skip scene+3DGS build)")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--fused_attention", action="store_true",
                    help="score through the fused attention-score kernels in the "
                    "pose driver (B1 forward, B2 backward)")
    args = ap.parse_args(argv)
    out_path = args.out or os.path.join(args.workdir, "pose_stage.json")

    from sixdgs_torch.apps import pose_eval, train_gs
    from sixdgs_torch.scene.dataset_loader import load_data
    from sixdgs_torch.scene.ply_io import store_point_cloud_ply

    root = os.path.join(args.workdir, "scene")
    exp_root = os.path.join(args.workdir, "output")
    model_path = os.path.join(exp_root, "synthetic_scene_0001")
    artifact = {"config": vars(args).copy(), "stages": {}}
    platform = ["--platform", args.platform]

    have_model = args.keep and os.path.isdir(
        os.path.join(model_path, "point_cloud"))
    if not have_model:
        if os.path.isdir(args.workdir):
            shutil.rmtree(args.workdir)
        os.makedirs(root, exist_ok=True)
        write_dataset(root, args.n_train, args.n_test, args.size, 3.2)
        gt, gt_arrs = gt_scene(args.n_gt, logscale_shift=-0.6, device=args.platform)
        rng = np.random.default_rng(11)
        pts = gt_arrs["xyz"] + rng.normal(scale=0.05,
                                          size=gt_arrs["xyz"].shape)
        store_point_cloud_ply(os.path.join(root, "points3d.ply"), pts,
                              rng.uniform(80, 180, size=pts.shape))

        info = load_data(LoaderArgs(root))
        t0 = time.time()
        render_gt_images(gt, info.train_cameras + info.test_cameras, 256, "auto")
        artifact["stages"]["gt_render_s"] = round(time.time() - t0, 1)
        del gt

        t0 = time.time()
        train_gs.main([
            "--source_path", root,
            "--model_path", model_path,
            "--eval",
            "--iterations", str(args.gs_iterations),
            "--test_iterations", str(args.gs_iterations),
            "--save_iterations", str(args.gs_iterations),
            "--quiet",
        ] + platform)
        artifact["stages"]["gs_train_s"] = round(time.time() - t0, 1)

    fused = ["--fused_attention"] if args.fused_attention else []
    for backbone in args.backbones.split(","):
        ckpt = os.path.join(model_path, "id_module.npz")
        if os.path.exists(ckpt):
            os.remove(ckpt)  # feature-dim-specific; fresh per backbone
        out_json = os.path.join(args.workdir, f"pose_results_{backbone}.json")
        tee = Tee(sys.stdout)
        t0 = time.time()
        with contextlib.redirect_stdout(tee):
            pose_eval.main([
                "--exp_path", exp_root,
                "--out_path", out_json,
                "--data_type", "blender",
                "--backbone", backbone,
                "--n_iterations", str(args.n_iterations),
                "--ray_budget", str(args.ray_budget),
                "--batch", str(args.batch),
            ] + platform + fused)
        wall = time.time() - t0
        text = "".join(tee.buf)
        with open(out_json) as fh:
            results = json.load(fh)
        artifact[backbone] = {
            "wall_s": round(wall, 1),
            "n_results": len(results),
            "overfit_t_err": _grab(
                r"Overfit AVG translation error: ([\d.eE+-]+)", text),
            "overfit_a_err": _grab(
                r"Overfit AVG angular error: ([\d.eE+-]+)", text),
            "test_t_err": _grab(
                r"Test AVG translation error: ([\d.eE+-]+)", text),
            "test_a_err": _grab(
                r"Test AVG angular error: ([\d.eE+-]+)", text),
            "test_recall": _grab(r"Test recall: ([\d.eE+-]+)", text),
            "time_per_image_s": _grab(r"Time per element: ([\d.eE+-]+)", text),
            "results": results,
        }
        print(f"[artifact] {backbone}: wall {wall:.1f}s, "
              f"t_err {artifact[backbone]['test_t_err']}, "
              f"a_err {artifact[backbone]['test_a_err']}, "
              f"t/img {artifact[backbone]['time_per_image_s']}")

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(artifact, fh, indent=1)
    print("[artifact] wrote", out_path)
    return artifact


if __name__ == "__main__":
    main()
