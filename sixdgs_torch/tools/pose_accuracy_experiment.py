"""Pose-recovery accuracy from PREDICTED scores: port of the JAX package's
tools/pose_accuracy_experiment.py.

Trains the identification module (a small trainable ViT backbone on a
synthetic GT Gaussian scene) and tracks the translation and angular error
and recall@100 of poses solved from the module's OWN predictions (never
use_target_scores) against the untrained module and the target-score
solve: the paper's headline capability, without pretrained DINOv2 weights.
Prints one JSON line with the JAX tool's keys.

Runs on the card unless ``--platform cpu``. ``--fused_attention`` trains
and evaluates through the fused attention-score kernels (B1 forward, B2
backward); the default is the plain scorer, as the JAX tool trains. Random
weights come from CPU torch generators seeded as the JAX tool seeds its
keys (DINO 1, id module 2, trainer 1); their numbers differ from
jax.random's.

Usage: python -m sixdgs_torch.tools.pose_accuracy_experiment
    [--iterations 600] [--platform cuda|cpu] [--fused_attention]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

SIZE = 64
FOV = 0.9


def make_gt_scene(n=300, seed=0, device="cuda"):
    """The synthetic GT scene of the JAX package's pose end-to-end test."""
    from sixdgs_torch.scene.gaussians import from_arrays

    rng = np.random.default_rng(seed)
    arrs = {
        "xyz": (rng.normal(size=(n, 3)) * 0.6).astype(np.float32),
        "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "features_rest": np.zeros((n, 15, 3), np.float32),
        "opacity": rng.uniform(1.0, 3.0, size=(n, 1)).astype(np.float32),
        "scaling": rng.uniform(-2.6, -2.0, size=(n, 3)).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
    }
    cap = 1 << (n - 1).bit_length()
    return from_arrays(arrs, max_sh_degree=3, capacity=max(cap, 128), device=device)


def make_camera_infos(scene, n=8, radius=1.8):
    """Ring of cameras looking at the origin; images rendered with the
    port's own renderer (on the scene's device) so the pipeline is
    self-consistent."""
    import torch

    from sixdgs_torch.scene.cameras import make_synthetic_camera
    from sixdgs_torch.scene.structures import CameraInfo
    from sixdgs_torch.train.gs_trainer import render_eval

    infos = []
    bg = torch.ones(3, device=scene.xyz.device)
    for i in range(n):
        ang = 2 * np.pi * i / n
        pos = np.array([radius * np.cos(ang), 0.4, radius * np.sin(ang)])
        z = -pos / np.linalg.norm(pos)
        up = np.array([0.0, 1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_w2c = np.stack([x, y, z], axis=0)
        T = -R_w2c @ pos
        cam = make_synthetic_camera(SIZE, SIZE, FOV, FOV, R_w2c.T, T)
        img = render_eval(scene, cam, bg, sh_degree=3, chunk=128).cpu().numpy()
        img_u8 = (np.clip(np.transpose(img, (1, 2, 0)), 0, 1) * 255).astype(np.uint8)
        infos.append(
            CameraInfo(
                uid=i, R=R_w2c.T, T=T, FovY=FOV, FovX=FOV,
                image=img_u8, image_path="", image_name=f"cam{i}",
                width=SIZE, height=SIZE,
            )
        )
    return infos


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=600)
    ap.add_argument("--chunk_iters", type=int, default=100)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ray_budget", type=int, default=8192)
    ap.add_argument("--fused_attention", action="store_true",
                    help="train and evaluate through the fused attention-score "
                    "kernels (B1 forward, B2 backward)")
    args = ap.parse_args(argv)

    import torch

    from sixdgs_torch.pose import dino
    from sixdgs_torch.pose.evaluate import test_pose_estimation as run_pose_eval
    from sixdgs_torch.pose.modules import init_id_module
    from sixdgs_torch.pose.trainer import PoseTrainer, model_up_from_cameras
    from sixdgs_torch.utils.config import PoseEstimationConfig

    dev = args.platform
    scene = make_gt_scene(device=dev)
    infos = make_camera_infos(scene)
    cfg = PoseEstimationConfig(
        gradient_accumulation_steps=8, ray_budget=args.ray_budget,
        max_ellipsoids=300,
    )
    dino_model = dino.init_params(torch.Generator().manual_seed(1), embed_dim=64,
                                  depth=2, device=dev)
    id_module = init_id_module(torch.Generator().manual_seed(2), feature_dim=64,
                               device=dev)
    model_up = torch.tensor(model_up_from_cameras(infos), device=dev)

    trainer = PoseTrainer(dino_model, id_module, scene, infos, cfg, seed=1,
                          fused_attention=args.fused_attention, device=dev)
    trainer._regen_rays()
    rays = trainer.rays

    def evaluate(module, use_target_scores=False):
        _, t_err, a_err, _, recall, _ = run_pose_eval(
            infos, dino_model, module, rays, model_up,
            use_target_scores=use_target_scores,
            fused_attention=args.fused_attention)
        return float(t_err), float(a_err), float(recall)

    t_tgt, a_tgt, _ = evaluate(id_module, use_target_scores=True)
    t0, a0, r0 = evaluate(id_module)
    print(f"target-score solve: t_err={t_tgt:.3f} a_err={a_tgt:.1f}")
    print(f"untrained: t_err={t0:.3f} a_err={a0:.1f} recall={r0:.3f}")

    traj = []
    start = time.time()
    it = 0
    while it < args.iterations:
        n = min(args.chunk_iters, args.iterations - it)
        trainer.run(n_iterations=it + n, start_iteration=it, validate_every=0)
        it += n
        t, a, r = evaluate(trainer.id_module)
        traj.append({"iter": it, "t_err": round(t, 4), "a_err": round(a, 2),
                     "recall": round(r, 4)})
        print(f"iter {it} ({time.time()-start:.0f}s): t_err={t:.3f} "
              f"a_err={a:.1f} recall={r:.3f}")

    final = traj[-1]
    out = {
        "metric": "pose_recovery_predicted_scores",
        "value": final["t_err"],
        "unit": "translation_error_scene_units",
        "angular_error_deg": final["a_err"],
        "recall_at_100": final["recall"],
        "untrained": {"t_err": round(t0, 3), "a_err": round(a0, 1),
                      "recall": round(r0, 4)},
        "target_score_solve_t_err": round(t_tgt, 3),
        "iterations": args.iterations,
        "trajectory": traj,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
