"""Pose-estimation driver: port of sixdgs_tpu/apps/pose_eval.py (parity
with the reference's pretrain_eval_attention.py and
pose_estimation/{opt,file_utils}.py).

Scans an experiment directory of trained 3DGS models (``<prefix><scene>_<id>``
dirs with ``cfg_args`` + ``point_cloud/iteration_N/point_cloud.ply``), trains
the identification module per scene (resuming from ``id_module.npz``),
evaluates pose estimation on the test split, and dumps a JSON results list.

Usage:
    python -m sixdgs_torch.apps.pose_eval --exp_path <dir> --out_path out.json
        [--data_type tankstemple|mip360|blender|cambridge_landmark|all]
        [--dino_weights dinov2_vits14.pth|.npz] [--platform cpu|cuda]
        [--backbone dino|superpoint] [--superpoint_weights superpoint.npz]
        [--fused_attention]

Runs on the card unless ``--platform cpu``. ``--fused_attention`` scores
through the fused attention-score kernels (B1 forward, B2 backward) in
training and evaluation; the default scores as the JAX driver does, with
the plain attention. Random weights are drawn from torch generators seeded
as the JAX driver seeds its keys (DINO or SuperPoint 71170, the id module
``seed``, the evaluation rays ``seed + 1``); their numbers differ from
jax.random's. ``--backbone superpoint`` scores 28 x 28 patches of 256-dim
descriptors with a 256-wide id module, from ``--superpoint_weights`` (the
JAX package's flat npz, ``"<name>.w"`` and ``"<name>.b"``) or random.

As in the JAX driver, a ``RuntimeError`` inside one scene is printed with
its traceback and the scene is skipped; torch reports CUDA faults as
``RuntimeError`` too, so the exit code alone does not show that a scene ran.
"""

from __future__ import annotations

import argparse
import json
import os
import traceback

import torch

from sixdgs_torch.scene.dataset_loader import load_data
from sixdgs_torch.scene.gaussians import load_ply
from sixdgs_torch.utils.config import PoseEstimationConfig, dotdict, read_cfg_args
from sixdgs_torch.utils.metrics_writer import MetricsWriter

PREFIXES = {
    "blender": "synthetic_",
    "mip360": "mip_360_",
    "tankstemple": "tt_",
    "cambridge_landmark": "cl_",
    "all": "",
}
DINO_SEED = 71170


def get_highest_valid_checkpoint(root_dir: str) -> str:
    """Largest point_cloud/iteration_*/point_cloud.ply (file_utils.py:19-43)."""
    ckpt_dir = os.path.join(root_dir, "point_cloud")
    if not os.path.isdir(ckpt_dir):
        return ""
    best, best_path = -1, ""
    for name in sorted(os.listdir(ckpt_dir), reverse=True):
        parts = name.split("_")
        if parts[0] != "iteration":
            continue
        try:
            val = int(parts[1])
        except ValueError:
            continue
        path = os.path.join(ckpt_dir, name, "point_cloud.ply")
        if os.path.exists(path) and val > best:
            best, best_path = val, path
    return best_path


def parse_exp_dir(exp_dir: str, prefix: str):
    """Scan experiment dirs keyed by scene id (file_utils.py:46-72)."""
    out = {}
    for name in sorted(os.listdir(exp_dir)):
        path = os.path.join(exp_dir, name)
        if not (os.path.isdir(path) and name.startswith(prefix)):
            continue
        parts = name.split("_")
        sequence_id = parts[-1]
        category_name = "_".join(parts[:-1])
        ckpt = get_highest_valid_checkpoint(path)
        if not ckpt:
            print(f"Object {sequence_id} of category {category_name} skipped: "
                  "no valid checkpoint")
            continue
        out[sequence_id] = {
            "exp_dir_filepath": path,
            "checkpoint_filepath": ckpt,
            "sequence_id": sequence_id,
            "category_name": category_name,
        }
    return out


def pretrain_single_object(
    checkpoint_filepath: str,
    checkpoint_args: dotdict,
    exp_dir_filepath: str,
    object_id: str,
    category_name: str,
    dino_model,
    cfg: PoseEstimationConfig,
    seed: int = 55176280,
    backbone: str = "dino",
    fused_attention: bool = False,
    device="cuda",
    id_params=None,
    ray_draws=None,
):
    """Train + evaluate one scene (pretrain_eval_attention.py:31-154).

    ``id_params``: initial id-module params as the JAX package's numpy
    dict (drawn from ``seed`` when None); ``ray_draws``: the evaluation
    rays' uniform draws, {"select_priority", "slot_priority"} as numpy
    (drawn from ``seed + 1`` when None). Both let a caller start this and
    the JAX driver from the same numbers."""
    from sixdgs_torch.pose.evaluate import test_pose_estimation
    from sixdgs_torch.pose.modules import init_id_module
    from sixdgs_torch.pose.trainer import PoseTrainer, model_up_from_cameras
    from sixdgs_torch.rays.engine import generate_rays_from_scene
    from sixdgs_torch.weights import id_module_from_numpy

    print("data_path:", checkpoint_args.source_path)
    scene = load_ply(checkpoint_filepath, max_sh_degree=checkpoint_args.sh_degree,
                     device=device)
    scene_info = load_data(checkpoint_args)

    if id_params is None:
        feature_dim, grid = (256, 28) if backbone == "superpoint" else (384, 16)
        id_module = init_id_module(torch.Generator().manual_seed(seed),
                                   feature_dim=feature_dim, grid=grid, device=device)
    else:
        id_module = id_module_from_numpy(id_params, device=device)
    ckpt_path = os.path.join(exp_dir_filepath, "id_module.npz")
    trainer = PoseTrainer(
        dino_model, id_module, scene, scene_info.train_cameras, cfg, seed=seed,
        backbone=backbone, fused_attention=fused_attention, device=device,
    )
    start_iterations = 0
    if os.path.exists(ckpt_path):
        # full resume: params + Adafactor state + running_loss, the reference
        # id_module.th semantics (pretrain_eval_attention.py:66-71)
        print("Checkpoint already exists, resuming (or skipping training)")
        start_iterations = trainer.restore_checkpoint(ckpt_path)
    writer = MetricsWriter(exp_dir_filepath, filename="pose_metrics.jsonl")

    def cb(it, aux, tr):
        writer.scalar("train/loss", aux["loss"], it)
        writer.scalar("train/loss_score", aux["loss_score"], it)
        writer.scalar("train/cam_up", aux["cam_up"], it)
        print(f"[{it}] loss: {aux['loss']:.5f}")

    if start_iterations < cfg.n_iterations:
        trainer.run(start_iteration=start_iterations, callback=cb,
                    test_cam_infos=scene_info.test_cameras, writer=writer)
        trainer.save_checkpoint(ckpt_path, epoch=cfg.n_iterations)
    id_module = trainer.id_module

    print("Training complete, starting testing phase...")
    draws = {k: torch.tensor(v, device=device) for k, v in (ray_draws or {}).items()}
    rays = generate_rays_from_scene(
        scene, torch.Generator(device=device).manual_seed(seed + 1), cfg, **draws)
    model_up = torch.tensor(model_up_from_cameras(scene_info.train_cameras), device=device)

    print("Testing overfit performances (target scores)...")
    (_, ov_t, ov_a, ov_s, ov_r, _) = test_pose_estimation(
        scene_info.test_cameras, dino_model, id_module, rays, model_up,
        sequence_id=object_id, category_id=category_name, use_target_scores=True,
        k=cfg.rays_to_output, backbone=backbone, fused_attention=fused_attention,
    )
    print("Overfit AVG translation error:", ov_t)
    print("Overfit AVG angular error:", ov_a)

    print("Testing performances on same points...")
    (results, t_err, a_err, s_loss, recall, t_img) = test_pose_estimation(
        scene_info.test_cameras, dino_model, id_module, rays, model_up,
        sequence_id=object_id, category_id=category_name, k=cfg.rays_to_output,
        backbone=backbone, fused_attention=fused_attention,
    )
    print("Test AVG translation error:", t_err)
    print("Test AVG angular error:", a_err)
    print("Test recall:", recall)
    print("Time per element:", t_img)
    writer.close()
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description="sixdgs_torch pose evaluation")
    parser.add_argument("--exp_path", type=str, required=True)
    parser.add_argument("--out_path", type=str, required=True)
    parser.add_argument(
        "--data_type", type=str, default="all", choices=list(PREFIXES.keys())
    )
    parser.add_argument("--dino_weights", type=str, default=None,
                        help="DINOv2-S/14 weights (.npz of the JAX package's names or "
                        "a torch .pth with the hub's); random init if absent")
    parser.add_argument("--backbone", type=str, default="dino",
                        choices=["dino", "superpoint"],
                        help="image backbone (backbone_type in the reference "
                        "IdentificationModule; superpoint = 28x28 grid, 256-dim "
                        "descriptors)")
    parser.add_argument("--superpoint_weights", type=str, default=None,
                        help="converted superpoint_v1 weights (.npz); with --backbone "
                        "superpoint")
    parser.add_argument("--n_iterations", type=int, default=1500)
    parser.add_argument("--ray_budget", type=int, default=32768)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--platform", type=str, default="cuda", choices=["cpu", "cuda"])
    parser.add_argument("--fused_attention", action="store_true",
                        help="score through the fused attention-score kernels "
                        "(B1 forward, B2 backward)")
    args = parser.parse_args(argv)

    device = args.platform
    if args.backbone == "superpoint":
        from sixdgs_torch.pose import superpoint

        if args.superpoint_weights:
            dino_model = superpoint.load_params(args.superpoint_weights, device=device)
        else:
            dino_model = superpoint.init_params(torch.Generator().manual_seed(DINO_SEED),
                                                device=device)
    else:
        from sixdgs_torch.pose import dino

        dino_model = dino.load_params(args.dino_weights,
                                      generator=torch.Generator().manual_seed(DINO_SEED),
                                      device=device)
    cfg = PoseEstimationConfig(
        n_iterations=args.n_iterations,
        ray_budget=args.ray_budget,
        gradient_accumulation_steps=args.batch,
    )

    out_abs = os.path.abspath(args.out_path)
    os.makedirs(os.path.dirname(out_abs), exist_ok=True)
    results = []
    experiments = parse_exp_dir(args.exp_path, PREFIXES[args.data_type])
    for exp in experiments.values():
        checkpoint_args = dotdict(read_cfg_args(exp["exp_dir_filepath"]))
        try:
            results.extend(
                pretrain_single_object(
                    exp["checkpoint_filepath"],
                    checkpoint_args,
                    exp["exp_dir_filepath"],
                    exp["sequence_id"],
                    exp["category_name"],
                    dino_model,
                    cfg,
                    backbone=args.backbone,
                    fused_attention=args.fused_attention,
                    device=device,
                )
            )
        except RuntimeError:
            traceback.print_exc()
    print("Saving results")
    with open(out_abs, "w") as fh:
        json.dump(results, fh)


if __name__ == "__main__":
    main()
