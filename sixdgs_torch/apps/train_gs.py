"""3DGS training CLI: port of sixdgs_tpu/apps/train_gs.py (parity with the
reference's train.py:301-343).

Usage:
    python -m sixdgs_torch.apps.train_gs --source_path <scene_dir> [--model_path out]
        [--eval] [--white_background] [--iterations N] [--rasterizer auto|scan|tiled|pallas]
        [--platform cpu|cuda] ...

Runs on the card unless ``--platform cpu``. ``--rasterizer auto`` resolves
to "pallas", the tile rasterizer on the hand-written kernels (B5, B3 with
the transmittance store, B4); "tiled" is the tile rasterizer in plain
PyTorch, "scan" the golden model. Writes ``cfg_args``, ``cameras.json``,
``input.ply``, ``metrics.jsonl`` and the PLY snapshots as the JAX CLI does.
``--detect_anomaly`` and ``--debug_from`` arm
``torch.autograd.set_detect_anomaly``, the reference's own switch.
``--gui`` serves the SIBR remote viewer on ``--ip``/``--port``: before each
step it drains the viewer's camera messages, rendering each through
``render_gui_camera`` (on the card: B5 and B3 without the store) and
sending the frame back, until a message asks to train on.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
import uuid

import torch

from sixdgs_torch.scene.cameras import camera_list_from_infos, camera_to_json
from sixdgs_torch.scene.dataset_loader import get_dataset_prefix, load_data
from sixdgs_torch.train.gs_trainer import GSTrainer
from sixdgs_torch.utils.config import (
    ModelConfig,
    OptimizationConfig,
    add_dataclass_args,
    extract_dataclass_args,
    write_cfg_args,
)
from sixdgs_torch.utils.metrics_writer import MetricsWriter


def build_parser():
    parser = argparse.ArgumentParser(description="sixdgs_torch 3DGS training")
    add_dataclass_args(parser, ModelConfig())
    add_dataclass_args(parser, OptimizationConfig())
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument(
        "--detect_anomaly", action="store_true", default=False,
        help="torch.autograd.set_detect_anomaly(True), as the reference's "
        "train.py:310,330: a NaN in a backward raises with the forward op's "
        "traceback")
    parser.add_argument(
        "--debug_from", type=int, default=-1,
        help="iteration from which anomaly detection is armed (the reference's "
        "pipe.debug arming at debug_from, train.py:106-107)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--chunk", type=int, default=256)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--capacity_bucket", type=int, default=16384)
    parser.add_argument("--rasterizer", type=str, default="auto",
                        choices=["auto", "scan", "tiled", "pallas"],
                        help="'auto' and 'pallas': the tile rasterizer on the CUDA "
                        "kernels (their plain versions on the CPU); 'tiled': the tile "
                        "rasterizer in plain PyTorch; 'scan': the exact full-frame "
                        "golden model for small images")
    parser.add_argument(
        "--binning_tiers", type=int, nargs=5, default=None,
        metavar=("T_MAX", "MID_K", "T_MAX_MID", "OVERFLOW_K", "T_MAX_BIG"),
        help="per-gaussian tile-slot budgets of the 3 binning tiers "
        "(default 16 4096 64 256 1024); tune per scene guided by the "
        "binning_* saturation counters in the train metrics")
    parser.add_argument("--gui", action="store_true",
                        help="serve the SIBR remote viewer during training")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--platform", type=str, default="cuda", choices=["cpu", "cuda"])
    return parser


def prepare_output_dir(model_cfg: ModelConfig, scene_info, train_cams) -> str:
    model_path = model_cfg.model_path
    if not model_path:
        unique = str(uuid.uuid4())[:10]
        prefix = get_dataset_prefix(model_cfg.source_path)
        scene_name = model_cfg.source_path.rstrip("/").split("/")[-1]
        model_path = os.path.join("./output/", f"{prefix}_{scene_name}_{unique}")
    os.makedirs(model_path, exist_ok=True)
    # persist cfg_args in the reference repr format (train.py:207-208)
    cfg = {
        "sh_degree": model_cfg.sh_degree,
        "source_path": os.path.abspath(model_cfg.source_path),
        "model_path": model_path,
        "images": model_cfg.images,
        "resolution": model_cfg.resolution,
        "white_background": model_cfg.white_background,
        "data_device": model_cfg.data_device,
        "eval": model_cfg.eval,
        "fps_sampling": model_cfg.fps_sampling,
    }
    write_cfg_args(model_path, cfg)
    # copy the input ply and write cameras.json like Scene.__init__
    # (scene/__init__.py:47-78)
    if scene_info.ply_path and os.path.exists(scene_info.ply_path):
        shutil.copyfile(scene_info.ply_path, os.path.join(model_path, "input.ply"))
    cam_json = [camera_to_json(i, c) for i, c in enumerate(train_cams)]
    with open(os.path.join(model_path, "cameras.json"), "w") as fh:
        json.dump(cam_json, fh)
    return model_path


def main(argv=None):
    args = build_parser().parse_args(argv)
    model_cfg = extract_dataclass_args(args, ModelConfig)
    model_cfg.source_path = os.path.abspath(model_cfg.source_path)
    opt_cfg = extract_dataclass_args(args, OptimizationConfig)
    save_iterations = sorted(set(args.save_iterations + [opt_cfg.iterations]))

    scene_info = load_data(model_cfg)
    train_cams = camera_list_from_infos(scene_info.train_cameras, model_cfg.resolution)
    test_cams = camera_list_from_infos(scene_info.test_cameras, model_cfg.resolution)
    model_path = prepare_output_dir(model_cfg, scene_info, train_cams)
    print(f"Output folder: {model_path} | {len(train_cams)} train / {len(test_cams)} test cams")

    writer = MetricsWriter(model_path)
    trainer = GSTrainer(model_cfg, opt_cfg, scene_info, train_cams, test_cams,
                        seed=args.seed, capacity_bucket=args.capacity_bucket,
                        device=args.platform)
    first_iteration = 1
    if args.start_checkpoint:
        first_iteration = trainer.restore_checkpoint(args.start_checkpoint) + 1
        print(f"Resumed from {args.start_checkpoint} at iteration {first_iteration}")

    t_start = time.time()
    last_t = [t_start]

    def callback(it, metrics, tr):
        now = time.time()
        writer.scalar("train_loss_patches/total_loss", metrics["loss"], it)
        writer.scalar("train_loss_patches/l1_loss", metrics["l1"], it)
        writer.scalar("iter_time", (now - last_t[0]) / args.log_every * 1000, it)
        writer.scalar("total_points", int(tr.state.scene.num_active()), it)
        for k in ("binning_dropped_main", "binning_dropped_mid",
                  "binning_dropped_big", "binning_overflow_spill",
                  "binning_total_area", "binning_real_pairs"):
            if k in metrics:
                writer.scalar(k, int(metrics[k]), it)
        last_t[0] = now
        if not args.quiet:
            print(f"[{it}] loss={metrics['loss']:.5f} psnr={metrics['psnr']:.2f} "
                  f"pts={int(tr.state.scene.num_active())}")
        if it in args.test_iterations and test_cams:
            psnr_val, l1_val = tr.eval_psnr()
            writer.scalar("test/loss_viewpoint - psnr", psnr_val, it)
            writer.scalar("test/loss_viewpoint - l1_loss", l1_val, it)
            print(f"\n[ITER {it}] Evaluating test: L1 {l1_val} PSNR {psnr_val}")

    pre_step, gui = None, None
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    if args.debug_from >= 0:
        def pre_step(it, tr, _debug_from=args.debug_from):
            # arm like the reference's pipe.debug (train.py:106-107)
            if it - 1 == _debug_from:
                torch.autograd.set_detect_anomaly(True)

    if args.gui:
        from sixdgs_torch.renderer.network_gui import NetworkGUI, image_to_bytes
        from sixdgs_torch.train.gs_trainer import render_gui_camera

        gui = NetworkGUI(args.ip, args.port)
        source_abs = os.path.abspath(model_cfg.source_path)
        _prev_pre_step = pre_step

        def pre_step(it, tr):
            if _prev_pre_step is not None:
                _prev_pre_step(it, tr)
            # drain viewer messages like the reference's train.py:59-90
            gui.try_connect()
            while gui.conn is not None:
                try:
                    cam, do_training, _, _, keep_alive, scaling = gui.receive()
                    img_bytes = None
                    if cam is not None:
                        img = render_gui_camera(
                            tr.state.scene, cam, tr.bg, tr.active_sh_degree,
                            scaling_modifier=scaling,
                        )
                        img_bytes = image_to_bytes(img.cpu().numpy())
                    gui.send(img_bytes, source_abs)
                    if do_training and (it < opt_cfg.iterations or not keep_alive):
                        break
                except Exception:
                    gui.disconnect()

    try:
        trainer.run(
            iterations=opt_cfg.iterations,
            log_every=args.log_every,
            save_iterations=save_iterations,
            model_path=model_path,
            callback=callback,
            chunk=args.chunk,
            rasterizer=args.rasterizer,
            checkpoint_iterations=args.checkpoint_iterations,
            first_iteration=first_iteration,
            pre_step=pre_step,
            **({"tiers": tuple(args.binning_tiers)} if args.binning_tiers else {}),
        )
    finally:
        if gui is not None:
            gui.close()
    writer.close()
    print(f"\nTraining complete in {time.time() - t_start:.1f}s.")
    return model_path


if __name__ == "__main__":
    main()
