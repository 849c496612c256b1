"""Pose-estimation evaluation.

Port of sixdgs_tpu/pose/evaluate.py (reference pose_estimation/test.py:
23-323): per-image score -> top-100 -> dedup -> LS solve -> rotation
assembly -> translation/angular errors; the eval-with-target mode replaces
predictions with target scores (the reference's training-time validation
quirk, :111-142) and reports recall@100 and the average score loss.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from sixdgs_torch.pose.id_module import score_image
from sixdgs_torch.pose.loss import distance_score_loss
from sixdgs_torch.pose.solver import angular_error_deg, solve_pose, translation_error
from sixdgs_torch.rays.engine import Rays
from sixdgs_torch.utils.profiling import count, span


@torch.no_grad()
@span("pose.eval_image")
def eval_image(
    dino_model,
    id_module,
    img: torch.Tensor,
    mask: torch.Tensor,
    gt_c2w: torch.Tensor,
    rays: Rays,
    k: int = 100,
    use_target_scores: bool = False,
    fused_attention: bool = False,
    backbone: str = "dino",
):
    """Score, solve and compare one image against ground truth.

    Returns the reference package's dict (c2w, translation_error,
    angular_error, loss_score, recall, mean_weight) plus the per-ray
    ``scores`` and the unit ``cam_up`` the solve used.
    """
    out = score_image(dino_model, id_module, img, mask, rays,
                      fused_attention=fused_attention, backbone=backbone)
    with span("pose.loss"):
        loss_score, target = distance_score_loss(
            out.scores, gt_c2w, rays.ori, rays.dir, rays.valid, out.n_patches
        )
        # recall@k: overlap between top-k predicted and top-k target rays (:122-124)
        neg_inf = float("-inf")
        pred_top = torch.topk(torch.where(rays.valid, out.scores, neg_inf), k).indices
        tgt_top = torch.topk(torch.where(rays.valid, target, neg_inf), k).indices
        recall = torch.mean(
            torch.any(pred_top[:, None] == tgt_top[None, :], dim=-1).to(torch.float32)
        )
    scores = target if use_target_scores else out.scores
    sol = solve_pose(scores, rays.ori, rays.dir, out.cam_up, rays.valid, k=k)
    t_err = translation_error(gt_c2w[:3, 3], sol.c2w[:3, 3])
    a_err = angular_error_deg(gt_c2w[:3, :3], sol.c2w[:3, :3])
    return {
        "c2w": sol.c2w,
        "translation_error": t_err,
        "angular_error": a_err,
        "loss_score": loss_score,
        "recall": recall,
        "mean_weight": torch.mean(sol.topk_weights),
        "scores": out.scores,
        "cam_up": out.cam_up,
    }


def prepare_image_mask(cam_info, target_hw=None):
    """Image (alpha-composited to white if RGBA) + mask (alpha > 0.3 or full)
    (pose_estimation/train.py:108-121); copy of
    sixdgs_tpu/pose/trainer.py::prepare_image_mask."""
    arr = cam_info.image_array().astype(np.float32) / 255.0
    if arr.ndim == 3 and arr.shape[-1] == 4:
        mask = arr[..., -1] > 0.3
        img = arr[..., :3] * arr[..., -1:] + (1.0 - arr[..., -1:])
    else:
        img = arr[..., :3] if arr.ndim == 3 else np.repeat(arr[..., None], 3, -1)
        mask = np.ones(img.shape[:2], bool)
    return img.astype(np.float32), mask


def test_pose_estimation(
    cam_infos: List,
    dino_model,
    id_module,
    rays: Rays,
    model_up,
    sequence_id: str = "",
    category_id: str = "",
    use_target_scores: bool = False,
    k: int = 100,
    backbone: str = "dino",
    fused_attention: bool = False,
    views: Optional[Sequence] = None,
):
    """Evaluate a list of CameraInfo (reference signature analogue) on the
    device the rays live on.

    ``views``, where given, holds each camera's prepared ``(img, mask)``
    (``prepare_image_mask``'s output), view i camera i's: it is read as it
    is and no view is prepared. Without it every view is prepared here.

    Returns (results, avg_translation_error, avg_angular_error,
    avg_loss_score, avg_recall, seconds_per_image) like test.py:323.
    """
    dev = rays.ori.device
    results = []
    t_errs, a_errs, losses, recalls = [], [], [], []
    start = time.time()
    for img_idx, info in enumerate(cam_infos):
        with span("val.view"):
            with span("val.prepare"):
                img, mask = prepare_image_mask(info) if views is None else views[img_idx]
                gt = info.c2w()
            with span("val.upload"):
                img_d = torch.tensor(img, device=dev)
                mask_d = torch.tensor(mask, device=dev)
                gt_d = torch.tensor(gt, dtype=torch.float32, device=dev)
            out = eval_image(
                dino_model, id_module, img_d, mask_d, gt_d, rays, k=k,
                use_target_scores=use_target_scores, fused_attention=fused_attention,
                backbone=backbone,
            )
            with span("val.read"):
                t_errs.append(float(out["translation_error"]))
                a_errs.append(float(out["angular_error"]))
                losses.append(float(out["loss_score"]))
                recalls.append(float(out["recall"]))
                results.append(
                    {
                        "sequence_id": sequence_id,
                        "category_name": category_id,
                        "frame_id": img_idx,
                        "loss": float(out["mean_weight"]),
                        "scores_loss": float(out["loss_score"]),
                        "recall": float(out["recall"]),
                        "total_optimization_time_in_ms": 0.0,
                        "pred_c2w": out["c2w"].cpu().numpy().tolist(),
                        "gt_c2w": gt.tolist(),
                    }
                )
                count("host.reads", 8)  # the eight float() and .cpu() reads above
    total = time.time() - start
    n = max(len(cam_infos), 1)
    return (
        results,
        float(np.mean(t_errs)) if t_errs else float("nan"),
        float(np.mean(a_errs)) if a_errs else float("nan"),
        float(np.mean(losses)) if losses else float("nan"),
        float(np.mean(recalls)) if recalls else float("nan"),
        total / n,
    )
