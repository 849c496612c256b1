"""Pose-stage configuration (copy of sixdgs_tpu/utils/config.py's
PoseEstimationConfig; the other configs arrive with the slices that use
them)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PoseEstimationConfig:
    """Pose-stage hyperparameters (hardcoded in the reference:
    pose_estimation/train.py:27-32, test.py:91, sampling.py:148,
    pretrain_eval_attention.py:166)."""

    n_iterations: int = 1500
    gradient_accumulation_steps: int = 32
    renewal_every_n_iterations: int = 10
    val_every_n_iterations: int = 20
    rays_to_output: int = 100
    quadricell_targets: int = 50
    max_ellipsoids: int = 1000
    knn_normals: int = 20
    ray_budget: int = 32768
    backbone_type: str = "dino"
    lock_backbone: bool = True
