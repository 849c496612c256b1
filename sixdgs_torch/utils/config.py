"""Configuration dataclasses (copies of sixdgs_tpu/utils/config.py's
ModelConfig, OptimizationConfig and PoseEstimationConfig, with the
reference's fields and defaults). The CLI wiring and the cfg_args parser
come with the apps."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ModelConfig:
    """ModelParams parity (arguments/__init__.py:54-69)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = False
    fps_sampling: int = -1


@dataclass
class OptimizationConfig:
    """OptimizationParams parity (arguments/__init__.py:82-119)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002


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
