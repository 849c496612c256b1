"""Backbone wrapper: preprocessing, DINO features, positional encoding, mask.

Port of sixdgs_tpu/pose/backbone.py (reference
pose_estimation/backbone.py:34-139):
  * image: resize shorter side to 256 (bicubic, antialias) -> center-crop 224
    -> ImageNet normalize,
  * mask: resize 256 (bilinear) -> crop 224 -> resize to the 16x16 patch grid
    -> threshold 0.1,
  * 14-dim 2D positional encoding: raw xy + sin/cos at 3 octaves,
  * features: DINOv2 x_norm_patchtokens on the 16x16 grid (384-dim), or
    SuperPoint's L2-normalised descriptors on the 28x28 grid (256-dim).

Both resizes use ``F.interpolate(..., antialias=True, align_corners=False)``,
which matches jax.image.resize with antialias; torch's default
(antialias=False) does not. All 256 patches are kept and the patch mask is
returned, as in the reference package.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sixdgs_torch.utils.profiling import span

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RESIZE = 256
CROP = 224
PATCH_GRID = 16  # 224 / 14 (DINOv2)
PATCH_GRID_SP = 28  # 224 / 8 (SuperPoint stride-8 descriptors)
NUM_PATCHES = PATCH_GRID * PATCH_GRID
PE_DIM = 14
FEATURE_DIM = 384


def _resize_shorter(img: torch.Tensor, target: int, mode: str) -> torch.Tensor:
    """img [C, H, W] -> shorter side == target, aspect kept."""
    h, w = img.shape[1], img.shape[2]
    if h < w:
        nh, nw = target, max(1, round(target * w / h))
    else:
        nh, nw = max(1, round(target * h / w)), target
    return _resize(img, nh, nw, mode)


def _resize(img: torch.Tensor, nh: int, nw: int, mode: str) -> torch.Tensor:
    return F.interpolate(img[None], size=(nh, nw), mode=mode, antialias=True,
                         align_corners=False)[0]


def _center_crop(img: torch.Tensor, size: int) -> torch.Tensor:
    h, w = img.shape[1], img.shape[2]
    top = (h - size) // 2
    left = (w - size) // 2
    return img[:, top : top + size, left : left + size]


def preprocess_image(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] in [0,1] -> normalized [3, 224, 224]."""
    x = _resize_shorter(img.permute(2, 0, 1), RESIZE, "bicubic")
    x = _center_crop(x, CROP)
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean[:, None, None]) / std[:, None, None]


def preprocess_mask(mask: torch.Tensor, grid: int = PATCH_GRID) -> torch.Tensor:
    """[H, W] bool/float -> [grid, grid] bool patch mask (threshold 0.1)."""
    m = mask.to(torch.float32)[None]
    m = _resize_shorter(m, RESIZE, "bilinear")
    m = _center_crop(m, CROP)
    m = _resize(m, grid, grid, "bilinear")
    return m[0] > 0.1


@functools.lru_cache(maxsize=4)
def _position_encoding_np(grid: int, freqs: int):
    lin = np.linspace(-1.0, 1.0, grid, dtype=np.float32)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    positions = np.stack([yy, xx], axis=-1).reshape(-1, 2)  # [N, 2]
    bands = 2.0 ** np.arange(freqs, dtype=np.float32)
    pts = (positions[..., None] * bands).reshape(positions.shape[0], -1)  # [N, 2F]
    return np.concatenate([positions, np.sin(pts), np.cos(pts)], axis=-1)  # [N, 2+4F]


def image_position_encoding(grid: int = PATCH_GRID, freqs: int = 3,
                            device="cuda") -> torch.Tensor:
    """[grid*grid, 14] positional encoding (backbone.py:116-139)."""
    return torch.tensor(_position_encoding_np(grid, freqs), device=device)


@span("pose.backbone")
def backbone_features(
    dino_model,
    img: torch.Tensor,
    mask: torch.Tensor,
    backbone: str = "dino",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full backbone forward.

    Args:
        dino_model: the backbone module (pose.dino.DinoViT or
            pose.superpoint.SuperPoint; the reference selects with
            backbone_type, and both share the resize-256/crop-224/ImageNet
            preprocessing).
        img: [H, W, 3] float image in [0, 1].
        mask: [H, W] foreground mask.
        backbone: "dino" (16x16 grid, 384-dim) or "superpoint" (28x28
            grid, 256-dim L2-normalised descriptors).

    Returns:
        (features_with_pe [G*G, D+14], patch_mask [G*G] bool,
         feature_map [D, G, G]).
    """
    if backbone not in ("dino", "superpoint"):
        raise ValueError(f"backbone must be 'dino' or 'superpoint', got {backbone!r}")
    grid = PATCH_GRID_SP if backbone == "superpoint" else PATCH_GRID
    # two preprocessing spans, so that the device gets its work in this order
    with span("pose.preprocess"):
        x = preprocess_image(img)
    feats = dino_model.forward_features(x)["x_norm_patchtokens"]
    with span("pose.preprocess"):
        patch_mask = preprocess_mask(mask, grid).reshape(-1)
    pe = image_position_encoding(grid, device=feats.device).to(feats.dtype)
    feats_pe = torch.cat([feats, pe], dim=-1)  # [G*G, D+14]
    fmap = feats.reshape(grid, grid, feats.shape[-1]).permute(2, 0, 1)
    return feats_pe, patch_mask, fmap
