"""Trainable pose modules: ray featurizer, cross-attention scorer, camera-up
head, as ``nn.Module``s with the reference package's initial distributions.

Port of sixdgs_tpu/pose/modules.py. Parity references:
  * RayPreprocessor (pose_estimation/ray_preprocessor.py:11-46):
    PE(pos 8, view 8, rgb 6) -> 141-dim input; Linear 141->512->512, skip
    concat, 653->512->384; ReLU between.
  * MultiHeadAttention (pose_estimation/our_multihead_attention.py:45-79):
    single head, Q: 398->384 (img feat + 14 PE), K: 384->384, xavier-uniform
    weights / zero bias, scores = softmax(QK^T / sqrt(384)) over rays.
  * CameraDirectionPredictor (pose_estimation/camera_direction_network.py:7-90):
    3x conv5x5 valid + 1x conv4x4 valid, 384ch, then MLP 384->256->3.

Weights are drawn on the CPU from an optional CPU ``torch.Generator`` and
then moved to ``device``, so one seed gives the same weights on every
device. The valid convolutions run as im2col plus an f32 matmul, which keeps
them out of cuDNN, whose float32 convolutions default to TF32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

RAY_PE = {"pospe": 8, "viewpe": 8, "rgbpe": 6}
RAY_IN_DIM = 9 + 2 * 3 * (RAY_PE["pospe"] + RAY_PE["viewpe"] + RAY_PE["rgbpe"])  # 141
RAY_HIDDEN = 512
FEATURE_DIM = 384
IMG_FEAT_DIM = FEATURE_DIM + 14


@torch.no_grad()
def _torch_init_(layer: nn.Module, generator) -> None:
    """torch.nn.Linear / Conv2d default: kaiming-uniform(a=sqrt5), i.e.
    U(+-1/sqrt(fan_in)) for weight and bias."""
    bound = 1.0 / math.sqrt(layer.weight[0].numel())
    layer.weight.uniform_(-bound, bound, generator=generator)
    layer.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def _xavier_init_(lin: nn.Linear, generator) -> None:
    fan_out, fan_in = lin.weight.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    lin.weight.uniform_(-bound, bound, generator=generator)
    lin.bias.zero_()


def positional_encoding(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """sin/cos PE (ray_preprocessor.py:3-9)."""
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * bands).reshape(*x.shape[:-1], freqs * x.shape[-1])
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


# ----------------------------------------------------------------- ray MLP


class RayMLP(nn.Module):
    """[N,3]x3 -> [N, fea_output] ray features."""

    def __init__(self, fea_output: int = FEATURE_DIM, featureC: int = RAY_HIDDEN):
        super().__init__()
        self.l1 = nn.Linear(RAY_IN_DIM, featureC)
        self.l2 = nn.Linear(featureC, featureC)
        self.l3 = nn.Linear(featureC + RAY_IN_DIM, featureC)
        self.l4 = nn.Linear(featureC, fea_output)

    def forward(self, ori, direction, rgb):
        x = torch.cat([ori, direction, rgb,
                       positional_encoding(ori, RAY_PE["pospe"]),
                       positional_encoding(direction, RAY_PE["viewpe"]),
                       positional_encoding(rgb, RAY_PE["rgbpe"])], dim=-1)
        h = F.relu(self.l1(x))
        h = F.relu(self.l2(h))
        h = F.relu(self.l3(torch.cat([h, x], dim=-1)))
        return self.l4(h)


def init_ray_mlp(generator=None, fea_output: int = FEATURE_DIM,
                 featureC: int = RAY_HIDDEN, device="cuda") -> RayMLP:
    mlp = RayMLP(fea_output, featureC)
    for lin in (mlp.l1, mlp.l2, mlp.l3, mlp.l4):
        _torch_init_(lin, generator)
    return mlp.to(device)


# --------------------------------------------------------------- attention


class Attention(nn.Module):
    """Single-head patches x rays attention projections."""

    def __init__(self, ray_fea: int = FEATURE_DIM, img_fea: int = IMG_FEAT_DIM,
                 embed: int = FEATURE_DIM):
        super().__init__()
        self.q = nn.Linear(img_fea, embed)
        self.k = nn.Linear(ray_fea, embed)


def init_attention(generator=None, ray_fea: int = FEATURE_DIM,
                   img_fea: int = IMG_FEAT_DIM, embed: int = FEATURE_DIM,
                   device="cuda") -> Attention:
    att = Attention(ray_fea, img_fea, embed)
    _xavier_init_(att.q, generator)
    _xavier_init_(att.k, generator)
    return att.to(device)


def attention_scores(attention: Attention, img_features, ray_features, ray_valid):
    """softmax(QK^T/sqrt(d)) over rays, padded rays masked to -9e15
    (our_multihead_attention.py:4-12 masked_fill parity).

    Returns the [n_patches, n_rays] attention map.
    """
    q = attention.q(img_features)
    k = attention.k(ray_features)
    logits = (q @ k.T) / math.sqrt(q.shape[-1])
    logits = torch.where(ray_valid[None, :], logits, torch.full_like(logits, -9e15))
    return torch.softmax(logits, dim=-1)


# ------------------------------------------------------------ camera-up head


def _conv_valid(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """x [B, C, H, W] -> [B, O, H-kh+1, W-kw+1], VALID padding: the batch's
    im2col columns side by side in one f32 matmul (at B = 1, views of the
    image's own columns)."""
    o, _, kh, kw = conv.weight.shape
    b, hout, wout = x.shape[0], x.shape[2] - kh + 1, x.shape[3] - kw + 1
    cols = F.unfold(x, (kh, kw))  # [B, C*kh*kw, hout*wout]
    cols = cols.transpose(0, 1).reshape(cols.shape[1], -1)  # [C*kh*kw, B*hout*wout]
    out = conv.weight.reshape(o, -1) @ cols + conv.bias[:, None]
    return out.reshape(o, b, hout, wout).transpose(0, 1)


class CamUpHead(nn.Module):
    """[C, G, G] -> [3] unnormalized up direction, or a batch [B, C, G, G]
    -> [B, 3]. Grid 16 (DINO) reduces 16->4->1 so the MLP sees [channels];
    the residual spatial dims are flattened C-major like the reference's
    conv2_output.view(B, -1)."""

    def __init__(self, channels: int = FEATURE_DIM, fea_output: int = 3,
                 featureC: int = 256, grid: int = 16):
        super().__init__()
        s = grid - 3 * 4 - 3  # three valid 5x5 convs then one valid 4x4
        if s < 1:
            raise ValueError(f"grid {grid} too small for the camera-up convs")
        self.conv1 = nn.ModuleList([nn.Conv2d(channels, channels, 5) for _ in range(3)])
        self.conv2 = nn.ModuleList([nn.Conv2d(channels, channels, 4)])
        self.mlp1 = nn.Linear(channels * s * s, featureC)
        self.mlp2 = nn.Linear(featureC, fea_output)

    def forward(self, feature_map):
        batched = feature_map.dim() == 4
        x = feature_map if batched else feature_map[None]
        for conv in (*self.conv1, *self.conv2):
            x = F.relu(_conv_valid(x, conv))
        # one image keeps its vector MLP (the pose request's launches)
        h = F.relu(self.mlp1(x.reshape(x.shape[0], -1) if batched else x.reshape(-1)))
        return self.mlp2(h)


def init_cam_up(generator=None, channels: int = FEATURE_DIM, fea_output: int = 3,
                featureC: int = 256, grid: int = 16, device="cuda") -> CamUpHead:
    head = CamUpHead(channels, fea_output, featureC, grid)
    for layer in (*head.conv1, *head.conv2, head.mlp1, head.mlp2):
        _torch_init_(layer, generator)
    return head.to(device)


# --------------------------------------------------------------- id module


class IdModule(nn.Module):
    """dict(ray_mlp, attention, cam_up) of the reference package as one
    module."""

    def __init__(self, ray_mlp: RayMLP, attention: Attention, cam_up: CamUpHead):
        super().__init__()
        self.ray_mlp = ray_mlp
        self.attention = attention
        self.cam_up = cam_up


def init_id_module(generator: Optional[torch.Generator] = None,
                   feature_dim: int = FEATURE_DIM, grid: int = 16,
                   device="cuda") -> IdModule:
    """feature_dim: backbone token dim (384 for DINOv2-S; smaller in tests).
    grid: backbone patch grid (16 for DINO)."""
    return IdModule(
        init_ray_mlp(generator, fea_output=feature_dim, device=device),
        init_attention(generator, ray_fea=feature_dim, img_fea=feature_dim + 14,
                       embed=feature_dim, device=device),
        init_cam_up(generator, channels=feature_dim, grid=grid, device=device),
    )
