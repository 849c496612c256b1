"""Plain reference of DINOv2 ViT-S/14 (arXiv:2304.07193) as the 6DGS pose
stage uses it: ``x_norm_patchtokens`` of a normalised 224 x 224 crop.

Weights are read by the torch.hub ``dinov2_vits14`` key names. 12 pre-norm
blocks of width 384 (6 heads of 64, MLP 1536, exact GELU, LayerScale,
LayerNorm eps 1e-6), a stride-14 patch embedding written as a product over
the 14 x 14 x 3 patches. Departure, stated in the configuration: the
position table is held at the 16 x 16 grid of the crop, so no resampling.
Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.pose_common import mm

GRID = 16


def _lin(x, w, name, dt):
    return mm(x, w[name + ".weight"].T, dt) + w[name + ".bias"]


def _ln(x, w, name):
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"], w[name + ".bias"], 1e-6)


def features(w, x, dt=torch.float32):
    """[3, 224, 224] -> [256, width] normalised patch tokens; the width
    (384), heads of 64 and depth (12) are read from the weights."""
    n, dim = GRID * GRID, w["cls_token"].numel()
    heads = max(1, dim // 64)
    patches = x.reshape(3, GRID, 14, GRID, 14).permute(1, 3, 0, 2, 4).reshape(n, -1)
    pw = w["patch_embed.proj.weight"]
    t = mm(patches, pw.reshape(pw.shape[0], -1).T, dt) + w["patch_embed.proj.bias"]
    t = torch.cat([w["cls_token"].reshape(1, dim), t]) + w["pos_embed"].reshape(n + 1, dim)
    for i in range(sum(k.endswith("ls1.gamma") for k in w)):
        b = f"blocks.{i}."
        h = _ln(t, w, b + "norm1")
        qkv = _lin(h, w, b + "attn.qkv", dt).reshape(n + 1, 3, heads, dim // heads)
        q, k, v = qkv.permute(1, 2, 0, 3)
        a = torch.softmax(mm(q, k.transpose(-1, -2), dt) / (dim // heads) ** 0.5, -1)
        h = mm(a, v, dt).transpose(0, 1).reshape(n + 1, dim)
        t = t + w[b + "ls1.gamma"] * _lin(h, w, b + "attn.proj", dt)
        h = F.gelu(_lin(_ln(t, w, b + "norm2"), w, b + "mlp.fc1", dt))
        t = t + w[b + "ls2.gamma"] * _lin(h, w, b + "mlp.fc2", dt)
    return _ln(t, w, "norm")[1:]
