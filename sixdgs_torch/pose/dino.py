"""DINOv2 ViT-S/14 as an ``nn.Module``.

Port of sixdgs_tpu/pose/dino.py, the frozen image backbone the reference
pulls from torch.hub (pose_estimation/backbone.py:14-16): ViT-S/14, embed
384, depth 12, heads 6, MLP ratio 4, LayerScale, pre-norm blocks,
LayerNorm eps 1e-6, exact GELU; the output of interest is
``x_norm_patchtokens``. The patch embedding keeps the hub checkpoint's conv
weight [D, 3, 14, 14] and runs as a reshape plus f32 matmul (the same map as
the stride-14 conv, without cuDNN's TF32). Weights are random
(``init_params``), carried over from the reference package's param dicts
by ``sixdgs_torch.weights.dino_from_numpy``, or loaded by ``load_params``:
a torch.hub checkpoint (``.pth``, the hub's key names) straight into
``DinoViT``, or an ``.npz`` of the JAX package's flat names
(``flatten_params`` writes one from a model).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

EMBED_DIM = 384
DEPTH = 12
NUM_HEADS = 6
PATCH = 14
MLP_RATIO = 4
LS_INIT = 1e-5  # LayerScale init
LN_EPS = 1e-6


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.ls1 = nn.Parameter(torch.full((dim,), LS_INIT))
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, MLP_RATIO * dim)
        self.fc2 = nn.Linear(MLP_RATIO * dim, dim)
        self.ls2 = nn.Parameter(torch.full((dim,), LS_INIT))

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        n, d = x.shape
        head = d // self.num_heads
        qkv = self.qkv(x).reshape(n, 3, self.num_heads, head).permute(1, 2, 0, 3)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [H, N, h]
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(head), dim=-1)
        out = (attn @ v).transpose(0, 1).reshape(n, d)
        return self.proj(out)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1 * self.attention(self.norm1(x))
        return x + self.ls2 * self.mlp(self.norm2(x))


class DinoViT(nn.Module):
    def __init__(self, embed_dim: int = EMBED_DIM, depth: int = DEPTH,
                 num_patches: int = 256, num_heads: Optional[int] = None):
        super().__init__()
        # ViT-S/14: 6 heads of 64; narrow test variants keep head_dim 64
        num_heads = num_heads or max(1, embed_dim // 64)
        self.patch_embed = nn.Conv2d(3, embed_dim, PATCH, stride=PATCH)
        self.cls_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1 + num_patches, embed_dim))
        self.blocks = nn.ModuleList([Block(embed_dim, num_heads) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward_features(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """DINOv2 forward for one image.

        Args:
            img: [3, H, W] normalized image; H, W divisible by 14.

        Returns:
            dict with "x_norm_patchtokens" [n_patches, D] and
            "x_norm_clstoken" [D].
        """
        c, h, w = img.shape
        gh, gw = h // PATCH, w // PATCH
        x = img.reshape(c, gh, PATCH, gw, PATCH).permute(1, 3, 0, 2, 4)
        x = x.reshape(gh * gw, c * PATCH * PATCH)
        wp = self.patch_embed.weight
        x = x @ wp.reshape(wp.shape[0], -1).T + self.patch_embed.bias

        x = torch.cat([self.cls_token, x], dim=0)  # [1+N, D]
        x = x + interpolate_pos_embed(self.pos_embed, gh, gw)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return {"x_norm_clstoken": x[0], "x_norm_patchtokens": x[1:]}


def interpolate_pos_embed(pos_embed: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """Bicubic-resample patch position embeddings to a gh x gw grid (DINOv2
    interpolates its 37x37 training grid at other resolutions). Antialiased,
    as jax.image.resize is by default."""
    n = pos_embed.shape[0] - 1
    side = int(round(math.sqrt(n)))
    if side * side != n:
        raise ValueError(f"pos_embed grid not square: {n}")
    if (gh, gw) == (side, side):
        return pos_embed
    patch_pe = pos_embed[1:].reshape(side, side, -1).permute(2, 0, 1)[None]
    resized = F.interpolate(patch_pe, size=(gh, gw), mode="bicubic",
                            antialias=True, align_corners=False)[0]
    return torch.cat([pos_embed[:1], resized.permute(1, 2, 0).reshape(gh * gw, -1)],
                     dim=0)


@torch.no_grad()
def init_params(generator: Optional[torch.Generator] = None,
                embed_dim: int = EMBED_DIM, depth: int = DEPTH,
                num_patches: int = 256, device="cuda") -> DinoViT:
    """Random weights with the reference package's distributions: patch,
    cls and pos embeddings N(0, 0.02^2); linear weights N(0, 1/fan_in), zero
    biases; LayerNorms identity; LayerScale 1e-5. Drawn on the CPU from the
    optional CPU ``generator``, then moved to ``device``."""
    model = DinoViT(embed_dim, depth, num_patches)

    def normal_(t, std):
        t.normal_(0.0, std, generator=generator)

    normal_(model.patch_embed.weight, 0.02)
    model.patch_embed.bias.zero_()
    normal_(model.cls_token, 0.02)
    normal_(model.pos_embed, 0.02)
    for blk in model.blocks:
        for lin in (blk.qkv, blk.proj, blk.fc1, blk.fc2):
            normal_(lin.weight, 1.0 / math.sqrt(lin.in_features))
            lin.bias.zero_()
    return model.to(device)


# ------------------------------------------------------------ weight loaders

# torch.hub dinov2_vits14 block keys -> DinoViT's
_HUB_BLOCK_KEYS = {
    "norm1.weight": "norm1.weight", "norm1.bias": "norm1.bias",
    "attn.qkv.weight": "qkv.weight", "attn.qkv.bias": "qkv.bias",
    "attn.proj.weight": "proj.weight", "attn.proj.bias": "proj.bias",
    "ls1.gamma": "ls1",
    "norm2.weight": "norm2.weight", "norm2.bias": "norm2.bias",
    "mlp.fc1.weight": "fc1.weight", "mlp.fc1.bias": "fc1.bias",
    "mlp.fc2.weight": "fc2.weight", "mlp.fc2.bias": "fc2.bias",
    "ls2.gamma": "ls2",
}


def convert_torch_state_dict(state_dict) -> Dict[str, torch.Tensor]:
    """A torch.hub dinov2_vits14 state dict -> ``DinoViT``'s state dict
    (the hub's ``mask_token`` is unused and dropped; blocks are taken by
    key presence, so shortened test dicts convert too)."""

    def t(name):
        return torch.as_tensor(np.asarray(state_dict[name].detach().cpu().numpy()
                                          if hasattr(state_dict[name], "detach")
                                          else state_dict[name]), dtype=torch.float32)

    dim = t("cls_token").numel()
    out = {
        "patch_embed.weight": t("patch_embed.proj.weight"),
        "patch_embed.bias": t("patch_embed.proj.bias"),
        "cls_token": t("cls_token").reshape(1, dim),
        "pos_embed": t("pos_embed").reshape(-1, dim),
        "norm.weight": t("norm.weight"),
        "norm.bias": t("norm.bias"),
    }
    i = 0
    while f"blocks.{i}.norm1.weight" in state_dict:
        for hub, ours in _HUB_BLOCK_KEYS.items():
            out[f"blocks.{i}.{ours}"] = t(f"blocks.{i}.{hub}")
        i += 1
    return out


def load_params(path_or_none: Optional[str], generator: Optional[torch.Generator] = None,
                device="cuda") -> DinoViT:
    """DINOv2 ViT-S/14 from converted weights, or random: an ``.npz`` of the
    JAX package's flat names, a torch checkpoint with the hub's key names
    (``.pth``, optionally under "model"), or with no path ``init_params``
    drawn from ``generator``."""
    if path_or_none is None:
        return init_params(generator, device=device)
    if path_or_none.endswith(".npz"):
        from sixdgs_torch.weights import dino_from_numpy

        with np.load(path_or_none) as data:
            return dino_from_numpy(unflatten_params(dict(data)), device=device)
    sd = torch.load(path_or_none, map_location="cpu")
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    sd = convert_torch_state_dict(sd)
    dim = sd["cls_token"].shape[1]
    depth = sum(1 for k in sd if k.endswith(".ls1"))
    model = DinoViT(dim, depth, num_patches=sd["pos_embed"].shape[0] - 1)
    model.load_state_dict(sd)
    return model.to(device)


def flatten_params(model: DinoViT) -> Dict[str, np.ndarray]:
    """A model as the JAX package's flat ``.npz`` names and layouts (patch
    embedding [14, 14, 3, D], dense weights [in, out]), which
    sixdgs_tpu.pose.dino.unflatten_params reads."""

    def a(x: torch.Tensor) -> np.ndarray:
        return x.detach().to("cpu", torch.float32).numpy().copy()

    flat = {
        "patch_embed.w": a(model.patch_embed.weight.permute(2, 3, 1, 0)),
        "patch_embed.b": a(model.patch_embed.bias),
        "cls_token": a(model.cls_token),
        "pos_embed": a(model.pos_embed),
        "norm.scale": a(model.norm.weight),
        "norm.bias": a(model.norm.bias),
    }
    for i, blk in enumerate(model.blocks):
        pre = f"blocks.{i}."
        for name in ("norm1", "norm2"):
            ln = getattr(blk, name)
            flat[pre + f"{name}.scale"] = a(ln.weight)
            flat[pre + f"{name}.bias"] = a(ln.bias)
        for name in ("qkv", "proj", "fc1", "fc2"):
            lin = getattr(blk, name)
            flat[pre + f"{name}.w"] = a(lin.weight.T)
            flat[pre + f"{name}.b"] = a(lin.bias)
        flat[pre + "ls1"] = a(blk.ls1)
        flat[pre + "ls2"] = a(blk.ls2)
    return flat


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict:
    """The JAX package's flat names -> its nested param dict, as numpy
    arrays (what ``weights.dino_from_numpy`` takes)."""
    params = {
        "patch_embed": {"w": flat["patch_embed.w"], "b": flat["patch_embed.b"]},
        "cls_token": flat["cls_token"],
        "pos_embed": flat["pos_embed"],
        "norm": {"scale": flat["norm.scale"], "bias": flat["norm.bias"]},
        "blocks": [],
    }
    i = 0
    while f"blocks.{i}.ls1" in flat:
        pre = f"blocks.{i}."
        blk = {}
        for name in ("norm1", "qkv", "proj", "norm2", "fc1", "fc2"):
            keys = ("scale", "bias") if name.startswith("norm") else ("w", "b")
            blk[name] = {leaf: flat[pre + f"{name}.{leaf}"] for leaf in keys}
        blk["ls1"] = flat[pre + "ls1"]
        blk["ls2"] = flat[pre + "ls2"]
        params["blocks"].append(blk)
        i += 1
    return params
