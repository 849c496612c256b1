"""Carry the reference package's parameter dicts into the port's modules.

The JAX package keeps its weights as nested dicts of arrays; a caller turns
them into numpy (``jax.tree.map(np.asarray, params)``) and hands them here.
Layouts: dense weights are [in, out] there and [out, in] in ``nn.Linear``;
the DINOv2 patch embedding is [14, 14, 3, D] there and [D, 3, 14, 14] in the
conv; the camera-up and SuperPoint conv weights are already OIHW in both.
Nothing here imports JAX.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from sixdgs_torch.pose.dino import DinoViT
from sixdgs_torch.pose.modules import Attention, CamUpHead, IdModule, RayMLP
from sixdgs_torch.pose.superpoint import SuperPoint


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


@torch.no_grad()
def _set(param: torch.Tensor, value: torch.Tensor) -> None:
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"shape {tuple(value.shape)} for a {tuple(param.shape)} parameter")
    param.copy_(value)


def _dense(lin: nn.Linear, p: Dict) -> None:
    _set(lin.weight, _t(p["w"]).T)
    _set(lin.bias, _t(p["b"]))


def _conv(conv: nn.Conv2d, p: Dict) -> None:
    _set(conv.weight, _t(p["w"]))
    _set(conv.bias, _t(p["b"]))


def _norm(ln: nn.LayerNorm, p: Dict) -> None:
    _set(ln.weight, _t(p["scale"]))
    _set(ln.bias, _t(p["bias"]))


def dino_from_numpy(params: Dict, device="cuda") -> DinoViT:
    """DinoViT from a sixdgs_tpu.pose.dino param dict of numpy arrays."""
    embed_dim = np.shape(params["patch_embed"]["w"])[-1]
    model = DinoViT(embed_dim, depth=len(params["blocks"]),
                    num_patches=np.shape(params["pos_embed"])[0] - 1)
    # [14, 14, 3, D] -> conv [D, 3, 14, 14]
    _set(model.patch_embed.weight, _t(params["patch_embed"]["w"]).permute(3, 2, 0, 1))
    _set(model.patch_embed.bias, _t(params["patch_embed"]["b"]))
    _set(model.cls_token, _t(params["cls_token"]))
    _set(model.pos_embed, _t(params["pos_embed"]))
    _norm(model.norm, params["norm"])
    for blk, p in zip(model.blocks, params["blocks"]):
        _norm(blk.norm1, p["norm1"])
        _dense(blk.qkv, p["qkv"])
        _dense(blk.proj, p["proj"])
        _set(blk.ls1, _t(p["ls1"]))
        _norm(blk.norm2, p["norm2"])
        _dense(blk.fc1, p["fc1"])
        _dense(blk.fc2, p["fc2"])
        _set(blk.ls2, _t(p["ls2"]))
    return model.to(device)


def superpoint_from_numpy(params: Dict, device="cuda") -> SuperPoint:
    """SuperPoint from a sixdgs_tpu.pose.superpoint param dict of numpy
    arrays ({name: {"w": OIHW, "b"}}; conv1a already 3 channels wide)."""
    model = SuperPoint()
    for name, p in params.items():
        _conv(getattr(model, name), p)
    return model.to(device)


def id_module_from_numpy(params: Dict, device="cuda") -> IdModule:
    """IdModule from a sixdgs_tpu.pose.modules.init_id_module param dict of
    numpy arrays."""
    rm, att, cu = params["ray_mlp"], params["attention"], params["cam_up"]
    ray_mlp = RayMLP(fea_output=np.shape(rm["l4"]["w"])[1],
                     featureC=np.shape(rm["l1"]["w"])[1])
    for name in ("l1", "l2", "l3", "l4"):
        _dense(getattr(ray_mlp, name), rm[name])

    img_fea, embed = np.shape(att["q"]["w"])
    attention = Attention(ray_fea=np.shape(att["k"]["w"])[0], img_fea=img_fea,
                          embed=embed)
    _dense(attention.q, att["q"])
    _dense(attention.k, att["k"])

    channels = np.shape(cu["conv1"][0]["w"])[0]
    mlp_in, feature_c = np.shape(cu["mlp1"]["w"])
    s = math.isqrt(mlp_in // channels)
    cam_up = CamUpHead(channels, fea_output=np.shape(cu["mlp2"]["w"])[1],
                       featureC=feature_c, grid=s + 3 * 4 + 3)
    for conv, p in zip((*cam_up.conv1, *cam_up.conv2), (*cu["conv1"], *cu["conv2"])):
        _conv(conv, p)
    _dense(cam_up.mlp1, cu["mlp1"])
    _dense(cam_up.mlp2, cu["mlp2"])
    return IdModule(ray_mlp, attention, cam_up).to(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _dense_np(lin: nn.Linear) -> Dict:
    return {"w": _np(lin.weight).T.copy(), "b": _np(lin.bias)}


def _conv_np(conv: nn.Conv2d) -> Dict:
    return {"w": _np(conv.weight), "b": _np(conv.bias)}


def id_module_to_numpy(module: IdModule) -> Dict:
    """The inverse of ``id_module_from_numpy``: an IdModule as a
    sixdgs_tpu.pose.modules.init_id_module param dict of numpy arrays
    (dense weights [in, out], convolutions OIHW)."""
    rm, att, cu = module.ray_mlp, module.attention, module.cam_up
    return {
        "ray_mlp": {name: _dense_np(getattr(rm, name)) for name in ("l1", "l2", "l3", "l4")},
        "attention": {"q": _dense_np(att.q), "k": _dense_np(att.k)},
        "cam_up": {
            "conv1": [_conv_np(c) for c in cu.conv1],
            "conv2": [_conv_np(c) for c in cu.conv2],
            "mlp1": _dense_np(cu.mlp1),
            "mlp2": _dense_np(cu.mlp2),
        },
    }
