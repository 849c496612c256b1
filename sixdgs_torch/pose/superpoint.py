"""SuperPoint descriptor backbone (the alternative to DINOv2) as an
``nn.Module``.

Port of sixdgs_tpu/pose/superpoint.py (reference
pose_estimation/superpoint.py:4-89): the VGG-style shared encoder (eight
3x3 convs, ReLU, three 2x2 max-pools) and the descriptor head (3x3 conv to
256, ReLU, 1x1 conv), descriptors L2-normalised over channels at stride 8;
the first conv is widened to 3 input channels by repeating its weight
(the reference's increase_input_channels, :58-63). Selected with
``backbone="superpoint"``: a 28 x 28 grid of 256-dim descriptors at the
224 input.

The parameter names are the superpoint_v1.pth checkpoint's (``conv1a`` ...
``convDb``), so ``convert_torch_state_dict`` loads a hub state dict
straight into the module; ``load_params`` reads the JAX package's flat npz
(``"<name>.w"``, ``"<name>.b"``) and ``flatten_params`` writes one.
Weights are random otherwise (``init_params``). Convolutions run in float32
without TF32 (cuDNN's flags are set for the block).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


ENC = [(3, 64), (64, 64), (64, 64), (64, 64), (64, 128), (128, 128), (128, 128),
       (128, 128)]
NAMES = ["conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b"]
HEAD = [("convDa", 128, 256, 3), ("convDb", 256, 256, 1)]
FEATURE_DIM = 256


class SuperPoint(nn.Module):
    """Shared encoder and descriptor head of SuperPoint v1."""

    def __init__(self):
        super().__init__()
        for name, (cin, cout) in zip(NAMES, ENC):
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
        for name, cin, cout, k in HEAD:
            setattr(self, name, nn.Conv2d(cin, cout, k, padding=k // 2))

    def forward_features(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """img [3, H, W] -> {"x_norm_patchtokens": [H/8 * W/8, 256]}."""
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            x = img[None]
            for i, name in enumerate(NAMES):
                x = F.relu(getattr(self, name)(x))
                if i in (1, 3, 5):  # after conv1b, conv2b, conv3b
                    x = F.max_pool2d(x, 2, 2)
            desc = self.convDb(F.relu(self.convDa(x)))[0]
        desc = desc / torch.linalg.norm(desc, dim=0, keepdim=True)
        c, h, w = desc.shape
        return {"x_norm_patchtokens": desc.permute(1, 2, 0).reshape(h * w, c)}


@torch.no_grad()
def init_params(generator: Optional[torch.Generator] = None, device="cuda") -> SuperPoint:
    """Random weights with the JAX package's distributions: each conv
    N(0, 1/fan_in) (convDb N(0, 1/256)), zero biases. Drawn on the CPU from
    the optional CPU ``generator``, then moved to ``device``."""
    model = SuperPoint()
    for name in NAMES + [h[0] for h in HEAD]:
        conv = getattr(model, name)
        fan = conv.weight[0].numel()
        std = 1.0 / 16.0 if name == "convDb" else 1.0 / math.sqrt(fan)
        conv.weight.normal_(0.0, std, generator=generator)
        conv.bias.zero_()
    return model.to(device)


def convert_torch_state_dict(state_dict) -> Dict[str, torch.Tensor]:
    """A superpoint_v1.pth state dict -> ``SuperPoint``'s state dict: the
    encoder and descriptor head (the detector head is dropped), conv1a
    widened from 1 to 3 input channels."""

    def t(name):
        v = state_dict[name]
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        return torch.as_tensor(v, dtype=torch.float32)

    out = {}
    for name in NAMES + [h[0] for h in HEAD]:
        w = t(f"{name}.weight")
        if name == "conv1a" and w.shape[1] == 1:
            w = w.expand(w.shape[0], 3, *w.shape[2:]).contiguous()
        out[f"{name}.weight"] = w
        out[f"{name}.bias"] = t(f"{name}.bias")
    return out


def flatten_params(model: SuperPoint) -> Dict[str, np.ndarray]:
    """A model as the JAX package's flat npz names (``"<name>.w"`` OIHW,
    ``"<name>.b"``), which its pose_eval --superpoint_weights reads."""
    flat = {}
    for name in NAMES + [h[0] for h in HEAD]:
        conv = getattr(model, name)
        flat[f"{name}.w"] = conv.weight.detach().to("cpu", torch.float32).numpy().copy()
        flat[f"{name}.b"] = conv.bias.detach().to("cpu", torch.float32).numpy().copy()
    return flat


def load_params(path: str, device="cuda") -> SuperPoint:
    """``SuperPoint`` from a flat npz of the JAX package's names."""
    from sixdgs_torch.weights import superpoint_from_numpy

    with np.load(path) as data:
        flat = dict(data)
    names = sorted({k.rsplit(".", 1)[0] for k in flat})
    return superpoint_from_numpy(
        {n: {"w": flat[f"{n}.w"], "b": flat[f"{n}.b"]} for n in names}, device=device)
