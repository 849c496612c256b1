"""LPIPS perceptual metric: port of sixdgs_tpu/pose/lpips.py.

Counterpart of the reference's lpipsPyTorch (modules/lpips.py:8-36,
modules/networks.py): frozen VGG16 (or AlexNet) feature stages, per-channel
unit normalisation, squared differences weighted by the LPIPS 1x1 linear
layers, spatial mean, sum over stages. Parameters are a flat dict of
tensors under the JAX package's names (``conv{i}.w`` OIHW, ``conv{i}.b``,
``lin{i}.w``), so ``save_params`` and ``load_params`` read and write the
same npz in both packages. Convolutions run on ``F.conv2d`` in float32
without TF32 (the JAX package asks for the highest precision).

Weights are random (uncalibrated, ``init_params``) unless converted from
torchvision and LPIPS checkpoints (``convert_torch_lpips``); the metrics
app reports LPIPS as null without them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


# reference ScalingLayer constants (lpips)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

VGG16_CFG: List = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                   512, 512, 512, "M", 512, 512, 512, "M"]
# indices (in conv order) after which features are tapped: relu1_2, relu2_2,
# relu3_3, relu4_3, relu5_3
VGG_TAPS = (1, 3, 6, 9, 12)
VGG_CHANNELS = (64, 128, 256, 512, 512)

ALEX_SHAPES = ((64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3), (256, 384, 3, 3),
               (256, 256, 3, 3))
ALEX_CHANNELS = (64, 192, 384, 256, 256)


def _conv(x, params, i: int, stride: int = 1, padding: int = 1):
    return F.relu(F.conv2d(x, params[f"conv{i}.w"], params[f"conv{i}.b"], stride=stride,
                           padding=padding))


def vgg16_features(params: Dict, x: torch.Tensor) -> List[torch.Tensor]:
    """x: [3, H, W] -> the five tapped feature maps [C, h, w]."""
    feats = []
    x = x[None]
    conv_i = 0
    for item in VGG16_CFG:
        if len(feats) == len(VGG_TAPS):
            break  # the last pool feeds no tap (and empties a small image)
        if item == "M":
            x = F.max_pool2d(x, 2, 2)
        else:
            x = _conv(x, params, conv_i)
            if conv_i in VGG_TAPS:
                feats.append(x[0])
            conv_i += 1
    return feats


def alexnet_features(params: Dict, x: torch.Tensor) -> List[torch.Tensor]:
    x = _conv(x[None], params, 0, stride=4, padding=2)
    feats = [x[0]]
    x = _conv(F.max_pool2d(x, 3, 2), params, 1, padding=2)
    feats.append(x[0])
    x = F.max_pool2d(x, 3, 2)
    for i in (2, 3, 4):
        x = _conv(x, params, i)
        feats.append(x[0])
    return feats


def _normalize_channels(f, eps=1e-10):
    norm = torch.sqrt(torch.sum(torch.square(f), dim=0, keepdim=True))
    return f / (norm + eps)


def lpips_distance(params: Dict, img1: torch.Tensor, img2: torch.Tensor,
                   net: str = "vgg") -> torch.Tensor:
    """LPIPS between two [3, H, W] images in [0, 1] (0-d tensor)."""
    shift = torch.tensor(_SHIFT, dtype=img1.dtype, device=img1.device)[:, None, None]
    scale = torch.tensor(_SCALE, dtype=img1.dtype, device=img1.device)[:, None, None]

    # Reference quirk kept: lpipsPyTorch z-scores its input directly
    # (BaseNet.z_score, lpipsPyTorch/modules/networks.py:50-51) with
    # shift/scale constants made for [-1, 1], but metrics.py feeds it [0, 1]
    # images with no 2x - 1 rescale (metrics.py:76)
    def prep(x):
        return (x - shift) / scale

    feat_fn = vgg16_features if net == "vgg" else alexnet_features
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        f1 = feat_fn(params, prep(img1))
        f2 = feat_fn(params, prep(img2))
    total = 0.0
    for i, (a, b) in enumerate(zip(f1, f2)):
        d = torch.square(_normalize_channels(a) - _normalize_channels(b))  # [C, H, W]
        total = total + torch.mean(torch.sum(d * params[f"lin{i}.w"][:, None, None], dim=0))
    return total


@torch.no_grad()
def init_params(generator: Optional[torch.Generator] = None, net: str = "vgg",
                device="cuda") -> Dict[str, torch.Tensor]:
    """Random (uncalibrated) weights with the JAX package's shapes and
    distributions: convs N(0, 1/fan_in), zero biases, linear weights 1/C.
    Drawn on the CPU from the optional CPU ``generator``."""
    if net == "vgg":
        shapes, cin = [], 3
        for item in VGG16_CFG:
            if item != "M":
                shapes.append((item, cin, 3, 3))
                cin = item
        channels = VGG_CHANNELS
    else:
        shapes, channels = ALEX_SHAPES, ALEX_CHANNELS
    params = {}
    for i, s in enumerate(shapes):
        fan = s[1] * s[2] * s[3]
        params[f"conv{i}.w"] = torch.randn(s, generator=generator) / np.sqrt(fan)
        params[f"conv{i}.b"] = torch.zeros(s[0])
    for i, c in enumerate(channels):
        params[f"lin{i}.w"] = torch.ones(c) / c
    return {k: v.to(device) for k, v in params.items()}


def convert_torch_lpips(vgg_state_dict, lin_state_dict, net: str = "vgg"
                        ) -> Dict[str, torch.Tensor]:
    """Convert torchvision VGG16/AlexNet conv weights and LPIPS linear
    weights (CPU tensors).

    Takes either the bare ``.features`` sub-dict (keys ``N.weight``) or a
    full torchvision checkpoint (keys ``features.N.weight`` and
    ``classifier.*``; the classifier is ignored: only 4-dim conv weights in
    layer order are taken). ``lin_state_dict`` uses the richzhang naming
    ``lin{i}.model.1.weight`` (the file lpipsPyTorch/modules/utils.py
    downloads; ``lins.{i}.model.1.weight`` and its renamed in-memory form
    ``{i}.1.weight`` are also taken)."""

    def arr(t):
        t = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
        return torch.as_tensor(t, dtype=torch.float32)

    def layer_index(key: str) -> int:
        for part in key.split("."):
            if part.isdigit():
                return int(part)
        raise ValueError(f"no layer index in key {key!r}")

    conv_keys = [
        k for k in vgg_state_dict
        if k.endswith("weight") and arr(vgg_state_dict[k]).ndim == 4
        and (k.startswith("features.") or "." not in k.rsplit(".weight", 1)[0])
    ]
    params = {}
    for conv_i, k in enumerate(sorted(conv_keys, key=layer_index)):
        params[f"conv{conv_i}.w"] = arr(vgg_state_dict[k])
        params[f"conv{conv_i}.b"] = arr(vgg_state_dict[k.replace("weight", "bias")])
    for i in range(5):
        for name in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight",
                     f"{i}.1.weight"):
            if name in lin_state_dict:
                params[f"lin{i}.w"] = arr(lin_state_dict[name]).reshape(-1)
                break
        else:
            raise KeyError(f"LPIPS linear weight for stage {i} not found")
    return params


def save_params(path: str, params: Dict) -> None:
    """An npz under the JAX package's keys (its load_params reads it)."""
    np.savez(path, **{k: v.detach().to("cpu", torch.float32).numpy()
                      if isinstance(v, torch.Tensor) else np.asarray(v)
                      for k, v in params.items()})


def load_params(path: str, device="cuda") -> Dict[str, torch.Tensor]:
    with np.load(path) as data:
        return {k: torch.tensor(v, device=device) for k, v in data.items()}


def make_lpips(weights_path: str, net: str = "vgg", device="cuda"):
    """Callable lpips(img1, img2) from converted weights, without autograd."""
    params = load_params(weights_path, device=device)

    @torch.no_grad()
    def lpips(a, b):
        return lpips_distance(params, a, b, net=net)

    return lpips
