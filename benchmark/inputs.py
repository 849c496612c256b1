"""Inputs made from the seed: weights, the Gaussian scene, cameras, images.

Everything here is drawn from one ``torch.Generator`` on the run's device,
in a few large calls, so that the same seed gives the same inputs and the
set-up does not walk the host leaf by leaf. The program and the reference
get the same tensors: weights in their published layouts (the torch.hub
DINOv2 names, the superpoint_v1.pth names, the 6DGS id-module checkpoint
tree with dense weights [in, out]).
"""

from __future__ import annotations

import math

import numpy as np
import torch

RAY_IN = 141


def _fill(spec, gen, device):
    """``spec``: [(name, shape, (kind, a, b))] with kind "normal" (mean a,
    std b), "uniform" (low a, high b) or "zeros". Two draws in all."""
    sizes = {kind: sum(math.prod(s) for _, s, (k, *_r) in spec if k == kind)
             for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=gen, device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen, device=device)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, (kind, a, b) in spec:
        n = math.prod(shape)
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
            continue
        x = pools[kind][at[kind]:at[kind] + n].reshape(shape)
        at[kind] += n
        out[name] = a + b * x if kind == "normal" else a + (b - a) * x
    return out


def _dino_spec(bb):
    d, f = bb["hidden_size"], bb["intermediate_size"]
    p, grid = bb["patch_size"], bb["patch_grid"]
    small, ln = ("normal", 0.0, 0.02), ("normal", 1.0, 0.1)

    def dense(name, out_f, in_f):
        return [(name + ".weight", (out_f, in_f), ("normal", 0.0, in_f ** -0.5)),
                (name + ".bias", (out_f,), small)]

    spec = [("patch_embed.proj.weight", (d, 3, p, p), ("normal", 0.0, (3 * p * p) ** -0.5)),
            ("patch_embed.proj.bias", (d,), small),
            ("cls_token", (1, 1, d), small),
            ("pos_embed", (1, grid * grid + 1, d), small)]
    for i in range(bb["num_hidden_layers"]):
        b = f"blocks.{i}."
        spec += [(b + "norm1.weight", (d,), ln), (b + "norm1.bias", (d,), small)]
        spec += dense(b + "attn.qkv", 3 * d, d) + dense(b + "attn.proj", d, d)
        spec += [(b + "ls1.gamma", (d,), ("uniform", 0.1, 0.5)),
                 (b + "norm2.weight", (d,), ln), (b + "norm2.bias", (d,), small)]
        spec += dense(b + "mlp.fc1", f, d) + dense(b + "mlp.fc2", d, f)
        spec += [(b + "ls2.gamma", (d,), ("uniform", 0.1, 0.5))]
    return spec + [("norm.weight", (d,), ln), ("norm.bias", (d,), small)]


def _superpoint_spec(bb):
    c1, c2, c3, c4 = bb["encoder_channels"]
    convs = [("conv1a", 1, c1), ("conv1b", c1, c1), ("conv2a", c1, c2), ("conv2b", c2, c2),
             ("conv3a", c2, c3), ("conv3b", c3, c3), ("conv4a", c3, c4), ("conv4b", c4, c4),
             ("convDa", c4, bb["descriptor_hidden"])]
    spec = []
    for name, cin, cout in convs:
        spec += [(name + ".weight", (cout, cin, 3, 3), ("normal", 0.0, (2.0 / (9 * cin)) ** 0.5)),
                 (name + ".bias", (cout,), ("normal", 0.0, 0.02))]
    dh, dd = bb["descriptor_hidden"], bb["descriptor_dim"]
    return spec + [("convDb.weight", (dd, dh, 1, 1), ("normal", 0.0, dh ** -0.5)),
                   ("convDb.bias", (dd,), ("normal", 0.0, 0.02))]


def _id_module_spec(im):
    d, h, chead = im["feature_dim"], im["ray_hidden"], im["cam_up_hidden"]
    s = im["cam_up_grid"] - 15  # three valid 5 x 5 convolutions and one 4 x 4

    def dense(name, in_f, out_f, bound=None):
        bound = bound or in_f ** -0.5
        return [(name + "/w", (in_f, out_f), ("uniform", -bound, bound)),
                (name + "/b", (out_f,), ("uniform", -in_f ** -0.5, in_f ** -0.5))]

    def conv(name, c, k):
        bound = (c * k * k) ** -0.5
        return [(name + "/w", (c, c, k, k), ("uniform", -bound, bound)),
                (name + "/b", (c,), ("uniform", -bound, bound))]

    xavier = (6.0 / (2 * d + 14)) ** 0.5
    spec = (dense("ray_mlp/l1", RAY_IN, h) + dense("ray_mlp/l2", h, h)
            + dense("ray_mlp/l3", h + RAY_IN, h) + dense("ray_mlp/l4", h, d)
            + dense("attention/q", d + 14, d, xavier)
            + dense("attention/k", d, d, (3.0 / d) ** 0.5))
    for i in range(3):
        spec += conv(f"cam_up/conv1/{i}", d, 5)
    spec += conv("cam_up/conv2/0", d, 4)
    return spec + dense("cam_up/mlp1", d * s * s, chead) + dense("cam_up/mlp2", chead, 3)


def nest(flat):
    """{"a/b/0/w": t} -> nested dicts, digit-keyed levels as lists."""
    tree = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = val

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


def weights(config, gen, device):
    """(backbone weights by their published names, id-module leaves by
    their 6DGS checkpoint names "ray_mlp/l1/w")."""
    bb = config["backbone"]
    bspec = _dino_spec(bb) if bb["type"] == "dino" else _superpoint_spec(bb)
    return _fill(bspec, gen, device), _fill(_id_module_spec(config["id_module"]), gen, device)


def scene(config, gen, device):
    """The Gaussian scene's leaves (xyz, features_dc, features_rest,
    opacity, log scaling, rotation quaternion), every Gaussian live."""
    sc = config["scene"]
    n, coeffs = sc["gaussians"], (sc["sh_degree"] + 1) ** 2
    (lo_s, hi_s), (lo_o, hi_o) = sc["log_scale"], sc["opacity_logit"]
    return _fill([("xyz", (n, 3), ("normal", 0.0, sc["xyz_std"])),
                  ("features_dc", (n, 1, 3), ("normal", 0.0, sc["sh_dc_std"])),
                  ("features_rest", (n, coeffs - 1, 3), ("normal", 0.0, sc["sh_rest_std"])),
                  ("opacity", (n, 1), ("uniform", lo_o, hi_o)),
                  ("scaling", (n, 3), ("uniform", lo_s, hi_s)),
                  ("rotation", (n, 4), ("normal", 0.0, 1.0))], gen, device)


def ray_draws(config, gen, device):
    """The uniform draws that pick the ellipsoids and then the rays."""
    pose, n = config["pose"], config["scene"]["gaussians"]
    e = min(n, pose["max_ellipsoids"])
    select = torch.rand(n, generator=gen, device=device)
    return select, torch.rand(e * pose["ring_slots"] * pose["ring_points"],
                              generator=gen, device=device)


def ring_c2w(n, radius, height, phase=0.0):
    """[n, 4, 4] float32 camera-to-world poses on a ring around the origin,
    looking at it (OpenCV axes: z forward)."""
    out = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        ang = 2 * math.pi * i / n + phase
        pos = np.array([radius * math.cos(ang), height, radius * math.sin(ang)])
        z = -pos / np.linalg.norm(pos)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        out[i, :3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
        out[i, :3, 3] = pos
        out[i, 3, 3] = 1.0
    return out


def host_images(n, height, width, gen, device, dtype):
    """n host images [height, width, 3]: float32 in [0, 1) or uint8, drawn
    on the device one at a time (so the device holds one) and copied."""
    out = []
    for _ in range(n):
        if dtype == "uint8":
            x = torch.randint(0, 256, (height, width, 3), generator=gen, device=device,
                              dtype=torch.uint8)
        else:
            x = torch.rand((height, width, 3), generator=gen, device=device)
        out.append(x.cpu().numpy())
    return out


def host_masks(n, height, width, cover, gen, device):
    """n host foreground masks [height, width] bool: an ellipse each, its
    centre and radii drawn so that it covers about ``cover`` of the frame."""
    yy = torch.linspace(0.0, 1.0, height, device=device)[:, None]
    xx = torch.linspace(0.0, 1.0, width, device=device)[None, :]
    params = torch.rand((n, 4), generator=gen, device=device)
    out = []
    for cy, cx, ry, rx in params.tolist():
        r = math.sqrt(cover / math.pi)
        m = (((yy - (0.4 + 0.2 * cy)) / (r * (0.8 + 0.4 * ry))) ** 2
             + ((xx - (0.4 + 0.2 * cx)) / (r * (0.8 + 0.4 * rx))) ** 2) < 1.0
        out.append(m.cpu().numpy())
    return out
