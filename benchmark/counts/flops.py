"""Operations and bytes of the pose stack, counted from the configuration's
shapes, and the H100's peaks (NVIDIA's data sheet, SXM, dense).

The scorer's counts are the function's, not its padding: B1 needs
2 (P N d + P d^2) flops (q'' = q Wk^T, then the logits on the ray stream),
B2 2 (3 P N d + 3 P d^2) (the logits again, dfeats and A on the ray stream;
q'', dq and dWk). Bytes: each input read once, each output written once.
Its bound runs at the bf16 tensor-core rate over the products the
configuration's accuracy takes (3 for bf16_split3). ``mfu`` divides model
flops by the dense bf16 peak whatever precision the program runs.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12
RAY_IN = 141


def scorer_shape(config):
    """(P patches, N rays, d width) of one scorer call."""
    return (config["backbone"]["patch_grid"] ** 2, config["pose"]["ray_budget"],
            config["id_module"]["feature_dim"])


def b1_flops(p, n, d):
    return 2 * (p * n * d + p * d * d)


def b2_flops(p, n, d):
    return 2 * (3 * p * n * d + 3 * p * d * d)


def b1_bytes(p, n, d):
    """q, feats, Wk, bk, pmask, valid in; scores, m, s out (float32)."""
    return 4 * (p * d + n * d + d * d + d + p + n + n + 2 * p)


def b2_bytes(p, n, d):
    """q, feats, Wk, bk, pmask, valid, m, s, g in; dq, dfeats, dWk, dbk out."""
    return 4 * (2 * p * d + 2 * n * d + 2 * d * d + 2 * d + 3 * p + 2 * n)


def bound_s(flops, nbytes, products):
    """The least time of a call: operations at the bf16 rate over the
    products each float32-class product takes, or bytes at HBM's rate."""
    return max(flops * products / BF16_FLOPS, nbytes / HBM_BYTES)


def backbone_flops(config):
    bb = config["backbone"]
    if bb["type"] == "dino":
        d, f, t = bb["hidden_size"], bb["intermediate_size"], bb["patch_grid"] ** 2 + 1
        patch = 2 * (t - 1) * 3 * bb["patch_size"] ** 2 * d
        block = 2 * t * (3 * d * d + d * d + 2 * d * f) + 2 * 2 * t * t * d
        return patch + bb["num_hidden_layers"] * block
    c1, c2, c3, c4 = bb["encoder_channels"]
    side = bb["image_size"]
    convs = [(side, 3, c1), (side, c1, c1), (side // 2, c1, c2), (side // 2, c2, c2),
             (side // 4, c2, c3), (side // 4, c3, c3), (side // 8, c3, c4), (side // 8, c4, c4),
             (side // 8, c4, bb["descriptor_hidden"])]
    total = sum(2 * s * s * cin * cout * 9 for s, cin, cout in convs)
    return total + 2 * (side // 8) ** 2 * bb["descriptor_hidden"] * bb["descriptor_dim"]


def ray_mlp_flops(config):
    im, n = config["id_module"], config["pose"]["ray_budget"]
    h, d = im["ray_hidden"], im["feature_dim"]
    return 2 * n * (RAY_IN * h + h * h + (h + RAY_IN) * h + h * d)


def q_projection_flops(config):
    p, _, d = scorer_shape(config)
    return 2 * p * (d + 14) * d


def cam_up_flops(config):
    im = config["id_module"]
    c, g = im["feature_dim"], im["cam_up_grid"]
    total = 0
    for k in (5, 5, 5, 4):
        g -= k - 1
        total += 2 * g * g * c * c * k * k
    return total + 2 * (c * g * g * im["cam_up_hidden"] + im["cam_up_hidden"] * 3)


def image_flops(config):
    """One ``eval_image``: backbone, ray MLP over every ray, q-projection,
    B1, camera-up head."""
    return (backbone_flops(config) + ray_mlp_flops(config) + q_projection_flops(config)
            + b1_flops(*scorer_shape(config)) + cam_up_flops(config))


def step_flops(config):
    """One training step over cached features: the ray MLP once (forward
    and backward, 3x), and per image the q-projection and camera-up head
    (3x), B1 and B2."""
    per_image = (3 * q_projection_flops(config) + 3 * cam_up_flops(config)
                 + b1_flops(*scorer_shape(config)) + b2_flops(*scorer_shape(config)))
    return 3 * ray_mlp_flops(config) + config["pose"]["gradient_accumulation_steps"] * per_image
