"""Adaptive density control: clone / split / prune as pure host functions
(copy of sixdgs_tpu/train/densify.py; host numpy, so the same generator
seed gives the same split samples in both packages).

Behavior parity with the reference's scene/gaussian_model.py:539-626 and the
schedule in train.py:153-179. Run at the (infrequent) densification events;
the caller re-pads the returned arrays into a capacity bucket.

Optimizer-state surgery parity (gaussian_model.py:422-507): kept Gaussians
carry their Adam (m, v); new (cloned/split) ones start at zero.

Every exp and log here goes through ``exp32`` / ``log32`` (float64, rounded
once), so that a densification splits, clones and prunes the same on every
host (ops/transforms.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from sixdgs_torch.ops.transforms import exp32, log32, quat_to_rotmat

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation")


def _gather(d: Dict[str, np.ndarray], mask_or_idx) -> Dict[str, np.ndarray]:
    return {k: v[mask_or_idx] for k, v in d.items()}


def _concat(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: np.concatenate([a[k], b[k]], axis=0) for k in a}


def _zeros_like(d: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
    return {k: np.zeros((n,) + v.shape[1:], v.dtype) for k, v in d.items()}


def _rotmats(quats: np.ndarray) -> np.ndarray:
    return quat_to_rotmat(torch.tensor(quats)).numpy()


def densify_and_prune(
    params: Dict[str, np.ndarray],
    adam_m: Dict[str, np.ndarray],
    adam_v: Dict[str, np.ndarray],
    grads: np.ndarray,
    max_radii2d: np.ndarray,
    *,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: int | None,
    percent_dense: float,
    rng: np.random.Generator,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], Dict[str, np.ndarray], np.ndarray]:
    """One densification event over live (unpadded) Gaussians.

    Args:
        params / adam_m / adam_v: dicts of [N, ...] arrays (live only).
        grads: [N] averaged screen-space gradient norms (accum / denom, NaN->0).
        max_radii2d: [N] max screen radii so far.

    Returns:
        (params', adam_m', adam_v', max_radii2d'). Stats accumulators reset to
        zero is the caller's job (densification_postfix resets them,
        gaussian_model.py:535-537).
    """
    grads = np.nan_to_num(grads, nan=0.0)
    scaling = exp32(params["scaling"])

    # ---- clone (gaussian_model.py:583-608): small gaussians under-reconstructing
    clone_mask = (grads >= max_grad) & (scaling.max(axis=1) <= percent_dense * extent)
    cloned = _gather(params, clone_mask)
    n0 = params["xyz"].shape[0]

    params = _concat(params, cloned)
    adam_m = _concat(adam_m, _zeros_like(adam_m, cloned["xyz"].shape[0]))
    adam_v = _concat(adam_v, _zeros_like(adam_v, cloned["xyz"].shape[0]))
    max_radii2d = np.concatenate([max_radii2d, np.zeros(cloned["xyz"].shape[0])])

    # ---- split (gaussian_model.py:539-581): big gaussians over-reconstructing
    N = 2
    n1 = params["xyz"].shape[0]
    padded_grad = np.zeros(n1)
    padded_grad[:n0] = grads
    scaling1 = exp32(params["scaling"])
    split_mask = (padded_grad >= max_grad) & (
        scaling1.max(axis=1) > percent_dense * extent
    )
    sel = _gather(params, split_mask)
    n_split = sel["xyz"].shape[0]
    if n_split:
        stds = exp32(sel["scaling"])  # [S, 3]
        stds_rep = np.tile(stds, (N, 1))
        samples = rng.normal(0.0, 1.0, size=stds_rep.shape).astype(np.float32) * stds_rep
        rots = np.tile(_rotmats(sel["rotation"]), (N, 1, 1))
        new_xyz = np.einsum("nij,nj->ni", rots, samples) + np.tile(sel["xyz"], (N, 1))
        new = {
            "xyz": new_xyz.astype(np.float32),
            "features_dc": np.tile(sel["features_dc"], (N, 1, 1)),
            "features_rest": np.tile(sel["features_rest"], (N, 1, 1)),
            "opacity": np.tile(sel["opacity"], (N, 1)),
            "scaling": log32(stds_rep / (0.8 * N)),
            "rotation": np.tile(sel["rotation"], (N, 1)),
        }
        params = _concat(params, new)
        adam_m = _concat(adam_m, _zeros_like(adam_m, N * n_split))
        adam_v = _concat(adam_v, _zeros_like(adam_v, N * n_split))
        max_radii2d = np.concatenate([max_radii2d, np.zeros(N * n_split)])
        # prune the originals that were split
        keep = np.concatenate([~split_mask, np.ones(N * n_split, bool)])
        params = _gather(params, keep)
        adam_m = _gather(adam_m, keep)
        adam_v = _gather(adam_v, keep)
        max_radii2d = max_radii2d[keep]

    # ---- prune (gaussian_model.py:610-626)
    opacity = 1.0 / (1.0 + exp32(-params["opacity"][:, 0]))
    prune_mask = opacity < min_opacity
    # hardening beyond the reference: drop gaussians whose params diverged to
    # non-finite values (they would otherwise poison every later render)
    finite = np.ones_like(prune_mask)
    for v in params.values():
        finite &= np.isfinite(v).all(axis=tuple(range(1, v.ndim)))
    prune_mask = prune_mask | ~finite
    if max_screen_size:
        big_vs = max_radii2d > max_screen_size
        big_ws = exp32(params["scaling"]).max(axis=1) > 0.1 * extent
        prune_mask = prune_mask | big_vs | big_ws
    keep = ~prune_mask
    params = _gather(params, keep)
    adam_m = _gather(adam_m, keep)
    adam_v = _gather(adam_v, keep)
    max_radii2d = max_radii2d[keep]

    return params, adam_m, adam_v, max_radii2d
