"""Identification module: compose backbone + ray MLP + attention + up head.

Port of sixdgs_tpu/pose/id_module.py (reference
pose_estimation/identification_module.py: ``run_attention`` (:77-92) ->
score_image). As in the reference package the per-forward ray shuffle is
skipped: with the full softmax over all rays it only permutes the output.

Both scorers take ``fused_attention``: True scores with the fused
attention-score kernel (B1 forward, B2 backward), which never materializes
the [256 x N_rays] attention matrix and is differentiable.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sixdgs_torch.pose.backbone import backbone_features
from sixdgs_torch.pose.modules import IdModule, attention_scores
from sixdgs_torch.rays.engine import Rays
from sixdgs_torch.utils.profiling import span


class ScoreOutput(NamedTuple):
    scores: torch.Tensor  # [N_rays] per-ray score (sum over masked patches)
    attention: torch.Tensor  # [256, N_rays] ([0,0] placeholder in fused mode)
    patch_mask: torch.Tensor  # [256] bool
    cam_up: torch.Tensor  # [3] unit predicted camera up
    n_patches: torch.Tensor  # scalar: number of masked patches


def score_image(dino_model, id_module: IdModule, img, mask, rays: Rays,
                fused_attention: bool = False,
                backbone: str = "dino") -> ScoreOutput:
    """Score every ray against one image.

    Args:
        dino_model: frozen backbone (pose.dino.DinoViT or pose.superpoint.SuperPoint).
        id_module: pose.modules.IdModule (ray_mlp, attention, cam_up).
        img: [H, W, 3] float in [0, 1].
        mask: [H, W] foreground mask.
        rays: Rays (padded; rays.valid excludes padding).
        fused_attention: score with the fused attention-score kernel: the
            [256 x N_rays] attention matrix is never materialized, in the
            forward (B1) or the backward (B2), so it also serves
            large-ray-count training.
        backbone: "dino" or "superpoint" (backbone_type in the reference).
    """
    feats_pe, patch_mask, fmap = backbone_features(dino_model, img, mask,
                                                   backbone=backbone)
    return score_image_cached(id_module, feats_pe, patch_mask, fmap, rays,
                              fused_attention=fused_attention)


def compute_image_features(dino_model, img, mask, backbone: str = "dino"):
    """Backbone features for caching: (feats_pe [G*G, D+14], patch_mask
    [G*G], fmap [D, G, G]). The backbone is frozen during id-module training
    (pose_estimation/train.py:36-40), so these are constants per camera: the
    reference recomputes them on every one of the 32 accumulation steps, the
    trainer computes them once per camera."""
    return backbone_features(dino_model, img, mask, backbone=backbone)


def score_image_cached(id_module: IdModule, feats_pe, patch_mask, fmap,
                       rays: Rays, fused_attention: bool = False,
                       ray_feats=None) -> ScoreOutput:
    """score_image with precomputed backbone features. ``ray_feats``
    ([N, D], the ray MLP's output) may be passed in when several images are
    scored against one ray set; it is computed here otherwise."""
    if ray_feats is None:
        with span("pose.ray_mlp"):
            ray_feats = id_module.ray_mlp(rays.ori, rays.dir, rays.rgb)
    with span("pose.scores"):
        if fused_attention:
            from sixdgs_torch.ops.attention_kernel import fused_ray_scores

            scores = fused_ray_scores(id_module, feats_pe, ray_feats, patch_mask,
                                      rays.valid)
            attn = feats_pe.new_zeros((0, 0))
        else:
            attn = attention_scores(id_module.attention, feats_pe, ray_feats, rays.valid)
            # per-ray score = sum over *masked* patches (identification_module.py:82)
            scores = torch.sum(attn * patch_mask[:, None], dim=0)
    with span("pose.cam_up"):
        cam_up = _unit(id_module.cam_up(fmap))
    return ScoreOutput(
        scores=scores,
        attention=attn,
        patch_mask=patch_mask,
        cam_up=cam_up,
        n_patches=torch.sum(patch_mask.to(torch.int32)),
    )


def score_batch_cached(id_module: IdModule, feats_pe, patch_mask, fmap, rays: Rays,
                       fused_attention: bool = False) -> ScoreOutput:
    """score_image_cached over a batch of images scored against one ray set:
    feats_pe [B, P, D+14], patch_mask [B, P] and fmap [B, D, G, G] give
    scores [B, N], cam_up [B, 3] and n_patches [B]; ``attention`` is a
    [0, 0] placeholder.

    The ray MLP and the camera-up head run once over the batch. The fused
    scorer projects the batch's queries in one GEMM and launches B1 (B2 in
    the backward) once per image; the plain scorer projects and forms one
    image's [P, N] map at a time, as ``score_image_cached`` does."""
    with span("pose.ray_mlp"):
        ray_feats = id_module.ray_mlp(rays.ori, rays.dir, rays.rgb)
    with span("pose.scores"):
        attention = id_module.attention
        if fused_attention:
            from sixdgs_torch.ops.attention_kernel import attention_scores_fused

            # unbind, not indexing: the backward stacks the images' dq once
            qs = attention.q(feats_pe).unbind(0)
            valid = rays.valid.to(torch.float32)
            wk = attention.k.weight.T
            scores = [attention_scores_fused(q, ray_feats, wk, attention.k.bias, pm, valid)
                      for q, pm in zip(qs, patch_mask.to(torch.float32).unbind(0))]
        else:
            # score_image_cached's projections and map, an image at a time
            scores = [torch.sum(attention_scores(attention, fp, ray_feats, rays.valid)
                                * pm[:, None], dim=0)
                      for fp, pm in zip(feats_pe.unbind(0), patch_mask.unbind(0))]
    with span("pose.cam_up"):
        cam_up = _unit(id_module.cam_up(fmap))
    return ScoreOutput(
        scores=torch.stack(scores),
        attention=feats_pe.new_zeros((0, 0)),
        patch_mask=patch_mask,
        cam_up=cam_up,
        n_patches=torch.sum(patch_mask.to(torch.int32), dim=-1),
    )


def _unit(v: torch.Tensor) -> torch.Tensor:
    """v over its norm along the last axis (each row of a batch)."""
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-12)
