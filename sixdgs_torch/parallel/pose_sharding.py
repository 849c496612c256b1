"""Sharded pose training step: DP over images x SP over rays (port of
sixdgs_tpu/parallel/pose_sharding.py), and the Gaussian-parallel render.

Layout, on a mesh with axes ("data", "rays"):

  * the image batch (images, masks, c2w, or the cached features) is split on
    its batch dimension over "data";
  * the rays (ori, dir, rgb, valid, gaussian_idx) are split on the ray
    dimension over "rays": each rank runs the ray MLP and the [256, N_local]
    attention logits of its own rays;
  * the id module and the optimizer state are replicated.

Each rank holds plain local tensors; the reductions over all rays and all
images are explicit collectives. Over "rays": the softmax over rays (a max,
then a differentiable sum of the exponentials), the target's
``scale = n_patches / sum(target)`` and the loss's valid-ray count. The
per-ray sum over patches is local. Over "data": the count of finite
per-image losses that the masked mean divides by (``_masked_mean`` of
the single-device trainer), so a rank holding a NaN image or fewer images
gives the single-device numbers.

Each rank differentiates its own share of the global loss: its rays' part
of each image's score loss, and the camera-up term on the first rank of
each "rays" group only. The gradients are then summed over the whole mesh,
their non-finite entries zeroed (after the sum, as the single-device step
does), and every rank takes the same Adafactor step, so the replicated
parameters stay equal across ranks. The scorer is the plain one
(``fused_attention=False``), as in the JAX package's sharded step.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist

from sixdgs_torch.parallel.mesh import all_gather_rows, all_reduce_sum, local_slice
from sixdgs_torch.pose.loss import cam_up_loss, target_ray_scores
from sixdgs_torch.pose.trainer import FeatureBatch, PoseBatch, _features
from sixdgs_torch.rays.engine import Rays


def shard_pose_inputs(mesh, batch: PoseBatch, rays: Rays):
    """This rank's slices of the training inputs: the batch on "data", the
    rays on "rays"."""
    return (PoseBatch(*(local_slice(x, mesh, "data") for x in batch)),
            Rays(*(local_slice(x, mesh, "rays") for x in rays)))


def shard_feature_inputs(mesh, fbatch: FeatureBatch, rays: Rays):
    """shard_pose_inputs for the cached-feature batch."""
    return (FeatureBatch(*(local_slice(x, mesh, "data") for x in fbatch)),
            Rays(*(local_slice(x, mesh, "rays") for x in rays)))


def _ray_scores(attention, feats_pe, k, valid, patch_mask, group):
    """Per-ray score (sum over masked patches) of this rank's rays, under
    the softmax over every rank's rays. Mirrors ``modules.attention_scores``
    and the patch sum of ``id_module.score_image_cached``; keep in step."""
    q = attention.q(feats_pe)
    logits = (q @ k.T) / math.sqrt(q.shape[-1])
    logits = torch.where(valid[None, :], logits, torch.full_like(logits, -9e15))
    m = logits.detach().amax(dim=-1)
    dist.all_reduce(m, dist.ReduceOp.MAX, group)
    e = torch.exp(logits - m[:, None])
    attn = e / all_reduce_sum(torch.sum(e, dim=-1), group)[:, None]
    return torch.sum(attn * patch_mask[:, None], dim=0)


def _sharded_batch_loss(mesh, id_module, fbatch: FeatureBatch, rays: Rays,
                        model_up: torch.Tensor):
    """(this rank's share of the global masked-mean loss, global aux).
    Mirrors ``trainer.batch_loss_cached`` in its per-image formulation (each
    image scored and its losses taken in turn), ``loss.distance_score_loss`` (the
    target's scale and the valid-ray count over "rays") and
    ``trainer._masked_mean`` (the count of finite losses over "data"); keep
    in step."""
    rays_group = mesh.get_group("rays")
    data_group = mesh.get_group("data")
    first = mesh.get_local_rank("rays") == 0
    valid = rays.valid
    k = id_module.attention.k(id_module.ray_mlp(rays.ori, rays.dir, rays.rgb))
    n_valid = torch.sum(valid.to(torch.float32))
    dist.all_reduce(n_valid, group=rays_group)
    n_valid = torch.clamp_min(n_valid, 1.0)
    parts, ups = [], []
    for b in range(fbatch.c2w.shape[0]):
        patch_mask = fbatch.patch_mask[b]
        scores = _ray_scores(id_module.attention, fbatch.feats_pe[b], k, valid,
                             patch_mask, rays_group)
        n_patches = torch.sum(patch_mask.to(torch.int32))
        with torch.no_grad():
            raw = target_ray_scores(fbatch.c2w[b], rays.ori, rays.dir, valid,
                                    n_patches).target_raw
            total = torch.sum(raw)
            dist.all_reduce(total, group=rays_group)
            scale = n_patches.to(raw.dtype) / total
            target = torch.where(valid, raw * scale, 0.0)
        diff = torch.square(scores - target)
        parts.append(torch.sum(torch.where(valid, diff, 0.0)) / n_valid)
        cam_up = id_module.cam_up(fbatch.fmap[b])
        cam_up = cam_up / torch.clamp_min(torch.linalg.norm(cam_up), 1e-12)
        ups.append(cam_up_loss(model_up, cam_up))
    dev = valid.device
    parts, ups = torch.stack(parts), torch.stack(ups)
    with torch.no_grad():
        score_losses = parts.detach().clone()
        dist.all_reduce(score_losses, group=rays_group)
        losses = score_losses + 0.1 * ups.detach()
        ok = torch.isfinite(losses)
        zero = torch.zeros((), device=dev)
        sums = torch.stack([torch.sum(torch.where(ok, losses, zero)),
                            torch.sum(torch.where(ok, score_losses, zero)),
                            torch.sum(torch.where(ok, ups.detach(), zero)),
                            torch.sum(ok.to(torch.float32)),
                            torch.sum((~ok).to(torch.float32))])
        dist.all_reduce(sums, group=data_group)
        n_ok = torch.clamp_min(sums[3], 1.0)
    share = parts + 0.1 * ups if first else parts
    total = torch.sum(torch.where(ok, share, torch.zeros((), device=dev))) / n_ok
    aux = {"loss": sums[0] / n_ok, "loss_score": sums[1] / n_ok, "cam_up": sums[2] / n_ok,
           "n_nan": sums[4].to(torch.int32)}
    return total, aux


def _sharded_update(id_module, optimizer, share: torch.Tensor) -> None:
    """Backward of this rank's share, the gradient sum over the whole mesh
    (the default group), non-finite entries zeroed, one Adafactor step."""
    optimizer.zero_grad(set_to_none=True)
    share.backward()
    params = list(id_module.parameters())
    flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                      for p in params])
    dist.all_reduce(flat)
    torch.nan_to_num_(flat, nan=0.0, posinf=0.0, neginf=0.0)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    optimizer.step()


def make_sharded_pose_step(mesh):
    """The multi-rank train step: step(id_module, optimizer, dino_model,
    batch, rays, model_up) -> aux, on this rank's slices
    (``shard_pose_inputs``). It updates ``id_module`` in place with
    ``optimizer``, as ``pose_train_step`` does; aux holds the global loss,
    loss_score, cam_up and n_nan."""

    def step(id_module, optimizer, dino_model, batch: PoseBatch, rays: Rays,
             model_up: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats_pe, patch_mask, fmap = _features(dino_model, batch.images, batch.masks,
                                               "dino")
        share, aux = _sharded_batch_loss(mesh, id_module,
                                         FeatureBatch(feats_pe, patch_mask, fmap, batch.c2w),
                                         rays, model_up)
        _sharded_update(id_module, optimizer, share)
        return aux

    return step


def make_sharded_pose_step_cached(mesh):
    """Cached-feature variant: step(id_module, optimizer, fbatch, rays,
    model_up) -> aux, on this rank's slices (``shard_feature_inputs``)."""

    def step(id_module, optimizer, fbatch: FeatureBatch, rays: Rays,
             model_up: torch.Tensor) -> Dict[str, torch.Tensor]:
        share, aux = _sharded_batch_loss(mesh, id_module, fbatch, rays, model_up)
        _sharded_update(id_module, optimizer, share)
        return aux

    return step


# --------------------------------------------------- sharded 3DGS rendering


def shard_scene(mesh, params: Dict[str, torch.Tensor], active: torch.Tensor):
    """This rank's slices of a scene's parameters and active mask over the
    mesh's first axis ("gaussians"); the capacity must divide evenly."""
    gax = mesh.mesh_dim_names[0]
    n = mesh.get_group(gax).size()
    if active.shape[0] % n:
        raise ValueError(f"capacity {active.shape[0]} does not split over {n} ranks")
    return ({k: local_slice(v, mesh, gax) for k, v in params.items()},
            local_slice(active, mesh, gax))


def band_rows(height: int, n: int, rank: int):
    """(first, end) image rows that rank ``rank`` of ``n`` composites."""
    rows = -(-height // n)
    return min(height, rank * rows), min(height, (rank + 1) * rows)


def make_sharded_render(mesh, width: int, height: int, sh_degree: int, chunk: int = 256):
    """Gaussian-parallel projection + pixel-parallel compositing.

    Returns render(params, active, cam, bg) -> [3, rows, W], this rank's
    band of image rows (``band_rows``), from this rank's slice of the scene
    (``shard_scene``). Each rank projects its slice; the projected records
    are all-gathered in rank order, so their index order is the scene's and
    depth ties sort as in ``render_eval``; each rank then rasterizes only its
    band through the "auto" rasterizer with the default tiers. The band is
    rasterized from the tile row that holds its first row,
    with the means shifted up by that many rows, so its tiles are the full
    frame's tiles. The JAX package returns the whole image sharded by rows;
    here the caller gathers the bands it needs.
    """
    from sixdgs_torch.ops.rasterizer.pallas_tiles import TILE
    from sixdgs_torch.ops.rasterizer.projection import ProjectedGaussians
    from sixdgs_torch.train.gs_trainer import _project_params, _rasterize

    gax = mesh.mesh_dim_names[0]
    group = mesh.get_group(gax)
    first, end = band_rows(height, group.size(), group.rank())
    origin = first // TILE * TILE

    @torch.no_grad()
    def render(params, active, cam, bg):
        proj = _project_params(params, active, cam, width, height, sh_degree)
        rec = all_gather_rows(torch.cat([
            proj.means2d, proj.depths[:, None], proj.conics,
            proj.radii[:, None].to(torch.float32), proj.colors, proj.opacities[:, None]],
            dim=1), group)
        means2d = rec[:, 0:2] - torch.tensor([0.0, origin], device=rec.device)
        proj = ProjectedGaussians(means2d=means2d, depths=rec[:, 2], conics=rec[:, 3:6],
                                  radii=rec[:, 6].to(torch.int32), colors=rec[:, 7:10],
                                  opacities=rec[:, 10])
        img, _ = _rasterize(proj, width, end - origin, bg, chunk)
        return img[:, first - origin:]

    return render
