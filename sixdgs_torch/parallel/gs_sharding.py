"""Data-parallel 3DGS training: a batch of cameras split over the mesh
(port of sixdgs_tpu/parallel/gs_sharding.py).

The reference trains one camera per iteration on one GPU. Here a step
renders B cameras with the batch split on the mesh's "data" axis:
parameters and Adam state are replicated, each rank renders its local
cameras one at a time (so that one transmittance store is live at a time
on the kernel path), the gradients are summed over the axis, and every rank
takes the same Adam step. The JAX package has two routes (a vmap for the
XLA rasterizer, a shard_map for the Pallas one) that compute the same
numbers; here every rasterizer takes the one route: a loop over the local
cameras, then explicit reductions.

Densification statistics keep reference semantics: a B-camera step is the
statistical equivalent of B reference iterations, so the screen-space
gradient accumulator receives the sum over cameras of per-camera gradient
norms (the loss's 1/B undone), the denominator the per-camera visibility
counts, and max radii the max over cameras.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from sixdgs_torch.ops.rasterizer import resolve_rasterizer
from sixdgs_torch.parallel.mesh import local_slice
from sixdgs_torch.ops.ssim import dssim_l1_loss, psnr
from sixdgs_torch.train.gs_trainer import (
    DEFAULT_TIERS,
    CameraArrays,
    GSTrainState,
    _render_params,
    camera_arrays,
)
from sixdgs_torch.train.optim import adam_update


def camera_batch_sharding(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``x`` batched on cameras: a contiguous slice on
    the "data" axis (``mesh.local_slice``)."""
    return local_slice(x, mesh, "data")


def stack_camera_batch(cams, device="cuda") -> CameraArrays:
    """Host Cameras -> batched CameraArrays with their images (leading camera
    axis)."""
    arrs = [camera_arrays(c, device, with_image=True) for c in cams]
    return CameraArrays(*(torch.stack(xs) for xs in zip(*arrs)))


def shard_camera_batch(mesh, cams: CameraArrays) -> CameraArrays:
    """This rank's cameras of a batched CameraArrays."""
    return CameraArrays(*(camera_batch_sharding(mesh, x) for x in cams))


def make_sharded_gs_step(
    mesh,
    *,
    width: int,
    height: int,
    sh_degree: int,
    chunk: int = 256,
    lambda_dssim: float = 0.2,
    rasterizer: str = "auto",
    tiers: tuple = DEFAULT_TIERS,
    nc_pairs: int = 0,
):
    """Build the DP train step: step(state, cams, bg, lrs) -> (state,
    metrics), where ``cams`` are this rank's cameras (``shard_camera_batch``)
    and ``state`` is replicated. On the card with ``rasterizer="auto"`` each
    local camera goes through B5, B3 with the transmittance store, and B4.

    Per step: loss = sum of the B cameras' losses / B; the gradients summed
    over "data"; Adam on every rank; ``xyz_grad_accum`` and ``denom`` summed
    and ``max_radii2d`` maxed over the ranks; metrics loss, l1 and psnr (the
    means over the B cameras) and grad_dropped (the cameras whose raster
    gradients the pair budget dropped; 0 off the kernel path).
    """
    rasterizer = resolve_rasterizer(rasterizer)
    with_stats = rasterizer == "pallas"
    group = mesh.get_group("data")

    def step(state: GSTrainState, cams: CameraArrays, bg: torch.Tensor,
             lrs: Dict[str, float]):
        scene = state.scene
        active, dev = scene.active, scene.xyz.device
        bl = cams.view.shape[0]
        B = torch.tensor(float(bl), device=dev)
        dist.all_reduce(B, group=group)
        B = int(B)
        params = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
        names = list(params)
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        accum = torch.zeros(scene.capacity, device=dev)
        denom = torch.zeros(scene.capacity, device=dev)
        radmax = torch.zeros(scene.capacity, dtype=torch.int32, device=dev)
        # [sum of losses, of l1, of psnr, cameras with dropped gradients]
        sums = torch.zeros(4, device=dev)
        scale = torch.tensor([[0.5 * width, 0.5 * height]], device=dev)
        for i in range(bl):
            cam = CameraArrays(*(x[i] for x in cams))
            offset = torch.zeros(scene.capacity, 2, device=dev, requires_grad=True)
            out = _render_params(params, active, cam, width, height, sh_degree, bg, chunk,
                                 rasterizer, tiers, nc_pairs, with_stats=with_stats,
                                 means2d_offset=offset)
            img, proj = out[0], out[1]
            loss, ll1 = dssim_l1_loss(img, cam.gt_image, lambda_dssim)
            g = torch.autograd.grad(loss / B, [params[k] for k in names] + [offset],
                                    allow_unused=True)
            with torch.no_grad():
                for k, gk in zip(names, g):
                    if gk is not None:
                        grads[k] += gk
                visible = proj.radii > 0
                gnorm = torch.linalg.norm(g[-1] * B * scale, dim=-1)
                accum += torch.where(visible, gnorm, torch.zeros_like(gnorm))
                denom += visible.to(denom.dtype)
                radmax = torch.maximum(radmax, proj.radii)
                img = img.detach()
                sums += torch.stack([
                    loss.detach(), ll1.detach(),
                    psnr(torch.clamp(img, 0, 1), torch.clamp(cam.gt_image, 0, 1)),
                    out[2]["grad_dropped"].to(torch.float32) if with_stats
                    else torch.zeros((), device=dev)])

        with torch.no_grad():
            flat = torch.cat([grads[k].reshape(-1) for k in names])
            dist.all_reduce(flat, group=group)
            offset = 0
            for k in names:
                n = grads[k].numel()
                grads[k] = flat[offset:offset + n].view_as(grads[k])
                offset += n
            stats = torch.stack([accum, denom])
            dist.all_reduce(stats, group=group)
            dist.all_reduce(radmax, dist.ReduceOp.MAX, group)
            sums[0] /= B  # as the JAX package: psum(sum(losses) / B)
            dist.all_reduce(sums, group=group)
            params = {k: v.detach() for k, v in params.items()}
            new_params, new_adam = adam_update(params, grads, state.adam, lrs)
            new_state = GSTrainState(
                scene=scene.with_params(new_params),
                adam=new_adam,
                xyz_grad_accum=state.xyz_grad_accum + stats[0],
                denom=state.denom + stats[1].to(state.denom.dtype),
                max_radii2d=torch.maximum(state.max_radii2d, radmax),
            )
            metrics = {"loss": sums[0], "l1": sums[1] / B, "psnr": sums[2] / B,
                       "grad_dropped": sums[3].to(torch.int32)}
        return new_state, metrics

    return step
