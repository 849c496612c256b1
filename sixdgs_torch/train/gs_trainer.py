"""3DGS training: an eager step plus host-event densification (port of
sixdgs_tpu/train/gs_trainer.py).

Loop parity with the reference's train.py:29-191: random camera order
without replacement, L1 + DSSIM loss, per-group Adam with a scheduled xyz
learning rate, SH degree warm-up every 1000 iterations, densify and prune
every 100 in [500, 15000), opacity reset every 3000, PLY snapshots.

The state is functional, as in the JAX package: ``train_step`` takes a
``GSTrainState`` of fixed-capacity tensors and returns a new one, the
densification statistics are carried inside the state, and densification is
a host event (numpy) that repacks the arrays into a capacity bucket. With
``rasterizer="auto"`` a step on the card goes through the hand-written
kernels B5, B3 (with the transmittance store) and B4.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from sixdgs_torch.ops.rasterizer import rasterize_scan, resolve_rasterizer
from sixdgs_torch.ops.rasterizer.pallas_tiles import DEFAULT_NC, KB, rasterize_pallas
from sixdgs_torch.ops.rasterizer.projection import project_gaussians
from sixdgs_torch.ops.rasterizer.tiles import binning_saturation, rasterize_tiled
from sixdgs_torch.ops.ssim import dssim_l1_loss, l1_loss, psnr
from sixdgs_torch.ops.transforms import covariance_planes, inverse_sigmoid
from sixdgs_torch.scene.gaussians import (
    PARAM_NAMES,
    GaussianScene,
    create_from_pcd,
    from_arrays,
    round_capacity,
)
from sixdgs_torch.train import densify as densify_mod
from sixdgs_torch.train.optim import AdamState, adam_init, adam_update, expon_lr
from sixdgs_torch.utils.config import ModelConfig, OptimizationConfig


class CameraArrays(NamedTuple):
    """A Camera's matrices on the device, and for a training step its
    ground-truth image (a render does not read it, and a 1232x816 one is
    12 MB to copy)."""

    view: torch.Tensor  # [4, 4]
    full_proj: torch.Tensor  # [4, 4]
    camera_center: torch.Tensor  # [3]
    tan_fovx: torch.Tensor  # 0-d float32
    tan_fovy: torch.Tensor  # 0-d float32
    gt_image: Optional[torch.Tensor] = None  # [3, H, W]


def camera_arrays(cam, device="cuda", with_image: bool = False) -> CameraArrays:
    """A host Camera's matrices (and image) as tensors on ``device``."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return CameraArrays(
        view=f32(cam.view),
        full_proj=f32(cam.full_proj),
        camera_center=f32(cam.camera_center),
        tan_fovx=f32(math.tan(cam.FoVx * 0.5)),
        tan_fovy=f32(math.tan(cam.FoVy * 0.5)),
        gt_image=f32(cam.image) if with_image else None,
    )


@dataclasses.dataclass
class GSTrainState:
    scene: GaussianScene
    adam: AdamState
    xyz_grad_accum: torch.Tensor  # [C]
    denom: torch.Tensor  # [C]
    max_radii2d: torch.Tensor  # [C] int32


def init_train_state(scene: GaussianScene) -> GSTrainState:
    cap, dev = scene.capacity, scene.xyz.device
    return GSTrainState(
        scene=scene,
        adam=adam_init(scene.params()),
        xyz_grad_accum=torch.zeros(cap, device=dev),
        denom=torch.zeros(cap, device=dev),
        max_radii2d=torch.zeros(cap, dtype=torch.int32, device=dev),
    )


# (t_max, mid_k, t_max_mid, overflow_k, t_max_big): per-gaussian tile-slot
# budgets of the binning tiers, adapted per scene and resolution from the
# binning_* saturation telemetry of the train metrics
DEFAULT_TIERS = (16, 4096, 64, 256, 1024)

# widening caps: (t_max, mid_k, t_max_mid, overflow_k, t_max_big)
_TIER_CAPS = (128, 16384, 256, 1024, 4096)


def widen_tiers(tiers, dropped_main, dropped_mid, dropped_big):
    """Pick the next tier widening from per-tier truncation telemetry: the
    widened 5-tuple, or None if every truncating tier is at its cap. It
    targets the tier that dropped the most area. The reference's binning is
    uncapped (it sizes buffers from the exact emitted count per frame);
    widening converges to it one step at a time."""
    t_max, mid_k, t_max_mid, ov_k, t_big = tiers
    by_drop = sorted(
        (("main", dropped_main), ("mid", dropped_mid), ("big", dropped_big)),
        key=lambda kv: -kv[1])
    for name, dropped in by_drop:
        if dropped <= 0:
            continue
        if name == "main" and t_max < _TIER_CAPS[0]:
            return (t_max * 2, mid_k, t_max_mid, ov_k, t_big)
        if name == "mid":
            if t_max_mid < _TIER_CAPS[2]:
                return (t_max, mid_k, t_max_mid * 2, ov_k, t_big)
            if mid_k < _TIER_CAPS[1]:
                return (t_max, mid_k * 2, t_max_mid, ov_k, t_big)
        if name == "big":
            if t_big < _TIER_CAPS[4]:
                return (t_max, mid_k, t_max_mid, ov_k, t_big * 2)
            if ov_k < _TIER_CAPS[3]:
                return (t_max, mid_k, t_max_mid, ov_k * 2, t_big)
    return None


def narrow_tiers(tiers, narrow_demand, n_points):
    """Halve the main-tier slot budget when the scene no longer needs it.

    ``narrow_demand`` is the binning telemetry's count of visible gaussians
    whose tile footprint exceeds t_max // 2, i.e. everything that would
    need an overflow tier after halving. Narrowing adds no main-tier
    truncation when all of them fit in the mid and giant tables; the 0.31
    occupancy bar mirrors the nc_pairs shrink hysteresis, so a halving and
    the widening trigger cannot ping-pong. The key-slot count
    P*t_max + mid_k*t_max_mid + ov_k*t_max_big is dominated by the main
    block at trained-scene scale, and the key sort, the key build and the
    segment starts are about linear in it. Returns the narrowed 5-tuple,
    or None if narrowing is not worthwhile."""
    t_max, mid_k, t_max_mid, ov_k, t_big = tiers
    new_t = t_max // 2
    if new_t < 4:
        return None  # floor: keep tiny footprints out of the tier tables
    if new_t > t_max_mid:
        return None  # displaced gaussians would out-size the mid budget
    if n_points * new_t < (1 << 18):
        return None  # too few slots saved to be worth a change of shapes
    if narrow_demand >= 0.31 * (mid_k + ov_k):
        return None
    return (new_t, mid_k, t_max_mid, ov_k, t_big)


def _project_params(params, active, cam: CameraArrays, width, height, sh_degree):
    """The scene's parameters projected through ``cam`` (activations as the
    reference's GaussianModel getters)."""
    cov3d = covariance_planes(torch.exp(params["scaling"]), params["rotation"])
    opacity = torch.sigmoid(params["opacity"]) * active[:, None]
    sh = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
    return project_gaussians(params["xyz"], cov3d, opacity, cam.view, cam.full_proj,
                             cam.camera_center, width, height, cam.tan_fovx,
                             cam.tan_fovy, sh=sh, sh_degree=sh_degree, active=active)


def _rasterize(proj, width, height, bg, chunk: int = 256, rasterizer: str = "auto",
               tiers: tuple = DEFAULT_TIERS, nc_pairs: int = 0, with_stats: bool = False):
    """Rasterize projected Gaussians: (img [3, H, W], stats), ``stats`` the
    rasterizer's budget telemetry with ``with_stats`` on the "pallas" path,
    else None.

    ``rasterizer``: "pallas" (the tile rasterizer on the CUDA kernels;
    "auto" resolves to it), "tiled" (the tile rasterizer in plain PyTorch)
    or "scan" (the golden model)."""
    rasterizer = resolve_rasterizer(rasterizer)
    if rasterizer not in ("pallas", "tiled", "scan"):
        raise ValueError("rasterizer must be 'auto', 'pallas', 'tiled' or 'scan', got "
                         f"{rasterizer!r}")
    t_max, mid_k, t_max_mid, overflow_k, t_max_big = tiers
    stats = None
    if rasterizer == "pallas":
        img = rasterize_pallas(proj, width, height, bg, t_max=t_max, mid_k=mid_k,
                               t_max_mid=t_max_mid, overflow_k=overflow_k,
                               t_max_big=t_max_big, nc_pairs=nc_pairs,
                               return_stats=with_stats)
        if with_stats:
            img, stats = img
    elif rasterizer == "tiled":
        img = rasterize_tiled(proj, width, height, bg, t_max=t_max, mid_k=mid_k,
                              t_max_mid=t_max_mid, overflow_k=overflow_k,
                              t_max_big=t_max_big)
    else:
        img = rasterize_scan(proj, width, height, bg, chunk=chunk)
    return img, stats


def _render_params(params, active, cam: CameraArrays, width, height, sh_degree,
                   bg, chunk: int = 256, rasterizer: str = "auto",
                   tiers: tuple = DEFAULT_TIERS, nc_pairs: int = 0,
                   with_stats: bool = False, means2d_offset=None):
    """Project the scene's parameters through ``cam`` and rasterize
    (``_rasterize``): (img [3, H, W], proj), and with ``with_stats`` the
    rasterizer's budget telemetry as a third item. ``means2d_offset``
    [P, 2] is added to the projected means: the gradient with respect to a
    zero offset is the screen-space position gradient that densification
    accumulates."""
    proj = _project_params(params, active, cam, width, height, sh_degree)
    if means2d_offset is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_offset)
    img, stats = _rasterize(proj, width, height, bg, chunk, rasterizer, tiers, nc_pairs,
                            with_stats)
    if with_stats:
        return img, proj, stats
    return img, proj


def train_step(
    state: GSTrainState,
    cam: CameraArrays,
    bg: torch.Tensor,
    lrs: Dict[str, float],
    *,
    width: int,
    height: int,
    sh_degree: int,
    chunk: int = 256,
    lambda_dssim: float = 0.2,
    rasterizer: str = "auto",
    tiers: tuple = DEFAULT_TIERS,
    nc_pairs: int = 0,
    with_telemetry: bool = True,
):
    """One training iteration (render, loss, backward, Adam, densification
    statistics): (new state, metrics). The metrics are 0-d tensors on the
    state's device; nothing here waits for the device."""
    scene = state.scene
    active = scene.active
    params = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
    offset = torch.zeros(scene.capacity, 2, device=active.device, requires_grad=True)
    rasterizer = resolve_rasterizer(rasterizer)
    on_tiles = rasterizer in ("tiled", "pallas")
    # the kernel path computes its nc-budget telemetry anyway
    want_stats = with_telemetry and rasterizer == "pallas"

    out = _render_params(params, active, cam, width, height, sh_degree, bg, chunk,
                         rasterizer, tiers, nc_pairs, with_stats=want_stats,
                         means2d_offset=offset)
    img, proj = out[0], out[1]
    nc_stats = out[2] if want_stats else None
    loss, ll1 = dssim_l1_loss(img, cam.gt_image, lambda_dssim)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names] + [offset],
                                allow_unused=True)
    g2d = grads[-1]
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(names, grads)}

    with torch.no_grad():
        params = {k: v.detach() for k, v in params.items()}
        new_params, new_adam = adam_update(params, grads, state.adam, lrs)
        # densification stats (train.py:153-161): norm of the screen-space
        # position gradient in NDC units (grad_pix * 0.5 * size), accumulated
        # over visible gaussians
        radii = proj.radii
        visible = radii > 0
        g_ndc = g2d * torch.tensor([[0.5 * width, 0.5 * height]], device=g2d.device)
        gnorm = torch.linalg.norm(g_ndc, dim=-1)
        new_state = GSTrainState(
            scene=scene.with_params(new_params),
            adam=new_adam,
            xyz_grad_accum=state.xyz_grad_accum + torch.where(
                visible, gnorm, torch.zeros_like(gnorm)),
            denom=state.denom + visible.to(state.denom.dtype),
            max_radii2d=torch.maximum(state.max_radii2d, radii),
        )
        img, gt = img.detach(), cam.gt_image
        metrics = {"loss": loss.detach(), "l1": ll1.detach(),
                   "psnr": psnr(torch.clamp(img, 0, 1), torch.clamp(gt, 0, 1))}
        if with_telemetry and on_tiles:
            # static-cap truncation telemetry: the reference's binning is
            # uncapped, so surface any coverage the tier budgets dropped. It
            # is only read on adaptation and logging iterations
            t_max, mid_k, t_max_mid, overflow_k, t_max_big = tiers
            sat = binning_saturation(
                proj.means2d.detach(), radii.to(torch.float32), visible,
                -(-width // 16), -(-height // 16), 16, t_max,
                overflow_k=overflow_k, t_max_big=t_max_big, mid_k=mid_k,
                t_max_mid=t_max_mid)
            metrics.update({f"binning_{k}": v for k, v in sat.items()})
        if nc_stats is not None:
            # exact post-cull budget telemetry from the rasterizer itself:
            # nc_demand = aligned compact slots this frame wants (the
            # widening signal), grad_dropped = 1 when the raster gradients
            # were zeroed
            metrics.update({f"binning_{k}": v for k, v in nc_stats.items()})
    return new_state, metrics


@torch.no_grad()
def reset_opacity(state: GSTrainState) -> GSTrainState:
    """Clamp opacities to <= 0.01 and zero the opacity Adam state
    (gaussian_model.py:335-340 and replace_tensor_to_optimizer)."""
    scene = state.scene
    op = torch.sigmoid(scene.opacity)
    # clamp below: a sigmoid that underflows to 0 would give log(0) = -inf
    new_raw = inverse_sigmoid(torch.clamp(op, 1e-7, 0.01))
    new_raw = torch.where(scene.active[:, None], new_raw, scene.opacity)
    params = dict(scene.params(), opacity=new_raw)
    m = dict(state.adam.m, opacity=torch.zeros_like(state.adam.m["opacity"]))
    v = dict(state.adam.v, opacity=torch.zeros_like(state.adam.v["opacity"]))
    return dataclasses.replace(state, scene=scene.with_params(params),
                               adam=AdamState(m=m, v=v, step=state.adam.step))


def densify_event(
    state: GSTrainState,
    *,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: Optional[int],
    percent_dense: float,
    rng: np.random.Generator,
    capacity_bucket: int = 16384,
) -> GSTrainState:
    """Host-side densify and prune; repacks into a (possibly new) capacity
    bucket on the state's device."""
    scene = state.scene
    dev = scene.xyz.device

    def host(t):
        return t.detach().cpu().numpy()

    mask = host(scene.active)
    params = {k: host(getattr(scene, k))[mask] for k in PARAM_NAMES}
    m = {k: host(state.adam.m[k])[mask] for k in PARAM_NAMES}
    v = {k: host(state.adam.v[k])[mask] for k in PARAM_NAMES}
    accum = host(state.xyz_grad_accum)[mask]
    denom = host(state.denom)[mask]
    max_radii = host(state.max_radii2d)[mask].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        grads = np.nan_to_num(accum / denom, nan=0.0)

    params, m, v, max_radii = densify_mod.densify_and_prune(
        params, m, v, grads, max_radii,
        max_grad=max_grad, min_opacity=min_opacity, extent=extent,
        max_screen_size=max_screen_size, percent_dense=percent_dense, rng=rng,
    )
    n_new = params["xyz"].shape[0]
    cap = round_capacity(n_new, capacity_bucket)
    new_scene = from_arrays(params, scene.max_sh_degree, capacity=cap, device=dev)

    def pad_state(d):
        out = {}
        for k, arr in d.items():
            buf = np.zeros((cap,) + arr.shape[1:], np.float32)
            buf[:n_new] = arr
            out[k] = torch.tensor(buf, device=dev)
        return out

    # densification_postfix resets the statistics (gaussian_model.py:535-537);
    # max_radii2D keeps its pruned values until fresh renders refresh it
    radii_buf = np.zeros(cap, np.int32)
    radii_buf[:n_new] = max_radii[:n_new].astype(np.int32)
    return GSTrainState(
        scene=new_scene,
        adam=AdamState(m=pad_state(m), v=pad_state(v), step=state.adam.step),
        xyz_grad_accum=torch.zeros(cap, device=dev),
        denom=torch.zeros(cap, device=dev),
        max_radii2d=torch.tensor(radii_buf, device=dev),
    )


def xyz_lr(opt: OptimizationConfig, spatial_lr_scale: float, step: int) -> float:
    return expon_lr(
        step,
        opt.position_lr_init * spatial_lr_scale,
        opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )


def lr_dict(opt: OptimizationConfig, spatial_lr_scale: float, step: int):
    """Learning rate per parameter name, rounded to float32 as the update
    uses them."""
    lrs = {
        "xyz": xyz_lr(opt, spatial_lr_scale, step),
        "features_dc": opt.feature_lr,
        "features_rest": opt.feature_lr / 20.0,
        "opacity": opt.opacity_lr,
        "scaling": opt.scaling_lr,
        "rotation": opt.rotation_lr,
    }
    return {k: float(np.float32(v)) for k, v in lrs.items()}


@torch.no_grad()
def render_gui_camera(scene: GaussianScene, gui_cam, bg, sh_degree: int,
                      scaling_modifier: float = 1.0,
                      rasterizer: str = "auto") -> torch.Tensor:
    """Render a network-GUI camera (matrices only, no ground-truth image)."""
    dev = scene.xyz.device
    params = dict(scene.params())
    params["scaling"] = torch.log(torch.exp(scene.scaling) * scaling_modifier)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    img, _ = _render_params(params, scene.active, camera_arrays(gui_cam, dev),
                            gui_cam.width, gui_cam.height, sh_degree, bg, 256, rasterizer)
    return img


@torch.no_grad()
def render_eval(scene, cam, bg, sh_degree: int, chunk: int = 256,
                rasterizer: str = "auto", tiers: tuple = DEFAULT_TIERS) -> torch.Tensor:
    """Inference render [3, H, W] of a host Camera, on the scene's device."""
    dev = scene.xyz.device
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    img, _ = _render_params(scene.params(), scene.active, camera_arrays(cam, dev),
                            cam.width, cam.height, sh_degree, bg, chunk, rasterizer,
                            tiers)
    return img


class GSTrainer:
    """Orchestrates the training loop (host side)."""

    def __init__(self, model_cfg: ModelConfig, opt_cfg: OptimizationConfig,
                 scene_info, train_cams, test_cams, seed: int = 0,
                 capacity_bucket: int = 16384, device="cuda"):
        self.model_cfg = model_cfg
        self.opt = opt_cfg
        self.scene_info = scene_info
        self.train_cams = train_cams
        self.test_cams = test_cams
        self.capacity_bucket = capacity_bucket
        self.device = torch.device(device)
        self.spatial_lr_scale = float(scene_info.nerf_normalization["radius"])
        self.cameras_extent = self.spatial_lr_scale
        n_pts = scene_info.point_cloud.points.shape[0]
        scene = create_from_pcd(
            scene_info.point_cloud, model_cfg.sh_degree,
            capacity=round_capacity(n_pts, capacity_bucket), device=self.device,
        )
        self.state = init_train_state(scene)
        self.rng = np.random.default_rng(seed)
        self.active_sh_degree = 0
        self.bg = torch.tensor(
            [1.0, 1.0, 1.0] if model_cfg.white_background else [0.0, 0.0, 0.0],
            device=self.device)
        self._viewpoint_stack = []
        self._cam_arrays = {}

    def _next_camera(self):
        if not self._viewpoint_stack:
            self._viewpoint_stack = list(self.train_cams)
        idx = self.rng.integers(len(self._viewpoint_stack))
        return self._viewpoint_stack.pop(int(idx))

    def _camera_arrays(self, cam) -> CameraArrays:
        """Device-cached CameraArrays: the reference uploads each image again
        every step (train.py:108-111); here each camera's arrays are staged
        to the device once and reused.

        The cache holds a reference to the camera object itself, so an id()
        can never be recycled to alias another (collected) camera, and a
        rebuilt camera list simply misses and is staged again."""
        key = id(cam)
        hit = self._cam_arrays.get(key)
        if hit is not None and hit[0] is cam:
            return hit[1]
        ca = camera_arrays(cam, self.device, with_image=True)
        self._cam_arrays[key] = (cam, ca)
        return ca

    def save_checkpoint(self, path: str, iteration: int) -> None:
        from sixdgs_torch.train.checkpoint import save_train_state

        save_train_state(path, self.state, iteration, self.active_sh_degree)

    def restore_checkpoint(self, path: str) -> int:
        from sixdgs_torch.train.checkpoint import load_train_state

        self.state, iteration, self.active_sh_degree = load_train_state(
            path, device=self.device)
        return iteration

    def run(self, iterations: Optional[int] = None, log_every: int = 50,
            save_iterations=(), model_path: Optional[str] = None,
            callback=None, chunk: int = 256, rasterizer: str = "auto",
            checkpoint_iterations=(), first_iteration: int = 1,
            pre_step=None, tiers: tuple = DEFAULT_TIERS,
            adapt_tiers_every: int = 500, adapt_drop_threshold: float = 0.01):
        opt = self.opt
        iterations = iterations or opt.iterations
        nc_pairs = 0  # 0 = rasterizer default; adaptively widened below
        for it in range(first_iteration, iterations + 1):
            if pre_step is not None:
                pre_step(it, self)
            if it % 1000 == 0 and self.active_sh_degree < self.state.scene.max_sh_degree:
                self.active_sh_degree += 1
            cam = self._next_camera()
            lrs = lr_dict(opt, self.spatial_lr_scale, it)  # only xyz is scheduled
            # telemetry is only read on adaptation, logging and final iterations
            adapt = bool(adapt_tiers_every) and it % adapt_tiers_every == 0
            need_telemetry = (it == iterations or adapt
                              or (callback is not None and it % log_every == 0))
            self.state, metrics = train_step(
                self.state,
                self._camera_arrays(cam),
                self.bg,
                lrs,
                width=cam.width,
                height=cam.height,
                sh_degree=self.active_sh_degree,
                chunk=chunk,
                lambda_dssim=opt.lambda_dssim,
                rasterizer=rasterizer,
                tiers=tiers,
                nc_pairs=nc_pairs,
                with_telemetry=need_telemetry,
            )
            if callback is not None and (it % log_every == 0 or it == iterations):
                callback(it, {k: v.item() for k, v in metrics.items()}, self)
            if adapt and ("binning_real_pairs" in metrics
                          or "binning_nc_demand" in metrics):
                # compact-pair budget: the aligned layout drops trailing
                # tiles (and the backward drops that step's gradients) when
                # the frame's demand exceeds nc, so widen before saturation.
                # binning_nc_demand is the rasterizer's exact post-cull
                # aligned demand; real_pairs is the pre-cull bound
                real = int(metrics.get("binning_nc_demand",
                                       metrics.get("binning_real_pairs")))
                effective = nc_pairs or DEFAULT_NC
                if real > 0.9 * effective:
                    nc_pairs = effective * 2
                    while real > 0.9 * nc_pairs:  # catch up in one change
                        nc_pairs *= 2
                    print(f"[{it}] compact-pair demand {real} > 90% of "
                          f"{effective}: widening nc_pairs -> {nc_pairs}")
                elif real * 3.2 < effective and effective > (1 << 18):
                    # every per-pair cost outside the kernels (key sort
                    # slice, compact gather, backward routing sort and
                    # running sum) scales with the budget; shrink when most
                    # of it is sentinel slack. Hysteresis: shrink only when
                    # the budget with a 1.6x margin would at least halve
                    # (occupancy < 31%), widen again at > 90%
                    nc_pairs = max(-(-int(real * 1.6) // KB) * KB, 1 << 18)
                    print(f"[{it}] compact pairs {real} < 31% of "
                          f"{effective}: shrinking nc_pairs -> {nc_pairs}")
            if adapt and "binning_total_area" in metrics:
                # adaptive binning: widen a tier when the static caps
                # truncate more than adapt_drop_threshold of tile coverage
                total = max(float(metrics["binning_total_area"]), 1.0)
                d_main = float(metrics["binning_dropped_main"])
                d_mid = float(metrics["binning_dropped_mid"])
                d_big = float(metrics["binning_dropped_big"])
                ratio = (d_main + d_mid + d_big) / total
                if ratio > adapt_drop_threshold:
                    new_tiers = widen_tiers(tiers, d_main, d_mid, d_big)
                    if new_tiers is not None:
                        print(f"[{it}] binning truncation {ratio:.1%} > "
                              f"{adapt_drop_threshold:.0%}: widening tiers "
                              f"{tiers} -> {new_tiers}")
                        tiers = new_tiers
                elif "binning_narrow_demand" in metrics:
                    # nothing truncating: try the other direction and halve
                    # the main slot budget when everything that would
                    # overflow it fits the tier tables (see narrow_tiers)
                    demand = int(metrics["binning_narrow_demand"])
                    new_tiers = narrow_tiers(tiers, demand, int(self.state.scene.capacity))
                    if new_tiers is not None:
                        print(f"[{it}] main-tier demand {demand} fits tiers: "
                              f"narrowing t_max {tiers} -> {new_tiers}")
                        tiers = new_tiers
            # save BEFORE the densify and opacity-reset block, like the
            # reference (train.py:148-150 precedes :153-179): otherwise a
            # save iteration that coincides with opacity_reset_interval
            # would persist the freshly reset (near-transparent) opacities.
            # Known parity delta: the reference saves before
            # optimizer.step() (train.py:182-184) while train_step includes
            # the Adam update, so a PLY at a save iteration is one
            # iteration's update ahead of the reference's
            if it in save_iterations and model_path:
                path = os.path.join(
                    model_path, "point_cloud", f"iteration_{it}", "point_cloud.ply"
                )
                self.state.scene.save_ply(path)
            if it < opt.densify_until_iter:
                if it > opt.densify_from_iter and it % opt.densification_interval == 0:
                    size_threshold = 20 if it > opt.opacity_reset_interval else None
                    self.state = densify_event(
                        self.state,
                        max_grad=opt.densify_grad_threshold,
                        min_opacity=0.005,
                        extent=self.cameras_extent,
                        max_screen_size=size_threshold,
                        percent_dense=opt.percent_dense,
                        rng=self.rng,
                        capacity_bucket=self.capacity_bucket,
                    )
                if it % opt.opacity_reset_interval == 0 or (
                    self.model_cfg.white_background and it == opt.densify_from_iter
                ):
                    self.state = reset_opacity(self.state)
            if it in checkpoint_iterations and model_path:
                self.save_checkpoint(os.path.join(model_path, f"chkpnt{it}.npz"), it)
        return self.state

    def eval_psnr(self, cams=None, chunk: int = 256):
        cams = cams if cams is not None else self.test_cams
        vals, l1s = [], []
        for cam in cams:
            img = render_eval(self.state.scene, cam, self.bg, self.active_sh_degree, chunk)
            img = torch.clamp(img, 0.0, 1.0)
            gt = torch.clamp(torch.as_tensor(cam.image, dtype=torch.float32,
                                             device=img.device), 0.0, 1.0)
            vals.append(float(psnr(img, gt)))
            l1s.append(float(l1_loss(img, gt)))
        return float(np.mean(vals)), float(np.mean(l1s))
