"""ID-module training.

Port of sixdgs_tpu/pose/trainer.py (reference pose_estimation/train.py:
16-317): 1500 iterations, 32 images per step, Adafactor with HF default
hyperparameters (relative step sizes min(1e-2, 1/sqrt(t)), parameter-scale
multiplication), rays regenerated every 10 iterations, distance-based score
loss + 0.1 * camera-up cosine loss, NaN images skipped, frozen DINO
backbone.

Batch axis: the reference package vmaps one jitted step over the image
batch. Here the ray features are computed once per step (they do not
depend on the image), each image is scored against them, and one backward
of the masked mean over finite per-image losses gives the same gradients.
With ``fused_attention=True`` each image's scores go through the fused
attention-score kernels (B1 forward, B2 backward), so no [256 x N_rays]
attention matrix is materialized in either direction.

Random draws: the batch picks come from ``np.random.default_rng(seed)``,
as in the reference package, so both pick the same images from one seed;
the ray regeneration draws from a ``torch.Generator`` seeded the same way
(its numbers differ from jax.random's, so tests set ``trainer.rays``).

The optimizer is ``Adafactor`` below, written to reproduce
``optax.adafactor`` as ``make_adafactor`` configures it in the reference
package (``torch.optim.Adafactor`` factors other axes and uses other
epsilons).
"""

from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from sixdgs_torch.pose.evaluate import prepare_image_mask
from sixdgs_torch.pose.id_module import compute_image_features, score_image_cached
from sixdgs_torch.pose.loss import cam_up_loss, distance_score_loss
from sixdgs_torch.rays.engine import Rays
from sixdgs_torch.utils.config import PoseEstimationConfig


class PoseBatch(NamedTuple):
    images: torch.Tensor  # [B, H, W, 3] float in [0,1]
    masks: torch.Tensor  # [B, H, W] bool
    c2w: torch.Tensor  # [B, 4, 4]


class FeatureBatch(NamedTuple):
    """Precomputed frozen-backbone features (cache-friendly training)."""

    feats_pe: torch.Tensor  # [B, 256, D+14]
    patch_mask: torch.Tensor  # [B, 256] bool
    fmap: torch.Tensor  # [B, D, 16, 16]
    c2w: torch.Tensor  # [B, 4, 4]


# ------------------------------------------------------------------ Adafactor


# make_adafactor's settings in the reference package (trainer.py:46-56)
DECAY_RATE = 0.8
EPS = 1e-30
CLIPPING_THRESHOLD = 1.0
MAX_STEP_SIZE = 1e-2
MIN_PARAM_SCALE = 1e-3  # optax's scale_by_param_block_rms default
MIN_DIM_SIZE_TO_FACTOR = 128  # optax.adafactor's default


def _factored_dims(shape):
    """optax's choice: the two largest axes (second largest, largest), when
    the second largest has at least MIN_DIM_SIZE_TO_FACTOR entries."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x)))


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(learning_rate=min(1e-2, 1/sqrt(t+1)),
    multiply_by_parameter_scale=True, clipping_threshold=1.0,
    decay_rate=0.8, eps=1e-30)``, the chain in its order:

    1. factored second moments with decay 1 - (t+1)^-0.8 over ``g^2 + eps``,
       factored over the two largest axes when the second largest has >= 128
       entries, a full ``v`` otherwise;
    2. clip by block RMS 1.0;
    3. times the relative step min(1e-2, 1/sqrt(t+1));
    4. times max(rms(param), 1e-3);
    5. subtracted from the parameter.

    Per-parameter state: ``step`` (int) and ``v_row``/``v_col`` or ``v``.
    ``nn.Linear`` weights are the transpose of the reference package's, so
    the factored state is laid out transposed; the update is symmetric in the
    two axes and agrees up to rounding.
    """

    def __init__(self, params):
        super().__init__(params, {})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, p.grad, self.state[p])

    @staticmethod
    def _update(p, g, st) -> None:
        dims = _factored_dims(tuple(p.shape))
        if not st:
            st["step"] = 0
            if dims is None:
                st["v"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                st["v_row"] = torch.zeros_like(p.sum(d0))
                st["v_col"] = torch.zeros_like(p.sum(d1))
        # schedules in float32, as the reference computes them
        t = torch.tensor(st["step"], dtype=torch.float32)
        decay = 1.0 - (t + 1.0) ** (-DECAY_RATE)
        g2 = g * g + EPS
        if dims is None:
            st["v"] = decay * st["v"] + (1.0 - decay) * g2
            u = g * st["v"] ** -0.5
        else:
            d1, d0 = dims
            st["v_row"] = decay * st["v_row"] + (1.0 - decay) * g2.mean(d0)
            st["v_col"] = decay * st["v_col"] + (1.0 - decay) * g2.mean(d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = st["v_row"].mean(reduced_d1, keepdim=True)
            row_factor = (st["v_row"] / row_col_mean) ** -0.5
            col_factor = st["v_col"] ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        u = u / torch.clamp_min(_rms(u) / CLIPPING_THRESHOLD, 1.0)
        u = torch.clamp_max(1.0 / torch.sqrt(t + 1.0), MAX_STEP_SIZE) * u
        rms = _rms(p)
        u = u * torch.where(rms <= MIN_PARAM_SCALE, torch.full_like(rms, MIN_PARAM_SCALE), rms)
        p.add_(-u)
        st["step"] += 1


def make_adafactor(params) -> Adafactor:
    """HF-default Adafactor (transformers.optimization.Adafactor with
    lr=None): relative step min(1e-2, 1/sqrt(t)), scale_parameter=True, no
    momentum, over ``params``."""
    return Adafactor(params)


# --------------------------------------------------------------------- losses


def _masked_mean(losses, score_losses, up_losses):
    """Mean over the finite per-image losses (train.py:176-177 skips NaN)."""
    ok = torch.isfinite(losses)
    n_ok = torch.clamp_min(torch.sum(ok.to(losses.dtype)), 1.0)
    zero = torch.zeros((), dtype=losses.dtype, device=losses.device)
    total = torch.sum(torch.where(ok, losses, zero)) / n_ok
    aux = {
        "loss": total,
        "loss_score": torch.sum(torch.where(ok, score_losses, zero)) / n_ok,
        "cam_up": torch.sum(torch.where(ok, up_losses, zero)) / n_ok,
        "n_nan": torch.sum((~ok).to(torch.int32)),
    }
    return total, aux


def batch_loss_cached(id_module, fbatch: FeatureBatch, rays: Rays,
                      model_up: torch.Tensor, fused_attention: bool = False):
    """Mean loss over the image batch from precomputed backbone features:
    (total, aux) with aux = {loss, loss_score, cam_up, n_nan}."""
    ray_feats = id_module.ray_mlp(rays.ori, rays.dir, rays.rgb)
    losses, score_losses, up_losses = [], [], []
    for b in range(fbatch.c2w.shape[0]):
        out = score_image_cached(id_module, fbatch.feats_pe[b], fbatch.patch_mask[b],
                                 fbatch.fmap[b], rays, fused_attention=fused_attention,
                                 ray_feats=ray_feats)
        loss_score, _ = distance_score_loss(out.scores, fbatch.c2w[b], rays.ori,
                                            rays.dir, rays.valid, out.n_patches)
        up = cam_up_loss(model_up, out.cam_up)
        losses.append(loss_score + 0.1 * up)
        score_losses.append(loss_score)
        up_losses.append(up)
    return _masked_mean(torch.stack(losses), torch.stack(score_losses),
                        torch.stack(up_losses))


@torch.no_grad()
def _features(dino_model, images, masks, backbone: str) -> tuple:
    feats = [compute_image_features(dino_model, img, mask, backbone=backbone)
             for img, mask in zip(images, masks)]
    return tuple(torch.stack([f[i] for f in feats]) for i in range(3))


def batch_loss(id_module, dino_model, batch: PoseBatch, rays: Rays,
               model_up: torch.Tensor, backbone: str = "dino",
               fused_attention: bool = False):
    """batch_loss_cached over backbone features computed here (the backbone
    is frozen, so under no_grad)."""
    feats_pe, patch_mask, fmap = _features(dino_model, batch.images, batch.masks,
                                           backbone)
    return batch_loss_cached(id_module, FeatureBatch(feats_pe, patch_mask, fmap,
                                                     batch.c2w),
                             rays, model_up, fused_attention)


def _step(id_module, optimizer, loss_fn) -> Dict[str, torch.Tensor]:
    optimizer.zero_grad(set_to_none=True)
    loss, aux = loss_fn()
    loss.backward()
    # zero NaN/inf gradients (a NaN image is skipped by the masked mean; this
    # guards batches that are NaN throughout)
    for p in id_module.parameters():
        if p.grad is not None:
            torch.nan_to_num_(p.grad, nan=0.0, posinf=0.0, neginf=0.0)
    optimizer.step()
    return {k: v.detach() for k, v in aux.items()}


def pose_train_step(id_module, optimizer, dino_model, batch: PoseBatch,
                    rays: Rays, model_up: torch.Tensor, backbone: str = "dino",
                    fused_attention: bool = False) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``id_module`` in place; returns aux. The
    step's gradients stay in the parameters' ``.grad``."""
    return _step(id_module, optimizer, lambda: batch_loss(
        id_module, dino_model, batch, rays, model_up, backbone, fused_attention))


def pose_train_step_cached(id_module, optimizer, fbatch: FeatureBatch,
                           rays: Rays, model_up: torch.Tensor,
                           fused_attention: bool = False) -> Dict[str, torch.Tensor]:
    """pose_train_step over precomputed backbone features."""
    return _step(id_module, optimizer, lambda: batch_loss_cached(
        id_module, fbatch, rays, model_up, fused_attention))


def model_up_from_cameras(cam_infos) -> np.ndarray:
    """Mean of train-camera R[:, 1] (pretrain_eval_attention.py:91-98)."""
    ups = np.asarray([c.R[:3, 1] for c in cam_infos], np.float32)
    return ups.mean(axis=0)


# ---------------------------------------------------------------- checkpoints


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists -> {"a/b/0/w": array}, the reference package's
    checkpoint key names."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    flat = {}
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            flat.update(_flatten(v, name + "/"))
        else:
            flat[name] = np.asarray(v)
    return flat


def _nest(flat: Dict[str, np.ndarray]):
    """The inverse of _flatten: digit-keyed levels become lists."""
    tree: dict = {}
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


def _load_params(module, data, prefix: str = "param:") -> None:
    from sixdgs_torch.weights import id_module_from_numpy

    tree = _nest({k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)})
    loaded = id_module_from_numpy(tree, device=next(module.parameters()).device)
    module.load_state_dict(loaded.state_dict())


class PoseTrainer:
    """Host orchestration of id-module training.

    Args:
        dino_model: frozen backbone (pose.dino.DinoViT or pose.superpoint.SuperPoint).
        id_module: pose.modules.IdModule; the trainer trains a deep copy.
        scene: GaussianScene the rays are cast from.
        train_cam_infos: CameraInfo list.
        fused_attention: score through the fused attention-score kernels.
        device: where the id module, caches and rays live ("cuda" unless
            the caller asks for the CPU).
    """

    def __init__(self, dino_model, id_module, scene, train_cam_infos,
                 cfg: Optional[PoseEstimationConfig] = None, seed: int = 55176280,
                 cache_features: bool = True, backbone: str = "dino",
                 fused_attention: bool = False, device="cuda"):
        self.cfg = cfg or PoseEstimationConfig()
        self.backbone = backbone
        self.fused_attention = fused_attention
        self.device = torch.device(device)
        self.dino_model = dino_model
        # own a copy: training updates the module in place
        self.id_module = copy.deepcopy(id_module).to(self.device)
        self.scene = scene
        self.train_cam_infos = train_cam_infos
        self.optimizer = make_adafactor(self.id_module.parameters())
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model_up = torch.tensor(model_up_from_cameras(train_cam_infos),
                                     device=self.device)
        self.rays: Optional[Rays] = None
        self.running_loss = 0.0
        # host-side cache of composited images/masks
        self._img_cache = [prepare_image_mask(c) for c in train_cam_infos]
        # frozen-backbone feature cache: the reference recomputes DINO
        # features on every accumulation step (train.py:146); they are
        # constants per camera while the backbone is locked, so they are
        # computed once and kept on the device, gathered by index per step
        self.cache_features = cache_features
        self._feat_cache = None
        if cache_features:
            self._feat_cache = _features(
                dino_model, *self._device_images(range(len(train_cam_infos))),
                backbone)

    def _device_images(self, idx):
        imgs = torch.tensor(np.stack([self._img_cache[i][0] for i in idx]),
                            device=self.device)
        masks = torch.tensor(np.stack([self._img_cache[i][1] for i in idx]),
                             device=self.device)
        return imgs, masks

    def _regen_rays(self):
        from sixdgs_torch.rays.engine import generate_rays_from_scene

        self.rays = generate_rays_from_scene(self.scene, self.generator, self.cfg)

    def _sample_batch(self):
        B = self.cfg.gradient_accumulation_steps
        idx = self.rng.integers(0, len(self.train_cam_infos), size=B)
        c2ws = torch.tensor(np.stack([self.train_cam_infos[i].c2w() for i in idx]),
                            dtype=torch.float32, device=self.device)
        if self.cache_features:
            idx_d = torch.as_tensor(idx, device=self.device)
            fp, pm, fm = self._feat_cache
            return FeatureBatch(feats_pe=fp.index_select(0, idx_d),
                                patch_mask=pm.index_select(0, idx_d),
                                fmap=fm.index_select(0, idx_d), c2w=c2ws)
        imgs, masks = self._device_images(idx)
        return PoseBatch(images=imgs, masks=masks, c2w=c2ws)

    def run(self, n_iterations: Optional[int] = None, start_iteration: int = 0,
            callback=None, log_every: int = 20, test_cam_infos=None,
            writer=None, validate_every: Optional[int] = None):
        """Train; every ``validate_every`` (cfg.val_every_n_iterations)
        steps, evaluate train + test cameras in target-score mode and log
        val translation/angular/recall, the reference's in-training
        validation (pose_estimation/train.py:214-303). ``callback(it, aux,
        trainer)`` gets aux as Python numbers."""
        cfg = self.cfg
        n_iterations = n_iterations if n_iterations is not None else cfg.n_iterations
        validate_every = (validate_every if validate_every is not None
                          else cfg.val_every_n_iterations)
        for it in range(start_iteration, n_iterations):
            if it % cfg.renewal_every_n_iterations == 0 or self.rays is None:
                self._regen_rays()
            batch = self._sample_batch()
            if self.cache_features:
                aux = pose_train_step_cached(self.id_module, self.optimizer, batch,
                                             self.rays, self.model_up,
                                             fused_attention=self.fused_attention)
            else:
                aux = pose_train_step(self.id_module, self.optimizer, self.dino_model,
                                      batch, self.rays, self.model_up,
                                      backbone=self.backbone,
                                      fused_attention=self.fused_attention)
            self.running_loss += float(aux["loss"])
            if it % log_every == log_every - 1 and (callback is not None or writer is not None):
                a = {k: v.item() for k, v in aux.items()}
                if callback is not None:
                    callback(it, a, self)
                if writer is not None:
                    writer.scalar("id_module/loss", a["loss"], it)
                    writer.scalar("id_module/loss_score", a["loss_score"], it)
                    writer.scalar("id_module/cam_up_loss", a["cam_up"], it)
            if validate_every and (it % validate_every == validate_every - 1):
                self.validate(it, test_cam_infos=test_cam_infos, writer=writer)
        return self.id_module

    def validate(self, iteration: int, test_cam_infos=None, writer=None,
                 max_images: Optional[int] = None):
        """train.py:214-303 analogue: target-score solve on train/test views."""
        from sixdgs_torch.pose.evaluate import test_pose_estimation

        out = {}
        splits = [("train_imgs", self.train_cam_infos)]
        if test_cam_infos:
            splits.append(("validation_imgs", test_cam_infos))
        for tag, infos in splits:
            infos = infos[:max_images] if max_images else infos
            _, t_err, a_err, loss_score, recall, _ = test_pose_estimation(
                infos, self.dino_model, self.id_module, self.rays, self.model_up,
                use_target_scores=True, k=self.cfg.rays_to_output,
                backbone=self.backbone, fused_attention=self.fused_attention,
            )
            out[tag] = {"translation_error": t_err, "angular_error": a_err,
                        "loss_score": loss_score, "recall": recall}
            if writer is not None:
                writer.scalar(f"{tag}/translation_error", t_err, iteration)
                writer.scalar(f"{tag}/angular_error", a_err, iteration)
                writer.scalar(f"{tag}/recall", recall, iteration)
                writer.scalar(f"{tag}/loss_score", loss_score, iteration)
        return out

    def save_checkpoint(self, path: str, epoch: int) -> None:
        """Full-state npz checkpoint with the reference's contents {epoch,
        model state, optimizer state, running_loss}
        (pose_estimation/train.py:309-317). Params carry the reference
        package's key names and layout (``param:ray_mlp/l1/w`` [in, out]),
        so either package loads the other's params; the Adafactor state has
        the port's own ``opt:<parameter>/<v_row|v_col|v>`` keys and
        ``opt:step``."""
        from sixdgs_torch.weights import id_module_to_numpy

        flat = _flatten(id_module_to_numpy(self.id_module), "param:")
        for name, p in self.id_module.named_parameters():
            st = self.optimizer.state.get(p, {})
            for key in ("v_row", "v_col", "v"):
                if key in st:
                    flat[f"opt:{name}/{key}"] = st[key].detach().cpu().numpy()
            if "step" in st:
                flat["opt:step"] = np.asarray(st["step"], np.int64)
        flat["epoch"] = np.asarray(epoch)
        flat["running_loss"] = np.asarray(self.running_loss, np.float64)
        np.savez(path, **flat)

    def restore_checkpoint(self, path: str) -> int:
        """Resume params + Adafactor state + running_loss; returns epoch. A
        checkpoint of the reference package restores params and
        running_loss; its optimizer state has other keys and is left as is."""
        data = np.load(path)
        _load_params(self.id_module, data)
        if "opt:step" in data.files:
            step = int(data["opt:step"])
            for name, p in self.id_module.named_parameters():
                st = {"step": step}
                for key in ("v_row", "v_col", "v"):
                    if f"opt:{name}/{key}" in data.files:
                        st[key] = torch.tensor(data[f"opt:{name}/{key}"], device=p.device)
                self.optimizer.state[p] = st
        self.running_loss = float(data["running_loss"]) if "running_loss" in data.files else 0.0
        return int(data["epoch"])

    @staticmethod
    def load_checkpoint(path: str, template_module):
        """Params-only load (inference path): (a copy of ``template_module``
        with the checkpoint's params, epoch)."""
        data = np.load(path)
        module = copy.deepcopy(template_module)
        _load_params(module, data)
        return module, int(data["epoch"])
