"""The id-module batch loss image by image, as the trainer computed it
before its step ran over the image axis: the reference that the batched
``trainer.batch_loss_cached`` is held to, on the CPU
(``test_torch_pose_trainer.py``) and on the card
(``test_torch_batched_step.py``). Also the one-image forms of the loss
formulas and the camera-up head as they were, which their broadcasting
forms must still equal bit for bit on one image.

Imports torch and sixdgs_torch only (the card's machine has no JAX);
imported as ``per_image_loss``.
"""

import math

import torch
import torch.nn.functional as F

from sixdgs_torch.pose import trainer
from sixdgs_torch.pose.id_module import score_image_cached
from sixdgs_torch.pose.loss import TargetScores, cam_up_loss, distance_score_loss
from sixdgs_torch.pose.modules import _conv_valid, init_id_module
from sixdgs_torch.rays.engine import Rays

# (feature width, patch grid, images, rays): DINO's 16 x 16 grid and
# SuperPoint's 28 x 28 (784 patches, the scorer's chunk-and-pad path)
SMALL = {"dino": (32, 16, 3, 512), "superpoint": (32, 28, 3, 512)}
FULL = {"dino": (384, 16, 32, 32768), "superpoint": (256, 28, 32, 32768)}
# float32 on both sides; the batch's GEMMs sum in other orders than the
# per-image ones: each loss, and each gradient's largest difference over
# its own largest entry
RTOL = 1e-6
# the two parameters whose true gradient is zero (test_torch_pose_trainer.py):
# rounding noise, held against the module's largest gradient entry
ZERO_GRAD_PARAMS = ("attention.k.bias", "ray_mlp.l4.bias")


def random_step(shape, nan_image: bool, device="cpu", seed=0):
    """(id module, FeatureBatch, rays, model_up) at ``shape`` from ``seed``:
    a quarter of the rays invalid, each image a different patch count; with
    ``nan_image`` the second image's camera is NaN, so its loss is."""
    d, grid, b, n = shape
    g = torch.Generator().manual_seed(seed)
    idm = init_id_module(torch.Generator().manual_seed(seed + 1), feature_dim=d, grid=grid,
                         device=device)
    c2w = torch.eye(4).repeat(b, 1, 1)
    c2w[:, :3, :3] = torch.linalg.qr(torch.randn(b, 3, 3, generator=g))[0]
    c2w[:, :3, 3] = 2.0 * torch.randn(b, 3, generator=g)
    if nan_image:
        c2w[1, 0, 3] = math.nan
    fbatch = trainer.FeatureBatch(
        feats_pe=torch.randn(b, grid * grid, d + 14, generator=g),
        patch_mask=torch.rand(b, grid * grid, generator=g) < torch.linspace(0.3, 0.9, b)[:, None],
        fmap=torch.randn(b, d, grid, grid, generator=g), c2w=c2w)
    rays = Rays(ori=torch.randn(n, 3, generator=g),
                dir=F.normalize(torch.randn(n, 3, generator=g), dim=-1),
                rgb=torch.rand(n, 3, generator=g), valid=torch.rand(n, generator=g) > 0.25,
                gaussian_idx=torch.zeros(n, dtype=torch.int32))
    up = torch.tensor([0.05, 0.9, 0.1])
    move = lambda t: t.to(device)  # noqa: E731
    return (idm, trainer.FeatureBatch(*map(move, fbatch)), Rays(*map(move, rays)),
            move(up))


def loss_and_grads(loss_fn, id_module, fbatch, rays, model_up, fused_attention):
    """(aux as floats, {parameter: gradient}) of one forward and backward."""
    id_module.zero_grad(set_to_none=True)
    loss, aux = loss_fn(id_module, fbatch, rays, model_up, fused_attention=fused_attention)
    loss.backward()
    return ({k: float(v.detach()) for k, v in aux.items()},
            {n: p.grad.detach().clone() for n, p in id_module.named_parameters()})


def _finite_max(t) -> float:
    t = t[torch.isfinite(t)]
    return t.abs().max().item() if t.numel() else 0.0


def gaps(got, want):
    """{name: gap}: each aux value's relative gap and each gradient's
    largest difference over its own largest entry (ZERO_GRAD_PARAMS: over
    the module's), over the entries finite on both sides (NaN entries must
    match: checked by the caller)."""
    out = {}
    for k, w in want[0].items():
        out[k] = abs(got[0][k] - w) / max(abs(w), 1e-30)
    top = max(_finite_max(w) for w in want[1].values())
    for name, w in want[1].items():
        ok = torch.isfinite(w) & torch.isfinite(got[1][name])
        scale = top if name in ZERO_GRAD_PARAMS else _finite_max(w[ok])
        err = (got[1][name][ok] - w[ok]).abs().max().item() if ok.any() else 0.0
        out[name] = err / scale if scale > 0 else err
    return out


def nan_entries_match(got, want) -> bool:
    return all(torch.equal(torch.isnan(got[1][n]), torch.isnan(w)) for n, w in want[1].items())


def batch_loss_per_image(id_module, fbatch, rays, model_up, fused_attention=False,
                         relu_masks=None):
    """(total, aux) of ``trainer.batch_loss_cached``: each image scored and
    its losses taken in turn against one ray-MLP output. ``relu_masks``
    (``head_preactivations`` of the batch, > 0) gates the camera-up head's
    ReLUs of each image as the batch's forward gates them."""
    ray_feats = id_module.ray_mlp(rays.ori, rays.dir, rays.rgb)
    losses, score_losses, up_losses = [], [], []
    for b in range(fbatch.c2w.shape[0]):
        out = score_image_cached(id_module, fbatch.feats_pe[b], fbatch.patch_mask[b],
                                 fbatch.fmap[b], rays, fused_attention=fused_attention,
                                 ray_feats=ray_feats)
        loss_score, _ = distance_score_loss(out.scores, fbatch.c2w[b], rays.ori,
                                            rays.dir, rays.valid, out.n_patches)
        cam_up = out.cam_up
        if relu_masks is not None:
            cam_up = unit_one(cam_up_head_one(id_module.cam_up, fbatch.fmap[b],
                                              [m[b] for m in relu_masks]))
        up = cam_up_loss(model_up, cam_up)
        losses.append(loss_score + 0.1 * up)
        score_losses.append(loss_score)
        up_losses.append(up)
    return trainer._masked_mean(torch.stack(losses), torch.stack(score_losses),
                                torch.stack(up_losses))


# ------------------------------------------------ one image, as it was written


def target_ray_scores(c2w, rays_ori, rays_dir, rays_valid, n_patches, tanh_denominator=1.0):
    gt_pos = c2w[:3, 3]
    to_cam = gt_pos[None, :] - rays_ori
    proj_len = torch.sum(to_cam * rays_dir, dim=-1, keepdim=True)
    closest = torch.where(proj_len < 0, rays_ori, rays_ori + proj_len * rays_dir)
    dist = torch.linalg.norm(closest - gt_pos[None, :], dim=-1)
    target = 1.0 - torch.tanh(dist / tanh_denominator)
    cam_z = c2w[:3, 2]
    cam_proj = torch.sum((rays_ori - gt_pos[None, :]) * cam_z[None, :], dim=-1)
    sign = torch.where(cam_proj == 0, 0.0, (torch.sign(cam_proj) + 1.0) * 0.5)
    target = target * sign
    target = torch.where(rays_valid, target, 0.0)
    point_dist = torch.linalg.norm(to_cam, dim=-1)
    point_score = 1.0 - torch.tanh(point_dist / tanh_denominator)
    target_with_distance = target * point_score
    scale = n_patches.to(target.dtype) / torch.sum(target)
    return TargetScores(target=target * scale, target_raw=target,
                        target_with_distance=target_with_distance)


def distance_score_loss_one(pred_scores, c2w, rays_ori, rays_dir, rays_valid, n_patches):
    tgt = target_ray_scores(c2w, rays_ori, rays_dir, rays_valid, n_patches)
    target = torch.where(rays_valid, tgt.target, 0.0)
    diff = torch.square(pred_scores - target)
    n_valid = torch.clamp_min(torch.sum(rays_valid.to(diff.dtype)), 1.0)
    loss = torch.sum(torch.where(rays_valid, diff, 0.0)) / n_valid
    return loss, target


def cam_up_loss_one(model_up, cam_up):
    mu = model_up / torch.clamp_min(torch.linalg.norm(model_up), 1e-12)
    cu = cam_up / torch.clamp_min(torch.linalg.norm(cam_up), 1e-12)
    return -0.5 * torch.sum(mu * cu) + 0.5


def unit_one(v):
    """score_image_cached's normalisation of the camera-up vector."""
    return v / torch.clamp_min(torch.linalg.norm(v), 1e-12)


def cam_up_head_one(head, feature_map, masks=None):
    """CamUpHead.forward on one [C, G, G] feature map; with ``masks`` (one
    bool tensor a ReLU) each ReLU passes where its mask is set."""
    relu = (lambda pre, i: F.relu(pre)) if masks is None else (lambda pre, i: pre * masks[i])
    x = feature_map
    for i, conv in enumerate((*head.conv1, *head.conv2)):
        o, _, kh, kw = conv.weight.shape
        hout, wout = x.shape[1] - kh + 1, x.shape[2] - kw + 1
        cols = F.unfold(x[None], (kh, kw))[0]
        x = relu((conv.weight.reshape(o, -1) @ cols + conv.bias[:, None])
                 .reshape(o, hout, wout), i)
    return head.mlp2(relu(head.mlp1(x.reshape(-1)), 4))


@torch.no_grad()
def head_preactivations(head, fmap):
    """The camera-up head's five ReLU inputs over a batch [B, C, G, G], as
    ``CamUpHead.forward`` forms them."""
    pres, x = [], fmap
    for conv in (*head.conv1, *head.conv2):
        pres.append(_conv_valid(x, conv))
        x = F.relu(pres[-1])
    pres.append(head.mlp1(x.reshape(x.shape[0], -1)))
    return pres


def as_before(monkeypatch):
    """Put the one-image forms above in the program's place (the pose
    request's path as it was)."""
    from sixdgs_torch.pose import evaluate, id_module, modules

    monkeypatch.setattr(evaluate, "distance_score_loss", distance_score_loss_one)
    monkeypatch.setattr(id_module, "_unit", unit_one)
    monkeypatch.setattr(modules.CamUpHead, "forward", cam_up_head_one)

