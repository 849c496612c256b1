"""The ported pose path as a whole against sixdgs_tpu: scene -> rays (the
JAX draws shared) -> DINOv2 + ray MLP + attention + camera-up head -> loss
-> top-100 solve, on a small synthetic scene with narrow random weights.

The JAX side scores with fused_attention=False: its Pallas kernel is called
without an interpret flag there and cannot run on the CPU. The port runs
both of its scorers (on the CPU the fused one is the kernel's plain
version). Poses are compared on the target-score solve: with predicted
scores, near-tied rays can swap in and out of the top 100 between
jax.lax.top_k and torch.topk.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sixdgs_tpu.pose import dino as jdino
from sixdgs_tpu.pose import evaluate as jev
from sixdgs_tpu.pose import id_module as jid
from sixdgs_tpu.pose import modules as jmod
from sixdgs_tpu.rays.engine import generate_rays_from_scene as j_gen
from sixdgs_tpu.scene.gaussians import from_arrays as j_from_arrays
from sixdgs_tpu.scene.structures import CameraInfo as JCam
from sixdgs_tpu.utils.config import PoseEstimationConfig as JCfg
from sixdgs_torch import weights
from sixdgs_torch.pose import evaluate as tev
from sixdgs_torch.pose import id_module as tid
from sixdgs_torch.rays.engine import generate_rays_from_scene as t_gen
from sixdgs_torch.scene.gaussians import from_arrays as t_from_arrays
from sixdgs_torch.scene.structures import CameraInfo as TCam
from sixdgs_torch.utils.config import PoseEstimationConfig as TCfg
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)

SIZE = 64


def _t(x):
    return torch.tensor(np.asarray(x))


def _look_at(pos):
    z = -pos / np.linalg.norm(pos)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)  # R_w2c


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    n = 300
    arrs = {
        "xyz": (rng.normal(size=(n, 3)) * 0.6).astype(np.float32),
        "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "features_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32),
        "opacity": rng.uniform(1.0, 3.0, size=(n, 1)).astype(np.float32),
        "scaling": rng.uniform(-2.6, -2.0, size=(n, 3)).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
    }
    kw = dict(ray_budget=2048, max_ellipsoids=300)
    key = jax.random.key(7)
    j_rays = j_gen(j_from_arrays(arrs, 3, capacity=512), key, JCfg(**kw))
    k_sel, k_sub = jax.random.split(key)
    t_rays = t_gen(t_from_arrays(arrs, 3, capacity=512, device="cpu"), None, TCfg(**kw),
                   select_priority=_t(jax.random.uniform(k_sel, (512,))),
                   slot_priority=_t(jax.random.uniform(k_sub, (300 * 50 * 32,))))

    j_dino = jdino.init_params(jax.random.key(1), embed_dim=64, depth=2)
    j_idm = jmod.init_id_module(jax.random.key(2), feature_dim=64)
    t_dino = weights.dino_from_numpy(jax.tree.map(np.asarray, j_dino), device="cpu")
    t_idm = weights.id_module_from_numpy(jax.tree.map(np.asarray, j_idm), device="cpu")

    cams = []
    for i in range(2):
        ang = 2 * np.pi * i / 2 + 0.3
        pos = np.array([1.8 * np.cos(ang), 0.4, 1.8 * np.sin(ang)])
        R_w2c = _look_at(pos)
        img = (rng.uniform(size=(SIZE, SIZE, 4)) * 255).astype(np.uint8)
        img[..., 3] = 0
        img[12:52, 8:56, 3] = 255  # foreground from the alpha channel
        cams.append(dict(uid=i, R=R_w2c.T, T=-R_w2c @ pos, FovY=0.9, FovX=0.9, image=img,
                         image_path="", image_name=f"cam{i}", width=SIZE, height=SIZE))
    return j_rays, t_rays, j_dino, j_idm, t_dino, t_idm, cams


def _inputs(cam):
    img, mask = tev.prepare_image_mask(TCam(**cam))
    return img, mask, TCam(**cam).c2w().astype(np.float32)


class TestPosePathParity:
    def test_rays_agree(self, setup):
        j_rays, t_rays = setup[:2]
        np.testing.assert_array_equal(t_rays.valid.numpy(), np.asarray(j_rays.valid))
        np.testing.assert_allclose(t_rays.ori.numpy(), np.asarray(j_rays.ori), atol=1e-5)

    def test_scores_cam_up_and_loss(self, setup):
        j_rays, t_rays, j_dino, j_idm, t_dino, t_idm, cams = setup
        img, mask, c2w = _inputs(cams[0])
        ref = jid.score_image(j_dino, j_idm, jnp.asarray(img), jnp.asarray(mask), j_rays)
        ref_eval = jev.eval_image(j_dino, j_idm, jnp.asarray(img), jnp.asarray(mask),
                                  jnp.asarray(c2w), j_rays)
        assert 0 < int(ref.n_patches) < 256
        scale = float(np.abs(np.asarray(ref.scores)).max())
        for fused in (False, True):
            out = tev.eval_image(t_dino, t_idm, _t(img), _t(mask), _t(c2w), t_rays,
                                 fused_attention=fused)
            np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref.scores),
                                       atol=1e-4 * scale, rtol=1e-3)
            np.testing.assert_allclose(out["cam_up"].numpy(), np.asarray(ref.cam_up),
                                       atol=1e-4)
            np.testing.assert_allclose(out["loss_score"].item(),
                                       float(ref_eval["loss_score"]), rtol=1e-3)
            assert out["c2w"].shape == (4, 4) and torch.isfinite(out["c2w"]).all()
        # the two scorers of the port agree more tightly than either with JAX
        plain = tid.score_image(t_dino, t_idm, _t(img), _t(mask), t_rays)
        with torch.no_grad():
            fused = tid.score_image(t_dino, t_idm, _t(img), _t(mask), t_rays,
                                    fused_attention=True)
        np.testing.assert_allclose(fused.scores.numpy(), plain.scores.detach().numpy(),
                                   atol=1e-6 * scale + 1e-9, rtol=1e-4)
        assert fused.attention.shape == (0, 0)

    def test_target_score_pose_matches(self, setup):
        j_rays, t_rays, j_dino, j_idm, t_dino, t_idm, cams = setup
        img, mask, c2w = _inputs(cams[1])
        ref = jev.eval_image(j_dino, j_idm, jnp.asarray(img), jnp.asarray(mask),
                             jnp.asarray(c2w), j_rays, use_target_scores=True)
        out = tev.eval_image(t_dino, t_idm, _t(img), _t(mask), _t(c2w), t_rays,
                             use_target_scores=True, fused_attention=True)
        np.testing.assert_allclose(out["c2w"].numpy(), np.asarray(ref["c2w"]), atol=1e-3)
        for k in ("translation_error", "recall", "mean_weight"):
            np.testing.assert_allclose(out[k].item(), float(ref[k]), atol=1e-3, rtol=1e-3,
                                       err_msg=k)
        np.testing.assert_allclose(out["angular_error"].item(), float(ref["angular_error"]),
                                   atol=0.05)
        assert out["translation_error"].item() < 0.6  # cameras sit at radius 1.8

    def test_test_pose_estimation_matches(self, setup):
        j_rays, t_rays, j_dino, j_idm, t_dino, t_idm, cams = setup
        model_up = np.array([0.0, 1.0, 0.0], np.float32)
        ref = jev.test_pose_estimation([JCam(**c) for c in cams], j_dino, j_idm, j_rays,
                                       jnp.asarray(model_up), use_target_scores=True)
        out = tev.test_pose_estimation([TCam(**c) for c in cams], t_dino, t_idm, t_rays,
                                       _t(model_up), use_target_scores=True,
                                       fused_attention=True)
        assert len(out[0]) == len(ref[0]) == 2
        np.testing.assert_allclose(out[1:5], ref[1:5], atol=0.05, rtol=1e-3)
        for r_out, r_ref in zip(out[0], ref[0]):
            assert r_out["frame_id"] == r_ref["frame_id"]
            np.testing.assert_allclose(r_out["pred_c2w"], r_ref["pred_c2w"], atol=1e-3)
            np.testing.assert_allclose(r_out["gt_c2w"], r_ref["gt_c2w"], atol=1e-6)
