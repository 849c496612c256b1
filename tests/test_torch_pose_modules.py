"""sixdgs_torch.pose modules against sixdgs_tpu.pose on the same weights
(carried over by sixdgs_torch.weights) and the same numpy inputs: ray MLP,
attention, camera-up head, DINOv2 (narrow, and with the hub's 37x37
pos-embed grid), backbone preprocessing, and the initial distributions."""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sixdgs_tpu.pose import backbone as jbb
from sixdgs_tpu.pose import dino as jdino
from sixdgs_tpu.pose import modules as jmod
from sixdgs_torch import weights
from sixdgs_torch.pose import backbone as tbb
from sixdgs_torch.pose import dino as tdino
from sixdgs_torch.pose import modules as tmod
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)

# f32 matmuls on both sides, reduced in different orders: a few ulps of the
# activations' scale per layer
ATOL, RTOL = 2e-5, 1e-4


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def id_pair():
    jp = jmod.init_id_module(jax.random.key(2), feature_dim=64)
    return jp, weights.id_module_from_numpy(_np_tree(jp), device="cpu")


@pytest.fixture(scope="module")
def dino_pair():
    jp = jdino.init_params(jax.random.key(1), embed_dim=64, depth=2)
    # LayerScale at its 1e-5 init hides the blocks; make them count
    for blk in jp["blocks"]:
        blk["ls1"] = jnp.full_like(blk["ls1"], 0.5)
        blk["ls2"] = jnp.full_like(blk["ls2"], 0.5)
    return jp, weights.dino_from_numpy(_np_tree(jp), device="cpu")


class TestIdModuleParts:
    def test_ray_mlp(self, id_pair):
        jp, tm = id_pair
        rng = np.random.default_rng(0)
        ori, d, rgb = (rng.normal(size=(300, 3)).astype(np.float32) for _ in range(3))
        ref = np.asarray(jmod.ray_mlp_apply(jp["ray_mlp"], *map(jnp.asarray, (ori, d, rgb))))
        with torch.no_grad():
            out = tm.ray_mlp(_t(ori), _t(d), _t(rgb)).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)

    def test_attention(self, id_pair):
        jp, tm = id_pair
        rng = np.random.default_rng(1)
        img = rng.normal(size=(256, 78)).astype(np.float32)
        rays = rng.normal(size=(500, 64)).astype(np.float32)
        valid = rng.uniform(size=500) > 0.2
        ref = np.asarray(jmod.attention_scores(jp["attention"], jnp.asarray(img),
                                               jnp.asarray(rays), jnp.asarray(valid)))
        with torch.no_grad():
            out = tmod.attention_scores(tm.attention, _t(img), _t(rays), _t(valid)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-4)
        assert (out[:, ~valid] == 0).all()

    def test_cam_up(self, id_pair):
        jp, tm = id_pair
        fmap = np.random.default_rng(2).normal(size=(64, 16, 16)).astype(np.float32)
        ref = np.asarray(jmod.cam_up_apply(jp["cam_up"], jnp.asarray(fmap)))
        with torch.no_grad():
            out = tm.cam_up(_t(fmap)).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)

    def test_positional_encoding(self):
        x = np.random.default_rng(3).normal(size=(10, 3)).astype(np.float32)
        np.testing.assert_allclose(tmod.positional_encoding(_t(x), 8).numpy(),
                                   np.asarray(jmod.positional_encoding(jnp.asarray(x), 8)),
                                   atol=1e-5)


class TestDino:
    def test_forward_matches(self, dino_pair):
        jp, tm = dino_pair
        img = np.random.default_rng(4).normal(size=(3, 224, 224)).astype(np.float32)
        ref = jdino.forward_features(jp, jnp.asarray(img))
        with torch.no_grad():
            out = tm.forward_features(_t(img))
        for k in ("x_norm_patchtokens", "x_norm_clstoken"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                       atol=1e-4, rtol=1e-4, err_msg=k)

    def test_hub_grid_pos_embed_resize(self):
        """The hub checkpoint's 37x37 pos-embed grid, resampled bicubically
        (antialiased) to the 16x16 grid of a 224 crop."""
        jp = jdino.init_params(jax.random.key(5), embed_dim=64, depth=1,
                               num_patches=37 * 37)
        tm = weights.dino_from_numpy(_np_tree(jp), device="cpu")
        np.testing.assert_allclose(
            tdino.interpolate_pos_embed(tm.pos_embed.detach(), 16, 16).numpy(),
            np.asarray(jdino.interpolate_pos_embed(jp["pos_embed"], 16, 16)),
            atol=1e-6)
        img = np.random.default_rng(6).normal(size=(3, 224, 224)).astype(np.float32)
        ref = jdino.forward_features(jp, jnp.asarray(img))["x_norm_patchtokens"]
        with torch.no_grad():
            out = tm.forward_features(_t(img))["x_norm_patchtokens"]
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


class TestBackbone:
    def test_preprocessing_non_square(self):
        rng = np.random.default_rng(7)
        img = rng.uniform(size=(90, 130, 3)).astype(np.float32)
        mask = np.zeros((90, 130), bool)
        mask[20:70, 30:100] = True
        np.testing.assert_allclose(tbb.preprocess_image(_t(img)).numpy(),
                                   np.asarray(jbb.preprocess_image(jnp.asarray(img))),
                                   atol=1e-4)
        pm_t = tbb.preprocess_mask(_t(mask)).numpy()
        np.testing.assert_array_equal(pm_t, np.asarray(jbb.preprocess_mask(jnp.asarray(mask))))
        assert 0 < pm_t.sum() < pm_t.size
        np.testing.assert_array_equal(tbb.image_position_encoding(device="cpu").numpy(),
                                      np.asarray(jbb.image_position_encoding()))

    def test_backbone_features(self, dino_pair):
        jp, tm = dino_pair
        rng = np.random.default_rng(8)
        img = rng.uniform(size=(120, 80, 3)).astype(np.float32)
        mask = rng.uniform(size=(120, 80)) > 0.4
        ref = jbb.backbone_features(jp, jnp.asarray(img), jnp.asarray(mask))
        with torch.no_grad():
            out = tbb.backbone_features(tm, _t(img), _t(mask))
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), atol=1e-4, rtol=1e-4)
        # "superpoint" is a backbone now (tests/test_torch_superpoint_lpips.py);
        # a name that is neither is refused
        with pytest.raises(ValueError, match="backbone"):
            tbb.backbone_features(tm, _t(img), _t(mask), backbone="nope")


class TestWeights:
    def test_converter_layouts(self, id_pair, dino_pair):
        jp, tm = dino_pair
        np.testing.assert_array_equal(
            tm.patch_embed.weight.detach().numpy(),
            np.transpose(np.asarray(jp["patch_embed"]["w"]), (3, 2, 0, 1)))
        np.testing.assert_array_equal(tm.blocks[1].fc1.weight.detach().numpy(),
                                      np.asarray(jp["blocks"][1]["fc1"]["w"]).T)
        assert tm.blocks[0].norm1.eps == 1e-6 and tm.blocks[0].num_heads == 1
        jip, tim = id_pair
        np.testing.assert_array_equal(tim.cam_up.conv1[2].weight.detach().numpy(),
                                      np.asarray(jip["cam_up"]["conv1"][2]["w"]))
        np.testing.assert_array_equal(tim.attention.k.weight.detach().numpy(),
                                      np.asarray(jip["attention"]["k"]["w"]).T)
        with pytest.raises(ValueError):
            bad = _np_tree(jip)
            bad["attention"]["k"]["b"] = np.zeros(3, np.float32)
            weights.id_module_from_numpy(bad, device="cpu")

    def test_full_width_shapes_match(self):
        """init_* at full width give the JAX package's parameter shapes."""
        shapes = jax.eval_shape(lambda k: jmod.init_id_module(k), jax.random.key(0))
        jid = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
        tid = tmod.init_id_module(torch.Generator().manual_seed(0), device="cpu")
        ref = weights.id_module_from_numpy(jid, device="cpu")
        assert [(n, p.shape) for n, p in tid.named_parameters()] == \
               [(n, p.shape) for n, p in ref.named_parameters()]
        dshapes = jax.eval_shape(lambda k: jdino.init_params(k, num_patches=37 * 37),
                                 jax.random.key(0))
        jd = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dshapes)
        td = tdino.init_params(torch.Generator().manual_seed(0), num_patches=37 * 37,
                               device="cpu")
        assert [(n, p.shape) for n, p in td.named_parameters()] == \
               [(n, p.shape) for n, p in weights.dino_from_numpy(jd, "cpu").named_parameters()]
        assert len(td.blocks) == 12 and td.blocks[0].num_heads == 6


class TestInitDistributions:
    """init_* draw from the JAX package's distributions (not its streams)."""

    def test_id_module(self):
        tid = tmod.init_id_module(torch.Generator().manual_seed(1), feature_dim=64,
                                  device="cpu")
        l1 = tid.ray_mlp.l1
        bound = 1.0 / math.sqrt(l1.in_features)
        w = l1.weight.detach()
        assert w.abs().max() <= bound and abs(w.std().item() - bound / math.sqrt(3)) < 0.05 * bound
        k = tid.attention.k
        xb = math.sqrt(6.0 / (k.in_features + k.out_features))
        assert k.weight.abs().max() <= xb and (k.bias == 0).all()
        conv = tid.cam_up.conv1[0]
        assert conv.weight.abs().max() <= 1.0 / math.sqrt(64 * 25)
        again = tmod.init_id_module(torch.Generator().manual_seed(1), feature_dim=64,
                                    device="cpu")
        assert torch.equal(again.cam_up.mlp2.weight, tid.cam_up.mlp2.weight)

    def test_dino(self):
        td = tdino.init_params(torch.Generator().manual_seed(2), embed_dim=64, depth=2,
                               device="cpu")
        assert abs(td.pos_embed.std().item() - 0.02) < 0.002
        fc1 = td.blocks[0].fc1.weight.detach()
        assert abs(fc1.std().item() - 1.0 / math.sqrt(64)) < 0.01
        assert (td.blocks[1].ls2 == 1e-5).all() and (td.norm.weight == 1).all()
