"""sixdgs_torch.rays against sixdgs_tpu.rays: quadricell grids, PCA normals,
and generate_rays fed the JAX package's own random draws."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from sixdgs_tpu.rays import engine as jeng
from sixdgs_tpu.rays import normals as jnorm
from sixdgs_tpu.rays import quadricell as jqc
from sixdgs_tpu.scene.gaussians import from_arrays as j_from_arrays
from sixdgs_tpu.utils.config import PoseEstimationConfig as JCfg
from sixdgs_torch.rays import engine as teng
from sixdgs_torch.rays import normals as tnorm
from sixdgs_torch.rays import quadricell as tqc
from sixdgs_torch.scene.gaussians import from_arrays as t_from_arrays
from sixdgs_torch.utils.config import PoseEstimationConfig as TCfg
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)


def _t(x):
    return torch.tensor(np.asarray(x))


def _scene_arrays(n=300, seed=0):
    """The synthetic scene of tests/test_pose_e2e.py."""
    rng = np.random.default_rng(seed)
    return {
        "xyz": (rng.normal(size=(n, 3)) * 0.6).astype(np.float32),
        "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "features_rest": (rng.normal(size=(n, 15, 3)) * 0.2).astype(np.float32),
        "opacity": rng.uniform(1.0, 3.0, size=(n, 1)).astype(np.float32),
        "scaling": rng.uniform(-2.6, -2.0, size=(n, 3)).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
    }


def _scales(seed=1, n=64):
    rng = np.random.default_rng(seed)
    s = np.exp(rng.uniform(-4.0, -1.0, size=(n, 3))).astype(np.float32)
    s[:4, 0] *= 30.0  # needle-like: degraded
    return s


class TestQuadricell:
    def test_layout_and_mask_match(self):
        s = _scales()
        a, b, c = (s[:, i] for i in range(3))
        rings_j, side_j = jqc.ring_layout(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
        rings_t, side_t = tqc.ring_layout(_t(a), _t(b), _t(c))
        np.testing.assert_array_equal(rings_t.numpy(), np.asarray(rings_j))
        np.testing.assert_allclose(side_t.numpy(), np.asarray(side_j), rtol=1e-6)
        mask_t = tqc.mask_degraded_ellipsoids(_t(a), _t(b), _t(c)).numpy()
        np.testing.assert_array_equal(
            mask_t, np.asarray(jqc.mask_degraded_ellipsoids(*map(jnp.asarray, (a, b, c)))))
        assert not mask_t[:4].all() and mask_t[4:].any()

    def test_points_match(self):
        s = _scales(seed=2)
        a, b, c = (s[:, i] for i in range(3))
        ref = jqc.quadricell_points(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
        out = tqc.quadricell_points(_t(a), _t(b), _t(c))
        np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_allclose(out.points.numpy(), np.asarray(ref.points),
                                   atol=1e-6, rtol=1e-5)


class TestNormals:
    def test_estimate_normals_match(self):
        rng = np.random.default_rng(3)
        # noisy samples of a few planes: well-defined normals
        pts = rng.normal(size=(200, 3)).astype(np.float32)
        pts[:, 2] = 0.05 * pts[:, 2] + 0.3 * pts[:, 0]
        valid = rng.uniform(size=200) > 0.1
        ref = np.asarray(jnorm.estimate_normals(jnp.asarray(pts), 20,
                                                valid=jnp.asarray(valid)))
        out = tnorm.estimate_normals(_t(pts), 20, valid=_t(valid)).numpy()
        np.testing.assert_allclose(out[valid], ref[valid], atol=1e-4)
        np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)

    def test_disambiguation_matches(self):
        rng = np.random.default_rng(4)
        df = rng.normal(size=(30, 20, 3)).astype(np.float32)
        vecs = rng.normal(size=(30, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            tnorm.disambiguate_vector_directions(_t(df), _t(vecs)).numpy(),
            np.asarray(jnorm.disambiguate_vector_directions(jnp.asarray(df),
                                                            jnp.asarray(vecs))))


def shared_draws(key, capacity, max_ellipsoids, r_max=50, p_max=32):
    """The two priority vectors generate_rays draws, on the JAX key schedule."""
    k_sel, k_sub = jax.random.split(key)
    e = min(capacity, max_ellipsoids)
    return (np.asarray(jax.random.uniform(k_sel, (capacity,))),
            np.asarray(jax.random.uniform(k_sub, (e * r_max * p_max,))))


class TestGenerateRays:
    def test_matches_with_shared_draws(self):
        arrs = _scene_arrays()
        jscene = j_from_arrays(arrs, max_sh_degree=3, capacity=512)
        tscene = t_from_arrays(arrs, max_sh_degree=3, capacity=512, device="cpu")
        kw = dict(ray_budget=2048, max_ellipsoids=300)
        key = jax.random.key(7)
        ref = jeng.generate_rays_from_scene(jscene, key, JCfg(**kw))
        sel, sub = shared_draws(key, 512, 300)
        out = teng.generate_rays_from_scene(tscene, None, TCfg(**kw),
                                            select_priority=_t(sel),
                                            slot_priority=_t(sub))
        np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_array_equal(out.gaussian_idx.numpy(),
                                      np.asarray(ref.gaussian_idx))
        for name in ("ori", "dir", "rgb"):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=1e-5, rtol=1e-5, err_msg=name)
        assert out.valid.all()  # the budget is saturated at this size

    def test_padded_budget_and_generator(self):
        """Over-budget slots pad with invalid rays (ori/dir/rgb zero, index
        -1); with no draws given, a seeded generator makes them."""
        arrs = _scene_arrays(n=40, seed=5)
        tscene = t_from_arrays(arrs, max_sh_degree=3, capacity=64, device="cpu")
        jscene = j_from_arrays(arrs, max_sh_degree=3, capacity=64)
        kw = dict(ray_budget=4096, max_ellipsoids=100)
        key = jax.random.key(3)
        ref = jeng.generate_rays_from_scene(jscene, key, JCfg(**kw))
        sel, sub = shared_draws(key, 64, 100)
        out = teng.generate_rays_from_scene(tscene, None, TCfg(**kw),
                                            select_priority=_t(sel),
                                            slot_priority=_t(sub))
        np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_allclose(out.ori.numpy(), np.asarray(ref.ori), atol=1e-5)
        inv = ~out.valid
        assert inv.any() and (out.gaussian_idx[inv] == -1).all()
        assert (out.ori[inv] == 0).all() and (out.rgb[inv] == 0).all()

        g1 = teng.generate_rays_from_scene(tscene, torch.Generator().manual_seed(0),
                                           TCfg(**kw))
        g2 = teng.generate_rays_from_scene(tscene, torch.Generator().manual_seed(0),
                                           TCfg(**kw))
        np.testing.assert_array_equal(g1.ori.numpy(), g2.ori.numpy())
        assert int(g1.valid.sum()) == int(out.valid.sum())
