"""sixdgs_torch's 3DGS training against sixdgs_tpu's, on the CPU.

The same numpy inputs go through the JAX function and its port: the image
losses, Adam, the learning-rate schedule, kNN and the point-cloud
initialisation, ``train_step`` (three steps from one state, on the tile
rasterizer and on the golden one), opacity reset, densification (the same
numpy generator), the tier policies, ``GSTrainer.run`` on a 32x32 ring
dataset, and checkpoints in both directions. The JAX side's Pallas kernels
run in interpret mode (``rasterizer="pallas_interpret"``); the port's
wrappers run their plain versions on CPU tensors.

Tolerances are stated where they are used. The recurring one: Adam divides
the gradient by its own magnitude, so the first updates are lr * sign(g)
and an entry whose gradient is rounding noise can differ by up to 2 lr per
step between two correct implementations. Parameters are therefore held
to 2 lr per step at worst and to a small fraction of lr on average, and
the moments, which are linear in the gradient, to the gradient's own
tolerance.
"""

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdgs_tpu.ops import knn as jknn
from sixdgs_tpu.scene import cameras as jscam
from sixdgs_tpu.scene import gaussians as jg
from sixdgs_tpu.scene import structures as jstruct
from sixdgs_tpu.train import checkpoint as jckpt
from sixdgs_tpu.train import gs_trainer as jtrain
from sixdgs_tpu.train import optim as joptim
from sixdgs_tpu.utils import config as jconfig
from sixdgs_torch.ops import knn as tknn
from sixdgs_torch.ops import ssim as tssim
from sixdgs_torch.ops.rasterizer import pallas_tiles as tpt
from sixdgs_torch.scene import cameras as tscam
from sixdgs_torch.scene import gaussians as tg
from sixdgs_torch.scene import structures as tstruct
from sixdgs_torch.train import checkpoint as tckpt
from sixdgs_torch.train import gs_trainer as ttrain
from sixdgs_torch.train import optim as toptim
from sixdgs_torch.utils import config as tconfig
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)

# the package's ops/__init__ re-exports the function under the module's name
jssim = importlib.import_module("sixdgs_tpu.ops.ssim")
PARAMS = tg.PARAM_NAMES


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ small ops


class TestImageLosses:
    @pytest.mark.parametrize("shape", [(3, 40, 56), (3, 16, 16), (1, 9, 30)])
    def test_values_and_image_gradient(self, shape):
        """SSIM, PSNR, L1, L2 and the photometric loss, and the loss's
        gradient with respect to the image: the same float32 stencil in
        both packages, so 1e-5 relative (sums in another order)."""
        rng = np.random.default_rng(0)
        gt = rng.uniform(size=shape).astype(np.float32)
        img = np.clip(gt + rng.normal(size=shape).astype(np.float32) * 0.1, 0, 1)
        img[:, : shape[1] // 2, : shape[2] // 3] = 0.5  # a flat region: sigma cancels
        for name in ("ssim", "psnr", "l1_loss", "l2_loss"):
            want = getattr(jssim, name)(jnp.asarray(img), jnp.asarray(gt))
            got = getattr(tssim, name)(_t(img), _t(gt))
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, err_msg=name)
        (wl, wl1), wg = jax.value_and_grad(
            lambda x: jssim.dssim_l1_loss(x, jnp.asarray(gt), 0.2), has_aux=True)(
                jnp.asarray(img))
        x = _t(img).requires_grad_()
        gl, gl1 = tssim.dssim_l1_loss(x, _t(gt), 0.2)
        np.testing.assert_allclose(_np(gl), np.asarray(wl), rtol=1e-5)
        np.testing.assert_allclose(_np(gl1), np.asarray(wl1), rtol=1e-5)
        (gg,) = torch.autograd.grad(gl, x)
        np.testing.assert_allclose(_np(gg), np.asarray(wg), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(wg)).max())

    def test_ssim_of_identical_images_is_one(self):
        img = _t(np.random.default_rng(1).uniform(size=(3, 20, 24)).astype(np.float32))
        assert abs(float(tssim.ssim(img, img)) - 1.0) < 1e-6


class TestOptim:
    def test_adam_update_five_steps(self):
        """Parameters, both moments and the step count over five updates of
        the six-name dict with its own learning rates (float32 rounding:
        1e-6 relative)."""
        rng = np.random.default_rng(9)
        shapes = {"xyz": (7, 3), "features_dc": (7, 1, 3), "features_rest": (7, 15, 3),
                  "opacity": (7, 1), "scaling": (7, 3), "rotation": (7, 4)}
        p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        lrs = ttrain.lr_dict(tconfig.OptimizationConfig(), 4.0, 10)
        jp, js = {k: jnp.asarray(v) for k, v in p0.items()}, None
        tp = {k: _t(v) for k, v in p0.items()}
        js, ts = joptim.adam_init(jp), toptim.adam_init(tp)
        for _ in range(5):
            g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
            jp, js = joptim.adam_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js,
                                        {k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()})
            tp, ts = toptim.adam_update(tp, {k: _t(v) for k, v in g.items()}, ts, lrs)
        assert int(ts.step) == int(js.step) == 5 and ts.step.dtype == torch.int32
        for k in shapes:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(_np(ts.m[k]), np.asarray(js.m[k]), rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(_np(ts.v[k]), np.asarray(js.v[k]), rtol=1e-6, atol=1e-9)

    @pytest.mark.parametrize("step", [0, 1, 500, 30_000, 40_000])
    def test_expon_lr_and_lr_dict(self, step):
        args = (1.6e-4 * 4, 1.6e-6 * 4)
        for kw in ({}, {"lr_delay_steps": 100, "lr_delay_mult": 0.01}):
            assert toptim.expon_lr(step, *args, max_steps=30_000, **kw) == joptim.expon_lr(
                step, *args, max_steps=30_000, **kw)
        assert toptim.expon_lr(step, 0.0, 0.0) == 0.0
        opt = tconfig.OptimizationConfig()
        want = jtrain.lr_dict(jconfig.OptimizationConfig(), 4.0, step)
        got = ttrain.lr_dict(opt, 4.0, step)
        assert {k: np.float32(v) for k, v in got.items()} == {
            k: np.float32(v) for k, v in want.items()}
        assert ttrain.xyz_lr(opt, 4.0, step) == jtrain.xyz_lr(jconfig.OptimizationConfig(),
                                                              4.0, step)

    def test_configs_are_copies(self):
        import dataclasses

        for name in ("ModelConfig", "OptimizationConfig"):
            want = dataclasses.asdict(getattr(jconfig, name)())
            got = dataclasses.asdict(getattr(tconfig, name)())
            want.pop("data_device", None)  # names the package's own device
            got.pop("data_device", None)
            assert got == want


class TestKnn:
    def test_distances_and_neighbour_sets(self):
        """Exact kNN on random points (distinct distances): the 3-NN mean
        squared distance to 1e-5 relative (the matrix-product form rounds
        at |x|^2 scale), and the 6-NN index sets equal, over several chunks
        and a ragged last one."""
        pts = np.random.default_rng(0).normal(size=(300, 3)).astype(np.float32)
        want = jknn.mean_sq_dist_3nn(jnp.asarray(pts), chunk=128)
        got = tknn.mean_sq_dist_3nn(_t(pts), chunk=128)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-6)
        wi = np.asarray(jknn.knn_indices(jnp.asarray(pts), k=6, chunk=128))
        gi = _np(tknn.knn_indices(_t(pts), k=6, chunk=128))
        assert gi.shape == wi.shape == (300, 6)
        np.testing.assert_array_equal(np.sort(gi, 1), np.sort(wi, 1))
        assert not (gi == np.arange(300)[:, None]).any()  # never the point itself

    def test_create_from_pcd(self):
        rng = np.random.default_rng(2)
        n = 150
        pts, cols = rng.normal(size=(n, 3)) * 0.5, rng.uniform(size=(n, 3))
        want = jg.create_from_pcd(jstruct.BasicPointCloud(pts, cols, np.zeros((n, 3))), 3,
                                  capacity=256)
        got = tg.create_from_pcd(tstruct.BasicPointCloud(pts, cols, np.zeros((n, 3))), 3,
                                 capacity=256, device="cpu")
        assert got.capacity == 256 and int(got.num_active()) == n
        np.testing.assert_array_equal(_np(got.active), np.asarray(want.active))
        for k in PARAMS:
            # scaling is 0.5 log of the 3-NN distance above; the rest is exact
            np.testing.assert_allclose(_np(getattr(got, k)), np.asarray(getattr(want, k)),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


# ------------------------------------------------------------ the dataset


def _ring(mod, n=6, radius=4.0, size=32, fov=0.9, images=None):
    """The ring of tests/test_gs_training.py, as ``mod``'s Cameras."""
    cams = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        pos = np.array([radius * np.cos(ang), 0.3, radius * np.sin(ang)])
        forward = -pos / np.linalg.norm(pos)
        right = np.cross(np.array([0.0, 1.0, 0.0]), forward)
        right /= np.linalg.norm(right)
        R_w2c = np.stack([right, np.cross(forward, right), forward], axis=0)
        cams.append(mod.make_synthetic_camera(
            size, size, fov, fov, R_w2c.T, -R_w2c @ pos, name=f"c{i}",
            image=None if images is None else images[i]))
    return cams


def _true_scene_arrays(n=60, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "xyz": (rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
        "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "features_rest": np.zeros((n, 15, 3), np.float32),
        "opacity": rng.uniform(1.0, 3.0, size=(n, 1)).astype(np.float32),
        "scaling": rng.uniform(-2.2, -1.4, size=(n, 3)).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def dataset():
    """(JAX cameras, port cameras) of the 32x32 ring with the same
    ground-truth images: the port's golden render of the true scene."""
    gt = tg.from_arrays(_true_scene_arrays(), max_sh_degree=3, capacity=64, device="cpu")
    images = [np.clip(_np(ttrain.render_eval(gt, cam, np.zeros(3, np.float32), 3, chunk=64,
                                             rasterizer="scan")), 0, 1)
              for cam in _ring(tscam)]
    return _ring(jscam, images=images), _ring(tscam, images=images)


def _scene_info(mod, n_pts=150, seed=5):
    rng = np.random.default_rng(seed)
    pcd = mod.BasicPointCloud(points=rng.normal(size=(n_pts, 3)) * 0.5,
                              colors=rng.uniform(size=(n_pts, 3)),
                              normals=np.zeros((n_pts, 3)))
    return mod.SceneInfo(pcd, [], [], {"radius": 4.0, "translate": np.zeros(3)}, "")


def _trainers(dataset, opt_kw=None, bucket=256, n_pts=150, seed=0, white=False):
    jcams, tcams = dataset
    opt_kw = opt_kw or {}
    jt = jtrain.GSTrainer(jconfig.ModelConfig(white_background=white),
                          jconfig.OptimizationConfig(**opt_kw), _scene_info(jstruct, n_pts),
                          jcams[:5], jcams[5:], seed=seed, capacity_bucket=bucket)
    tt = ttrain.GSTrainer(tconfig.ModelConfig(white_background=white),
                          tconfig.OptimizationConfig(**opt_kw), _scene_info(tstruct, n_pts),
                          tcams[:5], tcams[5:], seed=seed, capacity_bucket=bucket,
                          device="cpu")
    return jt, tt


def _port_state(jstate) -> ttrain.GSTrainState:
    """A JAX train state as the port's, array for array."""
    scene = tg.GaussianScene(active=_t(jstate.scene.active),
                             max_sh_degree=jstate.scene.max_sh_degree,
                             **{k: _t(getattr(jstate.scene, k)) for k in PARAMS})
    adam = toptim.AdamState(m={k: _t(v) for k, v in jstate.adam.m.items()},
                            v={k: _t(v) for k, v in jstate.adam.v.items()},
                            step=_t(jstate.adam.step))
    return ttrain.GSTrainState(scene, adam, _t(jstate.xyz_grad_accum), _t(jstate.denom),
                               _t(jstate.max_radii2d))


def _assert_states_equal(tstate, jstate, exact=True, **tol):
    cmp = np.testing.assert_array_equal if exact else (
        lambda a, b, **kw: np.testing.assert_allclose(a, b, **tol, **kw))
    np.testing.assert_array_equal(_np(tstate.scene.active), np.asarray(jstate.scene.active))
    for k in PARAMS:
        cmp(_np(getattr(tstate.scene, k)), np.asarray(getattr(jstate.scene, k)), err_msg=k)
        cmp(_np(tstate.adam.m[k]), np.asarray(jstate.adam.m[k]), err_msg=f"m {k}")
        cmp(_np(tstate.adam.v[k]), np.asarray(jstate.adam.v[k]), err_msg=f"v {k}")
    assert int(tstate.adam.step) == int(jstate.adam.step)
    cmp(_np(tstate.xyz_grad_accum), np.asarray(jstate.xyz_grad_accum))
    cmp(_np(tstate.denom), np.asarray(jstate.denom))
    np.testing.assert_array_equal(_np(tstate.max_radii2d), np.asarray(jstate.max_radii2d))


# ------------------------------------------------------------ train_step


class TestTrainStep:
    @pytest.mark.parametrize("rasterizer", ["pallas", "scan"])
    def test_three_steps_match(self, dataset, rasterizer):
        """Three steps from the same state through the same cameras: loss,
        l1 and psnr to 1e-5 relative; Adam moments, which are linear in the
        gradients, to rtol 2e-3 plus 1e-4 of the array's largest magnitude
        (the rasterizer's gradient tolerance); parameters to 2.1 lr per step
        at worst (a sign flip of a noise-sized gradient) and 0.02 lr on
        average; the densification statistics and the binning telemetry."""
        jcams, tcams = dataset
        scene_arrays = _true_scene_arrays(n=50, seed=11)
        scene_arrays["features_rest"] = (
            np.random.default_rng(1).normal(size=(50, 15, 3)) * 0.05).astype(np.float32)
        jstate = jtrain.init_train_state(jg.from_arrays(scene_arrays, 3, capacity=64))
        tstate = ttrain.init_train_state(tg.from_arrays(scene_arrays, 3, capacity=64,
                                                        device="cpu"))
        opt = tconfig.OptimizationConfig()
        jrast = "pallas_interpret" if rasterizer == "pallas" else "scan"
        for it in range(1, 4):
            lrs = ttrain.lr_dict(opt, 4.0, it)
            kw = dict(width=32, height=32, sh_degree=3, chunk=64)
            jstate, jm = jtrain.train_step(
                jstate, jtrain.camera_arrays(jcams[it]), jnp.zeros(3),
                {k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()}, rasterizer=jrast,
                **kw)
            tstate, tm = ttrain.train_step(
                tstate, ttrain.camera_arrays(tcams[it], "cpu", with_image=True),
                torch.zeros(3), lrs, rasterizer=rasterizer, **kw)
            assert set(tm) == set(jm)
            for k in ("loss", "l1", "psnr"):
                np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=1e-5,
                                           err_msg=f"step {it} {k}")
            for k in tm:
                if k.startswith("binning_"):
                    assert int(tm[k]) == int(jm[k]), (it, k)
            if rasterizer == "pallas":
                assert int(tm["binning_grad_dropped"]) == 0
                assert int(tm["binning_nc_demand"]) % 128 == 0
            for k in PARAMS:
                for mom in ("m", "v"):
                    want = np.asarray(getattr(jstate.adam, mom)[k])
                    np.testing.assert_allclose(
                        _np(getattr(tstate.adam, mom)[k]), want, rtol=2e-3,
                        atol=1e-4 * np.abs(want).max(), err_msg=f"step {it} {mom} {k}")
                diff = np.abs(_np(getattr(tstate.scene, k))
                              - np.asarray(getattr(jstate.scene, k)))
                assert diff.max() <= 2.1 * lrs[k] * it, (it, k, diff.max())
                assert diff.mean() <= 0.02 * lrs[k], (it, k, diff.mean())
            want = np.asarray(jstate.xyz_grad_accum)
            np.testing.assert_allclose(_np(tstate.xyz_grad_accum), want, rtol=2e-3,
                                       atol=1e-4 * want.max())
            np.testing.assert_array_equal(_np(tstate.denom), np.asarray(jstate.denom))
            np.testing.assert_array_equal(_np(tstate.max_radii2d),
                                          np.asarray(jstate.max_radii2d))
        assert int(tstate.adam.step) == 3 and float(tstate.denom.max()) == 3.0
        assert float(tstate.xyz_grad_accum.max()) > 0

    def test_without_telemetry_and_sh_warmup(self, dataset):
        """``with_telemetry=False`` returns the three losses only, and SH
        degree 0 leaves the higher SH coefficients without gradient."""
        _, tcams = dataset
        state = ttrain.init_train_state(tg.from_arrays(_true_scene_arrays(20), 3, capacity=32,
                                                       device="cpu"))
        new, m = ttrain.train_step(
            state, ttrain.camera_arrays(tcams[0], "cpu", with_image=True), torch.zeros(3),
            ttrain.lr_dict(tconfig.OptimizationConfig(), 4.0, 1), width=32, height=32,
            sh_degree=0, with_telemetry=False)
        assert set(m) == {"loss", "l1", "psnr"}
        assert torch.equal(new.scene.features_rest, state.scene.features_rest)
        assert not torch.equal(new.scene.features_dc, state.scene.features_dc)
        assert not any(t.requires_grad for t in new.scene.params().values())


class TestStateEvents:
    def test_reset_opacity(self, dataset):
        jt, tt = _trainers(dataset, n_pts=30, bucket=64)
        jt.state = jt.state.replace(
            adam=jt.state.adam.replace(m={k: v + 1.0 for k, v in jt.state.adam.m.items()}))
        tstate = ttrain.reset_opacity(_port_state(jt.state))
        jstate = jtrain.reset_opacity(jt.state)
        _assert_states_equal(tstate, jstate, exact=False, rtol=1e-6, atol=1e-6)
        active = _np(tstate.scene.active)
        assert (_np(tstate.scene.get_opacity)[active] <= 0.01 + 1e-5).all()
        assert not _np(tstate.adam.m["opacity"]).any()
        assert _np(tstate.adam.m["xyz"]).all()

    @pytest.mark.parametrize("case", ["grow", "prune_all", "screen_size"])
    def test_densify_event(self, dataset, case):
        """The same state and the same numpy generator seed through both
        packages' host-side densification: every array to float32 rounding
        (the split's rotation matrices come from each package's own
        quaternion code), the capacity bucket, the zeroed statistics."""
        jt, _ = _trainers(dataset, n_pts=50, bucket=128)
        rng = np.random.default_rng(7)
        cap = jt.state.scene.capacity
        # half the scene large enough to split, gradient statistics and radii
        scaling = np.asarray(jt.state.scene.scaling).copy()
        scaling[::2] += 2.5
        jstate = jt.state.replace(
            scene=jt.state.scene.replace(
                scaling=jnp.asarray(scaling),
                rotation=jnp.asarray(rng.normal(size=(cap, 4)).astype(np.float32))),
            adam=jt.state.adam.replace(
                m={k: v + 0.5 for k, v in jt.state.adam.m.items()},
                v={k: v + 0.25 for k, v in jt.state.adam.v.items()},
                step=jnp.asarray(5, jnp.int32)),
            xyz_grad_accum=jnp.asarray(rng.uniform(0, 1e-2, cap).astype(np.float32)),
            denom=jnp.asarray(rng.integers(0, 4, cap).astype(np.float32)),
            max_radii2d=jnp.asarray(rng.integers(0, 40, cap).astype(np.int32)))
        kw = {"grow": dict(max_grad=1e-9, min_opacity=0.005, max_screen_size=None),
              "prune_all": dict(max_grad=1e9, min_opacity=0.999, max_screen_size=None),
              "screen_size": dict(max_grad=2e-3, min_opacity=0.005, max_screen_size=20)}[case]
        kw.update(extent=4.0, percent_dense=0.01, capacity_bucket=128)
        want = jtrain.densify_event(jstate, rng=np.random.default_rng(3), **kw)
        got = ttrain.densify_event(_port_state(jstate), rng=np.random.default_rng(3), **kw)
        assert got.scene.capacity == want.scene.capacity
        assert int(got.scene.num_active()) == int(want.scene.num_active())
        _assert_states_equal(got, want, exact=False, rtol=1e-6, atol=1e-6)
        assert not _np(got.xyz_grad_accum).any() and not _np(got.denom).any()
        for k in PARAMS:  # the moments keep the scene's shapes
            assert got.adam.m[k].shape == got.adam.v[k].shape == getattr(got.scene, k).shape
        n = int(got.scene.num_active())
        if case == "grow":
            assert n > 50
        if case == "prune_all":
            assert n == 0 and got.scene.capacity == 128

    TIER_CASES = [
        # (function, args): the JAX tests' cases plus the gates' edges
        ("widen_tiers", ((16, 4096, 64, 256, 1024), 100.0, 1.0, 0.0)),
        ("widen_tiers", ((16, 4096, 64, 256, 1024), 1.0, 100.0, 0.0)),
        ("widen_tiers", ((16, 4096, 64, 256, 1024), 0.0, 0.0, 100.0)),
        ("widen_tiers", ((16, 4096, 256, 256, 1024), 0.0, 100.0, 0.0)),
        ("widen_tiers", ((16, 16384, 256, 256, 1024), 0.0, 100.0, 3.0)),
        ("widen_tiers", ((16, 4096, 64, 256, 4096), 0.0, 0.0, 100.0)),
        ("widen_tiers", ((128, 4096, 64, 256, 1024), 100.0, 5.0, 1.0)),
        ("widen_tiers", ((128, 16384, 256, 1024, 4096), 100.0, 100.0, 100.0)),
        ("widen_tiers", ((16, 4096, 64, 256, 1024), 0.0, 0.0, 0.0)),
        ("narrow_tiers", ((16, 4096, 64, 256, 1024), 100, 131072)),
        ("narrow_tiers", ((16, 4096, 64, 256, 1024), int(0.31 * 4352) + 1, 131072)),
        ("narrow_tiers", ((16, 4096, 64, 256, 1024), int(0.31 * 4352), 131072)),
        ("narrow_tiers", ((16, 4096, 64, 256, 1024), 100, 6000)),
        ("narrow_tiers", ((4, 4096, 64, 256, 1024), 0, 1 << 20)),
        ("narrow_tiers", ((8, 4096, 64, 256, 1024), 0, 1 << 20)),
        # the mid-budget gate: t_max // 2 against t_max_mid, as the JAX package has it
        ("narrow_tiers", ((128, 4096, 32, 256, 1024), 0, 1 << 20)),
        ("narrow_tiers", ((128, 4096, 64, 256, 1024), 0, 1 << 20)),
        ("narrow_tiers", ((64, 4096, 32, 256, 1024), 0, 1 << 20)),
        ("narrow_tiers", ((16, 4096, 64, 256, 1024), 0, (1 << 18) // 8)),
        ("narrow_tiers", ((16, 4096, 64, 256, 1024), 0, (1 << 18) // 8 - 1)),
    ]

    @pytest.mark.parametrize("fn,args", TIER_CASES)
    def test_tier_policies(self, fn, args):
        assert getattr(ttrain, fn)(*args) == getattr(jtrain, fn)(*args)

    def test_tier_policy_examples(self):
        base = (16, 4096, 64, 256, 1024)
        assert ttrain.widen_tiers(base, 100.0, 1.0, 0.0) == (32, 4096, 64, 256, 1024)
        assert ttrain.narrow_tiers(base, 100, 131072) == (8, 4096, 64, 256, 1024)
        assert ttrain.narrow_tiers((128, 4096, 32, 256, 1024), 0, 1 << 20) is None
        assert ttrain._TIER_CAPS == jtrain._TIER_CAPS


# ------------------------------------------------------------ the trainer


class TestTrainerRun:
    def test_run_matches_jax_trainer(self, dataset):
        """Twelve iterations of both trainers from the same point cloud and
        seed on the golden rasterizer, with a densification event at
        iteration 8 and an opacity reset at 10: the same camera order, the
        same Gaussian count after the event, and the loss trajectory to
        1e-4 relative before the event. After it the two scenes differ by
        the sign-flip noise of Adam's first steps, which the event's
        thresholds can turn into a few different clones; the later losses
        are held to 2e-2 relative."""
        opt_kw = dict(iterations=12, densify_from_iter=4, densification_interval=8,
                      densify_until_iter=100, opacity_reset_interval=10,
                      densify_grad_threshold=1e-5)
        jt, tt = _trainers(dataset, opt_kw)
        _assert_states_equal(tt.state, jt.state, exact=False, rtol=1e-5, atol=1e-5)
        jlog, tlog, jorder, torder = [], [], [], []
        jt.run(iterations=12, log_every=1, chunk=64, rasterizer="scan",
               callback=lambda it, m, tr: jlog.append((it, float(m["loss"]),
                                                       int(tr.state.scene.num_active()))),
               pre_step=lambda it, tr: jorder.append(
                   [c.image_name for c in tr._viewpoint_stack]))
        tt.run(iterations=12, log_every=1, chunk=64, rasterizer="scan",
               callback=lambda it, m, tr: tlog.append((it, m["loss"],
                                                       int(tr.state.scene.num_active()))),
               pre_step=lambda it, tr: torder.append(
                   [c.image_name for c in tr._viewpoint_stack]))
        assert torder == jorder
        assert [x[0] for x in tlog] == list(range(1, 13))
        for (it, tl, tn), (_, jl, jn) in zip(tlog, jlog):
            np.testing.assert_allclose(tl, jl, rtol=1e-4 if it <= 8 else 2e-2,
                                       err_msg=f"iteration {it}")
            assert abs(tn - jn) <= 3, (it, tn, jn)
        assert tlog[7][2] == jlog[7][2] == 150  # the callback runs before the event
        assert tlog[8][2] != 150
        assert tt.state.scene.capacity == jt.state.scene.capacity
        # the reset at iteration 10 has been trained on for two steps
        assert float(torch.sigmoid(tt.state.scene.opacity).max()) < 0.1
        psnr_t, l1_t = tt.eval_psnr(chunk=64)
        psnr_j, l1_j = jt.eval_psnr(chunk=64)
        assert np.isfinite(psnr_t) and abs(psnr_t - psnr_j) < 0.5 and abs(l1_t - l1_j) < 1e-2

    def test_save_precedes_opacity_reset(self, dataset, tmp_path):
        """A save iteration that coincides with opacity_reset_interval
        persists the opacities from before the reset (the JAX package's
        TestSaveOrdering)."""
        _, tt = _trainers(dataset, dict(iterations=6, densify_from_iter=100,
                                        opacity_reset_interval=6))
        tt.run(iterations=6, save_iterations=(6,), model_path=str(tmp_path), chunk=64,
               rasterizer="scan")
        ply = str(tmp_path / "point_cloud" / "iteration_6" / "point_cloud.ply")
        saved = tg.load_ply(ply, max_sh_degree=3, device="cpu")
        assert float(torch.sigmoid(saved.opacity).max()) > 0.011
        assert float(torch.sigmoid(tt.state.scene.opacity).max()) <= 0.011

    @pytest.mark.parametrize("default_nc,message", [
        (128, r"compact-pair demand (\d+) > 90% of 128: widening nc_pairs -> (\d+)"),
        (1 << 19, r"compact pairs (\d+) < 31% of 524288: shrinking nc_pairs -> (262144)"),
    ])
    def test_nc_pairs_adapts(self, dataset, capsys, monkeypatch, default_nc, message):
        """The JAX package's TestAdaptiveNcPairs on the port's tile
        rasterizer: a starved budget is widened past the exact aligned
        demand at once, an inflated one shrinks to the 2^18 floor once, and
        no step drops its gradients (nc is rounded up to 1024 slots, which
        holds this scene even when starved)."""
        _, tt = _trainers(dataset, dict(iterations=4, densify_from_iter=100))
        monkeypatch.setattr(ttrain, "DEFAULT_NC", default_nc)
        monkeypatch.setattr(tpt, "DEFAULT_NC", default_nc)
        dropped = []
        tt.run(iterations=4, chunk=64, rasterizer="auto", adapt_tiers_every=2,
               adapt_drop_threshold=0.9, log_every=1,
               callback=lambda it, m, tr: dropped.append(m["binning_grad_dropped"]))
        out = capsys.readouterr().out
        found = re.findall(message, out)
        assert len(found) == 1, out
        demand, budget = (int(x) for x in found[0])
        assert budget >= demand and dropped == [0, 0, 0, 0]

    def test_truncation_widens_a_tier(self, dataset, capsys):
        _, tt = _trainers(dataset, dict(iterations=4, densify_from_iter=100))
        logged = []
        tt.run(iterations=4, chunk=64, rasterizer="auto", tiers=(1, 4, 2, 2, 4),
               adapt_tiers_every=2, adapt_drop_threshold=1e-4)
        out = capsys.readouterr().out
        assert "widening tiers (1, 4, 2, 2, 4) ->" in out, out
        # the tile rasterizer in plain PyTorch is taken too (its binning
        # telemetry drives the same adaptation); a name that is no
        # rasterizer is refused
        tt.run(iterations=6, first_iteration=5, rasterizer="tiled", adapt_tiers_every=6,
               log_every=1, callback=lambda it, m, tr: logged.append(m))
        assert len(logged) == 2 and all(np.isfinite(m["loss"]) for m in logged)
        assert "binning_total_area" in logged[-1] and "binning_nc_demand" not in logged[-1]
        with pytest.raises(ValueError, match="rasterizer"):
            tt.run(iterations=7, first_iteration=7, rasterizer="nope")


class TestCheckpoints:
    def test_both_ways_and_resume(self, dataset, tmp_path):
        """A checkpoint written by either package loads in the other with
        every array equal, and a port trainer restored from its checkpoint
        continues bit for bit as the one that never stopped."""
        jt, tt = _trainers(dataset, dict(iterations=6, densify_from_iter=100))
        tt.run(iterations=3, chunk=64, rasterizer="auto", adapt_tiers_every=0,
               checkpoint_iterations=(3,), model_path=str(tmp_path))
        path = str(tmp_path / "chkpnt3.npz")
        # port -> JAX
        jstate, it, deg = jckpt.load_train_state(path)
        assert (it, deg) == (3, 0)
        _assert_states_equal(tt.state, jstate)
        assert jstate.max_radii2d.dtype == jnp.int32 and jstate.adam.step.dtype == jnp.int32
        # JAX -> port
        jt.run(iterations=2, chunk=64, rasterizer="scan")
        jpath = str(tmp_path / "jax.npz")
        jt.save_checkpoint(jpath, 2)
        fresh = ttrain.GSTrainer(tt.model_cfg, tt.opt, tt.scene_info, tt.train_cams,
                                 tt.test_cams, device="cpu", capacity_bucket=256)
        assert fresh.restore_checkpoint(jpath) == 2
        _assert_states_equal(fresh.state, jt.state)
        loaded, it, deg = tckpt.load_train_state(jpath, device="cpu")
        assert (it, deg) == (2, 0) and loaded.scene.xyz.device.type == "cpu"
        # the same keys, shapes and types in both files
        a, b = np.load(path), np.load(jpath)
        assert set(a.files) == set(b.files)
        assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a.files)
        # resume: the camera order comes from the generator, so hand it on
        assert fresh.restore_checkpoint(path) == 3
        fresh.rng = np.random.default_rng(0)
        fresh._viewpoint_stack = []
        for _ in range(3):
            fresh._next_camera()
        tt.run(iterations=6, first_iteration=4, chunk=64, rasterizer="auto",
               adapt_tiers_every=0)
        fresh.run(iterations=6, first_iteration=4, chunk=64, rasterizer="auto",
                  adapt_tiers_every=0)
        for k in PARAMS:
            assert torch.equal(getattr(fresh.state.scene, k), getattr(tt.state.scene, k)), k
            assert torch.equal(fresh.state.adam.m[k], tt.state.adam.m[k]), k
        assert torch.equal(fresh.state.xyz_grad_accum, tt.state.xyz_grad_accum)

    def test_render_gui_camera(self, dataset):
        _, tcams = dataset
        scene = tg.from_arrays(_true_scene_arrays(), 3, capacity=64, device="cpu")
        img = ttrain.render_gui_camera(scene, tcams[0], np.zeros(3, np.float32), 3)
        want = ttrain.render_eval(scene, tcams[0], np.zeros(3, np.float32), 3)
        assert torch.equal(img, want)
        small = ttrain.render_gui_camera(scene, tcams[0], np.zeros(3, np.float32), 3,
                                         scaling_modifier=0.5)
        assert float(small.sum()) < float(img.sum())
