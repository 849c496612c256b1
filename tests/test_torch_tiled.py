"""sixdgs_torch's tile rasterizer in plain PyTorch (``rasterize_tiled``) and
the public ``render()`` against sixdgs_tpu's, on the CPU.

Each JAX ``rasterize_tiled`` call costs tens of seconds here (its compile),
so the reference side is three calls, computed once per module: two scenes
that fold the cases of tests/test_tiled_rasterizer.py together, each
through one ``jax.value_and_grad`` (image and the gradients of every
differentiable field of the projection and of the background), and
``render(rasterizer="tiled")``. Scene "tiers": 200 random splats on a 70x45
image (not a multiple of the tile) with tiny budgets (t_max 4, mid 8 x 8
slots, giant 4 x 64 slots, k_max 64) that force every tier and the
truncation caps. Scene "near": a near-camera splat covering the whole
256x160 screen (the giant tier, cut to 4 rows) among medium splats of
17-60 tiles (the mid tier), at the default main and mid budgets and k_max
128.

Tolerances: both sides composite in float32 in the same order (slot by
slot, the same early-stop tests), so images agree to IMG_ATOL and the
gradients to GRAD_RTOL of each field's largest magnitude (the backward sums
per-pair terms in other orders). Binning outputs are integers and compared
as multisets of (tile, gaussian) pairs, segment starts exactly.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdgs_tpu.ops.rasterizer import projection as jproj
from sixdgs_tpu.ops.rasterizer import tiles as jtiles
from sixdgs_tpu.ops.transforms import build_covariance
from sixdgs_tpu.renderer import render as jrender
from sixdgs_tpu.scene import cameras as jscam
from sixdgs_tpu.scene import gaussians as jg
from sixdgs_torch.ops.rasterizer import projection as tproj
from sixdgs_torch.ops.rasterizer import tiles as ttiles
from sixdgs_torch.renderer import render as trender
from sixdgs_torch.scene import cameras as tscam
from sixdgs_torch.scene import gaussians as tg
from sixdgs_torch.train import gs_trainer as ttrain
from sixdgs_torch.utils import config as tconfig
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)

IMG_ATOL = 2e-6
GRAD_RTOL = 1e-4
FIELDS = ("means2d", "conics", "colors", "opacities")


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tiers_scene():
    """tests/test_tiled_rasterizer.py::random_proj at 70x45, seed 2."""
    W, H, n = 70, 45, 200
    rng = np.random.default_rng(2)
    cam = jscam.make_synthetic_camera(W, H, 0.9, 0.8, np.eye(3), np.zeros(3))
    means = (rng.normal(size=(n, 3)) + [0, 0, 5]).astype(np.float32)
    scales = np.exp(rng.normal(size=(n, 3)) * 0.4 - 1.8).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.1, 0.95, size=n).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    proj = jproj.project_gaussians(
        jnp.asarray(means), build_covariance(jnp.asarray(scales), jnp.asarray(quats)),
        jnp.asarray(opac), jnp.asarray(cam.view), jnp.asarray(cam.full_proj),
        jnp.asarray(cam.camera_center), W, H, math.tan(0.45), math.tan(0.4),
        colors_precomp=jnp.asarray(colors))
    kw = dict(t_max=4, mid_k=8, t_max_mid=8, overflow_k=4, t_max_big=64, k_max=64)
    return proj, W, H, np.array([1.0, 0.5, 0.0], np.float32), kw


def _near_scene():
    """One splat over the whole screen (test_pathological_near_camera_gaussian)
    among medium splats of 17-60 tiles (test_many_medium_gaussians_mid_tier)."""
    W, H, n = 256, 160, 48
    rng = np.random.default_rng(11)
    means = rng.uniform([20, 20], [W - 20, H - 20], size=(n, 2)).astype(np.float32)
    means[0] = [128.0, 80.0]
    sig = rng.uniform(10, 18, size=n).astype(np.float32)
    conics = np.stack([1 / sig**2, np.zeros(n, np.float32), 1 / sig**2], 1)
    conics[0] = [5e-5, 0.0, 5e-5]  # sigma ~140 px
    radii = (3 * sig).astype(np.int32)
    radii[0] = 500
    fields = dict(means2d=means, depths=np.linspace(1, 2, n).astype(np.float32),
                  conics=conics.astype(np.float32), radii=radii,
                  colors=rng.uniform(0, 1, size=(n, 3)).astype(np.float32),
                  opacities=rng.uniform(0.3, 0.9, size=n).astype(np.float32))
    proj = jproj.ProjectedGaussians(**{k: jnp.asarray(v) for k, v in fields.items()})
    return proj, W, H, np.array([0.2, 0.2, 0.2], np.float32), dict(k_max=128, overflow_k=4)


SCENES = {"tiers": _tiers_scene, "near": _near_scene}


def _loss_weights(H, W):
    return np.random.default_rng(9).normal(size=(3, H, W)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_refs():
    """{scene: (proj, W, H, bg, kw, image, grads)} of the JAX rasterize_tiled."""
    out = {}
    for name, make in SCENES.items():
        proj, W, H, bg, kw = make()
        wts = jnp.asarray(_loss_weights(H, W))

        def loss(d, bg_):
            img = jtiles.rasterize_tiled(proj._replace(**d), W, H, bg_, **kw)
            return jnp.sum(img * wts), img

        (_, img), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            {f: getattr(proj, f) for f in FIELDS}, jnp.asarray(bg))
        out[name] = (proj, W, H, bg, kw, np.asarray(img),
                     {**{f: np.asarray(g) for f, g in grads[0].items()},
                      "bg": np.asarray(grads[1])})
    return out


class TestRasterizeTiled:
    @pytest.mark.parametrize("scene", list(SCENES))
    def test_forward_and_gradients(self, jax_refs, scene):
        proj, W, H, bg, kw, want_img, want_grads = jax_refs[scene]
        leaves = {f: _t(getattr(proj, f)).requires_grad_() for f in FIELDS}
        tp = tproj.ProjectedGaussians(depths=_t(proj.depths), radii=_t(proj.radii), **leaves)
        tbg = _t(bg).requires_grad_()
        img = ttiles.rasterize_tiled(tp, W, H, tbg, **kw)
        assert img.shape == (3, H, W)
        np.testing.assert_allclose(_np(img), want_img, atol=IMG_ATOL, rtol=0)
        torch.sum(img * _t(_loss_weights(H, W))).backward()
        for f, leaf in (*leaves.items(), ("bg", tbg)):
            want = want_grads[f]
            scale = np.abs(want).max()
            assert scale > 0, f
            np.testing.assert_allclose(_np(leaf.grad), want, atol=GRAD_RTOL * scale, rtol=0,
                                       err_msg=f)
        # the same image without autograd (no checkpointing)
        with torch.no_grad():
            again = ttiles.rasterize_tiled(tp, W, H, _t(bg), **kw)
        np.testing.assert_array_equal(_np(again), _np(img))

    @pytest.mark.parametrize("scene", list(SCENES))
    def test_scene_exercises_its_cases(self, jax_refs, scene):
        """What each scene is there for: every tier in use and segments cut
        at k_max ("tiers"), the giant tier holding the screen-sized splat and
        the mid tier the medium ones ("near")."""
        proj, W, H, bg, kw, _, _ = jax_refs[scene]
        tp = tproj.ProjectedGaussians(*[_t(x) for x in proj])
        order = torch.argsort(torch.where(tp.radii > 0, tp.depths,
                                          torch.full_like(tp.depths, math.inf)), stable=True)
        t_max = kw.get("t_max", 16)
        tier_kw = {k: kw[k] for k in ("mid_k", "t_max_mid", "overflow_k", "t_max_big")
                   if k in kw}
        out = ttiles._bin_pairs(tp.means2d[order], tp.radii[order].float(),
                                (tp.radii > 0)[order], -(-W // 16), -(-H // 16), 16, t_max,
                                conics=tp.conics[order], opac=tp.opacities[order], **tier_kw)
        starts, mid_ok, big_ok = out[2], out[6], out[8]
        counts = starts[1:] - starts[:-1]
        assert bool(mid_ok.any()) and bool(big_ok.any())
        if scene == "tiers":
            assert int(counts.max()) > kw["k_max"]
        else:
            assert bool(big_ok[0]) and int(counts.min()) >= 1  # the splat is everywhere

    def test_binning_matches_jax(self):
        """_make_pair_keys and _bin_pairs against the JAX functions: the
        same (tile, gaussian) multiset, tier tables, segment starts, and each
        tile's segment in depth order."""
        proj, W, H, _, kw = _tiers_scene()
        nx, ny = -(-W // 16), -(-H // 16)
        order = np.argsort(np.where(np.asarray(proj.radii) > 0, np.asarray(proj.depths),
                                    np.inf), kind="stable")
        args = [np.asarray(proj.means2d)[order],
                np.asarray(proj.radii)[order].astype(np.float32),
                (np.asarray(proj.radii) > 0)[order]]
        cull = [np.asarray(proj.conics)[order], np.asarray(proj.opacities)[order]]
        tier_kw = {k: kw[k] for k in ("mid_k", "t_max_mid", "overflow_k", "t_max_big")}
        jk = jtiles._make_pair_keys(*map(jnp.asarray, args), nx, ny, 16, kw["t_max"],
                                    conics=jnp.asarray(cull[0]), opac=jnp.asarray(cull[1]),
                                    **tier_kw)
        tk = ttiles._make_pair_keys(*map(_t, args), nx, ny, 16, kw["t_max"],
                                    conics=_t(cull[0]), opac=_t(cull[1]), **tier_kw)
        for a, b in zip(tk, jk):
            np.testing.assert_array_equal(_np(a), np.asarray(b))

        def pairs(tiles, gidx):
            tiles, gidx = np.asarray(tiles).astype(np.int64), np.asarray(gidx).astype(np.int64)
            ok = tiles < nx * ny
            return np.sort(tiles[ok] * (1 << 32) + gidx[ok])

        jb = jtiles._bin_pairs(*map(jnp.asarray, args), nx, ny, 16, kw["t_max"],
                               conics=jnp.asarray(cull[0]), opac=jnp.asarray(cull[1]),
                               **tier_kw)
        tb = ttiles._bin_pairs(*map(_t, args), nx, ny, 16, kw["t_max"],
                               conics=_t(cull[0]), opac=_t(cull[1]), **tier_kw)
        np.testing.assert_array_equal(pairs(_np(tb[1]), _np(tb[4])), pairs(jb[1], jb[4]))
        np.testing.assert_array_equal(pairs(_np(tb[1]), _np(tb[4])), pairs(tk[0], tk[1]))
        np.testing.assert_array_equal(_np(tb[2]), np.asarray(jb[2]))  # starts
        for a, b in zip(tb[5:], jb[5:]):  # tier tables
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        real = _np(tb[1]) < nx * ny
        np.testing.assert_array_equal(_np(tb[3])[real], np.asarray(jb[3])[real])  # ranks
        g, t = _np(tb[4])[real], _np(tb[1])[real]
        assert all(np.all(np.diff(g[t == i]) > 0) for i in np.unique(t))
        # the sort permutation carries each slot's tile and gaussian
        np.testing.assert_array_equal(_np(tk[0])[_np(tb[0])], _np(tb[1]))
        np.testing.assert_array_equal(_np(tk[1])[_np(tb[0])], _np(tb[4]))

    def test_gathers_and_their_transposes(self):
        """_invert_perm_payload, and _PairGather's and _Window's backward
        passes against the JAX custom VJPs on the same cotangents."""
        proj, W, H, _, kw = _tiers_scene()
        nx, ny = -(-W // 16), -(-H // 16)
        P = proj.means2d.shape[0]
        rng = np.random.default_rng(4)
        perm = rng.permutation(1000).astype(np.int32)
        np.testing.assert_array_equal(
            _np(ttiles._invert_perm_payload(_t(perm).long(), torch.arange(1000))),
            np.asarray(jtiles._invert_perm_payload(jnp.asarray(perm),
                                                   jnp.arange(1000, dtype=jnp.int32))))
        args = [np.asarray(proj.means2d), np.asarray(proj.radii).astype(np.float32),
                np.asarray(proj.radii) > 0]
        tier_kw = {k: kw[k] for k in ("mid_k", "t_max_mid", "overflow_k", "t_max_big")}
        tb = ttiles._bin_pairs(*map(_t, args), nx, ny, 16, kw["t_max"], **tier_kw)
        order, tiles, starts, rank, gidx, mid_idx, mid_ok, big_idx, big_ok = tb
        records = rng.normal(size=(P, 9)).astype(np.float32)
        inv = ttiles._invert_perm_payload(order, torch.arange(order.shape[0]))
        sizes = (kw["t_max"], kw["t_max_mid"], kw["t_max_big"])
        rec_t = _t(records).requires_grad_()
        sorted_t = ttiles._PairGather.apply(rec_t, gidx, inv, mid_idx, mid_ok, big_idx,
                                            big_ok, *sizes)
        win_t = ttiles._Window.apply(sorted_t, starts, tiles, rank, kw["k_max"])
        cot = rng.normal(size=tuple(win_t.shape)).astype(np.float32)
        torch.sum(win_t * _t(cot)).backward()

        j = [jnp.asarray(_np(x).astype(np.int32)) for x in
             (gidx, inv, mid_idx, big_idx, starts, tiles, rank)]

        def f(r):
            s = jtiles._pair_gather(r, j[0], j[1], j[2], jnp.asarray(_np(mid_ok)), j[3],
                                    jnp.asarray(_np(big_ok)), *sizes)
            return jtiles._window(s, j[4], j[5], j[6], kw["k_max"])

        win_j, vjp = jax.vjp(f, jnp.asarray(records))
        np.testing.assert_array_equal(_np(win_t), np.asarray(win_j))
        (want,) = vjp(jnp.asarray(cot))
        np.testing.assert_allclose(_np(rec_t.grad), np.asarray(want), rtol=1e-5, atol=1e-5)


class TestRender:
    def test_render_matches_jax(self):
        """render() of an SH-3 scene through a camera, "scan" and "tiled",
        forward and the screen-space gradient (the means2d_offset
        receptacle), against the JAX render; "pallas" (the plain versions
        on CPU tensors) against the port's "tiled"."""
        rng = np.random.default_rng(30)
        n, W, H = 120, 40, 32
        arrays = {
            "xyz": (rng.normal(size=(n, 3)) * [1.0, 0.8, 0.6] + [0, 0, 4]).astype(np.float32),
            "features_dc": (rng.normal(size=(n, 1, 3)) * 0.5).astype(np.float32),
            "features_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32),
            "opacity": rng.uniform(-2.0, 3.0, size=(n, 1)).astype(np.float32),
            "scaling": rng.uniform(-3.5, -2.0, size=(n, 3)).astype(np.float32),
            "rotation": rng.normal(size=(n, 4)).astype(np.float32),
        }
        jscene = jg.from_arrays(arrays, max_sh_degree=3, capacity=128)
        tscene = tg.from_arrays(arrays, max_sh_degree=3, capacity=128, device="cpu")
        R, T = np.eye(3), np.array([0.1, -0.1, 0.0])
        jc = jscam.make_synthetic_camera(W, H, 0.9, 0.7, R, T)
        tc = tscam.make_synthetic_camera(W, H, 0.9, 0.7, R, T)
        bg = np.array([0.1, 0.0, 0.3], np.float32)
        wts = _loss_weights(H, W)
        got = {}
        for name in ("scan", "tiled"):
            def loss(off):
                out = jrender(jc, jscene, jnp.asarray(bg), means2d_offset=off, chunk=64,
                              rasterizer=name)
                return jnp.sum(out["render"] * wts), out

            (_, jout), jg2d = jax.value_and_grad(loss, has_aux=True)(jnp.zeros((128, 2)))
            off = torch.zeros(128, 2, requires_grad=True)
            tout = trender(tc, tscene, bg, means2d_offset=off, chunk=64, rasterizer=name)
            torch.sum(tout["render"] * _t(wts)).backward()
            np.testing.assert_allclose(_np(tout["render"]), np.asarray(jout["render"]),
                                       atol=IMG_ATOL, rtol=0)
            np.testing.assert_allclose(_np(off.grad), np.asarray(jg2d),
                                       atol=GRAD_RTOL * np.abs(np.asarray(jg2d)).max(), rtol=0)
            np.testing.assert_array_equal(_np(tout["radii"]), np.asarray(jout["radii"]))
            np.testing.assert_array_equal(_np(tout["visibility_filter"]),
                                          np.asarray(jout["visibility_filter"]))
            assert tout["viewspace_points"] is off
            got[name] = _np(tout["render"])
        assert np.abs(got["tiled"] - bg[:, None, None]).max() > 0.1  # the scene shows
        pallas = trender(tc, tscene, bg, rasterizer="pallas")["render"]
        np.testing.assert_allclose(_np(pallas), got["tiled"], atol=3e-5, rtol=0)
        with pytest.raises(ValueError, match="rasterizer"):
            trender(tc, tscene, bg, rasterizer="nope")

    def test_train_step_takes_tiled(self):
        """train_step on "tiled" carries the binning telemetry (as JAX's
        does there) and no nc-budget stats (the kernel path's); its loss
        and gradients equal those of the same step on "pallas" (plain
        versions) within the compositors' tolerance."""
        rng = np.random.default_rng(3)
        n = 60
        arrays = {
            "xyz": (rng.normal(size=(n, 3)) * 0.5 + [0, 0, 3]).astype(np.float32),
            "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
            "features_rest": np.zeros((n, 15, 3), np.float32),
            "opacity": rng.uniform(-1.0, 2.0, size=(n, 1)).astype(np.float32),
            "scaling": rng.uniform(-3.0, -2.0, size=(n, 3)).astype(np.float32),
            "rotation": rng.normal(size=(n, 4)).astype(np.float32),
        }
        tc = tscam.make_synthetic_camera(24, 16, 0.9, 0.7, np.eye(3), np.zeros(3))
        tc = dataclasses.replace(tc, image=rng.uniform(size=(3, 16, 24)).astype(np.float32))
        cam = ttrain.camera_arrays(tc, "cpu", with_image=True)
        lrs = ttrain.lr_dict(tconfig.OptimizationConfig(), 1.0, 1)
        metrics = {}
        for name in ("tiled", "pallas"):
            state = ttrain.init_train_state(tg.from_arrays(arrays, max_sh_degree=3,
                                                           capacity=64, device="cpu"))
            new, metrics[name] = ttrain.train_step(state, cam, torch.zeros(3), lrs, width=24,
                                                   height=16, sh_degree=0, rasterizer=name)
            metrics[name]["m_xyz"] = new.adam.m["xyz"]
        assert "binning_total_area" in metrics["tiled"]
        assert "binning_nc_demand" not in metrics["tiled"]
        assert "binning_nc_demand" in metrics["pallas"]
        for k in ("loss", "binning_total_area", "binning_real_pairs"):
            np.testing.assert_allclose(float(metrics["tiled"][k]), float(metrics["pallas"][k]),
                                       rtol=1e-5)
        a, b = _np(metrics["tiled"]["m_xyz"]), _np(metrics["pallas"]["m_xyz"])
        np.testing.assert_allclose(a, b, atol=1e-3 * np.abs(b).max(), rtol=0)
