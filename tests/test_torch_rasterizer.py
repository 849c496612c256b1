"""sixdgs_torch's 3DGS render path against sixdgs_tpu's, on the CPU.

The same numpy inputs go through the JAX function and its port: the
covariance builders, cameras, projection (SH degree 0 and 3), the golden
compositor, binning (the port's one int64 key, also where the JAX package
takes its two-key sort), segment and aligned starts, the plain versions of B5 (aligned-layout gather) and B3 (tile
compositor) against the Pallas kernels in interpret mode, rasterize_pallas
and render_eval end to end. On CPU tensors the port's kernel wrappers run
their plain versions, so no launch is counted here; the kernels themselves
are held against the plain versions on a card in
tests/test_torch_cuda_kernels.py.

Tolerances: projection and covariances agree to float32 rounding (1e-6
relative). Images are held at atol 3e-5, the JAX package's own bound for
its Pallas kernels against the golden model: the Pallas compositor takes
its transmittance through a bf16-split log-domain scan (~2^-16 relative),
the port's plain version through a float32 cumulative product. Integer
outputs (pair keys, counts, starts, aligned layouts, stats) are equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdgs_tpu.ops import cameras as jcams
from sixdgs_tpu.ops import sh as jsh
from sixdgs_tpu.ops import transforms as jtr
from sixdgs_tpu.ops.rasterizer import compositing as jcomp
from sixdgs_tpu.ops.rasterizer import pallas_tiles as jpt
from sixdgs_tpu.ops.rasterizer import projection as jproj
from sixdgs_tpu.ops.rasterizer import tiles as jtiles
from sixdgs_tpu.scene import cameras as jscam
from sixdgs_tpu.scene import gaussians as jg
from sixdgs_tpu.scene import structures as jstruct
from sixdgs_tpu.train import gs_trainer as jtrain
from sixdgs_torch.ops import cameras as tcams
from sixdgs_torch.ops import sh as tsh
from sixdgs_torch.ops import transforms as ttr
from sixdgs_torch.ops.rasterizer import compositing as tcomp
from sixdgs_torch.ops.rasterizer import pallas_tiles as tpt
from sixdgs_torch.ops.rasterizer import projection as tproj
from sixdgs_torch.ops.rasterizer import resolve_rasterizer
from sixdgs_torch.ops.rasterizer import tiles as ttiles
from sixdgs_torch.scene import cameras as tscam
from sixdgs_torch.scene import gaussians as tg
from sixdgs_torch.scene import structures as tstruct
from sixdgs_torch.train import gs_trainer as ttrain
from sixdgs_torch.utils import config as tconfig
from align_layouts import ALIGN_LAYOUTS, align_layout  # tests/align_layouts.py

IMG_ATOL = 3e-5


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol=1e-6, rtol=1e-6, **kw):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol, **kw)


def _scene_inputs(n=200, seed=0, spread=1.0):
    """Means, log-free scales, quaternions, opacities and colors of
    ``tests/test_tiled_rasterizer.py::random_proj``."""
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(n, 3)) * spread + [0, 0, 5]).astype(np.float32)
    scales = np.exp(rng.normal(size=(n, 3)) * 0.4 - 1.8).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.1, 0.95, size=n).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    return means, scales, quats, opac, colors


def _jax_proj(n=200, width=80, height=64, seed=0, spread=1.0):
    """The JAX projection of ``random_proj``'s scene (colors precomputed)."""
    means, scales, quats, opac, colors = _scene_inputs(n, seed, spread)
    cam = jscam.make_synthetic_camera(width, height, 0.9, 0.8, np.eye(3), np.zeros(3))
    return jproj.project_gaussians(
        jnp.asarray(means), jtr.build_covariance(jnp.asarray(scales), jnp.asarray(quats)),
        jnp.asarray(opac), jnp.asarray(cam.view), jnp.asarray(cam.full_proj),
        jnp.asarray(cam.camera_center), width, height, math.tan(0.45), math.tan(0.4),
        colors_precomp=jnp.asarray(colors))


def _to_torch_proj(jp):
    return tproj.ProjectedGaussians(*[_t(x) for x in jp])


# ------------------------------------------------------------- math ops


class TestTransformsAndSH:
    @pytest.mark.parametrize("name", ["build_scaling_rotation", "build_covariance",
                                      "build_covariance_6", "build_a_mat",
                                      "covariance_planes", "quat_rotmat_planes"])
    def test_builders_match(self, name):
        rng = np.random.default_rng(0)
        s = np.exp(rng.normal(size=(64, 3))).astype(np.float32)
        q = rng.normal(size=(64, 4)).astype(np.float32)
        q[0] = 0.0  # the normalization guard
        args = (s, q) if name != "quat_rotmat_planes" else (q,)
        want = getattr(jtr, name)(*[jnp.asarray(a) for a in args])
        got = getattr(ttr, name)(*[_t(a) for a in args])
        for w, g in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got, is_leaf=torch.is_tensor)):
            _close(g, w, atol=1e-6, rtol=1e-5)

    def test_scene_covariance_accessors(self):
        rng = np.random.default_rng(4)
        arrays = _render_scene(n=40, seed=4)
        jscene = jg.from_arrays(arrays, max_sh_degree=3, capacity=64)
        tscene = tg.from_arrays(arrays, max_sh_degree=3, capacity=64, device="cpu")
        mod = float(rng.uniform(0.5, 1.5))
        for name in ("get_covariance", "get_covariance_mat", "get_a_mat"):
            _close(getattr(tscene, name)(mod), getattr(jscene, name)(mod), atol=1e-6,
                   rtol=1e-5, err_msg=name)

    def test_symmetric_packing_round_trips(self):
        rng = np.random.default_rng(1)
        cov6 = rng.normal(size=(10, 6)).astype(np.float32)
        full = ttr.unpack_covariance_6(_t(cov6))
        np.testing.assert_array_equal(_np(full), np.asarray(jtr.unpack_covariance_6(cov6)))
        np.testing.assert_array_equal(_np(ttr.strip_symmetric(full)), cov6)
        want = jtr.strip_symmetric(jnp.asarray(full.numpy()))
        np.testing.assert_array_equal(_np(ttr.strip_symmetric(full)), np.asarray(want))

    @pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
    def test_eval_sh_planes(self, deg):
        rng = np.random.default_rng(deg)
        sh = rng.normal(size=(50, 25, 3)).astype(np.float32)
        d = rng.normal(size=(50, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        want = jsh.eval_sh_planes(deg, jnp.asarray(sh), jnp.asarray(d))
        _close(tsh.eval_sh_planes(deg, _t(sh), _t(d)), want, atol=1e-6, rtol=1e-6)
        # and the channel-major eval_sh on the transposed layout
        _close(tsh.eval_sh(deg, _t(sh).transpose(1, 2), _t(d)), want, atol=1e-5, rtol=1e-5)


class TestCameras:
    def test_matrix_builders(self):
        rng = np.random.default_rng(2)
        R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        t = rng.normal(size=3)
        for kw in ({}, {"translate": [0.1, -0.2, 0.3], "scale": 1.7}):
            np.testing.assert_array_equal(tcams.world_to_view(R, t, **kw),
                                          jcams.world_to_view(R, t, **kw))
        view = tcams.world_to_view(R, t)
        np.testing.assert_array_equal(tcams.projection_matrix(0.01, 100.0, 0.9, 0.7),
                                      jcams.projection_matrix(0.01, 100.0, 0.9, 0.7))
        np.testing.assert_array_equal(tcams.full_projection(view, 0.9, 0.7),
                                      jcams.full_projection(view, 0.9, 0.7))
        _close(tcams.camera_center_from_view(view),
               jcams.camera_center_from_view(jnp.asarray(view)), atol=1e-5)
        np.testing.assert_array_equal(tcams.intrinsic_matrix(0.9, 0.7, 640, 480),
                                      jcams.intrinsic_matrix(0.9, 0.7, 640, 480))
        assert tcams.focal2fov(tcams.fov2focal(0.9, 640), 640) == pytest.approx(0.9)
        assert (tcams.Z_NEAR, tcams.Z_FAR) == (jcams.Z_NEAR, jcams.Z_FAR)

    def test_synthetic_and_loaded_cameras(self):
        rng = np.random.default_rng(3)
        R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        T = rng.normal(size=3)
        a = tscam.make_synthetic_camera(64, 48, 0.9, 0.7, R, T, uid=4, name="c")
        b = jscam.make_synthetic_camera(64, 48, 0.9, 0.7, R, T, uid=4, name="c")
        for f in ("view", "proj", "full_proj", "camera_center", "image"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert tscam.camera_to_json(2, a) == jscam.camera_to_json(2, b)

        class FakeImage:
            """What load_camera needs of a PIL image: .size, .resize, __array__."""

            def __init__(self, arr):
                self.arr = arr

            @property
            def size(self):
                return self.arr.shape[1], self.arr.shape[0]

            def resize(self, res):
                w, h = res
                ys = np.arange(h) * self.arr.shape[0] // h
                xs = np.arange(w) * self.arr.shape[1] // w
                return FakeImage(self.arr[ys][:, xs])

            def __array__(self, dtype=None, copy=None):
                return self.arr

        rgba = rng.integers(0, 256, size=(60, 80, 4)).astype(np.uint8)
        kw = dict(uid=7, R=R, T=T, FovY=0.7, FovX=0.9, image=FakeImage(rgba),
                  image_path="", image_name="img", width=80, height=60)
        for res in (-1, 2):
            ta = tscam.camera_list_from_infos([tstruct.CameraInfo(**kw)], res)[0]
            ja = jscam.camera_list_from_infos([jstruct.CameraInfo(**kw)], res)[0]
            assert (ta.width, ta.height, ta.uid, ta.colmap_id) == (
                ja.width, ja.height, ja.uid, ja.colmap_id)
            for f in ("view", "full_proj", "camera_center", "image"):
                np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f))


# ------------------------------------------------------------ projection


class TestProjection:
    @pytest.mark.parametrize("deg", [0, 3])
    def test_project_gaussians_sh(self, deg):
        rng = np.random.default_rng(10 + deg)
        n, W, H = 300, 64, 48
        means = (rng.normal(size=(n, 3)) * [1.5, 1.5, 2.0] + [0, 0, 3]).astype(np.float32)
        scales = np.exp(rng.normal(size=(n, 3)) * 0.5 - 2.0).astype(np.float32)
        quats = rng.normal(size=(n, 4)).astype(np.float32)
        opac = rng.uniform(0, 1, size=(n, 1)).astype(np.float32)
        sh = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
        active = rng.uniform(size=n) > 0.1
        R, _ = np.linalg.qr(rng.normal(size=(3, 3)) * 0.1 + np.eye(3))
        jc = jscam.make_synthetic_camera(W, H, 0.9, 0.7, R, np.array([0.1, -0.2, 0.3]))
        args = (means, scales, quats, opac, jc.view, jc.full_proj, jc.camera_center)
        want = jproj.project_gaussians(
            jnp.asarray(means), jtr.covariance_planes(jnp.asarray(scales), jnp.asarray(quats)),
            jnp.asarray(opac), *[jnp.asarray(a) for a in args[4:]], W, H,
            jnp.float32(math.tan(0.45)), jnp.float32(math.tan(0.35)),
            sh=jnp.asarray(sh), sh_degree=deg, active=jnp.asarray(active))
        got = tproj.project_gaussians(
            _t(means), ttr.covariance_planes(_t(scales), _t(quats)), _t(opac),
            *[_t(a) for a in args[4:]], W, H,
            torch.tensor(math.tan(0.45), dtype=torch.float32),
            torch.tensor(math.tan(0.35), dtype=torch.float32),
            sh=_t(sh), sh_degree=deg, active=_t(active))
        assert int((want.radii > 0).sum()) > 50
        for f in want._fields:
            if f == "radii":
                # ceil(3 sqrt(lambda1)) may land one apart on an integer
                assert np.abs(_np(got.radii) - np.asarray(want.radii)).max() <= 1
                assert (_np(got.radii) == np.asarray(want.radii)).mean() > 0.99
            else:
                _close(getattr(got, f), getattr(want, f), atol=1e-4, rtol=1e-5, err_msg=f)

    @pytest.mark.parametrize("layout", ["full", "packed"])
    def test_covariance_layouts_and_project_scene(self, layout):
        rng = np.random.default_rng(20)
        n = 120
        arrays = {
            "xyz": (rng.normal(size=(n, 3)) + [0, 0, 4]).astype(np.float32),
            "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
            "features_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32),
            "opacity": rng.normal(size=(n, 1)).astype(np.float32),
            "scaling": rng.uniform(-3, -1.5, size=(n, 3)).astype(np.float32),
            "rotation": rng.normal(size=(n, 4)).astype(np.float32),
        }
        jscene = jg.from_arrays(arrays, max_sh_degree=3, capacity=128)
        tscene = tg.from_arrays(arrays, max_sh_degree=3, capacity=128, device="cpu")
        cam_j = jscam.make_synthetic_camera(40, 32, 0.9, 0.8, np.eye(3), np.zeros(3))
        cam_t = tscam.make_synthetic_camera(40, 32, 0.9, 0.8, np.eye(3), np.zeros(3))
        want = jproj.project_scene(jscene, cam_j, sh_degree=2)
        got = tproj.project_scene(tscene, cam_t, sh_degree=2)
        for f in want._fields:
            _close(getattr(got, f), getattr(want, f), atol=1e-4, rtol=1e-5, err_msg=f)
        # the [P, 3, 3] and packed [P, 6] covariance forms give the plane result
        s, q = tscene.get_scaling, tscene.rotation
        cov = ttr.build_covariance(s, q) if layout == "full" else ttr.build_covariance_6(s, q)
        other = tproj.project_gaussians(
            tscene.xyz, cov, tscene.get_opacity, _t(cam_t.view), _t(cam_t.full_proj),
            _t(cam_t.camera_center), 40, 32, math.tan(0.45), math.tan(0.4),
            sh=tscene.get_features, sh_degree=2, active=tscene.active)
        for f in want._fields:
            _close(getattr(other, f), getattr(got, f), atol=1e-4, rtol=1e-5, err_msg=f)
        with pytest.raises(ValueError, match="cov3d"):
            tproj.project_gaussians(tscene.xyz, torch.zeros(128, 4), tscene.get_opacity,
                                    _t(cam_t.view), _t(cam_t.full_proj),
                                    _t(cam_t.camera_center), 40, 32, 0.4, 0.4,
                                    colors_precomp=torch.zeros(128, 3))


# ------------------------------------------------------------ compositing


class TestGoldenModel:
    @pytest.mark.parametrize("chunk", [64, 0])
    def test_rasterize_scan_matches(self, chunk):
        jp = _jax_proj(n=150, width=40, height=30, seed=4, spread=0.5)
        bg = np.array([0.2, 0.4, 0.6], np.float32)
        if chunk:
            want = jcomp.rasterize_scan(jp, 40, 30, jnp.asarray(bg), chunk=chunk)
            got = tcomp.rasterize_scan(_to_torch_proj(jp), 40, 30, _t(bg), chunk=chunk)
        else:
            want = jcomp.rasterize_brute(jp, 40, 30, jnp.asarray(bg))
            got = tcomp.rasterize_brute(_to_torch_proj(jp), 40, 30, _t(bg))
        assert got.shape == (3, 30, 40)
        _close(got, want, atol=1e-6, rtol=0)
        assert (tcomp.ALPHA_MIN, tcomp.ALPHA_MAX, tcomp.T_EPS) == (
            jcomp.ALPHA_MIN, jcomp.ALPHA_MAX, jcomp.T_EPS)


# ---------------------------------------------------------------- binning


def _binning_inputs(n=300, width=64, height=48, seed=5, spread=1.0, scale=1.0):
    """Identical depth-ordered binning inputs for both packages, from the
    JAX projection: (means2d, radii_f, vis, conics, opac, nx, ny)."""
    jp = _jax_proj(n, width, height, seed, spread)
    vis = np.asarray(jp.radii) > 0
    order = np.argsort(np.where(vis, np.asarray(jp.depths), np.inf), kind="stable")
    radii = np.asarray(jp.radii)[order].astype(np.float32) * scale
    return (np.asarray(jp.means2d)[order], radii, vis[order],
            np.asarray(jp.conics)[order],
            np.where(vis, np.asarray(jp.opacities), 0.0)[order].astype(np.float32),
            -(-width // 16), -(-height // 16))


# small tier budgets so that every tier (and truncation) is exercised
TIERS = dict(t_max=4, overflow_k=3, t_max_big=24, mid_k=10, t_max_mid=9)


class TestBinning:
    @pytest.mark.parametrize("scale", [1.0, 3.0])
    def test_fused_pair_keys_and_saturation(self, scale):
        m, r, vis, con, op, nx, ny = _binning_inputs(scale=scale)
        kw = dict(TIERS)
        t_max = kw.pop("t_max")
        jk, _, _, jcounts, jbits = jtiles._fused_pair_keys(
            jnp.asarray(m), jnp.asarray(r), jnp.asarray(vis), nx, ny, 16, t_max,
            conics=jnp.asarray(con), opac=jnp.asarray(op), **kw)
        tk, tcounts, tbits = ttiles._fused_pair_keys(
            _t(m), _t(r), _t(vis), nx, ny, 16, t_max, conics=_t(con), opac=_t(op), **kw)
        assert tbits == jbits
        assert tk.dtype == torch.int64
        np.testing.assert_array_equal(_np(tk), np.asarray(jk).astype(np.int64))
        np.testing.assert_array_equal(_np(tcounts), np.asarray(jcounts))
        assert int(tcounts.sum()) == int(((tk >> tbits) < nx * ny).sum()) > 0

        want = jtiles.binning_saturation(jnp.asarray(m), jnp.asarray(r), jnp.asarray(vis),
                                         nx, ny, 16, t_max, **kw)
        got = ttiles.binning_saturation(_t(m), _t(r), _t(vis), nx, ny, 16, t_max, **kw)
        assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}
        if scale > 1.0:
            assert int(got["dropped_mid"]) + int(got["dropped_big"]) > 0

    def test_two_key_branch(self):
        """Where tile + depth-rank bits pass 32 the JAX package takes its
        two-key sort; the port's one int64 key carries the same (tile,
        depth rank) pairs, slot for slot. Past 62 bits it refuses."""
        P, nx, ny = 1 << 16, 400, 400  # 16 + 18 bits (test_pair_keys.py's case)
        rng = np.random.default_rng(3)
        m = rng.uniform([-10, -10], [nx * 16 + 10, ny * 16 + 10], size=(P, 2))
        m = m.astype(np.float32)
        r = rng.uniform(1.0, 40.0, size=P).astype(np.float32)
        vis = rng.uniform(size=P) > 0.15
        kw = dict(overflow_k=8, t_max_big=64, mid_k=32, t_max_mid=16)
        jk, jtile_ids, jgidx, jcounts, gbits = jtiles._fused_pair_keys(
            jnp.asarray(m), jnp.asarray(r), jnp.asarray(vis), nx, ny, 16, 4, **kw)
        assert jk is None  # the JAX package's two-key branch
        tk, tcounts, tbits = ttiles._fused_pair_keys(_t(m), _t(r), _t(vis), nx, ny, 16, 4,
                                                     **kw)
        assert tk.dtype == torch.int64 and tbits == gbits
        np.testing.assert_array_equal(_np(tk >> gbits), np.asarray(jtile_ids))
        np.testing.assert_array_equal(_np(tk & ((1 << gbits) - 1)), np.asarray(jgidx))
        np.testing.assert_array_equal(_np(tcounts), np.asarray(jcounts))
        assert int(tcounts.sum()) > P
        with pytest.raises(ValueError, match="key bits"):
            ttiles._fused_pair_keys(torch.zeros(1 << 22, 2), torch.ones(1 << 22),
                                    torch.ones(1 << 22, dtype=torch.bool), 1 << 20,
                                    1 << 20, 16, 4)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_segment_and_aligned_starts(self, seed):
        rng = np.random.default_rng(seed)
        n_tiles = 23
        # sorted tile ids with empty tiles and a sentinel (n_tiles) tail
        pool = np.setdiff1d(np.arange(n_tiles + 1), [0, 5, 6, 17])
        tiles_c = np.sort(rng.choice(pool, size=2048)).astype(np.int32)
        want = jpt._segment_starts(jnp.asarray(tiles_c), n_tiles)
        got = tpt._segment_starts(_t(tiles_c), n_tiles)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        for nc in (2048, 1024):
            wa, wt = jpt._aligned_starts(want, nc)
            ga, gt = tpt._aligned_starts(got, nc)
            assert ga.dtype == torch.int32
            np.testing.assert_array_equal(_np(ga), np.asarray(wa))
            assert int(gt) == int(wt)


# -------------------------------------------------------------------- B5


def _align_case(counts, nc, P=1000, seed=0):
    counts = np.asarray(counts, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    rng = np.random.default_rng(seed)
    gidx = np.full(nc, -1, np.int32)
    gidx[:starts[-1]] = rng.integers(0, P, starts[-1])
    starts_al, _ = jpt._aligned_starts(jnp.asarray(starts), nc)
    return gidx, starts, np.asarray(starts_al)


class TestAlignCompact:
    """B5's plain version (the path a CPU tensor takes) against the Pallas
    kernel in interpret mode and the numpy model of
    tests/test_aligned_layout.py."""

    @pytest.mark.parametrize("case", ["basic", "all_empty", "exact_fill", "truncated",
                                      "random", *ALIGN_LAYOUTS])
    def test_matches_pallas(self, case):
        from tests.test_aligned_layout import _np_reference

        if case in ALIGN_LAYOUTS:  # the layouts the card test and chip_smoke.py share
            counts, nc = ALIGN_LAYOUTS[case]
            gidx, starts, starts_al = align_layout(counts, nc)
            want = jpt._align_compact(jnp.asarray(gidx), jnp.asarray(starts),
                                      jnp.asarray(starts_al), len(counts), 1000,
                                      interpret=True)
            np.testing.assert_array_equal(
                starts_al, np.asarray(jpt._aligned_starts(jnp.asarray(starts), nc)[0]))
            got = tpt._align_compact(_t(gidx), _t(starts), _t(starts_al), len(counts), 1000)
            np.testing.assert_array_equal(_np(got), np.asarray(want))
            assert not (_np(got) == -7).any()  # no lane past a tile's run
            assert (_np(got)[starts_al[-1]:] == 1000).all()  # the tail
            return
        counts, nc = {
            "basic": ([5, 0, 128, 129, 300, 0, 1, 127], 2048),
            "all_empty": ([0] * 16, 1024),
            "exact_fill": ([128] * 8, 1024),
            "truncated": ([100, 200, 300, 150, 90, 130], 1024),
            "random": (np.random.default_rng(7).integers(0, 260, 20), 5120),
        }[case]
        if case == "truncated":  # the aligned demand (1408) exceeds nc
            counts = np.asarray(counts, np.int32)
            starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
            gidx = np.arange(nc, dtype=np.int32)
            starts_al = np.asarray(jpt._aligned_starts(jnp.asarray(starts), nc)[0])
        else:
            gidx, starts, starts_al = _align_case(counts, nc)
        n_tiles = len(counts)
        want = jpt._align_compact(jnp.asarray(gidx), jnp.asarray(starts),
                                  jnp.asarray(starts_al), n_tiles, 1000, interpret=True)
        before = tpt._align_compact.launches
        got = tpt._align_compact(_t(gidx), _t(starts), _t(starts_al), n_tiles, 1000)
        assert tpt._align_compact.launches == before  # CPU: plain version
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        if case != "truncated":
            ref, _ = _np_reference(gidx, starts, nc, 1000)
            np.testing.assert_array_equal(_np(got), ref)


# -------------------------------------------------------------------- B3


def _records_case(counts, seed=0, opaque=None, nx=3, ny=2):
    """Aligned synthetic records [16, NC] (as tests/test_pallas_rasterizer.py's
    stored-transmittance case): per tile, pair means around the tile,
    conics 0.05-0.3, colors and opacities uniform. ``opaque``: (start,
    length, value) of an opacity run to force early exits."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int32)
    spans = [-(-int(c) // 128) * 128 for c in counts]
    starts = np.zeros(nx * ny + 1, np.int32)
    starts[1:] = np.cumsum(spans)
    nc = int(starts[-1]) + 128
    rec = np.zeros((16, nc), np.float32)
    for t in range(nx * ny):
        s, c = starts[t], int(counts[t])
        ox, oy = (t % nx) * 16, (t // nx) * 16
        rec[0, s:s + c] = rng.uniform(ox - 4, ox + 20, c)
        rec[1, s:s + c] = rng.uniform(oy - 4, oy + 20, c)
        rec[2, s:s + c] = rng.uniform(0.05, 0.3, c)
        rec[3, s:s + c] = rng.uniform(-0.05, 0.05, c)
        rec[4, s:s + c] = rng.uniform(0.05, 0.3, c)
        rec[5:8, s:s + c] = rng.uniform(0, 1, (3, c))
        rec[8, s:s + c] = rng.uniform(0.1, 0.99, c)
    if opaque is not None:
        s, n, v = opaque
        rec[8, s:s + n] = v
    return rec, starts, counts


class TestCompositeForward:
    """B3's plain version against the Pallas kernel (interpret) on
    identical records."""

    @pytest.mark.parametrize("case", ["mixed", "early_exit", "deep_translucent"])
    def test_matches_pallas(self, case):
        counts = [50, 0, 130, 128, 300, 7]
        opaque = None
        if case == "early_exit":
            # saturate the front of the deep segment: every pixel of tile 4
            # stops before its last chunk
            opaque = (512, 140, 0.999)
        if case == "deep_translucent":
            counts = [700, 1, 0, 640, 5, 900]
        rec, starts, counts = _records_case(counts, seed=1, opaque=opaque)
        if case == "deep_translucent":
            rec[8] *= 0.05  # low opacity keeps the deep lanes contributing
        bg = np.array([0.1, 0.2, 0.3], np.float32)
        want = jpt.pallas_composite_fwd(jnp.asarray(rec), jnp.asarray(starts),
                                        jnp.asarray(counts), 3, 2, jnp.asarray(bg),
                                        interpret=True)
        before = tpt.pallas_composite_fwd.launches
        got = tpt.pallas_composite_fwd(_t(rec), _t(starts), _t(counts), 3, 2, _t(bg))
        assert tpt.pallas_composite_fwd.launches == before
        assert got.shape == (6, 256, 3)
        _close(got, want, atol=IMG_ATOL, rtol=0)
        # empty tiles are pure background
        for t in np.flatnonzero(counts == 0):
            _close(got[t], np.broadcast_to(bg, (256, 3)), atol=0, rtol=0)

    def test_work_counts_and_refusals(self):
        rec, starts, counts = _records_case([50, 0, 130, 128, 300, 7], seed=2,
                                            opaque=(512, 140, 0.999))
        out, (evals, contribs) = tpt.composite_fwd_plain(
            _t(rec), _t(starts), _t(counts), 3, 2, torch.zeros(3), return_work=True)
        np.testing.assert_array_equal(
            _np(out), _np(tpt.composite_fwd_plain(_t(rec), _t(starts), _t(counts), 3, 2,
                                                  torch.zeros(3))))
        # every pixel evaluates at most its segment; the opaque run stops
        # tile 4 long before its 300 pairs
        assert 0 < contribs < evals < 256 * int(counts.sum())
        # the transmittance store needs the aligned layout
        with pytest.raises(ValueError, match="aligned"):
            tpt.pallas_composite_fwd(_t(rec), _t(starts + 1), _t(counts), 3, 2,
                                     torch.zeros(3), store_t=True)
        with pytest.raises(ValueError, match="records"):
            tpt.pallas_composite_fwd(_t(rec[:9]), _t(starts), _t(counts), 3, 2,
                                     torch.zeros(3))


# ----------------------------------------------------------- full raster


class TestRasterizePallas:
    @pytest.mark.parametrize("case", ["matches_brute", "partial_edge_tile"])
    def test_matches_jax_pallas(self, case):
        n, W, H, seed = {"matches_brute": (150, 64, 48, 0),
                         "partial_edge_tile": (80, 50, 35, 2)}[case]
        jp = _jax_proj(n, W, H, seed)
        bg = np.array([1.0, 0.5, 0.0], np.float32)
        want = jpt.rasterize_pallas(jp, W, H, jnp.asarray(bg), t_max=64, interpret=True)
        got = tpt.rasterize_pallas(_to_torch_proj(jp), W, H, _t(bg), t_max=64)
        assert got.shape == (3, H, W)
        _close(got, want, atol=IMG_ATOL, rtol=0)
        _close(got, jcomp.rasterize_brute(jp, W, H, jnp.asarray(bg)), atol=IMG_ATOL, rtol=0)

    @pytest.mark.parametrize("case", ["dense_overlap", "deep_segments"])
    def test_matches_golden(self, case):
        n, W, H, seed, spread, t_max = {"dense_overlap": (300, 48, 32, 1, 0.25, 64),
                                        "deep_segments": (900, 32, 32, 7, 0.12, 16)}[case]
        jp = _jax_proj(n, W, H, seed, spread)
        if case == "deep_segments":
            # segments of 6+ chunks; low opacity keeps the deep lanes live
            jp = jp._replace(opacities=jp.opacities * 0.12)
        bg = np.array([0.2, 0.3, 0.4], np.float32)
        want = jcomp.rasterize_brute(jp, W, H, jnp.asarray(bg))
        got, stats = tpt.rasterize_pallas(_to_torch_proj(jp), W, H, _t(bg), t_max=t_max,
                                          return_stats=True)
        _close(got, want, atol=IMG_ATOL, rtol=0)
        if case == "deep_segments":
            assert int(stats["nc_real"]) > 6 * 128 * 4

    def test_two_key_branch_renders_the_same(self):
        """A scene whose keys need 33 bits: the JAX package renders it
        through its two-key sort, the port through one int64 key sort, and
        the images and budget telemetry agree."""
        P, W, H = (1 << 19) + 1, 1024, 1024  # 20 depth-rank + 13 tile bits
        assert (P - 1).bit_length() + (W // 16 * H // 16).bit_length() > 32
        rng = np.random.default_rng(8)
        fields = dict(
            means2d=rng.uniform(0, [W, H], size=(P, 2)),
            depths=rng.uniform(1, 5, P),
            conics=np.stack([rng.uniform(0.03, 0.1, P), rng.uniform(-0.01, 0.01, P),
                             rng.uniform(0.03, 0.1, P)], 1),
            # 200 visible gaussians spread over all depth ranks
            radii=np.where(rng.permutation(P) < 200, 12, 0),
            colors=rng.uniform(0, 1, (P, 3)),
            opacities=rng.uniform(0.2, 0.9, P))
        fields = {k: v.astype(np.int32 if k == "radii" else np.float32)
                  for k, v in fields.items()}
        jp = jproj.ProjectedGaussians(**{k: jnp.asarray(v) for k, v in fields.items()})
        bg = np.array([0.3, 0.2, 0.1], np.float32)
        kw = dict(t_max=4, nc_pairs=1 << 18, return_stats=True)
        want, wstats = jpt.rasterize_pallas(jp, W, H, jnp.asarray(bg), interpret=True, **kw)
        got, gstats = tpt.rasterize_pallas(_to_torch_proj(jp), W, H, _t(bg), **kw)
        assert {k: int(v) for k, v in gstats.items()} == {k: int(v) for k, v in wstats.items()}
        assert int(gstats["grad_dropped"]) == 0 and int(gstats["nc_real"]) > 200
        _close(got, want, atol=IMG_ATOL, rtol=0)
        assert (np.abs(_np(got) - bg[:, None, None]) > 0.05).mean() > 0.01  # splats show

    @pytest.mark.parametrize("case", ["empty", "all_culled", "single"])
    def test_degenerate_scenes(self, case):
        """TestEdgeCases' scenes: no visible gaussian, every pair below
        1/255 (conic-culled), and a single gaussian."""
        rng = np.random.default_rng(10)
        n, W, H = 40, 48, 32
        means = rng.uniform([0, 0], [W, H], size=(n, 2)).astype(np.float32)
        conics = np.tile(np.array([[0.15, 0.0, 0.15]], np.float32), (n, 1))
        colors = rng.uniform(size=(n, 3)).astype(np.float32)
        depths = rng.uniform(1, 5, size=n).astype(np.float32)
        if case == "empty":
            radii, opac = np.zeros(n, np.int32), np.full(n, 0.5, np.float32)
        elif case == "all_culled":
            radii, opac = np.full(n, 6, np.int32), np.full(n, 1e-3, np.float32)
        else:
            radii = np.where(np.arange(n) == 0, 6, 0).astype(np.int32)
            opac = np.full(n, 0.7, np.float32)
        bg = np.array([0.25, 0.5, 0.75], np.float32)
        fields = dict(means2d=means, conics=conics, colors=colors, opacities=opac,
                      depths=depths, radii=radii)
        jp = jproj.ProjectedGaussians(**{k: jnp.asarray(v) for k, v in fields.items()})
        tp = tproj.ProjectedGaussians(**{k: _t(v) for k, v in fields.items()})
        img, stats = tpt.rasterize_pallas(tp, W, H, _t(bg), return_stats=True)
        assert torch.isfinite(img).all()
        _close(img, jcomp.rasterize_brute(jp, W, H, jnp.asarray(bg)), atol=IMG_ATOL, rtol=0)
        if case != "single":
            _close(img, np.broadcast_to(bg[:, None, None], img.shape), atol=1e-6, rtol=0)
            assert int(stats["nc_real"]) == 0 and int(stats["nc_demand"]) == 0

    @pytest.mark.parametrize("nc_pairs", [0, 1024])
    def test_return_stats_match(self, nc_pairs):
        """Budget telemetry equals the JAX package's, also when the aligned
        demand overflows nc (trailing tiles cut in both packages alike)."""
        jp = _jax_proj(150, 64, 48, 3)
        bg = np.zeros(3, np.float32)
        want, wstats = jpt.rasterize_pallas(jp, 64, 48, jnp.asarray(bg), t_max=16,
                                            nc_pairs=nc_pairs, return_stats=True,
                                            interpret=True)
        got, gstats = tpt.rasterize_pallas(_to_torch_proj(jp), 64, 48, _t(bg), t_max=16,
                                           nc_pairs=nc_pairs, return_stats=True)
        assert {k: int(v) for k, v in gstats.items()} == {k: int(v) for k, v in wstats.items()}
        assert int(gstats["grad_dropped"]) == (1 if nc_pairs else 0)
        assert int(gstats["nc_demand"]) % 128 == 0
        _close(got, want, atol=IMG_ATOL, rtol=0)

    def test_refuses_inputs_that_require_grad(self):
        """Since the backward kernel was ported nothing is refused for
        requiring grad: every differentiable field of the projection gets a
        finite gradient of its own shape, the background gets none, and a
        call under no_grad stays off the graph. A training step takes
        ``"tiled"`` (the tile rasterizer in plain PyTorch) as well, and
        refuses a name that is no rasterizer."""
        jp = _jax_proj(50, 32, 32, 0)
        tp = _to_torch_proj(jp)
        for field in ("means2d", "conics", "colors", "opacities"):
            src = getattr(tp, field).clone().requires_grad_()
            bg = torch.zeros(3, requires_grad=True)
            img = tpt.rasterize_pallas(tp._replace(**{field: src}), 32, 32, bg)
            assert img.requires_grad
            g, g_bg = torch.autograd.grad(img.square().sum(), [src, bg], allow_unused=True)
            assert g.shape == src.shape and torch.isfinite(g).all() and g.abs().max() > 0
            assert g_bg is None
        with torch.no_grad():
            src = tp.colors.clone().requires_grad_()
            ok = tpt.rasterize_pallas(tp._replace(colors=src * 1.0), 32, 32, torch.zeros(3))
        assert ok.shape == (3, 32, 32) and not ok.requires_grad
        tscene = tg.from_arrays(_render_scene(n=20), max_sh_degree=3, capacity=32,
                                device="cpu")
        state = ttrain.init_train_state(tscene)
        tc = tscam.make_synthetic_camera(16, 16, 0.9, 0.9, np.eye(3), np.zeros(3))
        step = dict(cam=ttrain.camera_arrays(tc, "cpu", with_image=True), bg=torch.zeros(3),
                    lrs=ttrain.lr_dict(tconfig.OptimizationConfig(), 1.0, 1), width=16,
                    height=16, sh_degree=0)
        _, metrics = ttrain.train_step(state, rasterizer="tiled", **step)
        assert torch.isfinite(metrics["loss"]) and "binning_total_area" in metrics
        with pytest.raises(ValueError, match="rasterizer"):
            ttrain.train_step(state, rasterizer="nope", **step)


# ------------------------------------------------------------ render_eval


def _render_scene(n=400, seed=30):
    rng = np.random.default_rng(seed)
    return {
        "xyz": (rng.normal(size=(n, 3)) * [1.0, 0.8, 0.6] + [0, 0, 4]).astype(np.float32),
        "features_dc": (rng.normal(size=(n, 1, 3)) * 0.5).astype(np.float32),
        "features_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32),
        "opacity": rng.uniform(-2.0, 3.0, size=(n, 1)).astype(np.float32),
        "scaling": rng.uniform(-3.5, -2.0, size=(n, 3)).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
    }


class TestRenderEval:
    def test_matches_jax_render_eval(self):
        """SH degree 3 scene, padded to a capacity, through the whole
        inference path of both packages (JAX: Pallas kernels in interpret
        mode)."""
        arrays = _render_scene()
        W, H = 56, 40
        R = np.eye(3)
        T = np.array([0.1, -0.1, 0.0])
        jscene = jg.from_arrays(arrays, max_sh_degree=3, capacity=512)
        tscene = tg.from_arrays(arrays, max_sh_degree=3, capacity=512, device="cpu")
        jc = jscam.make_synthetic_camera(W, H, 0.9, 0.7, R, T)
        tc = tscam.make_synthetic_camera(W, H, 0.9, 0.7, R, T)
        bg = np.array([0.1, 0.0, 0.3], np.float32)
        want = jtrain.render_eval(jscene, jc, jnp.asarray(bg), 3,
                                  rasterizer="pallas_interpret")
        got = ttrain.render_eval(tscene, tc, bg, 3, rasterizer="auto")
        assert got.shape == (3, H, W) and not got.requires_grad
        _close(got, want, atol=IMG_ATOL, rtol=0)
        assert np.abs(_np(got) - bg[:, None, None]).max() > 0.1  # the scene shows
        # the golden path of both packages
        want_scan = jtrain.render_eval(jscene, jc, jnp.asarray(bg), 3, chunk=128,
                                       rasterizer="scan")
        got_scan = ttrain.render_eval(tscene, tc, bg, 3, chunk=128, rasterizer="scan")
        _close(got_scan, want_scan, atol=IMG_ATOL, rtol=0)
        _close(got, got_scan, atol=IMG_ATOL, rtol=0)

    def test_default_budget_cuts_trailing_tiles(self, monkeypatch):
        """render_eval passes no nc_pairs, so both packages render at the
        default pair budget (DEFAULT_NC, read at each call), and a frame
        whose aligned demand is above it has its trailing tiles cut: they
        render as background, with no warning. With the default shrunk to
        the smallest budget (1,024 slots) on a scene that wants more, the
        two packages' images agree; every tile the cut emptied is the
        background, and every tile it left whole equals the full-budget
        render."""
        arrays = _render_scene()
        W, H = 56, 40
        jscene = jg.from_arrays(arrays, max_sh_degree=3, capacity=512)
        tscene = tg.from_arrays(arrays, max_sh_degree=3, capacity=512, device="cpu")
        jc = jscam.make_synthetic_camera(W, H, 0.9, 0.7, np.eye(3), np.array([0.1, -0.1, 0]))
        tc = tscam.make_synthetic_camera(W, H, 0.9, 0.7, np.eye(3), np.array([0.1, -0.1, 0]))
        bg = np.array([0.1, 0.0, 0.3], np.float32)
        full = _np(ttrain.render_eval(tscene, tc, bg, 3))
        nc = tpt.ALIGN_CPB * tpt.KB
        monkeypatch.setattr(jpt, "DEFAULT_NC", nc)
        monkeypatch.setattr(tpt, "DEFAULT_NC", nc)
        want = jtrain.render_eval(jscene, jc, jnp.asarray(bg), 3, rasterizer="pallas_interpret")
        got = _np(ttrain.render_eval(tscene, tc, bg, 3))
        _close(got, want, atol=IMG_ATOL, rtol=0)
        proj = ttrain._project_params(tscene.params(), tscene.active,
                                      ttrain.camera_arrays(tc, "cpu"), W, H, 3)
        lay = tpt._compact_layout(proj, W, H, *(ttrain.DEFAULT_TIERS[i] for i in (0, 3, 4, 1, 2)),
                                  0)
        assert lay.nc == nc and int(lay.al_total) > nc
        counts = _np(lay.starts[1:] - lay.starts[:-1])
        kept = _np(lay.counts_k)
        def by_tile(x):  # [3, H, W] -> [12 tiles, 3, 16, 16], padded past the edge
            x = np.pad(x, ((0, 0), (0, 48 - H), (0, 64 - W)))
            return x.reshape(3, 3, 16, 4, 16).transpose(1, 3, 0, 2, 4).reshape(12, 3, 16, 16)

        tiles, ref = by_tile(got), by_tile(full)
        inside = by_tile(np.ones((3, H, W))) > 0
        emptied = (kept == 0) & (counts > 0)
        whole = (kept == counts) & (counts > 0)
        assert emptied.any() and whole.any()
        for t in np.flatnonzero(emptied):
            np.testing.assert_array_equal(
                tiles[t][inside[t]], np.broadcast_to(bg[:, None, None], (3, 16, 16))[inside[t]])
            assert np.abs(ref[t] - bg[:, None, None])[inside[t]].max() > 0.05
        for t in np.flatnonzero(whole):
            np.testing.assert_array_equal(tiles[t], ref[t])

    def test_rasterizer_names_and_camera_arrays(self):
        assert resolve_rasterizer("auto") == "pallas"
        assert resolve_rasterizer("scan") == "scan"
        tscene = tg.from_arrays(_render_scene(n=20), max_sh_degree=3, capacity=32,
                                device="cpu")
        tc = tscam.make_synthetic_camera(16, 16, 0.9, 0.9, np.eye(3), np.zeros(3))
        tiled = ttrain.render_eval(tscene, tc, np.zeros(3), 3, rasterizer="tiled")
        _close(tiled, ttrain.render_eval(tscene, tc, np.zeros(3), 3), atol=IMG_ATOL, rtol=0)
        with pytest.raises(ValueError, match="rasterizer"):
            ttrain.render_eval(tscene, tc, np.zeros(3), 3, rasterizer="nope")
        jc = jscam.make_synthetic_camera(16, 16, 0.9, 0.9, np.eye(3), np.zeros(3))
        ta, ja = ttrain.camera_arrays(tc, "cpu"), jtrain.camera_arrays(jc)
        # a render leaves the ground-truth image on the host, a training
        # step stages it
        assert ta._fields == ja._fields and ta.gt_image is None
        ta = ttrain.camera_arrays(tc, "cpu", with_image=True)
        for f in ta._fields:
            np.testing.assert_array_equal(_np(getattr(ta, f)), np.asarray(getattr(ja, f)))
        assert ttrain.DEFAULT_TIERS == jtrain.DEFAULT_TIERS
        assert (tpt.COLS, tpt.KB, tpt.TILE, tpt.NPIX, tpt.DEFAULT_NC, tpt.ALIGN_CPB) == (
            jpt.COLS, jpt.KB, jpt.TILE, jpt.NPIX, jpt.DEFAULT_NC, jpt.ALIGN_CPB)
