"""sixdgs_torch.ops (SH, quaternions, sym-eig 3x3, lines) against sixdgs_tpu.ops
on the same numpy inputs (CPU, float32)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sixdgs_tpu.ops import lines as jlines
from sixdgs_tpu.ops import sh as jsh
from sixdgs_tpu.ops import sym_eig as jsym
from sixdgs_tpu.ops import transforms as jtf
from sixdgs_torch.ops import lines as tlines
from sixdgs_torch.ops import sh as tsh
from sixdgs_torch.ops import sym_eig as tsym
from sixdgs_torch.ops import transforms as ttf
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)

# float32 elementwise math on both sides; the two libraries may fuse and
# order operations differently, so allow a few ulps of the values' scale
ATOL, RTOL = 1e-5, 1e-5


def _t(x):
    return torch.tensor(np.asarray(x))


def _unit_dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


class TestSH:
    @pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
    def test_eval_sh_matches(self, deg):
        rng = np.random.default_rng(deg)
        sh = rng.normal(size=(64, 3, (deg + 1) ** 2)).astype(np.float32)
        dirs = _unit_dirs(rng, 64)
        ref = np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))
        out = tsh.eval_sh(deg, _t(sh), _t(dirs)).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)

    def test_sh_to_color_and_rgb_to_sh(self):
        rng = np.random.default_rng(7)
        sh = rng.normal(size=(128, 3, 16)).astype(np.float32)
        dirs = _unit_dirs(rng, 128)
        ref = np.asarray(jsh.sh_to_color(3, jnp.asarray(sh), jnp.asarray(dirs)))
        out = tsh.sh_to_color(3, _t(sh), _t(dirs)).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
        assert (out >= 0).all()
        rgb = rng.uniform(size=(50, 3)).astype(np.float32)
        np.testing.assert_allclose(tsh.rgb_to_sh(_t(rgb)).numpy(),
                                   np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(np.asarray(jsh.sh_to_rgb(tsh.rgb_to_sh(_t(rgb)).numpy())),
                                   rgb, atol=1e-6)


class TestTransforms:
    def test_quat_to_rotmat_matches_with_zero_guard(self):
        rng = np.random.default_rng(1)
        q = rng.normal(size=(100, 4)).astype(np.float32)
        q[0] = 0.0  # collapsed quaternion: the 1e-12 guard keeps it finite
        ref = np.asarray(jtf.quat_to_rotmat(jnp.asarray(q)))
        out = ttf.quat_to_rotmat(_t(q)).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
        assert np.isfinite(out).all()
        R = out[1:]
        np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2),
                                   np.broadcast_to(np.eye(3), R.shape), atol=1e-5)

    def test_inverse_sigmoid(self):
        x = np.linspace(0.01, 0.99, 50, dtype=np.float32)
        np.testing.assert_allclose(ttf.inverse_sigmoid(_t(x)).numpy(),
                                   np.asarray(jtf.inverse_sigmoid(jnp.asarray(x))),
                                   atol=ATOL, rtol=RTOL)


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q


def _sym_cases():
    rng = np.random.default_rng(3)
    generic = []
    for _ in range(64):
        R = _rot(rng)
        lam = np.sort(rng.uniform(0.1, 5.0, size=3))
        generic.append(R @ np.diag(lam) @ R.T)
    degenerate = [
        np.eye(3) * 2.5,  # isotropic
        np.zeros((3, 3)),
        np.diag([1.0, 1.0, 3.0]),  # repeated smallest
        np.diag([1.0, 3.0, 3.0]),  # repeated largest
        np.outer([1.0, 2.0, 2.0], [1.0, 2.0, 2.0]) / 9.0,  # rank 1
        np.diag([0.0, 0.0, 1e-3]),
    ]
    R = _rot(rng)
    degenerate.append(R @ np.diag([0.5, 0.5, 2.0]) @ R.T)  # rotated repeated
    return (np.asarray(generic, np.float32), np.asarray(degenerate, np.float32))


class TestSymEig:
    def test_generic_matches_reference(self):
        A, _ = _sym_cases()
        ref_w, ref_v = (np.asarray(x) for x in jsym.sym_eig_3x3(jnp.asarray(A)))
        w, v = (x.numpy() for x in tsym.sym_eig_3x3(_t(A)))
        np.testing.assert_allclose(w, ref_w, atol=1e-4, rtol=1e-4)
        # same algorithm, so the same eigenvector SIGNS (they feed the normal
        # disambiguation): compare the vectors themselves
        np.testing.assert_allclose(v, ref_v, atol=1e-3)

    def test_degenerate_matrices(self):
        _, A = _sym_cases()
        ref_w, ref_v = (np.asarray(x) for x in jsym.sym_eig_3x3(jnp.asarray(A)))
        w, v = (x.numpy() for x in tsym.sym_eig_3x3(_t(A)))
        np.testing.assert_allclose(w, ref_w, atol=1e-4, rtol=1e-4)
        assert np.isfinite(v).all()
        # orthonormal eigenbasis that diagonalizes A
        np.testing.assert_allclose(np.swapaxes(v, -1, -2) @ v,
                                   np.broadcast_to(np.eye(3), v.shape), atol=1e-4)
        # a double root of the cubic costs the closed form ~sqrt(eps_f32)
        # relative accuracy in its eigenvectors (both packages alike)
        np.testing.assert_allclose(A @ v, v * w[:, None, :], atol=1e-3)
        # where the reference lands on the same basis (isotropic -> identity,
        # axis-aligned cases), the port does too
        for i in (0, 1, 2, 3):
            np.testing.assert_allclose(np.abs(v[i]), np.abs(ref_v[i]), atol=1e-5)

    def test_eigvals_only(self):
        A, _ = _sym_cases()
        np.testing.assert_allclose(
            tsym.sym_eig_3x3(_t(A), eigenvectors=False).numpy(),
            np.asarray(jsym.sym_eig_3x3(jnp.asarray(A), eigenvectors=False)),
            atol=1e-4, rtol=1e-4)


class TestLines:
    def _bundle(self, seed, n=40, noise=0.01):
        rng = np.random.default_rng(seed)
        target = rng.normal(size=3).astype(np.float32)
        d = _unit_dirs(rng, n)
        t = rng.uniform(0.5, 3.0, size=(n, 1)).astype(np.float32)
        pts = (target - d * t + noise * rng.normal(size=(n, 3))).astype(np.float32)
        w = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
        mask = rng.uniform(size=n) > 0.2
        return target, pts, d, w, mask

    def test_intersection_matches(self):
        target, pts, d, w, mask = self._bundle(0)
        for kw in ({}, {"weights": w}, {"mask": mask}, {"weights": w, "mask": mask}):
            ref = np.asarray(jlines.line_intersection_wls(
                jnp.asarray(pts), jnp.asarray(d),
                **{k: jnp.asarray(v) for k, v in kw.items()}))
            out = tlines.line_intersection_wls(
                _t(pts), _t(d), **{k: _t(v) for k, v in kw.items()}).numpy()
            np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(out, target, atol=0.05)

    def test_parallel_bundle_is_nan_sentinel(self):
        pts = np.random.default_rng(1).normal(size=(10, 3)).astype(np.float32)
        d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (10, 1))
        ref = np.asarray(jlines.line_intersection_wls(jnp.asarray(pts), jnp.asarray(d)))
        out = tlines.line_intersection_wls(_t(pts), _t(d)).numpy()
        assert np.isnan(ref).all() and np.isnan(out).all()

    def test_exclude_negatives_and_rotation(self):
        target, pts, d, _, _ = self._bundle(2)
        c = target + 0.3
        np.testing.assert_array_equal(
            tlines.exclude_negatives(_t(c), _t(pts), _t(d)).numpy(),
            np.asarray(jlines.exclude_negatives(jnp.asarray(c), jnp.asarray(pts),
                                                jnp.asarray(d))))
        up = np.array([0.1, 1.0, 0.2], np.float32)
        np.testing.assert_allclose(
            tlines.make_rotation_mat(_t(d[0]), _t(up)).numpy(),
            np.asarray(jlines.make_rotation_mat(jnp.asarray(d[0]), jnp.asarray(up))),
            atol=ATOL, rtol=RTOL)
