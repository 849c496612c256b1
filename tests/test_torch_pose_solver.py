"""The port's score loss and pose solver against sixdgs_tpu, including the
reference quirks the solver keeps: the coordinate-level duplicate-origin
filter, the unweighted LS re-solve and the NaN -> identity fallback.

Inputs are made with numpy from a seed and handed to both packages. The
scores are strictly decreasing, so top-k picks the same rays on both sides.
"""

import numpy as np
import jax.numpy as jnp
import torch

from sixdgs_tpu.pose import loss as jloss
from sixdgs_tpu.pose import solver as jsol
from sixdgs_torch.pose import loss as tloss
from sixdgs_torch.pose import solver as tsol
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)


def _t(x):
    return torch.tensor(np.asarray(x))


def _look_at_c2w(cam_pos):
    z = -cam_pos / np.linalg.norm(cam_pos)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = x, np.cross(z, x), z
    c2w[:3, 3] = cam_pos
    return c2w


def _rays(n, n_valid, seed, target=None, noise=0.02):
    """Origins on the unit sphere; directions toward ``target`` (plus noise)
    or random; padded tail zeroed and invalid."""
    rng = np.random.default_rng(seed)
    ori = rng.normal(size=(n, 3))
    ori /= np.linalg.norm(ori, axis=-1, keepdims=True)
    d = rng.normal(size=(n, 3)) if target is None else (
        target[None] - ori + noise * rng.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    valid = np.arange(n) < n_valid
    ori = np.where(valid[:, None], ori, 0.0).astype(np.float32)
    d = np.where(valid[:, None], d, 0.0).astype(np.float32)
    return ori, d, valid


def _solve_both(scores, ori, d, up, valid, k=100):
    ref = jsol.solve_pose(*map(jnp.asarray, (scores, ori, d, up, valid)), k=k)
    out = tsol.solve_pose(*map(_t, (scores, ori, d, up, valid)), k=k)
    return ref, out


class TestLossParity:
    def test_targets_and_loss_match(self):
        cam_pos = np.array([0.4, 0.5, 2.5], np.float32)
        c2w = _look_at_c2w(cam_pos)
        # half the rays aim near the camera, half anywhere (some start behind
        # it or point away, which the clamp and the sign mask handle)
        o1, d1, _ = _rays(300, 300, seed=1, target=cam_pos, noise=0.3)
        o2, d2, _ = _rays(300, 300, seed=2)
        ori, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
        ori[:40] *= 4.0  # these origins lie behind the camera
        valid = np.arange(600) < 560
        pred = np.random.default_rng(3).uniform(size=600).astype(np.float32)
        n_patches = np.asarray(137, np.int32)

        ref = jloss.target_ray_scores(*map(jnp.asarray, (c2w, ori, d, valid, n_patches)))
        out = tloss.target_ray_scores(*map(_t, (c2w, ori, d, valid, n_patches)))
        assert 0 < int((np.asarray(ref.target_raw) == 0).sum()) < 600
        for name in ("target", "target_raw", "target_with_distance"):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=1e-6, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(out.target.sum().item(), 137.0, rtol=1e-5)

        ref_loss, ref_tgt = jloss.distance_score_loss(
            *map(jnp.asarray, (pred, c2w, ori, d, valid, n_patches)))
        loss, tgt = tloss.distance_score_loss(*map(_t, (pred, c2w, ori, d, valid, n_patches)))
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
        np.testing.assert_allclose(tgt.numpy(), np.asarray(ref_tgt), atol=1e-6, rtol=1e-5)


class TestSolverParity:
    def test_recovers_the_camera_like_jax(self):
        cam_pos = np.array([0.0, 0.5, 3.0], np.float32)
        ori, d, valid = _rays(1024, 900, seed=6, target=cam_pos)
        c2w = _look_at_c2w(cam_pos)
        scores = np.asarray(jloss.target_ray_scores(
            *map(jnp.asarray, (c2w, ori, d, valid, np.asarray(100)))).target)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        ref, out = _solve_both(scores, ori, d, up, valid)
        np.testing.assert_array_equal(out.topk_idx.numpy(), np.asarray(ref.topk_idx))
        np.testing.assert_allclose(out.c2w.numpy(), np.asarray(ref.c2w), atol=1e-4)
        np.testing.assert_allclose(out.watch_dir.numpy(), np.asarray(ref.watch_dir),
                                   atol=1e-5)
        assert np.linalg.norm(out.center.numpy() - cam_pos) < 0.1

    def test_duplicate_origin_filter_matches(self):
        """Rows that repeat among the top k: the first occurrence of a
        repeated coordinate survives and the last is dropped, unless a
        coordinate also occurs in a row that appears once (rays 5 and 6)."""
        n, k = 256, 100
        ori, d, valid = _rays(n, n, seed=3)
        ori[1] = ori[7]
        ori[3] = ori[9] = ori[12]
        ori[5] = ori[6]
        ori[5, 0] = ori[6, 0] = ori[20, 0]
        scores = np.linspace(1.0, 0.01, n).astype(np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        ref, out = _solve_both(scores, ori, d, up, valid, k=k)
        kept = out.topk_weights.numpy() > 0
        np.testing.assert_array_equal(kept, np.asarray(ref.topk_weights) > 0)
        assert kept[1] and not kept[7] and kept[3] and kept[9] and not kept[12]
        assert kept[5] and kept[6]
        np.testing.assert_allclose(out.topk_weights.numpy(), np.asarray(ref.topk_weights),
                                   rtol=1e-6)
        np.testing.assert_allclose(out.center.numpy(), np.asarray(ref.center),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(out.c2w.numpy(), np.asarray(ref.c2w), atol=1e-4)

    def test_singular_solve_falls_back_to_identity(self):
        """Parallel rays make the LS system singular: NaN center -> identity."""
        n = 256
        ori = np.tile(np.array([[1.0, 0, 0]], np.float32), (n, 1))
        d = np.tile(np.array([[0.0, 0, 1]], np.float32), (n, 1))
        scores = np.linspace(1.0, 0.5, n).astype(np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        ref, out = _solve_both(scores, ori, d, up, np.ones(n, bool))
        assert np.isnan(out.center.numpy()).all() and np.isnan(np.asarray(ref.center)).all()
        np.testing.assert_allclose(np.asarray(ref.c2w), np.eye(4), atol=1e-6)
        np.testing.assert_allclose(out.c2w.numpy(), np.eye(4), atol=1e-6)

    def test_fewer_valid_rays_than_k(self):
        """Top-k reaches padded rays (score -inf): they get weight 0 and
        take no part in the solve."""
        cam_pos = np.array([1.0, 0.3, 2.5], np.float32)
        ori, d, valid = _rays(128, 60, seed=7, target=cam_pos)
        scores = np.linspace(1.0, 0.2, 128).astype(np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        ref, out = _solve_both(scores, ori, d, up, valid)
        w = out.topk_weights.numpy()
        np.testing.assert_array_equal(np.isfinite(w), np.isfinite(np.asarray(ref.topk_weights)))
        assert (w[:60] > 0).all() and not (w[60:] > 0).any()
        np.testing.assert_allclose(out.c2w.numpy(), np.asarray(ref.c2w), atol=1e-4)
        assert np.linalg.norm(out.center.numpy() - cam_pos) < 0.1


class TestErrorMetrics:
    def test_errors_and_inverse_match(self):
        rng = np.random.default_rng(5)

        def rotation():
            q, r = np.linalg.qr(rng.normal(size=(3, 3)))
            q = q * np.sign(np.diag(r))
            return (q * np.linalg.det(q)).astype(np.float32)  # det +1

        for _ in range(4):
            R, R2 = rotation(), rotation()
            np.testing.assert_allclose(tsol.inv3x3(_t(R2)).numpy(),
                                       np.asarray(jsol.inv3x3(jnp.asarray(R2))), atol=1e-5)
            np.testing.assert_allclose(tsol.angular_error_deg(_t(R), _t(R2)).item(),
                                       float(jsol.angular_error_deg(jnp.asarray(R),
                                                                    jnp.asarray(R2))),
                                       atol=1e-2)
        t0, t1 = rng.normal(size=(2, 3)).astype(np.float32)
        np.testing.assert_allclose(tsol.translation_error(_t(t0), _t(t1)).item(),
                                   float(jsol.translation_error(jnp.asarray(t0),
                                                                jnp.asarray(t1))),
                                   rtol=1e-6)
