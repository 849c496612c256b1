"""sixdgs_torch.scene against sixdgs_tpu.scene: PLY files cross-read and
byte-identical both ways, from_arrays padding, and the accessors."""

import numpy as np
import pytest

from sixdgs_tpu.scene import gaussians as jg
from sixdgs_tpu.scene import ply_io as jply
from sixdgs_tpu.scene import structures as jstruct
from sixdgs_torch.scene import gaussians as tg
from sixdgs_torch.scene import ply_io as tply
from sixdgs_torch.scene.structures import CameraInfo
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)


def _arrays(n=300, deg=3, seed=0):
    rng = np.random.default_rng(seed)
    r = (deg + 1) ** 2 - 1
    return {
        "xyz": rng.normal(size=(n, 3)).astype(np.float32),
        "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "features_rest": rng.normal(size=(n, r, 3)).astype(np.float32),
        "opacity": rng.normal(size=(n, 1)).astype(np.float32),
        "scaling": rng.uniform(-4, -1, size=(n, 3)).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
    }


class TestPly:
    @pytest.mark.parametrize("deg", [1, 3])
    def test_files_byte_identical_both_ways(self, tmp_path, deg):
        arrs = _arrays(deg=deg)
        p_jax, p_torch = tmp_path / "jax.ply", tmp_path / "torch.ply"
        jg.from_arrays(arrs, max_sh_degree=deg, capacity=512).save_ply(str(p_jax))
        tg.from_arrays(arrs, max_sh_degree=deg, capacity=512, device="cpu").save_ply(
            str(p_torch))
        assert p_jax.read_bytes() == p_torch.read_bytes()

        # JAX-written file read by the port, and the reverse
        port = tg.load_ply(str(p_jax), max_sh_degree=deg, capacity=512, device="cpu")
        ref = jg.load_ply(str(p_torch), max_sh_degree=deg, capacity=512)
        for name in tg.PARAM_NAMES:
            np.testing.assert_array_equal(getattr(port, name).numpy(),
                                          np.asarray(getattr(ref, name)))
            np.testing.assert_array_equal(getattr(port, name).numpy()[:300], arrs[name])
        np.testing.assert_array_equal(port.active.numpy(), np.asarray(ref.active))

    def test_degree_zero_checkpoint_load_fails_in_both(self, tmp_path):
        """Reference quirk, kept: a degree-0 checkpoint has no f_rest
        columns, and stacking none of them raises in both readers."""
        p = tmp_path / "d0.ply"
        tply.save_gaussian_ply(str(p), **_arrays(n=10, deg=0))
        with pytest.raises(ValueError, match="at least one array"):
            jply.load_gaussian_ply(str(p), 0)
        with pytest.raises(ValueError, match="at least one array"):
            tply.load_gaussian_ply(str(p), 0)

    def test_codec_module_is_a_copy(self, tmp_path):
        arrs = _arrays(n=20)
        a, b = tmp_path / "a.ply", tmp_path / "b.ply"
        jply.save_gaussian_ply(str(a), **arrs)
        tply.save_gaussian_ply(str(b), **arrs)
        assert a.read_bytes() == b.read_bytes()
        rgb = np.random.default_rng(1).integers(0, 255, size=(20, 3))
        jply.store_point_cloud_ply(str(a), arrs["xyz"], rgb)
        tply.store_point_cloud_ply(str(b), arrs["xyz"], rgb)
        assert a.read_bytes() == b.read_bytes()
        np.testing.assert_array_equal(tply.fetch_point_cloud_ply(str(a)).colors,
                                      jply.fetch_point_cloud_ply(str(b)).colors)


class TestScene:
    def test_from_arrays_padding_matches(self):
        arrs = _arrays(n=100)
        ref = jg.from_arrays(arrs, max_sh_degree=3)
        port = tg.from_arrays(arrs, max_sh_degree=3, device="cpu")
        assert port.capacity == ref.capacity == tg.round_capacity(100) == 16384
        for name in (*tg.PARAM_NAMES, "active"):
            np.testing.assert_array_equal(getattr(port, name).numpy(),
                                          np.asarray(getattr(ref, name)))
        # padded quaternions normalizable, padded opacities at -15
        assert (port.rotation[100:, 0] == 1).all() and (port.opacity[100:] == -15).all()
        assert int(port.num_active()) == 100
        with pytest.raises(ValueError):
            tg.from_arrays(arrs, max_sh_degree=3, capacity=50, device="cpu")

    def test_accessors_match(self):
        arrs = _arrays(n=200)
        ref = jg.from_arrays(arrs, max_sh_degree=3, capacity=256)
        port = tg.from_arrays(arrs, max_sh_degree=3, capacity=256, device="cpu")
        pairs = [
            (port.get_scaling, ref.get_scaling),
            (port.get_rotation, ref.get_rotation),
            (port.get_opacity, ref.get_opacity),
            (port.get_features, ref.get_features),
            (port.get_rotation_mat(), ref.get_rotation_mat()),
        ]
        for out, want in pairs:
            np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
        moved = port.with_params({"xyz": port.xyz + 1.0})
        np.testing.assert_array_equal(moved.xyz.numpy(), port.xyz.numpy() + 1.0)
        assert moved.max_sh_degree == 3 and port.params().keys() == set(tg.PARAM_NAMES)

    def test_camera_info_c2w(self):
        rng = np.random.default_rng(2)
        R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        T = rng.normal(size=3)
        kw = dict(uid=0, R=R, T=T, FovY=0.8, FovX=0.8, image=np.zeros((4, 4, 3)),
                  image_path="", image_name="c", width=4, height=4)
        c2w = CameraInfo(**kw).c2w()
        np.testing.assert_array_equal(c2w, jstruct.CameraInfo(**kw).c2w())
        np.testing.assert_allclose(c2w[:3, :3], R, atol=1e-6)
        np.testing.assert_allclose(c2w[:3, 3], -R @ T, atol=1e-5)
