"""The port's scene I/O (cfg_args, COLMAP readers, the Blender, COLMAP and
T&T loaders, the PNG fallback, the gsio reader) against the JAX
package's, on the CPU, on the same files.

The datasets are made as tests/test_scene_io.py makes them. The JAX
loader runs first on each: where the dataset has no point cloud it writes
a random one, which the port then reads. Every compared field is exact:
the two packages run the same numpy code on the same bytes.
"""

import os
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sixdgs_tpu.ops import sh as jsh
from sixdgs_tpu.pose import dino as jdino
from sixdgs_tpu.scene import colmap_io as jcol
from sixdgs_tpu.scene import dataset_loader as jdl
from sixdgs_tpu.utils import config as jconfig
from sixdgs_torch import weights
from sixdgs_torch.pose import dino as tdino
from sixdgs_torch.scene import colmap_io as tcol
from sixdgs_torch.scene import dataset_loader as tdl
from sixdgs_torch.scene import loaders as tloaders
from sixdgs_torch.scene import png
from sixdgs_torch.utils import config as tconfig
from sixdgs_torch.utils import native as tnative
from tests.test_converters import make_dino_state_dict
from tests.test_scene_io import make_blender_dataset


class _Args:
    images = None
    eval = True

    def __init__(self, path, white_background):
        self.source_path = path
        self.white_background = white_background


# ------------------------------------------------------------------ datasets


def _colmap_dataset(root, text: bool):
    """9 PINHOLE images of 64x48 and 50 points, in binary or text form
    (tests/test_scene_io.py's COLMAP round trip)."""
    sparse = os.path.join(root, "sparse/0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    rng = np.random.default_rng(4)
    cams = {1: jcol.ColmapCamera(1, "PINHOLE", 64, 48, np.array([60.0, 60.0, 32.0, 24.0]))}
    images = {}
    for i in range(1, 10):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        images[i] = jcol.ColmapImage(i, q, rng.normal(size=3), 1, f"img_{i:03d}.png",
                                     rng.normal(size=(3, 2)) * 10,
                                     np.array([i, -1, 2 * i], np.int64))
        Image.fromarray(rng.integers(0, 255, size=(48, 64, 3), dtype=np.uint8)).save(
            os.path.join(root, "images", f"img_{i:03d}.png"))
    xyz = rng.normal(size=(50, 3))
    rgb = rng.integers(0, 255, size=(50, 3)).astype(np.uint8)
    err = rng.uniform(size=50)
    if not text:
        jcol.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
        jcol.write_images_binary(images, os.path.join(sparse, "images.bin"))
        jcol.write_points3d_binary(xyz, rgb, err, os.path.join(sparse, "points3D.bin"))
        return
    with open(os.path.join(sparse, "cameras.txt"), "w") as fh:
        fh.write("# Camera list\n")
        for c in cams.values():
            fh.write(f"{c.id} {c.model} {c.width} {c.height} "
                     + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(sparse, "images.txt"), "w") as fh:
        fh.write("# Image list\n")
        for im in images.values():
            fh.write(" ".join(str(v) for v in [im.id, *map(repr, im.qvec.tolist()),
                                               *map(repr, im.tvec.tolist()),
                                               im.camera_id, im.name]) + "\n")
            fh.write(" ".join(f"{x!r} {y!r} {p}" for (x, y), p in
                              zip(im.xys.tolist(), im.point3D_ids.tolist())) + "\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as fh:
        fh.write("# 3D point list\n")
        for i in range(50):
            fh.write(" ".join([str(i), *map(repr, xyz[i].tolist()), *map(str, rgb[i]),
                               repr(float(err[i])), "1", "0"]) + "\n")


def _tt_dataset(root):
    """Tanks&Temples (NSVF) layout with a bbox (tests/test_scene_io.py)."""
    os.makedirs(os.path.join(root, "pose"))
    os.makedirs(os.path.join(root, "rgb"))
    rng = np.random.default_rng(5)
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 100.0
    np.savetxt(os.path.join(root, "intrinsics.txt"), K)
    np.savetxt(os.path.join(root, "bbox.txt"),
               np.array([-1, -1, -1, 1, 1, 1, 0.1]).reshape(1, -1))
    for split_prefix, n in [("0", 4), ("1", 2)]:
        for i in range(n):
            c2w = np.eye(4)
            c2w[:3, 3] = rng.normal(size=3)
            np.savetxt(os.path.join(root, "pose", f"{split_prefix}_{i:04d}.txt"), c2w)
            Image.fromarray(rng.integers(0, 255, size=(40, 60, 3), dtype=np.uint8)).save(
                os.path.join(root, "rgb", f"{split_prefix}_{i:04d}.png"))


def _make(kind, root):
    os.makedirs(root, exist_ok=True)
    if kind == "blender":
        make_blender_dataset(root, n_train=3, n_test=2, size=24)
    elif kind == "tt":
        _tt_dataset(root)
    else:
        _colmap_dataset(root, text=(kind == "colmap_text"))


def _same_scene_info(want, got):
    for split in ("train_cameras", "test_cameras"):
        w, g = getattr(want, split), getattr(got, split)
        assert len(g) == len(w), split
        for cw, cg in zip(w, g):
            for f in ("uid", "FovX", "FovY", "image_path", "image_name", "width",
                      "height"):
                assert getattr(cg, f) == getattr(cw, f), f
            np.testing.assert_array_equal(cg.R, cw.R)
            np.testing.assert_array_equal(cg.T, cw.T)
            np.testing.assert_array_equal(np.array(cg.image), np.array(cw.image))
    np.testing.assert_array_equal(got.nerf_normalization["translate"],
                                  want.nerf_normalization["translate"])
    assert got.nerf_normalization["radius"] == want.nerf_normalization["radius"]
    assert got.ply_path == want.ply_path
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got.point_cloud, f),
                                      getattr(want.point_cloud, f))


def _no_pillow(monkeypatch, *infos):
    """Make ``from PIL import Image`` raise ImportError, after decoding the
    (lazily read) Pillow images of ``infos`` into arrays."""
    for info in infos:
        for cam in info.train_cameras + info.test_cameras:
            cam.image = np.array(cam.image)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


# --------------------------------------------------------------------- tests


class TestCfgArgs:
    CFG = {"sh_degree": 3, "source_path": "/data/lego", "model_path": "out/x_1",
           "images": "images", "resolution": -1, "white_background": False,
           "data_device": "cuda", "eval": True, "fps_sampling": -1,
           "lrs": [0.1, 2e-05], "note": "it's \"quoted\"", "none": None}

    @pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
    def test_written_by_one_read_by_the_other(self, tmp_path, writer, reader):
        pkgs = {"jax": jconfig, "torch": tconfig}
        pkgs[writer].write_cfg_args(str(tmp_path), self.CFG)
        got = pkgs[reader].read_cfg_args(str(tmp_path))
        assert got == pkgs[writer].read_cfg_args(str(tmp_path)) == self.CFG

    def test_cli_wiring_matches(self):
        import argparse

        for cls in ("ModelConfig", "PipelineConfig", "OptimizationConfig",
                    "PoseEstimationConfig"):
            pj, pt = argparse.ArgumentParser(), argparse.ArgumentParser()
            jconfig.add_dataclass_args(pj, getattr(jconfig, cls)())
            tconfig.add_dataclass_args(pt, getattr(tconfig, cls)())
            aj, at = vars(pj.parse_args([])), vars(pt.parse_args([]))
            if cls == "ModelConfig":  # the device default is the platform's
                assert (aj.pop("data_device"), at.pop("data_device")) == ("tpu", "cuda")
            assert at == aj, cls
            ext = tconfig.extract_dataclass_args(pt.parse_args([]), getattr(tconfig, cls))
            assert ext == getattr(tconfig, cls)()


class TestColmapReaders:
    @pytest.mark.parametrize("text", [False, True])
    def test_readers_match(self, tmp_path, text):
        _colmap_dataset(str(tmp_path), text)
        sparse = str(tmp_path / "sparse/0")
        ext = "txt" if text else "bin"
        for name in ("cameras", "images"):
            fn = f"read_{name}_{'text' if text else 'binary'}"
            want = getattr(jcol, fn)(os.path.join(sparse, f"{name}.{ext}"))
            got = getattr(tcol, fn)(os.path.join(sparse, f"{name}.{ext}"))
            assert list(got) == list(want)
            for k in want:
                for f, v in vars(want[k]).items():
                    np.testing.assert_array_equal(getattr(got[k], f), v, err_msg=f)
        fn = f"read_points3d_{'text' if text else 'binary'}"
        want = getattr(jcol, fn)(os.path.join(sparse, f"points3D.{ext}"))
        got = getattr(tcol, fn)(os.path.join(sparse, f"points3D.{ext}"))
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)

    def test_gsio_and_numpy_paths_agree(self, tmp_path, monkeypatch):
        _colmap_dataset(str(tmp_path), text=False)
        path = str(tmp_path / "sparse/0/points3D.bin")
        if tnative.get_gsio() is None:
            pytest.skip("no C++ compiler: the gsio reader does not build")
        native = tcol.read_points3d_binary(path)
        monkeypatch.setattr(tnative, "get_gsio", lambda: None)
        plain = tcol.read_points3d_binary(path)
        for a, b in zip(native, plain):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert native[0].shape == (50, 3)


class TestLoaders:
    @pytest.mark.parametrize("kind", ["blender", "colmap_binary", "colmap_text", "tt"])
    def test_loaders_match(self, tmp_path, monkeypatch, kind):
        root = str(tmp_path / kind)
        _make(kind, root)
        want = jdl.load_data(_Args(root, white_background=True))
        assert tdl.get_dataset_prefix(root) == jdl.get_dataset_prefix(root)
        got = tdl.load_data(_Args(root, white_background=True))
        _same_scene_info(want, got)
        # the same without Pillow: the PNG fallback decodes every image
        _no_pillow(monkeypatch, want)
        bare = tdl.load_data(_Args(root, white_background=True))
        assert isinstance(bare.train_cameras[0].image, png.PngImage)
        _same_scene_info(want, bare)

    def test_black_background(self, tmp_path, monkeypatch):
        root = str(tmp_path / "lego")
        _make("blender", root)
        want = jdl.load_data(_Args(root, white_background=False))
        _same_scene_info(want, tdl.load_data(_Args(root, white_background=False)))
        _no_pillow(monkeypatch, want)
        _same_scene_info(want, tdl.load_data(_Args(root, white_background=False)))

    def test_random_cloud_when_none_is_given(self, tmp_path):
        root = str(tmp_path / "lego")
        _make("blender", root)
        info = tdl.load_data(_Args(root, white_background=True))
        pts = info.point_cloud.points
        assert pts.shape == (100_000, 3) and (np.abs(pts) <= 1.3 + 1e-6).all()
        shs = np.random.default_rng(0).random((1000, 3)) / 255.0
        np.testing.assert_allclose(tloaders._sh_to_rgb(shs), np.asarray(jsh.sh_to_rgb(shs)),
                                   rtol=0, atol=6e-8)

    def test_cambridge_is_not_ported(self, tmp_path):
        """A Cambridge Landmarks directory (reconstruction.nvm) loads as the
        JAX package loads it; the name is that of the refusal this test
        pinned before the NVM reader was ported (the reader's own tests are
        in tests/test_torch_nvm.py)."""
        from tests.test_nvm_loader import write_nvm_dataset

        root = str(tmp_path / "GreatCourt")
        os.makedirs(root)
        write_nvm_dataset(root)
        assert tdl.get_dataset_prefix(root) == "cl"
        want = jdl.load_data(_Args(root, white_background=False))
        got = tdl.load_data(_Args(root, white_background=False))
        _same_scene_info(want, got)
        assert len(got.train_cameras) == 7 and len(got.test_cameras) == 2

    def test_load_camera_without_pillow(self, tmp_path, monkeypatch):
        from sixdgs_tpu.scene import cameras as jscam
        from sixdgs_torch.scene import cameras as tscam

        root = str(tmp_path / "lego")
        _make("blender", root)
        want = jscam.load_camera(jdl.load_data(_Args(root, True)).train_cameras[0], 0)
        _no_pillow(monkeypatch)  # load_camera has decoded its image
        got = tscam.load_camera(tdl.load_data(_Args(root, True)).train_cameras[0], 0)
        np.testing.assert_array_equal(got.image, np.asarray(want.image))
        np.testing.assert_allclose(got.full_proj, np.asarray(want.full_proj), rtol=1e-6)


def _encode(arr: np.ndarray, filters) -> bytes:
    """An 8-bit PNG of ``arr`` whose row y is filtered with type
    filters[y % len(filters)] (PNG specification, section 9)."""
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    h = arr.shape[0]
    rows = arr.reshape(h, -1).astype(np.int64)
    raw = b""
    for y in range(h):
        f = filters[y % len(filters)]
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        a = np.concatenate([np.zeros(ch, np.int64), x[:-ch]])
        c = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        if f == 0:
            pred = np.zeros_like(x)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (a + up) // 2
        else:
            p = a + up - c
            pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
        raw += bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ctype = {1: 0, 3: 2, 4: 6}[ch]
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", arr.shape[1], h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


class TestPng:
    @pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
    def test_both_ways_with_pillow(self, tmp_path, mode):
        rng = np.random.default_rng(11)
        shape = (37, 29) if mode == "L" else (37, 29, len(mode))
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        arr[20:] = np.cumsum(arr[20:], axis=1, dtype=np.uint8)  # smooth rows: other filters
        path = str(tmp_path / "a.png")
        for kw in ({}, {"optimize": True}, {"compress_level": 9}):
            Image.fromarray(arr, mode).save(path, **kw)
            got = png.read_png(path)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, arr)
        png.write_png(path, arr)
        with Image.open(path) as im:
            assert im.mode == mode
            np.testing.assert_array_equal(np.array(im), arr)

    @pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
    def test_all_five_filters(self, tmp_path, mode):
        rng = np.random.default_rng(12)
        shape = (15, 11) if mode == "L" else (15, 11, len(mode))
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / "f.png")
        with open(path, "wb") as fh:
            fh.write(_encode(arr, [0, 1, 2, 3, 4]))
        with Image.open(path) as im:  # the encoder is right
            np.testing.assert_array_equal(np.array(im), arr)
        np.testing.assert_array_equal(png.read_png(path), arr)

    def test_image_methods(self, tmp_path):
        rng = np.random.default_rng(13)
        arr = rng.integers(0, 256, (6, 9, 4), dtype=np.uint8)
        path = str(tmp_path / "m.png")
        png.write_png(path, arr)
        ours, theirs = png.PngImage.open(path), Image.open(path)
        assert ours.size == theirs.size == (9, 6) and ours.mode == "RGBA"
        for mode in ("RGB", "RGBA"):
            np.testing.assert_array_equal(np.array(ours.convert(mode)),
                                          np.array(theirs.convert(mode)))
        gray = png.PngImage(arr[..., 0], "L")
        for mode in ("RGB", "RGBA"):
            np.testing.assert_array_equal(np.array(gray.convert(mode)),
                                          np.array(Image.fromarray(arr[..., 0], "L")
                                                   .convert(mode)))
        assert ours.resize((9, 6)) is ours
        with pytest.raises(NotImplementedError, match="Pillow"):
            ours.resize((4, 3))

    def test_refuses_what_it_cannot_read(self, tmp_path):
        path = str(tmp_path / "p.png")
        Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(path)
        with pytest.raises(ValueError, match="colour type 3"):
            png.read_png(path)
        Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(str(tmp_path / "j.jpg"))
        with pytest.raises(ValueError, match="Pillow"):
            png.read_png(str(tmp_path / "j.jpg"))


class TestDinoLoaders:
    """A hub-named state dict (depth 2) through both packages' load_params
    gives the same features on one image, and an .npz written by either
    package's flatten_params reads in the other's."""

    # both run the same f32 ViT from the same weights; the matmuls, softmax
    # and layer norms sum in other orders (XLA vs ATen): ~1e-6 relative per
    # op over 2 blocks, held at 1e-4 of the features' largest magnitude
    REL = 1e-4

    @pytest.fixture(scope="class")
    def setup(self, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("dino")
        pth = str(tmp / "dinov2_vits14.pth")
        torch.save(make_dino_state_dict(np.random.default_rng(5), depth=2, grid=16), pth)
        img = np.random.default_rng(6).normal(size=(3, 224, 224)).astype(np.float32)
        return str(tmp), pth, img

    @staticmethod
    def _check(jparams, tmodel, img, rel):
        want = np.asarray(jdino.forward_features(jparams, jnp.asarray(img))["x_norm_patchtokens"])
        with torch.no_grad():
            got = tmodel.forward_features(torch.tensor(img))["x_norm_patchtokens"].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())

    def test_pth(self, setup):
        tmp, pth, img = setup
        self._check(jdino.load_params(pth), tdino.load_params(pth, device="cpu"), img,
                    self.REL)

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_npz_both_ways(self, setup, writer):
        tmp, pth, img = setup
        jparams, tmodel = jdino.load_params(pth), tdino.load_params(pth, device="cpu")
        npz = os.path.join(tmp, f"{writer}.npz")
        if writer == "jax":
            np.savez(npz, **jdino.flatten_params(jparams))
        else:
            np.savez(npz, **tdino.flatten_params(tmodel))
        with np.load(npz) as data:  # the same arrays from either writer
            flat = dict(data)
        for k, v in jdino.flatten_params(jparams).items():
            np.testing.assert_array_equal(flat[k], np.asarray(v), err_msg=k)
        self._check(jdino.load_params(npz), tdino.load_params(npz, device="cpu"), img,
                    self.REL)

    def test_random_without_a_path(self):
        a = tdino.load_params(None, generator=torch.Generator().manual_seed(3), device="cpu")
        b = tdino.load_params(None, generator=torch.Generator().manual_seed(3), device="cpu")
        assert len(a.blocks) == 12 and a.pos_embed.shape == (257, 384)
        for pa, pb in zip(a.parameters(), b.parameters()):
            assert torch.equal(pa, pb)

    def test_hub_names_load_into_dinovit(self, setup):
        tmp, pth, img = setup
        sd = tdino.convert_torch_state_dict(torch.load(pth))
        model = tdino.DinoViT(384, depth=2, num_patches=256)
        model.load_state_dict(sd)  # strict: every key named and shaped as DinoViT's
        ref = weights.dino_from_numpy(jax.tree.map(np.asarray, jdino.load_params(pth)),
                                      device="cpu")
        for (name, p), q in zip(model.state_dict().items(), ref.state_dict().values()):
            np.testing.assert_array_equal(p.numpy(), q.numpy(), err_msg=name)
