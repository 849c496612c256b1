"""The port's NVM reader and Cambridge Landmarks loader
(sixdgs_torch.scene.nvm) against the JAX package's, on the CPU, and the
pose driver on a Cambridge experiment.

* ``read_nvm`` on tests/test_nvm_loader.py's dataset, with a ``FixedK``
  header, ``#`` comments, a second model ended by the end of the file and
  one image removed: every model, camera, point and colour equal.
* ``read_cambridge_scene_info`` and ``load_data`` on that dataset: every
  camera's R, T, FoVs, name, size and image array, the split, the cloud
  and the nerf normalisation equal (both packages run the same numpy code
  on the same bytes, so equal, which is inside the 1e-6 asked of R, T and
  the FoVs); ``points3d.ply`` written with the JAX package's bytes, and
  not written again once it exists.
* the port's reader without Pillow on PNG frames (``scene.png``): the
  images Pillow gives; a JPEG frame then raises with its file name.
* ``pose_eval --data_type cambridge_landmark`` of both packages on one
  tiny Cambridge experiment (9 ring cameras of 24x24, a 150-Gaussian PLY,
  depth-2 DINOv2 weights, 2 steps): one result per test image, the same
  keys, ids and ground-truth poses (to 1e-6), finite errors.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from sixdgs_tpu.apps import pose_eval as jpe
from sixdgs_tpu.scene import dataset_loader as jdl
from sixdgs_tpu.scene import nvm as jnvm
from sixdgs_torch.apps import pose_eval as tpe
from sixdgs_torch.scene import dataset_loader as tdl
from sixdgs_torch.scene import nvm as tnvm
from sixdgs_torch.scene.gaussians import from_arrays
from sixdgs_torch.scene.png import write_png
from sixdgs_torch.utils.config import ModelConfig, write_cfg_args
from tests.test_converters import make_dino_state_dict
from tests.test_nvm_loader import write_nvm_dataset
from tests.test_torch_scene_io import _Args, _no_pillow, _same_scene_info
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)

MISSING = "seq1/frame00003.jpg"


def _nums(v):
    """Floats as text that reads back to the same float64."""
    return " ".join(repr(float(x)) for x in v)


def _rich_nvm(root):
    """tests/test_nvm_loader.py's dataset (9 cameras, 40 points), its file
    rewritten with a FixedK header, comments, and a second model of 3
    cameras and 4 points ended by the end of the file; one image removed."""
    write_nvm_dataset(root)
    path = os.path.join(root, "reconstruction.nvm")
    with open(path) as fh:
        lines = fh.read().splitlines()
    assert lines[0] == "NVM_V3" and lines[-1] == "0"
    lines[0] = "NVM_V3 FixedK 500.0 20.0 500.0 15.0  # calibration"
    lines[3] += "  # first camera"
    lines.insert(2, "# a comment line")
    rng = np.random.default_rng(1)
    second = ["3"]
    for i in range(3):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        c = rng.normal(size=3)
        second.append(f"seq2/frame{i:05d}.jpg 400.0 {_nums(q)} "
                      f"{_nums(c)} 0.01 0")
    second.append("4")
    for p in rng.normal(size=(4, 3)):
        second.append(f"{p[0]} {p[1]} {p[2]} 10.7 20 255.0 2 0 1 3.5 4.5 1 2 5.5 6.5")
    lines = lines[:-1] + second
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    os.remove(os.path.join(root, MISSING))


def rotmat_to_qvec(R):
    """(w, x, y, z) of a rotation matrix (COLMAP's rotmat2qvec)."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = R.flat
    K = np.array([[rxx - ryy - rzz, 0, 0, 0],
                  [ryx + rxy, ryy - rxx - rzz, 0, 0],
                  [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
                  [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def write_ring_cambridge(root, n_cams=9, size=24, ext="png", seed=0, radius=3.0,
                         focal=30.0):
    """A Cambridge-layout dataset of ``n_cams`` cameras on a ring looking
    at the origin (world->camera quaternion, camera centre, one focal), 40
    points with colours, and random RGB frames -> (R_c2w list, centres)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "seq1"), exist_ok=True)
    lines, rots, centres = ["NVM_V3", "", str(n_cams)], [], []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams
        c = np.array([radius * np.cos(ang), 0.5, radius * np.sin(ang)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R_c2w = np.stack([x, np.cross(z, x), z], axis=1)
        q = rotmat_to_qvec(R_c2w.T)
        name = f"seq1/frame{i:05d}.{ext}"
        pixels = rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)
        if ext == "png":
            write_png(os.path.join(root, name), pixels)
        else:
            from PIL import Image

            Image.fromarray(pixels).save(os.path.join(root, name))
        lines.append(f"{name} {focal!r} {_nums(q)} "
                     f"{_nums(c)} 0.0 0")
        rots.append(R_c2w)
        centres.append(c)
    pts = rng.normal(size=(40, 3))
    lines.append(str(len(pts)))
    for p in pts:
        lines.append(f"{_nums(p)} {rng.integers(0, 256)} 128 64 1 0 0 1.5 2.5")
    lines.append("0")
    with open(os.path.join(root, "reconstruction.nvm"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return rots, centres


class TestReadNvm:
    def test_models_match_jax(self, tmp_path):
        root = str(tmp_path / "KingsCollege")
        _rich_nvm(root)
        path = os.path.join(root, "reconstruction.nvm")
        want, got = jnvm.read_nvm(path), tnvm.read_nvm(path)
        assert len(got) == len(want) == 2
        assert [len(m.cameras) for m in got] == [9, 3]
        for mw, mg in zip(want, got):
            for cw, cg in zip(mw.cameras, mg.cameras):
                assert (cg.file_name, cg.focal, cg.radial) == (cw.file_name, cw.focal,
                                                                cw.radial)
                np.testing.assert_array_equal(cg.qvec, cw.qvec)
                np.testing.assert_array_equal(cg.center, cw.center)
            np.testing.assert_array_equal(mg.points, mw.points)
            assert mg.colors.dtype == np.uint8
            np.testing.assert_array_equal(mg.colors, mw.colors)
        assert got[1].colors[0].tolist() == [10, 20, 255]  # int(float(tok))

    def test_refuses_other_files(self, tmp_path):
        path = tmp_path / "x.nvm"
        path.write_text("PLY 1\n")
        with pytest.raises(ValueError, match="not an NVM file"):
            tnvm.read_nvm(str(path))


class TestCambridgeLoader:
    @pytest.mark.parametrize("eval_split", [True, False])
    def test_scene_info_matches_jax(self, tmp_path, eval_split):
        root = str(tmp_path / "OldHospital")
        _rich_nvm(root)
        twin = str(tmp_path / "twin")
        shutil.copytree(root, twin)
        want = jnvm.read_cambridge_scene_info(root, eval_split)
        got = tnvm.read_cambridge_scene_info(root, eval_split)
        _same_scene_info(want, got)
        # 8 of the 9 cameras have an image; uid counts the sorted list
        n_test = 1 if eval_split else 0
        assert len(got.test_cameras) == n_test and len(got.train_cameras) == 8 - n_test
        assert [c.uid for c in got.train_cameras + got.test_cameras][:3] == (
            [1, 2, 4] if eval_split else [0, 1, 2])
        assert all(c.image_name != "frame00003" for c in got.train_cameras)
        np.testing.assert_array_equal(got.point_cloud.normals, 0.0)
        # points3d.ply: the port writes the JAX package's bytes, once
        info = tnvm.read_cambridge_scene_info(twin, eval_split)
        with open(info.ply_path, "rb") as fh_t, open(want.ply_path, "rb") as fh_j:
            assert fh_t.read() == fh_j.read()
        stamp = os.stat(info.ply_path).st_mtime_ns
        os.utime(info.ply_path, ns=(stamp - 10**9, stamp - 10**9))
        tnvm.read_cambridge_scene_info(twin, eval_split)
        assert os.stat(info.ply_path).st_mtime_ns == stamp - 10**9

    def test_centre_convention(self, tmp_path):
        """The file stores the camera centre: T = -R_w2c @ c, R = R_w2c^T."""
        root = str(tmp_path / "ring")
        rots, centres = write_ring_cambridge(root)
        info = tnvm.read_cambridge_scene_info(root, eval_split=False)
        for cam, R_c2w, c in zip(info.train_cameras, rots, centres):
            np.testing.assert_allclose(cam.R, R_c2w, atol=1e-12)
            np.testing.assert_allclose(cam.T, -R_c2w.T @ c, atol=1e-12)
            np.testing.assert_allclose(cam.c2w()[:3, 3], c, atol=1e-6)  # float32 c2w
            assert cam.FovX == cam.FovY == pytest.approx(2 * np.arctan(24 / 60.0), abs=1e-12)

    def test_dispatch(self, tmp_path):
        root = str(tmp_path / "ShopFacade")
        _rich_nvm(root)
        assert tdl.get_dataset_prefix(root) == "cl"
        want = jdl.load_data(_Args(root, white_background=False))
        _same_scene_info(want, tdl.load_data(_Args(root, white_background=False)))

    def test_png_frames_without_pillow(self, tmp_path, monkeypatch):
        root = str(tmp_path / "StMarysChurch")
        write_ring_cambridge(root)
        want = jnvm.read_cambridge_scene_info(root)
        _no_pillow(monkeypatch, want)
        got = tnvm.read_cambridge_scene_info(root)
        _same_scene_info(want, got)
        assert type(got.train_cameras[0].image).__name__ == "PngImage"
        jpg = str(tmp_path / "jpg")
        monkeypatch.undo()
        write_ring_cambridge(jpg, ext="jpg")
        _no_pillow(monkeypatch)
        with pytest.raises(ValueError, match="frame00000.jpg"):
            tnvm.read_cambridge_scene_info(jpg)


# ------------------------------------------------------------ the pose driver

BUDGETS = ["--n_iterations", "2", "--batch", "2", "--ray_budget", "512"]
SCENE = "cl_ring_0001"


def _cambridge_experiment(root):
    """A Cambridge dataset of 9 ring cameras and an experiment directory
    over it (cfg_args and a 150-Gaussian SH-3 PLY) -> the experiments'
    root."""
    data = os.path.join(root, "ring")
    write_ring_cambridge(data)
    exp = os.path.join(root, "output", SCENE)
    write_cfg_args(exp, vars(ModelConfig(source_path=data, model_path=exp, eval=True)))
    rng = np.random.default_rng(7)
    n = 150
    arrays = {
        "xyz": rng.normal(size=(n, 3)).astype(np.float32),
        "features_dc": (rng.normal(size=(n, 1, 3)) * 0.5).astype(np.float32),
        "features_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32),
        "opacity": rng.uniform(-2.0, 3.0, size=(n, 1)).astype(np.float32),
        "scaling": rng.uniform(-3.0, -2.0, size=(n, 3)).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
    }
    ply = os.path.join(exp, "point_cloud", "iteration_4", "point_cloud.ply")
    os.makedirs(os.path.dirname(ply))
    from_arrays(arrays, 3, device="cpu").save_ply(ply)
    return os.path.dirname(exp)


def _run(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        main(argv)
    with open(argv[argv.index("--out_path") + 1]) as fh:
        return json.load(fh), err.getvalue()


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cambridge"))
    exp = _cambridge_experiment(root)
    pth = os.path.join(root, "dinov2_vits14_depth2.pth")
    torch.save(make_dino_state_dict(np.random.default_rng(5), depth=2, grid=16), pth)
    out = {}
    for name, main, extra in (("jax", jpe.main, []), ("torch", tpe.main,
                                                      ["--platform", "cpu"])):
        d = os.path.join(root, name)
        shutil.copytree(exp, d)
        out[name] = _run(main, ["--exp_path", d, "--out_path",
                                os.path.join(root, f"{name}.json"), "--data_type",
                                "cambridge_landmark", "--dino_weights", pth]
                         + BUDGETS + extra)
        out[f"{name}_dir"] = d
    return out


class TestCambridgeDriver:
    def test_results_match_the_jax_driver(self, driver_runs):
        (jres, jerr), (tres, terr) = driver_runs["jax"], driver_runs["torch"]
        assert "Traceback" not in jerr and "Traceback" not in terr, terr
        assert len(tres) == len(jres) == 2  # frames 0 and 8 of 9
        for j, t in zip(jres, tres):
            assert set(t) == set(j)
            for key in ("sequence_id", "category_name", "frame_id"):
                assert t[key] == j[key], key
            assert t["category_name"] == "cl_ring" and t["sequence_id"] == "0001"
            np.testing.assert_allclose(t["gt_c2w"], j["gt_c2w"], atol=1e-6)
            assert np.isfinite(np.asarray(t["pred_c2w"])).all()
            for key in ("loss", "scores_loss", "recall"):
                assert np.isfinite(t[key]), key

    def test_files_written(self, driver_runs):
        for pkg in ("jax", "torch"):
            for name in ("id_module.npz", "pose_metrics.jsonl"):
                assert os.path.exists(os.path.join(driver_runs[f"{pkg}_dir"], SCENE, name))
