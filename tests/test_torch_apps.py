"""The port's 3DGS apps (train_gs, render, metrics) against the JAX
package's, on the CPU.

One tiny Blender-format dataset per file (as tests/test_apps_cli.py makes
it), and each package's train_gs -> render -> metrics pipeline run on it
once, both with ``--rasterizer tiled`` and LPIPS from one VGG weights file
written by the port's ``save_params`` (the JAX package's npz keys). Both
trainers draw their cameras from ``np.random.default_rng(seed)``, start
from the same point cloud and take the same steps, so:

* the training loss in metrics.jsonl agrees to LOSS_RTOL relative;
* the PLY parameters agree to 2 lr per step (Adam's first updates are
  lr * sign(g), and an entry whose gradient is rounding noise can take
  either sign in two correct implementations), and on average to a tenth
  of that;
* the rendered PNGs agree to one 8-bit level (a render on a rounding
  boundary of the quantisation), on at most PNG_SHARE of the values; the
  ground-truth PNGs are equal;
* results.json agrees: SSIM and PSNR of those images to SSIM_ATOL and
  PSNR_ATOL, LPIPS to LPIPS_RTOL relative.

Then the port alone: ``--rasterizer auto``, ``--detect_anomaly`` armed (and
reset here), ``--gui`` serving a viewer, and the PNG written and read
without Pillow equal to Pillow's.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from sixdgs_tpu.apps import metrics as jmetrics
from sixdgs_tpu.apps import render as jrender
from sixdgs_tpu.apps import train_gs as jtrain_gs
from sixdgs_tpu.scene.ply_io import store_point_cloud_ply
from sixdgs_torch.apps import metrics as tmetrics
from sixdgs_torch.apps import render as trender
from sixdgs_torch.apps import train_gs as ttrain_gs
from sixdgs_torch.pose import lpips as tlpips
from sixdgs_torch.scene.gaussians import load_ply
from sixdgs_torch.utils.config import OptimizationConfig
from tests.test_scene_io import make_blender_dataset

ITERS = 8
LOSS_RTOL = 1e-4
PNG_SHARE = 0.02
SSIM_ATOL = 1e-3
PSNR_ATOL = 0.05
LPIPS_RTOL = 1e-3


def _train_argv(root, model_path, rasterizer="tiled", iterations=ITERS):
    return ["--source_path", root, "--model_path", model_path, "--eval",
            "--white_background", "--iterations", str(iterations),
            "--densify_from_iter", "100", "--test_iterations", str(iterations),
            "--save_iterations", str(iterations), "--quiet", "--chunk", "64",
            "--log_every", "1", "--capacity_bucket", "256", "--rasterizer", rasterizer]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both pipelines on one dataset: {"jax": model dir, "torch": model
    dir, "root": dataset dir}."""
    tmp = tmp_path_factory.mktemp("apps")
    root = str(tmp / "lego")
    os.makedirs(root)
    make_blender_dataset(root, n_train=3, n_test=2, size=24)
    rng = np.random.default_rng(0)
    store_point_cloud_ply(os.path.join(root, "points3d.ply"), rng.normal(size=(200, 3)),
                          rng.integers(0, 255, size=(200, 3)))
    weights = str(tmp / "lpips_vgg.npz")
    tlpips.save_params(weights, tlpips.init_params(torch.Generator().manual_seed(5), "vgg",
                                                   device="cpu"))
    out = {"root": root}
    for name, train, render, metrics, extra in (
            ("jax", jtrain_gs, jrender, jmetrics, []),
            ("torch", ttrain_gs, trender, tmetrics, ["--platform", "cpu"])):
        model = str(tmp / f"out_{name}")
        assert train.main(_train_argv(root, model) + extra) == model
        render.main(["--model_path", model, "--iteration", str(ITERS), "--chunk", "64",
                     "--quiet"] + extra)
        metrics.main(["--model_paths", model, "--lpips_weights", weights] + extra)
        out[name] = model
    return out


def _losses(model):
    with open(os.path.join(model, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return {r["step"]: r["value"] for r in recs
            if r.get("tag") == "train_loss_patches/total_loss"}


class TestPipelineAgainstJax:
    def test_outputs_and_loss(self, runs):
        for name in ("jax", "torch"):
            for f in ("cfg_args", "cameras.json", "input.ply", "metrics.jsonl",
                      f"point_cloud/iteration_{ITERS}/point_cloud.ply"):
                assert os.path.exists(os.path.join(runs[name], f)), (name, f)
        with open(os.path.join(runs["jax"], "cameras.json")) as fh:
            jcams = json.load(fh)
        with open(os.path.join(runs["torch"], "cameras.json")) as fh:
            tcams = json.load(fh)
        assert [c["img_name"] for c in tcams] == [c["img_name"] for c in jcams]
        np.testing.assert_allclose([c["position"] for c in tcams],
                                   [c["position"] for c in jcams], rtol=1e-6, atol=1e-6)
        jl, tl = _losses(runs["jax"]), _losses(runs["torch"])
        assert sorted(tl) == sorted(jl) == list(range(1, ITERS + 1))
        np.testing.assert_allclose([tl[i] for i in sorted(tl)], [jl[i] for i in sorted(jl)],
                                   rtol=LOSS_RTOL)
        assert np.isfinite(list(tl.values())).all()

    def test_ply_parameters(self, runs):
        ply = f"point_cloud/iteration_{ITERS}/point_cloud.ply"
        j = load_ply(os.path.join(runs["jax"], ply), device="cpu")
        t = load_ply(os.path.join(runs["torch"], ply), device="cpu")
        assert int(j.num_active()) == int(t.num_active()) == 200
        opt = OptimizationConfig()
        with open(os.path.join(runs["torch"], "cameras.json")) as fh:
            centers = np.array([c["position"] for c in json.load(fh)])
        # nerfpp_norm: 1.1 x the largest camera distance from their mean
        radius = 1.1 * np.linalg.norm(centers - centers.mean(0), axis=1).max()
        lrs = {"xyz": opt.position_lr_init * radius, "features_dc": opt.feature_lr,
               "features_rest": opt.feature_lr / 20.0, "opacity": opt.opacity_lr,
               "scaling": opt.scaling_lr, "rotation": opt.rotation_lr}
        for k, lr in lrs.items():
            a = getattr(t, k)[:200].numpy()
            b = getattr(j, k)[:200].numpy()
            diff = np.abs(a - b)
            assert diff.max() <= 2 * lr * ITERS, (k, diff.max(), lr)
            assert diff.mean() <= 0.2 * lr * ITERS, (k, diff.mean(), lr)

    def test_pngs_and_results(self, runs):
        for split, n in (("train", 3), ("test", 2)):
            for sub in ("renders", "gt"):
                d = os.path.join(split, f"ours_{ITERS}", sub)
                names = sorted(os.listdir(os.path.join(runs["torch"], d)))
                assert names == sorted(os.listdir(os.path.join(runs["jax"], d)))
                assert len(names) == n
                for nm in names:
                    a = tmetrics.read_image(os.path.join(runs["torch"], d, nm))
                    b = tmetrics.read_image(os.path.join(runs["jax"], d, nm))
                    assert a.shape == b.shape == (3, 24, 24)
                    levels = np.abs(a - b) * 255
                    if sub == "gt":
                        np.testing.assert_array_equal(a, b)
                    else:
                        assert levels.max() <= 1.0 + 1e-4, (d, nm, levels.max())
                        assert (levels > 0.5).mean() <= PNG_SHARE, (d, nm)
        results = {}
        for name in ("jax", "torch"):
            with open(os.path.join(runs[name], "results.json")) as fh:
                results[name] = json.load(fh)
        assert sorted(results["torch"]) == sorted(results["jax"]) == [
            f"test/ours_{ITERS}", f"train/ours_{ITERS}"]
        for key, jr in results["jax"].items():
            tr = results["torch"][key]
            for v in tr.values():
                assert v is not None and np.isfinite(v), (key, tr)
            assert abs(tr["SSIM"] - jr["SSIM"]) <= SSIM_ATOL, (key, tr, jr)
            assert abs(tr["PSNR"] - jr["PSNR"]) <= PSNR_ATOL, (key, tr, jr)
            np.testing.assert_allclose(tr["LPIPS"], jr["LPIPS"], rtol=LPIPS_RTOL)

    def test_metrics_of_the_same_images(self, runs):
        """The port's metrics app on the JAX package's renders gives the
        JAX app's numbers: the same PNGs, SSIM, PSNR and LPIPS (from the
        shared npz) computed in float32 in each package."""
        with open(os.path.join(runs["jax"], "per_view.json")) as fh:
            want = json.load(fh)[f"test/ours_{ITERS}"]
        weights = os.path.join(os.path.dirname(runs["jax"]), "lpips_vgg.npz")
        got, per_view = tmetrics.evaluate_dir(
            os.path.join(runs["jax"], "test", f"ours_{ITERS}"),
            tlpips.make_lpips(weights, device="cpu"), device="cpu")
        assert sorted(per_view) == sorted(want)
        for nm, w in want.items():
            np.testing.assert_allclose(per_view[nm]["SSIM"], w["SSIM"], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(per_view[nm]["PSNR"], w["PSNR"], rtol=1e-5)
            np.testing.assert_allclose(per_view[nm]["LPIPS"], w["LPIPS"], rtol=1e-5)
        assert got["LPIPS"] is not None


class TestPortAlone:
    def test_auto_and_detect_anomaly(self, runs, tmp_path):
        """--rasterizer auto (the plain versions of the kernel path on the
        CPU) with --detect_anomaly: a healthy run completes, anomaly
        detection is armed by it, and LPIPS is null without weights."""
        model = str(tmp_path / "auto")
        try:
            ttrain_gs.main(_train_argv(runs["root"], model, "auto", 2)
                           + ["--platform", "cpu", "--detect_anomaly"])
            assert torch.is_anomaly_enabled()
        finally:
            torch.autograd.set_detect_anomaly(False)
        assert os.path.exists(os.path.join(model, "point_cloud", "iteration_2",
                                           "point_cloud.ply"))
        trender.main(["--model_path", model, "--skip_train", "--platform", "cpu",
                      "--quiet"])
        tmetrics.main(["--model_paths", model, "--platform", "cpu"])
        with open(os.path.join(model, "results.json")) as fh:
            res = json.load(fh)["test/ours_2"]
        assert res["LPIPS"] is None and np.isfinite(res["PSNR"])

    def test_gui_raises(self, runs, tmp_path, monkeypatch):
        """--gui binds the viewer's port and serves a frame a step (the name
        is that of the refusal this test pinned before the server was
        ported; tests/test_torch_network_gui.py holds the frames against
        the renders)."""
        from sixdgs_torch.scene.cameras import camera_list_from_infos
        from sixdgs_torch.scene.dataset_loader import load_data
        from sixdgs_torch.utils.config import dotdict
        from tests.test_torch_network_gui import serve_train_gs, viewer_message

        info = load_data(dotdict(source_path=runs["root"], images=None, eval=True,
                                 white_background=True))
        cam = camera_list_from_infos(info.test_cameras)[0]
        messages = [viewer_message(cam), viewer_message(cam, keep_alive=False)]
        model = str(tmp_path / "gui")
        frames, renders = serve_train_gs(
            monkeypatch, _train_argv(runs["root"], model, iterations=2)
            + ["--platform", "cpu"], messages)
        assert len(frames) == len(renders) == 2
        for img_bytes, verify in frames:
            assert len(img_bytes) == 24 * 24 * 3 and verify == os.path.abspath(runs["root"])
        assert os.path.exists(os.path.join(model, "point_cloud", "iteration_2",
                                           "point_cloud.ply"))

    def test_png_without_pillow(self, monkeypatch, tmp_path):
        """save_png and read_image through scene.png give Pillow's values."""
        img = np.random.default_rng(2).uniform(-0.1, 1.1, size=(3, 7, 9)).astype(np.float32)
        trender.save_png(str(tmp_path / "pil.png"), img)
        want = tmetrics.read_image(str(tmp_path / "pil.png"))
        monkeypatch.setitem(sys.modules, "PIL", None)
        monkeypatch.setitem(sys.modules, "PIL.Image", None)
        trender.save_png(str(tmp_path / "png.png"), img)
        np.testing.assert_array_equal(tmetrics.read_image(str(tmp_path / "png.png")), want)
        np.testing.assert_array_equal(tmetrics.read_image(str(tmp_path / "pil.png")), want)
        assert want.dtype == np.float32 and want.shape == (3, 7, 9)
