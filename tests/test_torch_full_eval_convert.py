"""The port's orchestrator CLIs (full_eval, convert) and profiling helpers
against the JAX package's, on the CPU.

* ``full_eval`` of each package on one T&T root holding one scene
  (``truck``, a tiny Blender-format dataset with 150 points) at 8
  iterations, with one VGG LPIPS npz: the same files; the training loss
  logged at the last iteration to tests/test_torch_apps.py's LOSS_RTOL;
  results.json to its SSIM_ATOL, PSNR_ATOL and LPIPS_RTOL. The JAX run's
  "auto" rasterizer is "tiled" off the TPU, the port's is its kernel path
  through the plain versions on the CPU: two implementations of one
  compositor, whose images agree to ~2e-7.
* ``convert`` of each package against one stub ``colmap`` (and a stub
  ``magick`` for ``--resize``) that logs its argv and makes each stage's
  outputs: identical command logs and printed lines, the same ``sparse/0``
  layout and downscaled sets; and the same exit and message without the
  binary.
* ``utils.profiling``: ``StepTimer`` against the JAX package's under one
  fake clock (the same step times and EMA), ``time_fn``'s keys and call
  count, and ``trace`` writing a profiler trace on the CPU.
"""

import contextlib
import io
import json
import os
import shutil
import stat

import numpy as np
import pytest
import torch

from sixdgs_tpu.apps import convert as jconvert
from sixdgs_tpu.apps import full_eval as jfull_eval
from sixdgs_tpu.scene.ply_io import store_point_cloud_ply
from sixdgs_tpu.utils import profiling as jprofiling
from sixdgs_torch.apps import convert as tconvert
from sixdgs_torch.apps import full_eval as tfull_eval
from sixdgs_torch.pose import lpips as tlpips
from sixdgs_torch.utils import profiling as tprofiling
from tests.test_scene_io import make_blender_dataset
from tests.test_torch_apps import LOSS_RTOL, LPIPS_RTOL, PSNR_ATOL, SSIM_ATOL
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)

ITERS = 8


@pytest.fixture(scope="module")
def full_evals(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("full_eval")
    scene_root = str(tmp / "tat" / "truck")
    os.makedirs(scene_root)
    make_blender_dataset(scene_root, n_train=3, n_test=2, size=24)
    rng = np.random.default_rng(0)
    store_point_cloud_ply(os.path.join(scene_root, "points3d.ply"),
                          rng.normal(size=(150, 3)), rng.integers(0, 255, size=(150, 3)))
    weights = str(tmp / "lpips_vgg.npz")
    tlpips.save_params(weights, tlpips.init_params(torch.Generator().manual_seed(5), "vgg",
                                                   device="cpu"))
    out = {}
    for name, main, extra in (("jax", jfull_eval.main, []),
                              ("torch", tfull_eval.main, ["--platform", "cpu"])):
        out[name] = str(tmp / f"eval_{name}")
        main(["--tanksandtemples", str(tmp / "tat"), "--output_path", out[name],
              "--iterations", str(ITERS), "--lpips_weights", weights] + extra)
    return out


def _files(root):
    """Every file under ``root``, relative; TensorBoard event files (named
    by time and host) as one name."""
    return sorted(os.path.relpath(os.path.join(d, "events.out.tfevents" if f.startswith(
        "events.out.tfevents") else f), root) for d, _, fs in os.walk(root) for f in fs)


class TestFullEval:
    def test_same_files(self, full_evals):
        want, got = _files(full_evals["jax"]), _files(full_evals["torch"])
        assert got == want
        for f in ("truck/cfg_args", "truck/results.json", "truck/per_view.json",
                  f"truck/point_cloud/iteration_{ITERS}/point_cloud.ply"):
            assert f in got, f
        renders = [f for f in got if f.startswith(f"truck/test/ours_{ITERS}/renders/")]
        assert len(renders) == 2 and not any("/train/" in f for f in got)  # --skip_train

    def test_loss_and_results(self, full_evals):
        losses, results = {}, {}
        for name, root in full_evals.items():
            with open(os.path.join(root, "truck", "metrics.jsonl")) as fh:
                recs = [json.loads(line) for line in fh]
            losses[name] = {r["step"]: r["value"] for r in recs
                            if r.get("tag") == "train_loss_patches/total_loss"}
            with open(os.path.join(root, "truck", "results.json")) as fh:
                results[name] = json.load(fh)
        assert list(losses["torch"]) == list(losses["jax"]) == [ITERS]
        np.testing.assert_allclose(losses["torch"][ITERS], losses["jax"][ITERS],
                                   rtol=LOSS_RTOL)
        assert list(results["torch"]) == list(results["jax"]) == [f"test/ours_{ITERS}"]
        t, j = results["torch"][f"test/ours_{ITERS}"], results["jax"][f"test/ours_{ITERS}"]
        assert all(v is not None and np.isfinite(v) for v in t.values()), t
        assert abs(t["SSIM"] - j["SSIM"]) <= SSIM_ATOL, (t, j)
        assert abs(t["PSNR"] - j["PSNR"]) <= PSNR_ATOL, (t, j)
        np.testing.assert_allclose(t["LPIPS"], j["LPIPS"], rtol=LPIPS_RTOL)

    def test_no_scene_found(self, tmp_path):
        err = io.StringIO()
        with contextlib.redirect_stdout(err):
            tfull_eval.main(["--tanksandtemples", str(tmp_path), "--platform", "cpu"])
        assert "No scene directories found" in err.getvalue()


# ------------------------------------------------------------------ convert


def _stubs(tmp_path, src):
    """A stub colmap that logs its argv and fabricates each stage's
    outputs (tests/test_full_eval_convert.py's), and a stub magick that
    logs its argv -> (colmap path, magick path, log path)."""
    log = tmp_path / "calls.log"
    colmap = tmp_path / "colmap"
    colmap.write_text(f"""#!/bin/bash
echo "colmap $@" >> {log}
case "$1" in
  mapper)
    mkdir -p {src}/distorted/sparse/0
    touch {src}/distorted/sparse/0/cameras.bin {src}/distorted/sparse/0/images.bin
    ;;
  image_undistorter)
    mkdir -p {src}/sparse {src}/images
    touch {src}/sparse/cameras.bin {src}/sparse/images.bin {src}/sparse/points3D.bin
    echo a > {src}/images/0.jpg
    echo b > {src}/images/1.jpg
    ;;
esac
exit 0
""")
    magick = tmp_path / "magick"
    magick.write_text(f"""#!/bin/bash
echo "magick $@" >> {log}
exit 0
""")
    for f in (colmap, magick):
        f.chmod(f.stat().st_mode | stat.S_IEXEC)
    return str(colmap), str(magick), log


def _reset(src):
    for d in os.listdir(src):
        if d != "input":
            shutil.rmtree(os.path.join(src, d))


class TestConvert:
    @pytest.mark.parametrize("flags", [["--no_gpu"], ["--skip_matching"],
                                       ["--resize", "--camera", "PINHOLE"]],
                             ids=["no_gpu", "skip_matching", "resize"])
    def test_same_commands_as_jax(self, tmp_path, flags):
        src = tmp_path / "scene"
        (src / "input").mkdir(parents=True)
        (src / "input" / "0.jpg").write_bytes(b"fake")
        colmap, magick, log = _stubs(tmp_path, src)
        runs = {}
        for name, main in (("jax", jconvert.main), ("torch", tconvert.main)):
            _reset(src)
            if log.exists():
                log.unlink()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                main(["--source_path", str(src), "--colmap_executable", colmap,
                      "--magick_executable", magick] + flags)
            runs[name] = (log.read_text().splitlines(), out.getvalue(), _files(str(src)))
        assert runs["torch"] == runs["jax"]
        calls, printed, files = runs["torch"]
        stages = [c.split()[1] for c in calls if c.startswith("colmap")]
        assert stages == (["image_undistorter"] if "--skip_matching" in flags else
                          ["feature_extractor", "exhaustive_matcher", "mapper",
                           "image_undistorter"])
        assert "sparse/0/cameras.bin" in files and "sparse/cameras.bin" not in files
        if "--resize" in flags:
            assert "--ImageReader.camera_model PINHOLE" in calls[0]
            assert sum(c.startswith("magick mogrify -resize") for c in calls) == 6
            assert {f"images_{k}/1.jpg" for k in (2, 4, 8)} <= set(files)
        assert printed.endswith("Done.\n")

    def test_missing_binary(self, tmp_path):
        src = tmp_path / "scene"
        (src / "input").mkdir(parents=True)
        outs = []
        for main in (jconvert.main, tconvert.main):
            out = io.StringIO()
            with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exc:
                main(["--source_path", str(src), "--colmap_executable",
                      str(tmp_path / "definitely_missing")])
            outs.append((exc.value.code, out.getvalue()))
        assert outs[1] == outs[0] and outs[1][0] == 1
        assert "not found on PATH" in outs[1][1]


# ---------------------------------------------------------------- profiling


class TestProfiling:
    def test_step_timer_matches_jax(self, monkeypatch):
        ticks = [0.0, 0.010, 0.020, 0.050, 0.060, 0.061]  # start/stop pairs, seconds
        got = {}
        for name, mod in (("jax", jprofiling), ("torch", tprofiling)):
            clock = iter(ticks)
            monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
            timer = mod.StepTimer(ema=0.9)
            dts = []
            for _ in range(3):
                timer.start()
                dts.append(timer.stop())
            got[name] = (dts, timer.value_ms)
            monkeypatch.undo()
        assert got["torch"] == got["jax"]
        np.testing.assert_allclose(got["torch"][0], [10.0, 30.0, 1.0])
        np.testing.assert_allclose(got["torch"][1], 0.9 * (0.9 * 10 + 0.1 * 30) + 0.1 * 1)

    def test_step_timer_takes_tensors(self):
        timer = tprofiling.StepTimer()
        timer.start()
        dt = timer.stop(torch.ones(3), {"a": [torch.zeros(2)]})
        assert dt >= 0 and timer.value_ms == dt

    def test_time_fn(self):
        calls = []

        def fn(x, scale=1.0):
            calls.append(x)
            return {"y": torch.full((4,), x * scale)}

        got = tprofiling.time_fn(fn, 2.0, iters=5, warmup=3, scale=0.5)
        want = jprofiling.time_fn(lambda: 0, iters=1)
        assert set(got) == set(want) == {"compile_s", "steady_ms"}
        assert len(calls) == 1 + 2 + 5 and all(v >= 0 for v in got.values())

    def test_trace_writes_a_file(self, tmp_path):
        a = torch.randn(32, 32)
        with tprofiling.trace(str(tmp_path)):
            (a @ a).sum()
        files = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path) for f in fs]
        assert files and any(f.endswith(".json") for f in files), files
        with open(next(f for f in files if f.endswith(".json"))) as fh:
            assert "aten::mm" in fh.read()
