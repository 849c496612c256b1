"""The port's workflow tools (sixdgs_torch/tools/) against the JAX package's
tools/ on the CPU, at small sizes.

* quality workflow: ``write_dataset`` and ``gt_scene`` against the JAX
  tool's (imported by path, as tests/test_apps_cli.py imports it): the
  transforms JSON and the placeholder PNGs equal, the GT arrays and padded
  scene equal; the GT views each package renders with ``render_eval(...,
  "tiled")`` within IMG_ATOL, the tile rasterizer parity tolerance of
  tests/test_torch_tiled.py. Then the port's ``main`` and the JAX tool's at
  the JAX test's micro scale, with telemetry logged every 2 steps and tiers
  tight enough that the truncation ratios are not 0: the JAX tool's keys, a
  finite PSNR, SSIM in [0, 1], the transforms JSON and init-cloud PLY equal
  to the JAX recipe's bytes, PSNR and SSIM within tests/test_torch_apps.py's
  PSNR_ATOL and SSIM_ATOL of the JAX tool's, and the adaptation counts,
  truncation ratios and final Gaussian count equal.
* pose accuracy: ``make_gt_scene`` equal to tests/test_pose_e2e.py's, the
  ring images within one 8-bit level (both render in f32, through the
  tiled rasterizer in JAX and the kernels' plain versions in the port, and
  ``astype(uint8)`` truncates, so a value within rounding of a level can
  land on either side); with the JAX weights carried over and the JAX
  tool's evaluation-ray draws passed as priorities, the target-score solve
  against JAX ``test_pose_estimation`` to the tolerances of
  tests/test_torch_pose_e2e.py (mean errors atol 0.05 rtol 1e-3, poses
  1e-3). Then 100 port iterations through the tool's ``main`` meet every
  assertion of tests/test_pose_e2e.py::test_pose_recovery_from_predicted_scores.
* pose stage: ``main`` at a micro scale for both backbones writes the
  artifact with the JAX keys and one result per test image, and nothing
  outside ``--workdir``. Then both packages' tools on one scene: the JAX
  tool builds it and evaluates with DINO at 0 pose iterations; the port's
  runs with ``--keep`` on a copy, its driver given the JAX run's backbone
  weights, initial id-module params and evaluation-ray draws (as
  tests/test_torch_pose_eval.py's ``evaluate_both``). The artifacts' parsed
  averages (target-score and predicted-score errors) and per-image errors
  agree within that file's ERR_ATOL, the recall to float rounding, and the
  result counts and frame ids are equal.
* the tools import torch, numpy and the port only.
"""

import ast
import glob
import json
import os
import shutil
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from sixdgs_tpu.apps import pose_eval as jpe  # noqa: E402
from sixdgs_tpu.pose import dino as jdino  # noqa: E402
from sixdgs_tpu.pose import evaluate as jev  # noqa: E402
from sixdgs_tpu.pose.modules import init_id_module as j_init_id_module  # noqa: E402
from sixdgs_tpu.pose.trainer import model_up_from_cameras  # noqa: E402
from sixdgs_tpu.rays.engine import generate_rays_from_scene as j_gen  # noqa: E402
from sixdgs_tpu.scene import cameras as jcams  # noqa: E402
from sixdgs_tpu.scene.dataset_loader import load_data as j_load_data  # noqa: E402
from sixdgs_tpu.scene.ply_io import store_point_cloud_ply as j_store_ply  # noqa: E402
from sixdgs_tpu.train.gs_trainer import render_eval as j_render_eval  # noqa: E402
from sixdgs_tpu.utils.config import PoseEstimationConfig as JCfg  # noqa: E402
from sixdgs_torch import weights  # noqa: E402
from sixdgs_torch.apps import pose_eval as tpe  # noqa: E402
from sixdgs_torch.pose import evaluate as tev  # noqa: E402
from sixdgs_torch.rays.engine import generate_rays_from_scene as t_gen  # noqa: E402
from sixdgs_torch.scene import cameras as tcams  # noqa: E402
from sixdgs_torch.scene.dataset_loader import load_data as t_load_data  # noqa: E402
from sixdgs_torch.scene.gaussians import load_ply as t_load_ply  # noqa: E402
from sixdgs_torch.scene.png import read_png  # noqa: E402
from sixdgs_torch.scene.structures import CameraInfo as TCam  # noqa: E402
from sixdgs_torch.tools import pose_accuracy_experiment as tpa  # noqa: E402
from sixdgs_torch.tools import pose_stage_artifact as tps  # noqa: E402
from sixdgs_torch.tools import quality_workflow as tqw  # noqa: E402
from sixdgs_torch.train.gs_trainer import render_eval as t_render_eval  # noqa: E402
from sixdgs_torch.utils.config import PoseEstimationConfig as TCfg  # noqa: E402
from tests import test_pose_e2e as jpose  # noqa: E402
from tests.test_torch_apps import PSNR_ATOL, SSIM_ATOL  # noqa: E402
from tests.test_torch_pose_eval import ERR_ATOL, SEED, _errors  # noqa: E402
from tools import pose_stage_artifact as jps  # noqa: E402
from tools import quality_workflow as jqw  # noqa: E402
from torch_threads import shared_cores  # noqa: E402, F401 (an autouse fixture)

IMG_ATOL = 2e-6
N_TRAIN, N_TEST, SIZE, N_GT = 3, 2, 32, 60
QUALITY_KEYS = {"metric", "value", "unit", "ssim", "iterations", "rasterizer",
                "train_wall_s", "init_points", "tier_widenings", "budget_widenings",
                "budget_shrinks", "trunc_ratio_max", "trunc_ratio_final", "final_gaussians"}
ACCURACY_KEYS = {"metric", "value", "unit", "angular_error_deg", "recall_at_100",
                 "untrained", "target_score_solve_t_err", "iterations", "trajectory"}
STAGE_KEYS = {"wall_s", "n_results", "overfit_t_err", "overfit_a_err", "test_t_err",
              "test_a_err", "test_recall", "time_per_image_s", "results"}


def _files(root):
    return sorted(os.path.relpath(p, root)
                  for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
                  if os.path.isfile(p))


def _jax_init_cloud(gt_arrs, path):
    """The JAX tool's init cloud (tools/quality_workflow.py, n_init 0)
    written by the JAX package."""
    rng = np.random.default_rng(11)
    pts = gt_arrs["xyz"] + rng.normal(scale=0.05, size=gt_arrs["xyz"].shape)
    j_store_ply(path, pts, rng.uniform(80, 180, size=pts.shape))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    base = tmp_path_factory.mktemp("datasets")
    roots = {"jax": str(base / "jax"), "torch": str(base / "torch")}
    jqw.write_dataset(roots["jax"], N_TRAIN, N_TEST, SIZE, 3.2)
    tqw.write_dataset(roots["torch"], N_TRAIN, N_TEST, SIZE, 3.2)
    return roots


class TestQualityWorkflow:
    def test_write_dataset_matches_jax(self, datasets):
        j, t = datasets["jax"], datasets["torch"]
        assert _files(j) == _files(t)
        for split in ("train", "test"):
            name = f"transforms_{split}.json"
            with open(os.path.join(j, name)) as fj, open(os.path.join(t, name)) as ft:
                assert json.load(fj) == json.load(ft)
        for rel in _files(j):
            if rel.endswith(".png"):
                np.testing.assert_array_equal(read_png(os.path.join(t, rel)),
                                              read_png(os.path.join(j, rel)))

    def test_gt_scene_matches_jax(self):
        j_scene, j_arrs = jqw.gt_scene(N_GT, logscale_shift=-0.6)
        t_scene, t_arrs = tqw.gt_scene(N_GT, logscale_shift=-0.6, device="cpu")
        assert t_arrs.keys() == j_arrs.keys()
        for name in j_arrs:
            np.testing.assert_array_equal(t_arrs[name], j_arrs[name])
        assert t_scene.capacity == j_scene.capacity == 64
        for name, value in j_scene.params().items():
            np.testing.assert_array_equal(t_scene.params()[name].numpy(), np.asarray(value),
                                          err_msg=name)
        np.testing.assert_array_equal(t_scene.active.numpy(), np.asarray(j_scene.active))

    def test_gt_renders_match_jax(self, datasets):
        """Each package renders the GT views of its own dataset through its
        tile rasterizer, as the tool does before writing them."""
        j_scene, _ = jqw.gt_scene(N_GT)
        t_scene, _ = tqw.gt_scene(N_GT, device="cpu")
        j_info = j_load_data(tqw.LoaderArgs(datasets["jax"]))
        t_info = t_load_data(tqw.LoaderArgs(datasets["torch"]))
        j_list = j_info.train_cameras + j_info.test_cameras
        t_list = t_info.train_cameras + t_info.test_cameras
        assert len(j_list) == len(t_list) == N_TRAIN + N_TEST
        covered = 0.0
        for jc, tc in zip(j_list, t_list):
            want = np.asarray(j_render_eval(j_scene, jcams.camera_list_from_infos([jc])[0],
                                            jnp.zeros(3), 3, 64, "tiled"))
            got = t_render_eval(t_scene, tcams.camera_list_from_infos([tc])[0],
                                torch.zeros(3), 3, 64, "tiled").numpy()
            np.testing.assert_allclose(got, want, atol=IMG_ATOL, rtol=0)
            covered += float((want > 1e-3).mean())
        assert covered > 0.05  # the views see the scene

    def test_main_at_micro_scale(self, tmp_path):
        workdir = str(tmp_path / "qw")
        argv = ["--iterations", "8", "--size", str(SIZE), "--n_train", str(N_TRAIN),
                "--n_test", str(N_TEST), "--n_gt", str(N_GT), "--rasterizer", "tiled",
                "--chunk", "64", "--extra_train_args", "--log_every 2 --binning_tiers 1 4 2 4 4"]
        out = tqw.main(["--workdir", workdir, "--platform", "cpu"] + argv)
        ref = jqw.main(["--workdir", str(tmp_path / "jax")] + argv)
        assert set(out) == set(ref) == QUALITY_KEYS
        assert out["metric"] == "quality_workflow_psnr"
        assert np.isfinite(out["value"]) and out["value"] > 0
        assert 0 <= out["ssim"] <= 1
        assert out["init_points"] == out["final_gaussians"] == N_GT
        assert abs(out["value"] - ref["value"]) <= PSNR_ATOL, (out, ref)
        assert abs(out["ssim"] - ref["ssim"]) <= SSIM_ATOL, (out, ref)
        same = ("metric", "unit", "iterations", "rasterizer", "init_points", "tier_widenings",
                "budget_widenings", "budget_shrinks", "trunc_ratio_max", "trunc_ratio_final",
                "final_gaussians")
        assert {k: out[k] for k in same} == {k: ref[k] for k in same}
        assert out["trunc_ratio_max"] > 0  # the tight tiers truncate
        # the dataset and the init cloud are the JAX recipe's, byte for byte
        ref = str(tmp_path / "ref")
        jqw.write_dataset(ref, N_TRAIN, N_TEST, SIZE, 3.2)
        _jax_init_cloud(jqw.gt_scene(N_GT)[1], os.path.join(ref, "points3d.ply"))
        scene = os.path.join(workdir, "scene")
        for name in ("transforms_train.json", "transforms_test.json", "points3d.ply"):
            with open(os.path.join(ref, name), "rb") as fr, \
                    open(os.path.join(scene, name), "rb") as fs:
                assert fs.read() == fr.read(), name


@pytest.fixture(scope="module")
def pose_setup():
    j_scene = jpose.make_gt_scene()
    t_scene = tpa.make_gt_scene(device="cpu")
    return j_scene, t_scene, jpose.make_camera_infos(j_scene), tpa.make_camera_infos(t_scene)


class TestPoseAccuracy:
    def test_scene_and_cameras_match_jax(self, pose_setup):
        j_scene, t_scene, j_infos, t_infos = pose_setup
        for name, value in j_scene.params().items():
            np.testing.assert_array_equal(t_scene.params()[name].numpy(), np.asarray(value),
                                          err_msg=name)
        assert len(t_infos) == len(j_infos) == 8
        for ji, ti in zip(j_infos, t_infos):
            np.testing.assert_array_equal(ti.R, ji.R)
            np.testing.assert_array_equal(ti.T, ji.T)
            assert ti.image.shape == ji.image.shape == (tpa.SIZE, tpa.SIZE, 3)
            diff = np.abs(ti.image.astype(int) - np.asarray(ji.image).astype(int))
            assert diff.max() <= 1, diff.max()

    def test_target_score_solve_matches_jax(self, pose_setup):
        """The tool's evaluation rays (the JAX trainer's first renewal from
        seed 1) and the JAX tool's weights in both packages, on the JAX
        ring images: the target-score solve of every camera."""
        j_scene, t_scene, j_infos, _ = pose_setup
        kw = dict(gradient_accumulation_steps=8, ray_budget=8192, max_ellipsoids=300)
        _, sub = jax.random.split(jax.random.key(1))
        j_rays = j_gen(j_scene, sub, JCfg(**kw))
        k_sel, k_sub = jax.random.split(sub)
        t_rays = t_gen(t_scene, None, TCfg(**kw),
                       select_priority=torch.tensor(np.asarray(
                           jax.random.uniform(k_sel, (t_scene.capacity,)))),
                       slot_priority=torch.tensor(np.asarray(
                           jax.random.uniform(k_sub, (300 * 50 * 32,)))))
        np.testing.assert_array_equal(t_rays.valid.numpy(), np.asarray(j_rays.valid))
        j_dino = jdino.init_params(jax.random.key(1), embed_dim=64, depth=2)
        j_idm = j_init_id_module(jax.random.key(2), feature_dim=64)
        t_dino = weights.dino_from_numpy(jax.tree.map(np.asarray, j_dino), device="cpu")
        t_idm = weights.id_module_from_numpy(jax.tree.map(np.asarray, j_idm), device="cpu")
        model_up = model_up_from_cameras(j_infos)
        ref = jev.test_pose_estimation(j_infos, j_dino, j_idm, j_rays, jnp.asarray(model_up),
                                       use_target_scores=True)
        t_infos = [TCam(**vars(ci)) for ci in j_infos]
        out = tev.test_pose_estimation(t_infos, t_dino, t_idm, t_rays,
                                       torch.tensor(model_up), use_target_scores=True)
        assert len(out[0]) == len(ref[0]) == 8
        # mean translation and angular error, loss, recall
        np.testing.assert_allclose(out[1:5], ref[1:5], atol=0.05, rtol=1e-3)
        for r_out, r_ref in zip(out[0], ref[0]):
            np.testing.assert_allclose(r_out["pred_c2w"], r_ref["pred_c2w"], atol=1e-3)

    def test_pose_recovery_from_predicted_scores(self):
        """tests/test_pose_e2e.py::test_pose_recovery_from_predicted_scores's
        assertions, on the port tool's 100-iteration run."""
        out = tpa.main(["--iterations", "100", "--platform", "cpu"])
        assert set(out) == ACCURACY_KEYS
        t_untrained, a_untrained = out["untrained"]["t_err"], out["untrained"]["a_err"]
        r_untrained = out["untrained"]["recall"]
        t_trained, a_trained = out["value"], out["angular_error_deg"]
        r_trained, t_target = out["recall_at_100"], out["target_score_solve_t_err"]
        assert out["trajectory"][-1]["iter"] == 100
        assert t_trained < 0.6 * t_untrained, (t_trained, t_untrained)
        assert a_trained < 0.6 * a_untrained, (a_trained, a_untrained)
        assert r_trained > 0.15 > r_untrained, (r_trained, r_untrained)
        assert t_trained < 6.0 * t_target, (t_trained, t_target)
        assert t_trained < 0.95, t_trained
        assert a_trained < 45.0, a_trained
        assert r_trained > 0.30, r_trained


def test_pose_stage_at_micro_scale(tmp_path, monkeypatch):
    """Both backbones; the run's working and temporary directories stay
    empty, so everything it writes is under --workdir."""
    cwd, tmp = tmp_path / "cwd", tmp_path / "tmp"
    cwd.mkdir()
    tmp.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    workdir = str(tmp_path / "ps")
    n_test = 2
    art = tps.main(["--workdir", workdir, "--gs_iterations", "8", "--size", "32",
                    "--n_gt", "200", "--n_train", "3", "--n_test", str(n_test),
                    "--n_iterations", "2", "--ray_budget", "1024", "--batch", "2",
                    "--platform", "cpu", "--fused_attention"])
    assert list(os.listdir(cwd)) == [] and list(os.listdir(tmp)) == []
    assert sorted(os.listdir(tmp_path)) == ["cwd", "ps", "tmp"]
    with open(os.path.join(workdir, "pose_stage.json")) as fh:
        assert json.load(fh) == json.loads(json.dumps(art))
    assert set(art) == {"config", "stages", "dino", "superpoint"}
    assert set(art["stages"]) == {"gt_render_s", "gs_train_s"}
    for backbone in ("dino", "superpoint"):
        rec = art[backbone]
        assert set(rec) == STAGE_KEYS
        assert rec["n_results"] == len(rec["results"]) == n_test
        for key in STAGE_KEYS - {"results", "n_results"}:
            assert np.isfinite(rec[key]), (backbone, key)
        assert [r["frame_id"] for r in rec["results"]] == list(range(n_test))


def test_pose_stage_matches_jax(tmp_path, monkeypatch):
    """One scene, both tools, DINO at 0 pose iterations (evaluation only):
    the port's driver starts from the JAX run's numbers, so the artifacts
    agree to the solve's float rounding."""
    micro = ["--gs_iterations", "8", "--size", "32", "--n_gt", "200", "--n_train", "3",
             "--n_test", "2", "--n_iterations", "0", "--ray_budget", "1024", "--batch", "2",
             "--backbones", "dino"]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    j_backbone = {}
    j_pretrain, t_pretrain = jpe.pretrain_single_object, tpe.pretrain_single_object

    def kept_backbone(*args, **kw):
        j_backbone["params"] = jax.tree.map(np.asarray, args[5])
        return j_pretrain(*args, **kw)

    def from_jax_numbers(ckpt, args, exp, oid, cat, dino_model, cfg, **kw):
        cap = t_load_ply(ckpt, max_sh_degree=args.sh_degree, device="cpu").capacity
        k_sel, k_sub = jax.random.split(jax.random.key(SEED + 1))
        n_ell = min(cfg.max_ellipsoids, cap)
        kw["ray_draws"] = {
            "select_priority": np.asarray(jax.random.uniform(k_sel, (cap,))),
            "slot_priority": np.asarray(jax.random.uniform(k_sub, (n_ell * 50 * 32,)))}
        kw["id_params"] = jax.tree.map(np.asarray, j_init_id_module(jax.random.key(SEED)))
        dino_model = weights.dino_from_numpy(j_backbone["params"], device="cpu")
        return t_pretrain(ckpt, args, exp, oid, cat, dino_model, cfg, **kw)

    monkeypatch.setattr(jpe, "pretrain_single_object", kept_backbone)
    jps.main(["--workdir", str(jdir), "--out", str(tmp_path / "jax.json")] + micro)
    with open(tmp_path / "jax.json") as fh:
        ref = json.load(fh)["dino"]
    shutil.copytree(jdir, tdir)
    monkeypatch.setattr(tpe, "pretrain_single_object", from_jax_numbers)
    art = tps.main(["--workdir", str(tdir), "--keep", "--platform", "cpu"] + micro)
    got = art["dino"]
    assert set(got) == set(ref) == STAGE_KEYS
    assert got["n_results"] == ref["n_results"] == len(got["results"]) == 2
    assert [r["frame_id"] for r in got["results"]] == [r["frame_id"] for r in ref["results"]]
    for key, tol in (("overfit_t_err", "t"), ("overfit_a_err", "a_deg"), ("test_t_err", "t"),
                     ("test_a_err", "a_deg")):
        assert abs(got[key] - ref[key]) <= ERR_ATOL[tol], (key, got[key], ref[key])
    assert abs(got["test_recall"] - ref["test_recall"]) <= 1e-6
    je, te = _errors(ref["results"]), _errors(got["results"])
    np.testing.assert_allclose(te[:, 0], je[:, 0], atol=ERR_ATOL["t"])
    np.testing.assert_allclose(te[:, 1], je[:, 1], atol=ERR_ATOL["a_deg"])
    assert np.isfinite(got["time_per_image_s"])


TOOL_FILES = sorted(glob.glob(os.path.join(ROOT, "sixdgs_torch", "tools", "*.py")))
FORBIDDEN = ("jax", "flax", "optax", "sixdgs_tpu", "PIL", "tools", "tests")


@pytest.mark.parametrize("path", TOOL_FILES, ids=os.path.basename)
def test_tools_import_only_the_port(path):
    tree = ast.parse(open(path).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "relative import"
            names.append(node.module)
    for name in names:
        assert name.split(".")[0] not in FORBIDDEN, name
    assert len(TOOL_FILES) == 4
