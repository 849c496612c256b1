"""The port's pose driver (sixdgs_torch.apps.pose_eval) against the JAX
package's, on the CPU.

One experiment directory per file, made by the JAX package's train_gs on a
tiny Blender-format scene (as tests/test_pose_eval_cli.py makes it), and
each driver run once on its own copy at the reference test's budgets: the
results JSON must match in length, keys, sequence and category ids, every
error must be finite, and both write id_module.npz and
pose_metrics.jsonl. A second run of the port resumes and skips training.

Both drivers load the same hub-named DINOv2 weights (depth 2) through
--dino_weights. Then one evaluation-only run of each package's
pretrain_single_object (n_iterations 0) from the same numbers: those
weights through each package's load_params, the JAX package's initial
id-module params and its draws of the evaluation rays. Both evaluations
(target scores, then predicted scores) must give the same per-image
translation and angular errors, within ERR_ATOL.
"""

import contextlib
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdgs_tpu.apps import pose_eval as jpe
from sixdgs_tpu.apps import train_gs
from sixdgs_tpu.pose import evaluate as jev
from sixdgs_tpu.pose import modules as jmod
from sixdgs_tpu.utils.config import PoseEstimationConfig as JCfg
from sixdgs_tpu.utils.config import dotdict as jdotdict
from sixdgs_tpu.utils.config import read_cfg_args as jread_cfg_args
from sixdgs_torch.apps import pose_eval as tpe
from sixdgs_torch.pose import dino as tdino
from sixdgs_torch.pose import evaluate as tev
from sixdgs_torch.utils.config import PoseEstimationConfig as TCfg
from tests.test_converters import make_dino_state_dict
from tests.test_scene_io import make_blender_dataset

BUDGETS = ["--n_iterations", "2", "--batch", "2", "--ray_budget", "512"]
SCENE = "synthetic_chair_0001"
SEED = 55176280  # pretrain_single_object's default in both packages
# Per-image errors of one evaluation from the same weights, rays and
# images: both solve the same LS problem on the same top-100 rays in
# float32, from scores that agree to ~1e-6 relative (the DINO features,
# attention and softmax summed in other orders). The camera then moves by
# the solve's float32 rounding, eps 1.2e-7 times the scene's scale (errors
# of 1-5 here) times the LS system's amplification (~100 at most): 1e-4 in
# translation and, over a rotation built from unit vectors, 1e-3 degrees
# (read: 6e-8 and 1.4e-5). A ray swapped into the top 100 moves it by far more.
ERR_ATOL = {"t": 1e-4, "a_deg": 1e-3}


def _experiment(root):
    """A tiny trained 3DGS experiment dir (tests/test_pose_eval_cli.py)."""
    data = os.path.join(root, "chair")
    os.makedirs(data)
    make_blender_dataset(data, n_train=3, n_test=2, size=24)
    from sixdgs_tpu.scene.ply_io import store_point_cloud_ply

    rng = np.random.default_rng(0)
    store_point_cloud_ply(os.path.join(data, "points3d.ply"), rng.normal(size=(150, 3)),
                          rng.integers(0, 255, size=(150, 3)))
    exp_root = os.path.join(root, "output")
    train_gs.main(["--source_path", data, "--model_path", os.path.join(exp_root, SCENE),
                   "--eval", "--white_background", "--iterations", "4",
                   "--densify_from_iter", "100", "--test_iterations", "-1",
                   "--save_iterations", "4", "--quiet", "--chunk", "64",
                   "--capacity_bucket", "256"])
    return exp_root


def _run(main, argv):
    """main(argv) with stderr captured (a scene's RuntimeError is printed
    there and swallowed) -> (results list, stderr text)."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        main(argv)
    out = argv[argv.index("--out_path") + 1]
    with open(out) as fh:
        return json.load(fh), err.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pose_eval"))
    exp = _experiment(root)
    dirs = {}
    for name in ("jax", "torch", "eval_jax", "eval_torch"):
        dirs[name] = os.path.join(root, name)
        shutil.copytree(exp, dirs[name])
    # hub-named DINOv2 weights at depth 2 for both drivers (the
    # --dino_weights .pth path of each): the same features, a quarter of
    # the full backbone's time
    pth = os.path.join(root, "dinov2_vits14_depth2.pth")
    torch.save(make_dino_state_dict(np.random.default_rng(5), depth=2, grid=16), pth)
    common = ["--data_type", "blender", "--dino_weights", pth] + BUDGETS
    jres, jerr = _run(jpe.main, ["--exp_path", dirs["jax"], "--out_path",
                                 os.path.join(root, "jax.json")] + common)
    targv = ["--exp_path", dirs["torch"], "--out_path", os.path.join(root, "torch.json"),
             "--platform", "cpu"] + common
    tres, terr = _run(tpe.main, targv)
    return {"root": root, "dirs": dirs, "pth": pth, "jax": (jres, jerr),
            "torch": (tres, terr), "targv": targv}


def _errors(results):
    """Per-image (translation error, angular error in degrees) from the
    results' predicted and ground-truth camera-to-world matrices."""
    out = []
    for r in results:
        p, g = np.asarray(r["pred_c2w"]), np.asarray(r["gt_c2w"])
        cos = (np.trace(p[:3, :3].T @ g[:3, :3]) - 1) / 2
        out.append((np.linalg.norm(p[:3, 3] - g[:3, 3]),
                    np.degrees(np.arccos(np.clip(cos, -1, 1)))))
    return np.asarray(out)


class TestPoseDriver:
    def test_results_match_the_jax_driver(self, runs):
        (jres, jerr), (tres, terr) = runs["jax"], runs["torch"]
        assert "Traceback" not in jerr and "Traceback" not in terr, terr
        assert len(tres) == len(jres) == 2  # one entry per test image
        for j, t in zip(jres, tres):
            assert set(t) == set(j)
            for key in ("sequence_id", "category_name", "frame_id"):
                assert t[key] == j[key], key
            assert t["category_name"] == "synthetic_chair" and t["sequence_id"] == "0001"
            for key in ("loss", "scores_loss", "recall"):
                assert np.isfinite(t[key]), key
            assert np.asarray(t["pred_c2w"]).shape == (4, 4)
            assert np.isfinite(np.asarray(t["pred_c2w"])).all()
        assert np.isfinite(_errors(tres)).all()

    @pytest.mark.parametrize("name", ["id_module.npz", "pose_metrics.jsonl"])
    def test_files_written(self, runs, name):
        for pkg in ("jax", "torch"):
            assert os.path.exists(os.path.join(runs["dirs"][pkg], SCENE, name)), pkg

    def test_second_run_resumes_and_skips_training(self, runs, monkeypatch):
        from sixdgs_torch.pose import trainer as ttrainer

        def no_training(*args, **kwargs):
            raise AssertionError("training ran again")  # not a RuntimeError: propagates

        monkeypatch.setattr(ttrainer.PoseTrainer, "run", no_training)
        ckpt = os.path.join(runs["dirs"]["torch"], SCENE, "id_module.npz")
        before = os.path.getmtime(ckpt)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tres, terr = _run(tpe.main, runs["targv"])
        assert "Checkpoint already exists" in out.getvalue()
        assert "Traceback" not in terr and len(tres) == 2
        assert os.path.getmtime(ckpt) == before

    def test_superpoint_is_not_ported(self, runs):
        """The SuperPoint backbone raised here until it was ported; its
        driver run is held against the JAX driver's in
        tests/test_torch_superpoint_lpips.py. What is left to pin: a
        backbone that is neither is refused before any scene is read."""
        with pytest.raises(SystemExit):
            tpe.main(runs["targv"] + ["--backbone", "nope"])


def evaluate_both(dirs, j_backbone, t_backbone, backbone="dino"):
    """Both packages' pretrain_single_object with n_iterations 0, each on
    its own copy of the experiment (``dirs["jax"]``, ``dirs["torch"]``),
    from the same backbone weights, the JAX package's initial id-module
    params (at the backbone's width and grid) and its draws of the
    evaluation rays; every test_pose_estimation call recorded ->
    {"jax": [...], "torch": [...]}."""
    from sixdgs_torch.scene.gaussians import load_ply

    feature_dim, grid = (256, 28) if backbone == "superpoint" else (384, 16)
    j_idm = jmod.init_id_module(jax.random.key(SEED), feature_dim=feature_dim, grid=grid)
    kw = dict(n_iterations=0, ray_budget=512, gradient_accumulation_steps=2)

    exp = os.path.join(dirs["torch"], SCENE)
    ckpt = jpe.get_highest_valid_checkpoint(exp)
    args = jdotdict(jread_cfg_args(exp))
    cap = load_ply(ckpt, max_sh_degree=args.sh_degree, device="cpu").capacity
    k_sel, k_sub = jax.random.split(jax.random.key(SEED + 1))
    n_ell = min(TCfg().max_ellipsoids, cap)
    draws = {"select_priority": np.asarray(jax.random.uniform(k_sel, (cap,))),
             "slot_priority": np.asarray(jax.random.uniform(k_sub, (n_ell * 50 * 32,)))}

    calls = {"jax": [], "torch": []}

    def recorder(fn, key):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            calls[key].append(out[0])
            return out
        return wrapped

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jev, "test_pose_estimation", recorder(jev.test_pose_estimation, "jax"))
        mp.setattr(tev, "test_pose_estimation", recorder(tev.test_pose_estimation, "torch"))
        for pkg in ("jax", "torch"):
            exp = os.path.join(dirs[pkg], SCENE)
            args = jdotdict(jread_cfg_args(exp))
            ckpt = jpe.get_highest_valid_checkpoint(exp)
            if pkg == "jax":
                jpe.pretrain_single_object(ckpt, args, exp, "0001", "synthetic_chair",
                                           j_backbone, JCfg(**kw), backbone=backbone)
            else:
                tpe.pretrain_single_object(
                    ckpt, args, exp, "0001", "synthetic_chair", t_backbone, TCfg(**kw),
                    backbone=backbone, device="cpu",
                    id_params=jax.tree.map(np.asarray, j_idm), ray_draws=draws)
    finally:
        mp.undo()
    return calls


def assert_same_per_image_errors(calls):
    """Two evaluations (overfit, test) of two images each, with the same
    per-image errors within ERR_ATOL and the same ground truth."""
    assert len(calls["jax"]) == len(calls["torch"]) == 2  # overfit, test
    for j, t in zip(calls["jax"], calls["torch"]):
        je, te = _errors(j), _errors(t)
        assert je.shape == te.shape == (2, 2)
        np.testing.assert_allclose(te[:, 0], je[:, 0], atol=ERR_ATOL["t"])
        np.testing.assert_allclose(te[:, 1], je[:, 1], atol=ERR_ATOL["a_deg"])
        for a, b in zip(j, t):
            np.testing.assert_allclose(b["gt_c2w"], a["gt_c2w"], atol=1e-6)


@pytest.fixture(scope="module")
def eval_only(runs):
    """The evaluation-only runs from the drivers' DINO weights."""
    from sixdgs_tpu.pose import dino as jdino

    dirs, pth = runs["dirs"], runs["pth"]
    return evaluate_both({"jax": dirs["eval_jax"], "torch": dirs["eval_torch"]},
                         jdino.load_params(pth), tdino.load_params(pth, device="cpu"))


class TestEvaluationOnly:
    def test_same_per_image_errors(self, eval_only):
        assert_same_per_image_errors(eval_only)
