"""sixdgs_torch's SuperPoint backbone, LPIPS and the attention kernels'
chunk-and-pad wrapper against sixdgs_tpu, on the CPU.

* SuperPoint: the forward from the JAX package's params (carried over by
  ``weights.superpoint_from_numpy``), ``backbone_features("superpoint")``
  (28 x 28 patches of 256-dim descriptors), the converter from a
  superpoint_v1.pth-named state dict (grayscale conv1a widened to 3
  channels), and the flat npz both ways.
* LPIPS: VGG16 and AlexNet distances from the JAX package's params, the
  converter from torchvision- and richzhang-named state dicts in both
  namings, and ``save_params`` / ``load_params`` npz both ways.
* The pose driver with ``--backbone superpoint`` against the JAX driver on
  one JAX-trained experiment dir, at the reference test's budgets, both
  from the same --superpoint_weights npz; then one evaluation-only run of
  each package's pretrain_single_object (n_iterations 0) from those
  weights, the JAX package's initial 256-wide id module on the 28 x 28
  grid and its draws of the evaluation rays: the same per-image errors
  within the DINO comparison's ERR_ATOL (tests/test_torch_pose_eval.py).
* The attention kernels' wrapper at SuperPoint's shape (P = 784, d = 256):
  the kernels are compiled for P = 256 and d = 384, so the wrapper pads the
  width and splits the patches into launches; here it runs over the plain
  versions and is held against one unchunked plain call.

Tolerances are stated where they are used: float32 convolutions summed in
other orders agree to ~1e-6 relative, and the descriptors are unit
vectors.
"""

import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdgs_tpu.apps import pose_eval as jpe
from sixdgs_tpu.pose import backbone as jbb
from sixdgs_tpu.pose import lpips as jlp
from sixdgs_tpu.pose import superpoint as jsp
from sixdgs_torch.apps import pose_eval as tpe
from sixdgs_torch.ops import attention_kernel as tak
from sixdgs_torch.pose import backbone as tbb
from sixdgs_torch.pose import lpips as tlp
from sixdgs_torch.pose import superpoint as tsp
from sixdgs_torch.weights import superpoint_from_numpy
from tests.test_converters import make_superpoint_state_dict, make_vgg16_state_dict
from tests.test_torch_pose_eval import (BUDGETS, SCENE, _errors, _experiment, _run,
                                        assert_same_per_image_errors, evaluate_both)
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)

# descriptors are unit vectors through 10 float32 convolutions
DESC_ATOL = 1e-5
# an LPIPS distance is a sum of ~1e-3-sized means of normalised features
LPIPS_RTOL = 1e-5


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def sp_pair():
    jp = jsp.init_params(jax.random.key(3))
    return jp, superpoint_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


class TestSuperPoint:
    def test_forward_matches(self, sp_pair):
        jp, tm = sp_pair
        img = np.random.default_rng(1).normal(size=(3, 64, 48)).astype(np.float32)
        want = jsp.forward_features(jp, jnp.asarray(img))["x_norm_patchtokens"]
        with torch.no_grad():
            got = tm.forward_features(_t(img))["x_norm_patchtokens"]
        assert got.shape == (8 * 6, tsp.FEATURE_DIM)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=DESC_ATOL, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(_np(got), axis=1), 1.0, atol=1e-5)

    def test_backbone_features(self, sp_pair):
        jp, tm = sp_pair
        rng = np.random.default_rng(8)
        img = rng.uniform(size=(120, 80, 3)).astype(np.float32)
        mask = rng.uniform(size=(120, 80)) > 0.4
        ref = jbb.backbone_features(jp, jnp.asarray(img), jnp.asarray(mask),
                                    backbone="superpoint")
        with torch.no_grad():
            out = tbb.backbone_features(tm, _t(img), _t(mask), backbone="superpoint")
        assert out[0].shape == (784, 256 + tbb.PE_DIM) and out[2].shape == (256, 28, 28)
        # the resize and crop agree to ~1e-6 (tests/test_torch_pose_modules.py)
        np.testing.assert_allclose(_np(out[0]), np.asarray(ref[0]), atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(_np(out[1]), np.asarray(ref[1]))
        np.testing.assert_allclose(_np(out[2]), np.asarray(ref[2]), atol=1e-4, rtol=1e-4)

    def test_converter_and_npz(self, tmp_path):
        """A superpoint_v1.pth-named state dict (grayscale conv1a, the
        detector head beside) converts to the JAX package's descriptors;
        the flat npz goes both ways."""
        rng = np.random.default_rng(21)
        sd = make_superpoint_state_dict(rng)
        tsd = tsp.convert_torch_state_dict(sd)
        assert tsd["conv1a.weight"].shape == (64, 3, 3, 3) and "convPa.weight" not in tsd
        tm = tsp.SuperPoint()
        tm.load_state_dict(tsd)
        jp = jsp.convert_torch_state_dict(sd)
        img = rng.normal(size=(3, 32, 40)).astype(np.float32) * 0.5
        want = np.asarray(jsp.forward_features(jp, jnp.asarray(img))["x_norm_patchtokens"])
        with torch.no_grad():
            got = _np(tm.forward_features(_t(img))["x_norm_patchtokens"])
        np.testing.assert_allclose(got, want, atol=DESC_ATOL, rtol=0)
        # the port's flat npz, read as the JAX driver reads --superpoint_weights
        path = str(tmp_path / "sp.npz")
        np.savez(path, **tsp.flatten_params(tm))
        flat = dict(np.load(path))
        jp2 = {n: {"w": jnp.asarray(flat[f"{n}.w"]), "b": jnp.asarray(flat[f"{n}.b"])}
               for n in {k.rsplit(".", 1)[0] for k in flat}}
        for n in jp:
            np.testing.assert_array_equal(np.asarray(jp2[n]["w"]), np.asarray(jp[n]["w"]))
        # and the JAX params' npz into the port
        path2 = str(tmp_path / "sp_jax.npz")
        np.savez(path2, **{f"{n}.{leaf}": np.asarray(p[leaf]) for n, p in jp.items()
                           for leaf in ("w", "b")})
        with torch.no_grad():
            again = tsp.load_params(path2, device="cpu").forward_features(_t(img))
        np.testing.assert_array_equal(_np(again["x_norm_patchtokens"]), got)


class TestLpips:
    @pytest.mark.parametrize("net", ["vgg", "alex"])
    def test_distance_matches(self, net):
        jp = jlp.init_params(jax.random.key(4), net=net)
        tp = {k: _t(v) for k, v in jp.items()}
        rng = np.random.default_rng(6)
        a = rng.uniform(size=(3, 64, 72)).astype(np.float32)
        b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
        want = float(jlp.lpips_distance(jp, jnp.asarray(a), jnp.asarray(b), net=net))
        got = float(tlp.lpips_distance(tp, _t(a), _t(b), net=net))
        assert want > 0
        np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL)
        assert float(tlp.lpips_distance(tp, _t(a), _t(a), net=net)) == 0.0

    def test_converters_both_namings(self):
        rng = np.random.default_rng(31)
        full = make_vgg16_state_dict(rng)
        bare = {k.split("features.")[1]: v for k, v in full.items()
                if k.startswith("features.")}
        lin = {f"lin{i}.model.1.weight": torch.from_numpy(
            rng.uniform(0.0, 2.0 / c, size=(1, c, 1, 1)).astype(np.float32))
            for i, c in enumerate(tlp.VGG_CHANNELS)}
        renamed = {f"{i}.1.weight": lin[f"lin{i}.model.1.weight"] for i in range(5)}
        want = jlp.convert_torch_lpips(full, lin)
        for vgg, lins in ((full, lin), (bare, renamed)):
            got = tlp.convert_torch_lpips(vgg, lins)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
        with pytest.raises(KeyError):
            tlp.convert_torch_lpips(full, {})

    def test_npz_both_ways(self, tmp_path):
        tp = tlp.init_params(torch.Generator().manual_seed(1), "vgg", device="cpu")
        path = str(tmp_path / "port.npz")
        tlp.save_params(path, tp)
        jp = jlp.load_params(path)
        assert sorted(jp) == sorted(tp)
        for k in tp:
            np.testing.assert_array_equal(np.asarray(jp[k]), _np(tp[k]))
        path2 = str(tmp_path / "jax.npz")
        jlp.save_params(path2, jlp.init_params(jax.random.key(2), net="alex"))
        back = tlp.load_params(path2, device="cpu")
        img = np.random.default_rng(3).uniform(size=(3, 64, 64)).astype(np.float32)
        fn = tlp.make_lpips(path2, net="alex", device="cpu")
        want = float(jax.jit(lambda x, y: jlp.lpips_distance(jlp.load_params(path2), x, y,
                                                             net="alex"))(
            jnp.asarray(img), jnp.asarray(img[:, ::-1].copy())))
        got = fn(_t(img), _t(img[:, ::-1].copy()))
        assert not got.requires_grad and sorted(back) == sorted(jlp.load_params(path2))
        np.testing.assert_allclose(float(got), want, rtol=LPIPS_RTOL)


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """Both drivers with --backbone superpoint on copies of one
    JAX-trained experiment dir, from the same --superpoint_weights npz."""
    root = str(tmp_path_factory.mktemp("pose_sp"))
    exp = _experiment(root)
    npz = os.path.join(root, "superpoint.npz")
    np.savez(npz, **tsp.flatten_params(tsp.init_params(torch.Generator().manual_seed(7),
                                                       device="cpu")))
    out = {"npz": npz}
    for name in ("eval_jax", "eval_torch"):
        out[name] = os.path.join(root, name)
        shutil.copytree(exp, out[name])
    for name, main, extra in (("jax", jpe.main, []), ("torch", tpe.main,
                                                      ["--platform", "cpu"])):
        d = os.path.join(root, name)
        shutil.copytree(exp, d)
        argv = ["--exp_path", d, "--out_path", os.path.join(root, f"{name}.json"),
                "--data_type", "blender", "--backbone", "superpoint",
                "--superpoint_weights", npz] + BUDGETS + extra
        out[name] = (*_run(main, argv), d)
    return out


class TestSuperPointDriver:
    def test_results_match_the_jax_driver(self, sp_runs):
        (jres, jerr, jdir), (tres, terr, tdir) = sp_runs["jax"], sp_runs["torch"]
        assert "Traceback" not in jerr and "Traceback" not in terr, terr
        assert len(tres) == len(jres) == 2  # one entry per test image
        for j, t in zip(jres, tres):
            assert set(t) == set(j)
            for key in ("sequence_id", "category_name", "frame_id"):
                assert t[key] == j[key], key
            for key in ("loss", "scores_loss", "recall"):
                assert np.isfinite(t[key]), key
            np.testing.assert_allclose(t["gt_c2w"], j["gt_c2w"], atol=1e-6)
        assert np.isfinite(_errors(tres)).all()
        for d in (jdir, tdir):
            for name in ("id_module.npz", "pose_metrics.jsonl"):
                assert os.path.exists(os.path.join(d, SCENE, name)), (d, name)
        # the 256-wide id module on the 28 x 28 grid, in both packages
        with np.load(os.path.join(tdir, SCENE, "id_module.npz")) as t, \
                np.load(os.path.join(jdir, SCENE, "id_module.npz")) as j:
            shapes = {k: t[k].shape for k in t.files if k.startswith("param:")}
            assert shapes == {k: j[k].shape for k in shapes}
            assert shapes["param:attention/k/w"] == (256, 256)
            assert shapes["param:attention/q/w"] == (256 + tbb.PE_DIM, 256)

    def test_evaluation_matches_the_jax_driver(self, sp_runs):
        """The driver's scoring at P = 784 through the 256-wide id module,
        from the same SuperPoint weights (read from the npz as each driver
        reads --superpoint_weights), id-module params and ray draws."""
        flat = dict(np.load(sp_runs["npz"]))
        j_sp = {n: {"w": jnp.asarray(flat[f"{n}.w"]), "b": jnp.asarray(flat[f"{n}.b"])}
                for n in {k.rsplit(".", 1)[0] for k in flat}}
        calls = evaluate_both({"jax": sp_runs["eval_jax"], "torch": sp_runs["eval_torch"]},
                              j_sp, tsp.load_params(sp_runs["npz"], device="cpu"),
                              backbone="superpoint")
        assert_same_per_image_errors(calls)


def _attention_inputs(P, d, N, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(P, d, generator=g)
    feats = torch.randn(N, d, generator=g)
    wk = torch.randn(d, d, generator=g) * 0.05
    bk = torch.randn(d, generator=g) * 0.1
    pmask = (torch.rand(P, generator=g) > 0.3).float()
    valid = torch.ones(N)
    valid[N - N // 8:] = 0.0
    return q, feats, wk, bk, pmask, valid


def _plain_fwd(q, feats, wk, bk, pmask, valid, mode, sqrt_d):
    assert q.shape == (tak.N_PATCHES, tak.KERNEL_WIDTH) and feats.shape[1] == tak.KERNEL_WIDTH
    return tak.attention_scores_plain(q, feats, wk, bk, pmask, valid, mode, sqrt_d=sqrt_d)


def _plain_bwd(q, feats, wk, bk, pmask, valid, m, s, g, mode, sqrt_d):
    assert q.shape == (tak.N_PATCHES, tak.KERNEL_WIDTH) and wk.shape == (384, 384)
    return tak.attention_scores_bwd_plain(q, feats, wk, bk, pmask, valid, m, s, g, mode,
                                          sqrt_d=sqrt_d)


class TestChunkedAttention:
    @pytest.mark.parametrize("mode", tak.MODES)
    def test_superpoint_shape_matches_one_plain_call(self, mode):
        """P = 784, d = 256 through 4 chunks of 256 patches at width 384
        against one plain call at the true shape: scores, m and s, and the
        four gradients, each within 1e-5 of its largest magnitude (dbk, zero
        in exact arithmetic, against max_col sum_j |dk_j|). A padded patch
        adds 0 and zero columns add exact zeros, so what is left is the
        order of the sums."""
        P, d, N = 784, 256, 640
        ins = _attention_inputs(P, d, N, 0)
        q, feats, wk, bk, pmask, valid = ins
        calls = []

        def fwd(*a):
            calls.append(a[0].shape)
            return _plain_fwd(*a)

        got = tak.chunked_fwd(*ins, mode, fwd)
        want = tak.attention_scores_plain(*ins, mode)
        assert len(calls) == 4
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-5 * float(b.abs().max()), rtol=0)
        g = torch.randn(N, generator=torch.Generator().manual_seed(1))
        _, m, s = want
        got = tak.chunked_bwd(*ins, m, s, g, mode, _plain_bwd)
        want = tak.attention_scores_bwd_plain(*ins, m, s, g, mode)
        logits = q @ (feats @ wk + bk).T / math.sqrt(d)
        logits = torch.where(valid[None] > 0, logits, torch.full_like(logits, tak.NEG))
        probs = torch.exp(logits - m) / s
        dlog = pmask[:, None] * probs * (g - (probs * g).sum(1, keepdim=True)) / math.sqrt(d)
        for name, a, b in zip(("dq", "dfeats", "dwk", "dbk"), got, want):
            assert a.shape == b.shape, name
            scale = float((dlog.T @ q).abs().sum(0).max() if name == "dbk" else b.abs().max())
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-5 * scale, rtol=0, err_msg=name)

    def test_dino_shape_is_one_call_of_the_inputs(self):
        """At the kernels' own shape the wrapper makes one call, of the
        inputs themselves, and returns its results unchanged."""
        ins = _attention_inputs(256, 384, 300, 2)
        seen = []

        def fwd(*a):
            seen.append(a)
            return _plain_fwd(*a)

        got = tak.chunked_fwd(*ins, "f32", fwd)
        assert len(seen) == 1
        for a, b in zip(seen[0][:6], ins):
            assert a is b
        assert seen[0][7] == math.sqrt(384)
        for a, b in zip(got, tak.attention_scores_plain(*ins, "f32")):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="d <= 384"):
            tak._check_kernel_inputs(*_attention_inputs(4, 400, 8, 3))
