"""The port's id-module trainer against sixdgs_tpu's, on the CPU at small
widths (DINO 2 x 64, feature_dim 64, 2,048 rays, 4 images per step): the
hand-written Adafactor against optax, the batch loss and its gradients
(one image NaN), three PoseTrainer steps from one seed on shared rays, the
fused and plain scorers, checkpoints both ways, and the camera-up loss and
augmentations. The batched batch loss is also held to the per-image loop
of ``per_image_loss.py``, and the pose request's one-image path to its
forms there, bit for bit.

Two parameters have a true gradient of exactly zero: the k-projection bias
and the ray MLP's last bias (a shift of every logit of a patch by q_p . bk
leaves its softmax unchanged, and sum_j dfeats_j = dbk Wk^T). Their
gradients are rounding noise in both packages, and Adafactor's first step
divides a gradient by its own size, so each step moves them by an update
of rms up to lr * max(rms(p), 1e-3) with a sign neither package controls.
They are held to that bound; every other parameter to rounding.
"""

import copy
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from sixdgs_tpu.pose import cam_augmentations as jaug
from sixdgs_tpu.pose import dino as jdino
from sixdgs_tpu.pose import loss as jloss
from sixdgs_tpu.pose import modules as jmod
from sixdgs_tpu.pose import trainer as jtr
from sixdgs_tpu.rays.engine import generate_rays_from_scene as j_gen
from sixdgs_tpu.scene.gaussians import from_arrays as j_from_arrays
from sixdgs_tpu.scene.structures import CameraInfo as JCam
from sixdgs_tpu.utils.config import PoseEstimationConfig as JCfg
from sixdgs_torch import weights
from sixdgs_torch.ops import attention_kernel as tak
from sixdgs_torch.pose import cam_augmentations as taug
from sixdgs_torch.pose import evaluate as tev
from sixdgs_torch.pose import loss as tloss
from sixdgs_torch.pose import trainer as ttr
from sixdgs_torch.rays.engine import Rays as TRays
from sixdgs_torch.scene.gaussians import from_arrays as t_from_arrays
from sixdgs_torch.scene.structures import CameraInfo as TCam
from sixdgs_torch.utils.config import PoseEstimationConfig as TCfg
from sixdgs_torch.utils import profiling
import per_image_loss as pil  # tests/per_image_loss.py
from torch_threads import held_at, one_thread, shared_cores  # noqa: F401 (fixtures)


def _launches(kernel):
    """Launches of ``kernel`` (b1-b5, b3_store) counted so far on CUDA tensors."""
    return profiling.snapshot()["counters"].get("kernel." + kernel, 0)


SIZE = 64
CFG = dict(gradient_accumulation_steps=4, ray_budget=2048, max_ellipsoids=300)
ZERO_GRAD_PARAMS = ("attention/k/b", "ray_mlp/l4/b")
# f32 on both sides, summed in other orders through a few layers and three
# Adafactor steps
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-4
# the port's torch threads in the three-step comparison, whatever the
# worker's share: the thread count sets torch's order of summation, and
# ray_mlp/l1/w, a small difference of large terms, meets PARAM_ATOL at 4 and
# 8 threads but not at 1 or 2 (one entry of 72,192 off by 1.24e-6)
PARITY_THREADS = 8


def _t(x):
    return torch.tensor(np.asarray(x))


def _look_at(pos):
    z = -pos / np.linalg.norm(pos)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)  # R_w2c


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    n = 300
    arrs = {
        "xyz": (rng.normal(size=(n, 3)) * 0.6).astype(np.float32),
        "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "features_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32),
        "opacity": rng.uniform(1.0, 3.0, size=(n, 1)).astype(np.float32),
        "scaling": rng.uniform(-2.6, -2.0, size=(n, 3)).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
    }
    j_scene = j_from_arrays(arrs, 3, capacity=512)
    t_scene = t_from_arrays(arrs, 3, capacity=512, device="cpu")
    j_rays = j_gen(j_scene, jax.random.key(7), JCfg(**CFG))
    t_rays = TRays(*[_t(x) for x in j_rays])
    cams = []
    for i in range(6):
        ang = 2 * np.pi * i / 6
        pos = np.array([1.8 * np.cos(ang), 0.4, 1.8 * np.sin(ang)])
        R_w2c = _look_at(pos)
        img = (rng.uniform(size=(SIZE, SIZE, 4)) * 255).astype(np.uint8)
        img[..., 3] = 0
        img[10 + i:50, 8:56 - i, 3] = 255  # foreground from the alpha channel
        cams.append(dict(uid=i, R=R_w2c.T, T=-R_w2c @ pos, FovY=0.9, FovX=0.9, image=img,
                         image_path="", image_name=f"cam{i}", width=SIZE, height=SIZE))
    j_dino = jdino.init_params(jax.random.key(1), embed_dim=64, depth=2)
    j_idm = jmod.init_id_module(jax.random.key(2), feature_dim=64)
    t_dino = weights.dino_from_numpy(jax.tree.map(np.asarray, j_dino), device="cpu")
    t_idm = weights.id_module_from_numpy(jax.tree.map(np.asarray, j_idm), device="cpu")
    return dict(j_scene=j_scene, t_scene=t_scene, j_rays=j_rays, t_rays=t_rays,
                j_cams=[JCam(**c) for c in cams], t_cams=[TCam(**c) for c in cams],
                j_dino=j_dino, j_idm=j_idm, t_dino=t_dino, t_idm=t_idm)


@pytest.fixture
def trainers(setup):
    """A JAX and a port trainer from one seed, both on the JAX rays; the
    port's torch on PARITY_THREADS threads until the test ends (its feature
    cache is computed here)."""
    s = setup
    with held_at(PARITY_THREADS):
        jt = jtr.PoseTrainer(s["j_dino"], s["j_idm"], s["j_scene"], s["j_cams"],
                             JCfg(**CFG), seed=3)
        tt = ttr.PoseTrainer(s["t_dino"], s["t_idm"], s["t_scene"], s["t_cams"],
                             TCfg(**CFG), seed=3, device="cpu")
        jt.rays, tt.rays = s["j_rays"], s["t_rays"]
        yield jt, tt


def _flat_jax(params):
    return ttr._flatten(jax.tree.map(np.asarray, params))


def _flat_port(module):
    return ttr._flatten(weights.id_module_to_numpy(module))


# ------------------------------------------------------------------ Adafactor


class TestAdafactor:
    # (JAX shape, port shape): nn.Linear weights are stored transposed
    @pytest.mark.parametrize("jshape,tshape", [
        ((141, 512), (512, 141)),  # factored, non-square
        ((384, 384), (384, 384)),  # factored, square
        ((256, 256, 5, 5), (256, 256, 5, 5)),  # factored 4-D conv
        ((512,), (512,)),  # unfactored vector
    ])
    def test_matches_optax_over_five_steps(self, jshape, tshape):
        rng = np.random.default_rng(1)
        p0 = (rng.normal(size=jshape) * 0.05).astype(np.float32)
        grads = [(rng.normal(size=jshape) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
                 for _ in range(5)]
        to_port = (lambda a: a.T) if jshape != tshape else (lambda a: a)

        opt = jtr.make_adafactor()
        jp = jnp.asarray(p0)
        state = opt.init(jp)
        tp = torch.tensor(to_port(p0).copy(), requires_grad=True)
        topt = ttr.make_adafactor([tp])
        for g in grads:
            upd, state = opt.update(jnp.asarray(g), state, jp)
            jp = optax.apply_updates(jp, upd)
            tp.grad = torch.tensor(to_port(g).copy())
            topt.step()
            # updates agree to rounding (the factored estimate is symmetric
            # in the two axes, so the transposed layout changes only order)
            np.testing.assert_allclose(tp.detach().numpy(), to_port(np.asarray(jp)),
                                       rtol=1e-5, atol=1e-7)
        assert topt.state[tp]["step"] == 5
        assert ("v" in topt.state[tp]) == (len(jshape) < 2)


# ------------------------------------------------------------------ batch loss


def _feature_batch(setup, idx, nan_image):
    s = setup
    feats = [jtr.compute_image_features(s["j_dino"], *map(jnp.asarray, jtr.prepare_image_mask(
        s["j_cams"][i]))) for i in idx]
    c2w = np.stack([s["j_cams"][i].c2w() for i in idx]).astype(np.float32)
    if nan_image:
        c2w[1, 0, 3] = np.nan  # its target scores, and so its loss, are NaN
    arrs = [np.stack([np.asarray(f[k]) for f in feats]) for k in range(3)] + [c2w]
    return jtr.FeatureBatch(*map(jnp.asarray, arrs)), ttr.FeatureBatch(*map(_t, arrs))


@pytest.fixture(scope="module")
def jax_batch_losses(setup):
    """{nan_image: (port FeatureBatch, model_up, JAX (loss, aux), JAX
    gradients)} of images 0, 3, 5, 2, the second one's camera NaN where
    nan_image is set: the reference of both scorers."""
    s = setup
    model_up = np.array([0.05, 0.9, 0.1], np.float32)
    loss = jax.jit(jax.value_and_grad(jtr.batch_loss_cached, has_aux=True))
    out = {}
    for nan_image in (False, True):
        jb, tb = _feature_batch(setup, [0, 3, 5, 2], nan_image)
        jlaux, jg = loss(s["j_idm"], jb, s["j_rays"], jnp.asarray(model_up))
        out[nan_image] = (tb, model_up, jlaux, jg)
    return out


class TestBatchLoss:
    @pytest.mark.parametrize("fused", [False, True])
    @pytest.mark.parametrize("nan_image", [False, True])
    def test_loss_aux_and_grads_match_jax(self, setup, jax_batch_losses, nan_image, fused):
        s = setup
        tb, model_up, (jl, jaux), jg = jax_batch_losses[nan_image]
        tm = copy.deepcopy(s["t_idm"])
        tl, taux = ttr.batch_loss_cached(tm, tb, s["t_rays"], _t(model_up),
                                         fused_attention=fused)
        tl.backward()
        for k in ("loss", "loss_score", "cam_up"):
            np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)
        assert int(taux["n_nan"]) == int(jaux["n_nan"]) == int(nan_image)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        jgf = _flat_jax(jg)
        port = _grads_in_jax_layout(tm)
        # each gradient within 1e-4 of its own largest entry; the two whose
        # true value is zero within 1e-5 of the largest gradient entry overall
        top = max(np.abs(g[np.isfinite(g)]).max(initial=0.0) for g in jgf.values())
        for k, g in jgf.items():
            scale = np.abs(g[np.isfinite(g)]).max(initial=0.0)
            atol = 1e-5 * top if k in ZERO_GRAD_PARAMS else 1e-4 * scale + 1e-12
            np.testing.assert_allclose(port[k], g, rtol=1e-3, atol=atol, err_msg=k)
        # the NaN image leaves NaN gradients where the reference has them,
        # which the train step zeroes before the optimizer
        assert {k for k, g in port.items() if np.isnan(g).any()} == {
            k for k, g in jgf.items() if np.isnan(g).any()}
        assert nan_image == any(np.isnan(g).any() for g in jgf.values())


def _grads_in_jax_layout(module):
    """The module's .grad in the reference package's param-dict layout."""
    grads = copy.deepcopy(module)
    with torch.no_grad():
        for p, q in zip(grads.parameters(), module.parameters()):
            p.copy_(q.grad)
    return _flat_port(grads)


class TestFusedVersusPlain:
    def test_same_gradients_on_the_cpu(self, setup):
        """The fused scorer (the kernels' plain versions on the CPU, B2's
        unmasked dlog included) and the plain scorer give one gradient."""
        s = setup
        _, tb = _feature_batch(setup, [1, 4, 4, 0], nan_image=False)
        model_up = _t(np.array([0.0, 1.0, 0.0], np.float32))
        out = {}
        for fused in (False, True):
            tm = copy.deepcopy(s["t_idm"])
            loss, _ = ttr.batch_loss_cached(tm, tb, s["t_rays"], model_up,
                                            fused_attention=fused)
            loss.backward()
            out[fused] = (loss.item(), _grads_in_jax_layout(tm))
        np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
        top = max(np.abs(g).max() for g in out[False][1].values())
        for k, g in out[False][1].items():
            np.testing.assert_allclose(out[True][1][k], g, rtol=1e-4,
                                       atol=1e-6 * top, err_msg=k)


@pytest.mark.usefixtures("one_thread")
class TestBatchedStep:
    @pytest.mark.parametrize("nan_image", [False, True])
    @pytest.mark.parametrize("fused", [False, True])
    @pytest.mark.parametrize("shape", ["dino", "superpoint"])
    def test_matches_per_image_loop(self, shape, fused, nan_image):
        """The batch scored as one (one camera-up head, one loss over
        [B, N], one q-projection on the fused scorer) against the loop that
        scores it image by image: loss, aux and every gradient within
        pil.RTOL, NaN where the loop has NaN."""
        idm, fbatch, rays, up = pil.random_step(pil.SMALL[shape], nan_image)
        want = pil.loss_and_grads(pil.batch_loss_per_image, idm, fbatch, rays, up, fused)
        got = pil.loss_and_grads(ttr.batch_loss_cached, idm, fbatch, rays, up, fused)
        assert got[0]["n_nan"] == want[0]["n_nan"] == int(nan_image)
        assert pil.nan_entries_match(got, want)
        assert nan_image == any(torch.isnan(g).any() for g in want[1].values())
        worst = pil.gaps(got, want)
        assert max(worst.values()) <= pil.RTOL, worst


@pytest.mark.usefixtures("one_thread")
class TestOneImagePath:
    """The pose request scores one image through the functions the batch
    goes through."""

    def test_batched_rows_equal_one_image_calls(self):
        idm, fbatch, rays, up = pil.random_step(pil.SMALL["superpoint"], nan_image=False)
        n = fbatch.patch_mask.sum(-1, dtype=torch.int32)
        scores = torch.rand(fbatch.c2w.shape[0], rays.valid.shape[0])
        losses, targets = tloss.distance_score_loss(scores, fbatch.c2w, rays.ori, rays.dir,
                                                    rays.valid, n)
        with torch.no_grad():
            heads = idm.cam_up(fbatch.fmap)
        ups = tloss.cam_up_loss(up, heads)
        for b in range(fbatch.c2w.shape[0]):
            loss, target = tloss.distance_score_loss(scores[b], fbatch.c2w[b], rays.ori,
                                                     rays.dir, rays.valid, n[b])
            assert torch.equal(losses[b], loss) and torch.equal(targets[b], target)
            assert torch.equal(ups[b], tloss.cam_up_loss(up, heads[b]))
            with torch.no_grad():
                head = idm.cam_up(fbatch.fmap[b])
            # one GEMM over the batch against one image's matrix-vector product
            torch.testing.assert_close(heads[b], head, rtol=pil.RTOL, atol=0.0)

    def test_one_image_forms_bitwise_as_before(self):
        idm, fbatch, rays, up = pil.random_step(pil.SMALL["dino"], nan_image=False)
        scores = torch.rand(rays.valid.shape[0])
        for b in range(fbatch.c2w.shape[0]):
            args = (fbatch.c2w[b], rays.ori, rays.dir, rays.valid,
                    fbatch.patch_mask[b].sum(dtype=torch.int32))
            for new, old in zip(tloss.target_ray_scores(*args), pil.target_ray_scores(*args)):
                assert torch.equal(new, old)
            for new, old in zip(tloss.distance_score_loss(scores, *args),
                                pil.distance_score_loss_one(scores, *args)):
                assert torch.equal(new, old)
            with torch.no_grad():
                head = idm.cam_up(fbatch.fmap[b])
                assert torch.equal(head, pil.cam_up_head_one(idm.cam_up, fbatch.fmap[b]))
            assert torch.equal(tloss.cam_up_loss(up, head), pil.cam_up_loss_one(up, head))

    @pytest.mark.parametrize("fused", [False, True])
    def test_eval_image_bitwise_as_before(self, setup, fused, monkeypatch):
        from sixdgs_torch.pose.evaluate import eval_image

        s = setup
        cam = s["t_cams"][2]
        img, mask = map(torch.as_tensor, ttr.prepare_image_mask(cam))
        args = (s["t_dino"], s["t_idm"], img, mask, torch.tensor(cam.c2w(), dtype=torch.float32),
                s["t_rays"])
        now = eval_image(*args, k=16, fused_attention=fused)
        pil.as_before(monkeypatch)
        before = eval_image(*args, k=16, fused_attention=fused)
        assert now.keys() == before.keys()
        for k in now:
            assert torch.equal(now[k], before[k]), k


# ---------------------------------------------------------------- the trainer


class TestTrainerParity:
    def test_three_steps_match_jax(self, trainers):
        jt, tt = trainers
        jl, tl = [], []
        # start at 1: iteration 0 would regenerate the rays from each
        # package's own random stream
        jt.run(n_iterations=4, start_iteration=1, validate_every=0, log_every=1,
               callback=lambda it, aux, tr: jl.append(float(aux["loss"])))
        tt.run(n_iterations=4, start_iteration=1, validate_every=0, log_every=1,
               callback=lambda it, aux, tr: tl.append(aux["loss"]))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert tt.running_loss == pytest.approx(jt.running_loss, rel=1e-5)
        jp, tp = _flat_jax(jt.id_params), _flat_port(tt.id_module)
        assert jp.keys() == tp.keys()
        for k in jp:
            if k in ZERO_GRAD_PARAMS:
                # each step's update has rms <= lr 1e-2 x max(rms(p), 1e-3)
                # (block clip 1.0), of a sign neither package controls
                bound = 2 * 3 * 1e-2 * max(np.sqrt(np.mean(jp[k] ** 2)), 1e-3) * 1.1
                assert np.sqrt(np.mean((tp[k] - jp[k]) ** 2)) <= bound, k
            else:
                np.testing.assert_allclose(tp[k], jp[k], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                           err_msg=k)
        assert all(st["step"] == 3 for st in tt.optimizer.state.values())

    @pytest.mark.usefixtures("one_thread")
    def test_validate_and_fused_run(self, setup):
        """A fused trainer from iteration 0 (its own rays, drawn on the CPU)
        trains, regenerates rays at iteration 0 and validates."""
        s = setup
        tt = ttr.PoseTrainer(s["t_dino"], s["t_idm"], s["t_scene"], s["t_cams"],
                             TCfg(**CFG), seed=5, fused_attention=True, device="cpu")
        before = _launches("b2")
        losses = []
        tt.run(n_iterations=2, validate_every=0, log_every=1,
               callback=lambda it, aux, tr: losses.append(aux))
        assert _launches("b2") == before  # no CUDA launch on the CPU
        assert tt.rays is not None and bool(tt.rays.valid.any())
        assert all(np.isfinite(a["loss"]) and a["n_nan"] == 0 for a in losses)
        out = tt.validate(0, max_images=2)
        assert np.isfinite(out["train_imgs"]["translation_error"])
        # the caller's module is not trained
        for p, q in zip(s["t_idm"].parameters(), tt.id_module.parameters()):
            assert p is not q


def _cached_views():
    return profiling.snapshot()["counters"].get("val.cached_views", 0)


class TestPreparedViews:
    """A validation reads each view as the trainer prepared it once: the
    training views from its image cache, the held-out views from a cache
    filled at their first validation and keyed on the camera objects."""

    @pytest.fixture
    def trainer(self, setup):
        s = setup
        tt = ttr.PoseTrainer(s["t_dino"], s["t_idm"], s["t_scene"], s["t_cams"][:4],
                             TCfg(**CFG), seed=5, fused_attention=True, device="cpu")
        tt.rays = s["t_rays"]
        return tt

    @staticmethod
    def _counted_preparation(monkeypatch):
        """The cameras prepare_image_mask is called on from now, in both
        namespaces that call it."""
        prepared, original = [], tev.prepare_image_mask

        def prepare(info, *a, **k):
            prepared.append(info)
            return original(info, *a, **k)

        monkeypatch.setattr(tev, "prepare_image_mask", prepare)
        monkeypatch.setattr(ttr, "prepare_image_mask", prepare)
        return prepared

    @pytest.mark.usefixtures("one_thread")
    def test_second_validation_prepares_no_view(self, setup, trainer, monkeypatch):
        held_out = setup["t_cams"][4:]
        prepared = self._counted_preparation(monkeypatch)
        before = _cached_views()
        trainer.validate(0, test_cam_infos=held_out, max_images=1)
        # a short validation prepares the whole held-out list, and nothing else
        assert [id(c) for c in prepared] == [id(c) for c in held_out]
        assert _cached_views() - before == 1
        prepared.clear()
        before = _cached_views()
        second = trainer.validate(1, test_cam_infos=held_out)
        assert prepared == []
        assert _cached_views() - before == len(trainer.train_cam_infos) + len(held_out)
        assert trainer.validate(2, test_cam_infos=held_out) == second

    @pytest.mark.usefixtures("one_thread")
    def test_prepared_views_give_bitwise_equal_results(self, trainer):
        infos = trainer.train_cam_infos
        runs = [tev.test_pose_estimation(
            infos, trainer.dino_model, trainer.id_module, trainer.rays, trainer.model_up,
            use_target_scores=True, k=trainer.cfg.rays_to_output, fused_attention=True,
            **kw) for kw in ({}, {"views": trainer._img_cache})]
        (plain, *plain_avg), (cached, *cached_avg) = runs
        assert len(plain) == len(infos)
        for a, b in zip(plain, cached):
            assert set(a) == set(b)
            for key in a:
                assert repr(a[key]) == repr(b[key]), key
        # the averages but the seconds a view took
        assert repr(plain_avg[:-1]) == repr(cached_avg[:-1])

    def test_different_held_out_list_is_prepared_afresh(self, setup, trainer, monkeypatch):
        """Cameras of another list, even with the first list's uids and
        names, are never served the first list's images."""
        first = setup["t_cams"][4:]
        other = [dataclasses.replace(c, image=np.ascontiguousarray(c.image[::-1]))
                 for c in first]
        seen = []
        original = tev.test_pose_estimation

        def recorded(cam_infos, *a, **k):
            seen.append((cam_infos, k["views"]))
            return original(cam_infos, *a, **k)

        monkeypatch.setattr(tev, "test_pose_estimation", recorded)
        trainer.validate(0, test_cam_infos=first, max_images=1)
        prepared = self._counted_preparation(monkeypatch)
        before = _cached_views()
        trainer.validate(1, test_cam_infos=other)
        assert [id(c) for c in prepared] == [id(c) for c in other]
        assert _cached_views() - before == len(trainer.train_cam_infos)
        infos, views = seen[-1]
        assert [id(c) for c in infos] == [id(c) for c in other]
        for cam, (img, mask) in zip(other, views):
            ref_img, ref_mask = tev.prepare_image_mask(cam)
            np.testing.assert_array_equal(img, ref_img)
            np.testing.assert_array_equal(mask, ref_mask)
        # the training split still reads the trainer's own image cache
        assert all(v is c for v, c in zip(seen[-2][1], trainer._img_cache))


class TestCheckpoints:
    def test_port_checkpoint_loads_in_jax(self, setup, tmp_path):
        s = setup
        tt = ttr.PoseTrainer(s["t_dino"], s["t_idm"], s["t_scene"], s["t_cams"],
                             TCfg(**CFG), seed=2, device="cpu")
        tt.rays = s["t_rays"]
        tt.run(n_iterations=2, start_iteration=1, validate_every=0)
        path = str(tmp_path / "port.npz")
        tt.save_checkpoint(path, epoch=7)
        params, epoch = jtr.PoseTrainer.load_checkpoint(path, s["j_idm"])
        assert epoch == 7
        ref = _flat_port(tt.id_module)
        for k, v in _flat_jax(params).items():
            np.testing.assert_array_equal(v, ref[k], err_msg=k)

    def test_jax_checkpoint_loads_in_the_port(self, setup, tmp_path):
        s = setup
        jt = jtr.PoseTrainer(s["j_dino"], s["j_idm"], s["j_scene"], s["j_cams"][:2],
                             JCfg(**CFG), seed=2)
        jt.rays = s["j_rays"]
        jt.run(n_iterations=2, start_iteration=1, validate_every=0)
        path = str(tmp_path / "jax.npz")
        jt.save_checkpoint(path, epoch=5)
        tt = ttr.PoseTrainer(s["t_dino"], s["t_idm"], s["t_scene"], s["t_cams"][:2],
                             TCfg(**CFG), seed=2, device="cpu")
        assert tt.restore_checkpoint(path) == 5
        assert tt.running_loss == pytest.approx(jt.running_loss)
        ref = _flat_jax(jt.id_params)
        for k, v in _flat_port(tt.id_module).items():
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
        module, epoch = ttr.PoseTrainer.load_checkpoint(path, s["t_idm"])
        assert epoch == 5
        for k, v in _flat_port(module).items():
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
        # the reference's optimizer state has other keys: left fresh
        assert not tt.optimizer.state

    @pytest.mark.usefixtures("one_thread")
    def test_resume_continues_bit_identically(self, setup, tmp_path):
        """params + Adafactor state + running_loss restore exactly: a resumed
        trainer continues bit for bit like the one that never stopped (the
        batch-pick generator and the rays are host state outside the
        checkpoint, as in the reference package, and are carried over)."""
        s = setup
        kw = dict(seed=4, device="cpu")
        tr_a = ttr.PoseTrainer(s["t_dino"], s["t_idm"], s["t_scene"], s["t_cams"],
                               TCfg(**CFG), **kw)
        tr_a.run(n_iterations=3, validate_every=0)
        path = str(tmp_path / "resume.npz")
        tr_a.save_checkpoint(path, epoch=3)
        rng_state = copy.deepcopy(tr_a.rng.bit_generator.state)
        tr_c = ttr.PoseTrainer(s["t_dino"], s["t_idm"], s["t_scene"], s["t_cams"],
                               TCfg(**CFG), **kw)
        start = tr_c.restore_checkpoint(path)
        assert start == 3 and tr_c.running_loss == tr_a.running_loss
        tr_c.rng.bit_generator.state = rng_state
        tr_c.rays = tr_a.rays
        for pa, pc in zip(tr_a.id_module.parameters(), tr_c.id_module.parameters()):
            sa, sc = tr_a.optimizer.state[pa], tr_c.optimizer.state[pc]
            assert sa.keys() == sc.keys() and sa["step"] == sc["step"] == 3
            for k in sa:
                if k != "step":
                    assert torch.equal(sa[k], sc[k])
        before = [p.detach().clone() for p in tr_c.id_module.parameters()]
        tr_a.run(n_iterations=6, start_iteration=3, validate_every=0)
        tr_c.run(n_iterations=6, start_iteration=start, validate_every=0)
        for pa, pc, p0 in zip(tr_a.id_module.parameters(), tr_c.id_module.parameters(),
                              before):
            assert torch.equal(pa, pc)
        assert any(not torch.equal(pc, p0)
                   for pc, p0 in zip(tr_c.id_module.parameters(), before))
        assert all(st["step"] == 6 for st in tr_c.optimizer.state.values())
        assert tr_c.running_loss == tr_a.running_loss


# ----------------------------------------------- camera-up loss, augmentations


class TestCamUp:
    def test_cam_up_loss_matches(self):
        rng = np.random.default_rng(3)
        for mu, cu in [(rng.normal(size=3), rng.normal(size=3)),
                       (np.array([0.0, 1.0, 0.0]), np.array([0.0, -2.0, 0.0])),
                       (np.zeros(3), rng.normal(size=3))]:  # the 1e-12 guard
            mu, cu = mu.astype(np.float32), cu.astype(np.float32)
            ref = float(jloss.cam_up_loss(jnp.asarray(mu), jnp.asarray(cu)))
            out = tloss.cam_up_loss(_t(mu), _t(cu)).item()
            np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)

    def test_augmentations_match(self):
        rng = np.random.default_rng(4)
        targets = rng.normal(loc=2.0, scale=3.0, size=(5, 7, 3)).astype(np.float32)
        x = rng.normal(size=(4, 3)).astype(np.float32)
        ref = np.asarray(jaug.make_normalization_reverser(jnp.asarray(targets))(jnp.asarray(x)))
        out = taug.make_normalization_reverser(_t(targets))(_t(x)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
        # std as std (the upstream bug registers the mean twice)
        flat = targets.reshape(-1, 3)
        np.testing.assert_allclose(out, x * flat.std(0) + flat.mean(0), rtol=1e-5, atol=1e-5)

        enc = rng.uniform(-1.2, 1.2, size=(4, 3 * 11)).astype(np.float32)
        ref = np.asarray(jaug.make_reverse_pos_enc(10)(jnp.asarray(enc)))
        out = taug.make_reverse_pos_enc(10)(_t(enc)).numpy()
        assert out.shape == (4, 3)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
        assert [e.value for e in taug.OutputAugmentationTypes] == [
            e.value for e in jaug.OutputAugmentationTypes]
