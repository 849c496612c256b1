"""Parity at depth: the port's two trainers held to the JAX package's across
the events that only a long run reaches, on the CPU.

The id-module trainer (``PoseTrainer``) runs in lock step with the JAX
trainer from iteration 0: the same initial weights (the JAX package's,
carried through ``sixdgs_torch.weights``), the same images and frozen
backbone features, and at every ray renewal the JAX trainer's own draw,
which the port's ``_regen_rays`` takes in place of its generator's
(patched here only). Both pick batches from
``np.random.default_rng(seed)``, so the picks agree by themselves.

What "agree" can mean is measured, not assumed. Adafactor divides each
gradient by its own running size and clips the block, so an entry whose
gradient is rounding noise moves by a full relative step of either sign,
and two correct float32 implementations drift apart from their first
step. A third trainer, the JAX one again from weights 1 ulp away
(``control``), shows how far rounding alone carries a parameter; the port
is held to a multiple of the control's largest drift. The limit is one
for every parameter, not one per module: where a ReLU's input sits within
rounding of 0, whichever of two orders of summation crosses it first
turns its gradient on or off, and Adafactor's per-entry normalisation of
the camera-up convolutions' updates makes that a full step, so a module
that the 1-ulp control happens to leave alone can move as far as any
other (with one torch thread instead of eight the port's camera-up head
moves 3e-4 by step 25, the control's 1e-7). The two biases whose true
gradient is zero (the k projection's and the ray MLP's last;
``test_torch_pose_trainer.py``) are held to the bound that file uses:
each step moves them by at most lr x max(rms(p), 1e-3).

The 3DGS trainer (``GSTrainer``) runs both packages across an SH degree
step and two densifications on the golden-rasterizer ring of
``test_torch_gs_training.py``, resumed just before iteration 1,000.

The host's share of a 3DGS run, the initialisation and the densification
(numpy on the CPU), gives the same bits whatever SIMD level numpy and
ATen dispatch to: two processes, one of them with every dispatchable
numpy feature disabled and ``ATEN_CPU_CAPABILITY=default``.

``test_lockstep_600`` is the accuracy experiment's own trainer at its own
shapes for 600 steps, its t_err, a_err and recall@100 from predicted
scores every 100 steps on each side; ``test_seed_spread`` runs each
package's experiment from its own seeds 1-3. Both print their
trajectories and are marked ``slow`` (~35 and ~20 min of CPU):

    python -m pytest tests/test_torch_depth_parity.py -m slow -s
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdgs_tpu.pose import dino as jdino
from sixdgs_tpu.pose import evaluate as jev
from sixdgs_tpu.pose import modules as jmod
from sixdgs_tpu.pose import trainer as jtr
from sixdgs_tpu.utils.config import PoseEstimationConfig as JCfg
from sixdgs_torch import weights
from sixdgs_torch.pose import evaluate as tev
from sixdgs_torch.pose import trainer as ttr
from sixdgs_torch.rays.engine import Rays as TRays
from sixdgs_torch.scene import gaussians as tg
from sixdgs_torch.scene.structures import CameraInfo as TCam
from sixdgs_torch.utils.config import PoseEstimationConfig as TCfg
from test_pose_e2e import make_camera_infos, make_gt_scene
from test_torch_gs_training import dataset, _trainers  # noqa: F401 (a fixture)
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)

ZERO_GRAD_PARAMS = ("attention/k/b", "ray_mlp/l4/b")
# the accuracy experiment's trainer (tools/pose_accuracy_experiment.py:
# 2-block 64-wide ViT, 300 ellipsoids, 8 ring views of 64x64)
TOOL_CFG = dict(gradient_accumulation_steps=8, ray_budget=8192, max_ellipsoids=300)
SMALL_CFG = dict(gradient_accumulation_steps=4, ray_budget=2048, max_ellipsoids=300)


def _t(x):
    return torch.tensor(np.asarray(x))


def _rms(x):
    return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))


def _flat_jax(params):
    return ttr._flatten(jax.tree.map(np.asarray, params))


def _flat_port(module):
    return ttr._flatten(weights.id_module_to_numpy(module))


@pytest.fixture(scope="module")
def tool_scene():
    """The accuracy experiment's scene and ring, rendered by the JAX
    package: (JAX scene, port scene, JAX infos, port infos)."""
    js = make_gt_scene()
    infos = make_camera_infos(js)
    n = int(np.asarray(js.active).sum())
    ts = tg.from_arrays({k: np.asarray(getattr(js, k))[:n] for k in tg.PARAM_NAMES}, 3,
                        capacity=js.capacity, device="cpu")
    tinfos = [TCam(**{f.name: getattr(i, f.name) for f in dataclasses.fields(i)})
              for i in infos]
    return js, ts, infos, tinfos


def _perturbed(params, seed):
    """Every float entry moved 1 ulp up or down at random."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x)
        if not np.issubdtype(x.dtype, np.floating):
            return x
        way = np.where(rng.uniform(size=x.shape) < 0.5, -np.inf, np.inf).astype(x.dtype)
        return jnp.asarray(np.nextafter(x, way))

    return jax.tree.map(one, params)


class Lockstep:
    """A JAX PoseTrainer, the port's, and a JAX control from weights 1 ulp
    away, trained from iteration 0 on the JAX trainer's ray draws.

    ``seed`` seeds as the accuracy experiment does: DINO key ``seed``, the
    id module's ``seed + 1``, the trainers' ``seed``."""

    def __init__(self, scene, cfg_kw, seed=1):
        js, ts, self.infos, self.tinfos = scene
        jd = jdino.init_params(jax.random.key(seed), embed_dim=64, depth=2)
        ji = jmod.init_id_module(jax.random.key(seed + 1), feature_dim=64)
        self.jd, self.td = jd, weights.dino_from_numpy(jax.tree.map(np.asarray, jd),
                                                       device="cpu")
        tm = weights.id_module_from_numpy(jax.tree.map(np.asarray, ji), device="cpu")
        self.jt = jtr.PoseTrainer(jd, ji, js, self.infos, JCfg(**cfg_kw), seed=seed)
        self.tt = ttr.PoseTrainer(self.td, tm, ts, self.tinfos, TCfg(**cfg_kw), seed=seed,
                                  device="cpu")
        self.ct = jtr.PoseTrainer(jd, _perturbed(ji, seed), js, self.infos, JCfg(**cfg_kw),
                                  seed=seed)
        # the frozen backbone's features are an input: the JAX trainer's,
        # so that what drifts is the trainer (the port's own DINO features
        # differ by ~4e-6, which the camera-up head's ReLUs amplify)
        self.tt._feat_cache = tuple(_t(x) for x in self.jt._feat_cache)
        draws = {"port": collections.deque(), "control": collections.deque()}
        regen = self.jt._regen_rays

        def jax_regen():
            regen()
            for q in draws.values():
                q.append(self.jt.rays)

        def port_regen():
            self.tt.rays = TRays(*[_t(x) for x in draws["port"].popleft()])

        def control_regen():
            self.ct.rays = draws["control"].popleft()

        self.jt._regen_rays, self.tt._regen_rays = jax_regen, port_regen
        self.ct._regen_rays = control_regen
        # the evaluation rays: the tool's draw before training
        for tr in (self.jt, self.tt, self.ct):
            tr._regen_rays()
        self.rays = (self.jt.rays, self.tt.rays)
        self.up = (jnp.asarray(jtr.model_up_from_cameras(self.infos)),
                   _t(ttr.model_up_from_cameras(self.tinfos)))
        self.it = 0

    def step(self, n):
        """``n`` more steps on each side: per-step losses {jax, port,
        control}."""
        losses = {}
        for key, tr in (("jax", self.jt), ("port", self.tt), ("control", self.ct)):
            got = losses[key] = []
            tr.run(n_iterations=self.it + n, start_iteration=self.it, validate_every=0,
                   log_every=1, callback=lambda it, aux, _, got=got: got.append(
                       float(aux["loss"])))
        self.it += n
        return losses

    def drift(self):
        """Relative RMS difference of each parameter from the JAX
        trainer's: {"port": {name: x}, "control": {name: x}}."""
        jp = _flat_jax(self.jt.id_params)
        out = {"port": _flat_port(self.tt.id_module), "control": _flat_jax(self.ct.id_params)}
        return {side: {k: _rms(p[k] - jp[k]) / max(_rms(jp[k]), 1e-30) for k in jp}
                for side, p in out.items()}

    def evaluate(self):
        """t_err, a_err, recall@100 from predicted scores on the ring, each
        side on the evaluation rays: {"jax": [...], "port": [...]}."""
        _, t1, a1, _, r1, _ = jev.test_pose_estimation(
            self.infos, self.jd, self.jt.id_params, self.rays[0], self.up[0])
        _, t2, a2, _, r2, _ = tev.test_pose_estimation(
            self.tinfos, self.td, self.tt.id_module, self.rays[1], self.up[1])
        return {"jax": [float(t1), float(a1), float(r1)],
                "port": [float(t2), float(a2), float(r2)]}


def _zero_grad_bound(lock, name, steps):
    rms = _rms(_flat_jax(lock.jt.id_params)[name])
    return 2 * steps * 1e-2 * max(rms, 1e-3) * 1.1


# each parameter's drift from JAX within CONTROL_FACTOR x the control's
# largest drift plus DRIFT_FLOOR (float32 noise of a parameter that has
# barely moved)
CONTROL_FACTOR, DRIFT_FLOOR = 4.0, 1e-5


def _check_drift(lock, steps):
    d = lock.drift()
    limit = CONTROL_FACTOR * max(v for k, v in d["control"].items()
                                 if k not in ZERO_GRAD_PARAMS) + DRIFT_FLOOR
    tp, jp = _flat_port(lock.tt.id_module), _flat_jax(lock.jt.id_params)
    for k, v in d["port"].items():
        if k in ZERO_GRAD_PARAMS:
            assert _rms(tp[k] - jp[k]) <= _zero_grad_bound(lock, k, steps), k
        else:
            assert v <= limit, (k, v, limit)
    return d


class TestIdModuleLockstep:
    def test_25_steps_across_renewals(self, tool_scene):
        """25 steps from iteration 0 (renewals at 0, 10 and 20) at small
        widths: every step's loss to 1e-3 relative, and every parameter
        within the control's drift (CONTROL_FACTOR)."""
        lock = Lockstep(tool_scene, SMALL_CFG, seed=1)
        losses = lock.step(25)
        assert len(losses["port"]) == len(losses["jax"]) == 25
        np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-3)
        # renewals at 0, 10, 20 consumed every draw but the evaluation one
        assert lock.jt.rays is not lock.rays[0]
        np.testing.assert_array_equal(lock.tt.rays.ori.numpy(), np.asarray(lock.jt.rays.ori))
        _check_drift(lock, 25)


@pytest.mark.slow
def test_lockstep_600(tool_scene):
    """The accuracy experiment's trainer, 600 steps in lock step: every
    100 steps the loss, t_err, a_err and recall@100 on both sides and the
    drift of each parameter against the control's."""
    lock = Lockstep(tool_scene, TOOL_CFG, seed=1)
    for _ in range(6):
        losses = lock.step(100)
        d = lock.drift()
        ev = lock.evaluate()
        row = {"it": lock.it, "loss": [losses["jax"][-1], losses["port"][-1]],
               "t_a_recall": ev,
               "drift_max": {s: max(v for k, v in d[s].items() if k not in ZERO_GRAD_PARAMS)
                             for s in d}}
        print("[lockstep] " + json.dumps(row), flush=True)
        _check_drift(lock, lock.it)



def _tool_trajectory(side, seed, iterations=600, every=100):
    """The accuracy experiment as each package's tool runs it, from its own
    random weights and renders (JAX keys or CPU torch generators, seeded
    ``seed``, ``seed + 1`` and ``seed``): t_err, a_err and recall@100 from
    predicted scores every ``every`` steps."""
    if side == "jax":
        scene = make_gt_scene()
        infos = make_camera_infos(scene)
        dino_p = jdino.init_params(jax.random.key(seed), embed_dim=64, depth=2)
        tr = jtr.PoseTrainer(dino_p, jmod.init_id_module(jax.random.key(seed + 1),
                                                         feature_dim=64),
                             scene, infos, JCfg(**TOOL_CFG), seed=seed)
        up = jnp.asarray(jtr.model_up_from_cameras(infos))
        run_eval, params = jev.test_pose_estimation, lambda: tr.id_params
    else:
        from sixdgs_torch.pose import dino as tdino
        from sixdgs_torch.pose.modules import init_id_module
        from sixdgs_torch.tools import pose_accuracy_experiment as tool

        scene = tool.make_gt_scene(device="cpu")
        infos = tool.make_camera_infos(scene)
        dino_p = tdino.init_params(torch.Generator().manual_seed(seed), embed_dim=64,
                                   depth=2, device="cpu")
        tr = ttr.PoseTrainer(dino_p, init_id_module(torch.Generator().manual_seed(seed + 1),
                                                    feature_dim=64, device="cpu"),
                             scene, infos, TCfg(**TOOL_CFG), seed=seed, device="cpu")
        up = _t(ttr.model_up_from_cameras(infos))
        run_eval, params = tev.test_pose_estimation, lambda: tr.id_module
    tr._regen_rays()
    rays, out = tr.rays, []
    for it in range(0, iterations, every):
        tr.run(n_iterations=it + every, start_iteration=it, validate_every=0)
        _, t_err, a_err, _, recall, _ = run_eval(infos, dino_p, params(), rays, up)
        out.append([float(t_err), float(a_err), float(recall)])
    return out


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seed_spread(seed):
    """The accuracy experiment at 600 steps on each side from its own
    seeds: prints both trajectories, so that the port's a_err is read
    against the JAX package's spread over seeds, not one run."""
    rows = {side: _tool_trajectory(side, seed) for side in ("jax", "port")}
    print("[seeds] " + json.dumps({"seed": seed, **rows}), flush=True)
    for side, traj in rows.items():
        assert all(np.isfinite(v).all() for v in traj), side

class TestGSTrainerDepth:
    def test_sh_step_and_two_densifications(self, dataset):  # noqa: F811
        """Both trainers from one point cloud and seed on the golden
        rasterizer, resumed at iteration 997 so that one run crosses the SH
        degree step at 1,000 and densifications at 1,002 and 1,008: the
        same camera order, the SH degree, the loss to 1e-4 relative before
        the first densification and 2e-2 after it, and the Gaussian count
        within 3 after each (test_torch_gs_training.py's limits: Adam's
        sign-flip noise can turn into a few different clones)."""
        opt_kw = dict(iterations=1008, densify_from_iter=500, densification_interval=6,
                      densify_until_iter=2000, densify_grad_threshold=1e-5)
        jt, tt = _trainers(dataset, opt_kw)
        logs = {"jax": [], "port": []}
        orders = {"jax": [], "port": []}
        for key, tr in (("jax", jt), ("port", tt)):
            tr.run(iterations=1008, first_iteration=997, log_every=1, chunk=64,
                   rasterizer="scan",
                   callback=lambda it, m, t, log=logs[key]: log.append(
                       (it, float(m["loss"]), int(t.state.scene.num_active()),
                        t.active_sh_degree)),
                   pre_step=lambda it, t, order=orders[key]: order.append(
                       [c.image_name for c in t._viewpoint_stack]))
        assert orders["port"] == orders["jax"]
        assert [x[0] for x in logs["port"]] == list(range(997, 1009))
        for (it, tl, tn, tsh), (_, jl, jn, jsh) in zip(logs["port"], logs["jax"]):
            assert tsh == jsh == (1 if it >= 1000 else 0), it
            np.testing.assert_allclose(tl, jl, rtol=1e-4 if it <= 1002 else 2e-2,
                                       err_msg=f"iteration {it}")
            assert abs(tn - jn) <= 3, (it, tn, jn)
        # the callback runs before each event: 150 points up to 1,002, more
        # after the densification there and at 1,008
        counts = [x[2] for x in logs["port"]]
        assert counts[:6] == [150] * 6 and counts[6] > 150
        n_t, n_j = int(tt.state.scene.num_active()), int(jt.state.scene.num_active())
        assert n_t > counts[-1] and abs(n_t - n_j) <= 3
        # the SH step opened band 1 of features_rest on both sides, nothing above
        for tr, rest in ((tt, tt.state.scene.features_rest.numpy()),
                         (jt, np.asarray(jt.state.scene.features_rest))):
            live = rest[: int(np.asarray(tr.state.scene.num_active()))]
            assert np.abs(live[:, :3]).max() > 0 and not live[:, 3:].any()



# create_from_pcd and two densifications (a clone, a split and a prune
# each) on the CPU; prints a hash of every array of the state
HOST_SCRIPT = r"""
import hashlib
import numpy as np
import torch
from sixdgs_torch.scene.gaussians import create_from_pcd
from sixdgs_torch.scene.structures import BasicPointCloud
from sixdgs_torch.train import gs_trainer as gs

rng = np.random.default_rng(0)
n = 2000
pcd = BasicPointCloud(rng.normal(size=(n, 3)) * 0.5, rng.uniform(size=(n, 3)),
                      np.zeros((n, 3)))
state = gs.init_train_state(create_from_pcd(pcd, 3, capacity=4096, device="cpu"))
for event in range(2):
    cap = state.scene.capacity
    sc = state.scene
    def draw(x):
        return torch.tensor(x.astype(np.float32))

    params = dict(sc.params(), opacity=draw(rng.uniform(-7, 3, (cap, 1))),
                  scaling=sc.scaling + draw(rng.uniform(-1, 1, (cap, 3))),
                  rotation=draw(rng.normal(size=(cap, 4))))
    state.scene = sc.with_params(params)
    state.xyz_grad_accum = torch.tensor(rng.uniform(0, 4e-4, cap).astype(np.float32))
    state.denom = torch.ones(cap)
    state.max_radii2d = torch.tensor(rng.integers(0, 30, cap).astype(np.int32))
    state = gs.densify_event(state, max_grad=2e-4, min_opacity=0.005, extent=4.0,
                             max_screen_size=20, percent_dense=0.01,
                             rng=np.random.default_rng(event), capacity_bucket=1024)
h = hashlib.sha256()
for t in [*state.scene.params().values(), state.scene.active, *state.adam.m.values()]:
    h.update(t.numpy().tobytes())
print(int(state.scene.num_active()), h.hexdigest())
"""


class TestHostIndependence:
    def test_init_and_densify_whatever_the_simd_level(self):
        """The state after create_from_pcd and two densifications is the
        same bytes under numpy's and ATen's widest SIMD kernels and under
        none: numpy's float32 exp and log round differently from one SIMD
        level to another, so the port takes them in float64 and rounds
        once (ops/transforms.py exp32, log32)."""
        import numpy._core._multiarray_umath as um

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        plain = {"NPY_DISABLE_CPU_FEATURES": " ".join(
            f for f in um.__cpu_dispatch__ if um.__cpu_features__.get(f)),
            "ATEN_CPU_CAPABILITY": "default"}
        got = []
        for extra in ({}, plain):
            env = {k: v for k, v in os.environ.items()
                   if k not in ("NPY_DISABLE_CPU_FEATURES", "ATEN_CPU_CAPABILITY")}
            env.update(extra, PYTHONPATH=root)
            out = subprocess.run([sys.executable, "-c", HOST_SCRIPT], env=env, cwd=root,
                                 capture_output=True, text=True, timeout=300)
            assert out.returncode == 0, out.stderr
            got.append(out.stdout.split())
        n_active = int(got[0][0])
        assert 2000 < n_active < 8000  # the events cloned, split and pruned
        assert got[0] == got[1]
