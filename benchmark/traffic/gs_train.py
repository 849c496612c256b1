"""Traffic kind ``gs_train``: 3DGS training of one scene resumed past
densification.

``sixdgs_torch.train.gs_trainer.GSTrainer.run`` as the published
train.py runs it after ``densify_until_iter``: one random training camera
a step (without replacement, as ``run`` draws them), render, the 0.8 L1 +
0.2 (1 - SSIM) loss, backward, Adam on every Gaussian. The scene is drawn
from the seed at the configuration's size (its ``gaussians`` group): an
object cloud at the centre and a background shell beyond the cameras, a
small share of large Gaussians, SH degree 3; Adam's two moments are drawn
at the configuration's gradient scale, and the trainer resumes at
``resume_iteration`` with SH degree 3 active, through its public state
(``GSTrainer.state``, ``active_sh_degree``). The cameras stand on a ring
(``inputs.ring_c2w``) with uint8 photographs from the seed, every
``test_every``-th held out.

``run`` runs at the traffic's ``log_every`` and ``adapt_every`` (the
``train_gs`` app's 50 and ``run``'s 500 in ``gs_train_bicycle``): its
callback reads the metrics of every ``log_every``-th step, and it adapts
its compact-pair budget and binning tiers after every ``adapt_every``-th.
Steps are counted through ``train_step`` (every call ``run`` makes is
observed: camera, tiers, pair budget, and the step's dropped-gradient flag
where the step computed telemetry), and a call is ended before a step by
``run``'s ``pre_step``. A call's first steps whose raster gradients were
dropped, at most ``prologue_max`` of them, are untimed (each is read,
which waits for the device); ``gs_train_bicycle`` allows none. Set-up
runs ``warmup_steps`` steps; each window continues the iterations in a
call of its own. ``gs_step_ms`` is the window's wall time over the steps
it ran.

The photographs' count, size and test split are the configuration's
``dataset``. Parameters (the traffic file): ``ring_radius``,
``ring_height``, ``fov`` (horizontal, radians), ``log_every``,
``adapt_every``, ``prologue_max``, ``warmup_steps``, ``check_steps``,
``trace_seconds``.

``correct``: once the window has closed, ``run`` takes one more call; for
each of its first ``check_steps`` steps after its prologue the plain
reference (``reference/gaussians.py``) repeats the step from the
program's state before it (parameters, Adam's moments and count), on the
same camera and photograph, at the tiers ``run`` passed: ``render_gap``
(the largest pixel gap of the rendered image), ``loss_gap`` (relative),
``grad_gap`` (the worst leaf's gap of gradient norms, as Adam got them,
over the larger of that leaf's and the median leaf's reference norm),
``grad_diff`` (the worst leaf's norm of the gradients' difference over
that leaf's reference norm), ``change_gap`` and ``change_diff`` (the same
two of the parameters' change after the Adam step); the largest over the
checked steps. ``grad_diff`` and the change numbers leave out a leaf
whose reference gradient norm is under a thousandth of the median leaf's:
Adam moves it by round-off. ``dropped_steps``: steps of the windows that computed telemetry
and whose raster gradients the program dropped (its
``binning_grad_dropped``); at ``log_every`` 50 one step in 50 is read.
``work_gap``: the ``train_step`` calls against the iterations the calls
ran (exact, limit 0). The reference follows the program's own state,
which only the program reaches after hundreds of steps; the window between
is held by ``dropped_steps``, ``work_gap`` and every logged loss being
finite.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.counts import gs as counts
from benchmark.reference import gaussians as ref

GS = "sixdgs_torch.train.gs_trainer."
PT = "sixdgs_torch.ops.rasterizer.pallas_tiles."
SPANS = tuple(GS + n for n in ("train_step", "_render_params", "dssim_l1_loss", "adam_update",
                               "binning_saturation")) + tuple(
    PT + n for n in ("_compact_layout", "_align_compact", "_gather_records",
                     "pallas_composite_fwd", "pallas_composite_bwd"))


class _Stop(Exception):
    """Ends a call of ``run`` from its callback."""


def scene_leaves(cfg, gen, device):
    """The scene's leaves, every Gaussian live: a share ``object_share`` in
    a cloud at the centre (per-axis std ``object_std``), the rest on a
    background shell (radius ``background_radius``, height std
    ``background_height_std``); per-axis log-scales uniform in the
    object's or the background's range, a share ``large_share`` in
    ``large_log_scale``."""
    g = cfg["gaussians"]
    n, coeffs = g["count"], (cfg["model"]["sh_degree"] + 1) ** 2
    u = torch.rand(n, 10, generator=gen, device=device)
    z = torch.randn(n, 4 + 3 * coeffs + 4, generator=gen, device=device)
    obj = torch.arange(n, device=device) < round(n * g["object_share"])

    def between(lo_hi, x):
        return lo_hi[0] + (lo_hi[1] - lo_hi[0]) * x

    ang = 2 * math.pi * u[:, 0]
    rad = between(g["background_radius"], u[:, 1])
    shell = torch.stack([rad * torch.cos(ang), g["background_height_std"] * z[:, 0],
                         rad * torch.sin(ang)], 1)
    cloud = z[:, 1:4] * torch.tensor(g["object_std"], device=device)
    xyz = torch.where(obj[:, None], cloud, shell)

    scale = torch.where(obj[:, None], between(g["object_log_scale"], u[:, 2:5]),
                        between(g["background_log_scale"], u[:, 2:5]))
    large = u[:, 5] < g["large_share"]
    scale = torch.where(large[:, None], between(g["large_log_scale"], u[:, 6:9]), scale)
    sh = z[:, 4:4 + 3 * coeffs].reshape(n, coeffs, 3)
    return {"xyz": xyz.contiguous(),
            "features_dc": (g["sh_dc_std"] * sh[:, :1]).contiguous(),
            "features_rest": (g["sh_rest_std"] * sh[:, 1:]).contiguous(),
            "opacity": between(g["opacity_logit"], u[:, 9:10]).contiguous(),
            "scaling": scale.contiguous(),
            "rotation": z[:, 4 + 3 * coeffs:].contiguous()}


def adam_moments(cfg, leaves, gen, device):
    """Adam's moments at ``resume_iteration``: per leaf, v = s^2 (0.5 + U)
    and m = 0.1 s N(0, 1), s the leaf's ``adam_grad_rms``."""
    rms = cfg["gaussians"]["adam_grad_rms"]
    m, v = {}, {}
    for k, x in leaves.items():
        m[k] = 0.1 * rms[k] * torch.randn(x.shape, generator=gen, device=device)
        v[k] = rms[k] ** 2 * (0.5 + torch.rand(x.shape, generator=gen, device=device))
    return m, v


def _images(n, height, width, gen, device):
    """n uint8 photographs from the seed as [3, H, W] float32 host arrays
    in [0, 1], drawn on the device one at a time."""
    out = []
    for _ in range(n):
        x = torch.randint(0, 256, (3, height, width), generator=gen, device=device,
                          dtype=torch.uint8)
        out.append((x.to(torch.float32) / 255.0).cpu().numpy())
    return out


def reference_camera(c2w, fov_x, fov_y, device):
    """The camera's matrices as the published rasterizer takes them:
    world->view, projection @ view (z in [0.01, 100]), centre, tan(fov/2)."""
    R = c2w[:3, :3].astype(np.float64)
    view = np.eye(4)
    view[:3, :3], view[:3, 3] = R.T, -R.T @ c2w[:3, 3].astype(np.float64)
    tx, ty = math.tan(fov_x / 2), math.tan(fov_y / 2)
    n, f = 0.01, 100.0
    P = np.zeros((4, 4))
    P[0, 0], P[1, 1] = 1.0 / tx, 1.0 / ty
    P[2, 2], P[2, 3], P[3, 2] = f / (f - n), -(f * n) / (f - n), 1.0
    view32 = view.astype(np.float32)
    return {"view": torch.tensor(view32, device=device),
            "full_proj": torch.tensor((P @ view32.astype(np.float64)).astype(np.float32),
                                      device=device),
            "campos": torch.tensor(c2w[:3, 3], dtype=torch.float32, device=device),
            "tan_fovx": tx, "tan_fovy": ty}


class CameraWork(dict):
    """The work the traced steps' cameras need (``counts.gs``), measured on
    first use by a reader, after the window: empty until ``fill()``."""

    def __init__(self, job, steps):
        super().__init__()
        self._job, self._steps = job, steps

    def fill(self):
        if not self and self._steps and self._job.trainer is not None:
            self.update(self._job.camera_work(self._steps))
        return self


class Job:
    def __init__(self, ctx):
        from sixdgs_torch.scene.cameras import make_synthetic_camera
        from sixdgs_torch.scene.gaussians import GaussianScene
        from sixdgs_torch.scene.structures import BasicPointCloud, SceneInfo
        from sixdgs_torch.train import gs_trainer as gt
        from sixdgs_torch.train.optim import AdamState
        from sixdgs_torch.utils.config import ModelConfig, OptimizationConfig

        cfg, tr, dev, gen = ctx.config, ctx.traffic, ctx.device, ctx.generator
        self.ctx, self.gt = ctx, gt
        leaves = scene_leaves(cfg, gen, dev)
        m0, v0 = adam_moments(cfg, leaves, gen, dev)
        ds = cfg["dataset"]
        n, h, w = ds["images"], ds["height"], ds["width"]
        self.c2w = inputs.ring_c2w(n, tr["ring_radius"], tr["ring_height"])
        self.fov_x = tr["fov"]
        self.fov_y = 2 * math.atan(math.tan(self.fov_x / 2) * h / w)
        self.images = _images(n, h, w, gen, dev)
        self.trainer_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=dev))
        cams = []
        for i in range(n):
            R = self.c2w[i, :3, :3].astype(np.float64)
            T = -R.T @ self.c2w[i, :3, 3].astype(np.float64)
            cams.append(make_synthetic_camera(w, h, self.fov_x, self.fov_y, R, T,
                                              image=self.images[i], uid=i, name=f"cam{i:03d}"))
        self.train_ids = [i for i in range(n) if i % ds["test_every"]]
        train = [cams[i] for i in self.train_ids]
        test = [cams[i] for i in range(n) if i % ds["test_every"] == 0]
        centres = self.c2w[:, :3, 3][self.train_ids]
        self.extent = 1.1 * float(np.linalg.norm(centres - centres.mean(0), axis=1).max())
        pts = leaves["xyz"][:16].detach().cpu().numpy().astype(np.float64)
        info = SceneInfo(point_cloud=BasicPointCloud(points=pts, colors=np.full_like(pts, 0.5),
                                                     normals=np.zeros_like(pts)),
                         train_cameras=[], test_cameras=[], ply_path="",
                         nerf_normalization={"translate": np.zeros(3), "radius": self.extent})
        self.trainer = gt.GSTrainer(ModelConfig(sh_degree=cfg["model"]["sh_degree"]),
                                    OptimizationConfig(**cfg["optimization"]), info, train, test,
                                    seed=self.trainer_seed, device=dev)
        self.count = count = leaves["xyz"].shape[0]
        self.trainer.state = gt.GSTrainState(
            scene=GaussianScene(active=torch.ones(count, dtype=torch.bool, device=dev),
                                max_sh_degree=cfg["model"]["sh_degree"], **leaves),
            adam=AdamState(m=m0, v=v0, step=torch.tensor(
                cfg["resume_iteration"] - 1, dtype=torch.int32, device=dev)),
            xyz_grad_accum=torch.zeros(count, device=dev),
            denom=torch.zeros(count, device=dev),
            max_radii2d=torch.zeros(count, dtype=torch.int32, device=dev))
        self.trainer.active_sh_degree = cfg["model"]["sh_degree"]
        # every training photograph staged once, as a run past its first epoch holds them
        self.arrays = {id(self.trainer._camera_arrays(c)): i for c, i in zip(train, self.train_ids)}
        self.calls, self.flags = [], []
        self._train_step = gt.train_step
        gt.train_step = self._observed

        self.iteration = cfg["resume_iteration"]
        self.dropped = self.work_gap = 0
        self.captured = self.traced_work = self.at = None
        warm = self._call(self.iteration, lambda n: n >= tr["warmup_steps"])
        self.setup_counts = {"gaussians": count, "train_views": len(train),
                             "test_views": len(test), "extent": self.extent,
                             "warmup_iterations": [warm["first"], warm["last"]],
                             "warmup_demand": warm["demand"], "prologue": warm["prologue"],
                             "warmup_dropped": warm["dropped"],
                             "budgets": sorted({(c[1], c[2]) for c in self.calls}, key=str)}

    # ------------------------------------------------------------ program

    def _observed(self, state, cam, *a, **k):
        """``train_step`` as ``run`` calls it: which camera, tiers and pair
        budget each step had, its dropped-gradient flag where it computed
        telemetry (a 0-d tensor, read once its call has ended) and, while a
        check runs, what it produced."""
        out = self._train_step(state, cam, *a, **k)
        self.calls.append((self.arrays.get(id(cam)), tuple(k.get("tiers", ())),
                           int(k.get("nc_pairs", 0))))
        self.flags.append(out[1].get("binning_grad_dropped"))
        if self.captured is not None:
            self.captured.append({"state": state, "out": out[0], "loss": float(out[1]["loss"]),
                                  "camera": self.calls[-1][0], "tiers": self.calls[-1][1],
                                  "sh_degree": k["sh_degree"], "iteration": self.at})
        return out

    def _dropped(self, i):
        flag = self.flags[i]
        return flag is not None and float(flag) > 0

    def _call(self, first, stop, timed=None):
        """One call of ``run`` from iteration ``first``. Its first steps
        whose gradients were dropped, up to ``prologue_max``, are untimed;
        then, before each step, ``stop(steps)`` or the window's time ends
        the call."""
        cap = self.ctx.traffic["prologue_max"]
        rec = {"first": first, "last": first - 1, "iterations": 0, "steps": 0, "start": None,
               "prologue": 0, "from": len(self.calls), "demand": [], "losses": []}

        def pre_step(it, trainer):
            done = len(self.calls) - rec["from"]
            if rec["start"] is None:
                if self.captured:  # an untimed step is not checked: free its states
                    self.captured.clear()
                if done < cap and (done == 0 or self._dropped(len(self.calls) - 1)):
                    rec["prologue"] = done + 1
                else:
                    self.ctx.sync()
                    rec["start"] = time.perf_counter()
                    rec["prologue"] = done
            else:
                rec["steps"] = done - rec["prologue"]
                if rec["steps"] and (stop(rec["steps"]) or (
                        timed and time.perf_counter() - rec["start"] >= timed)):
                    raise _Stop
            self.at = rec["last"] = it
            rec["iterations"] += 1

        def callback(it, metrics, trainer):
            rec["demand"].append(int(metrics.get("binning_nc_demand", 0)))
            rec["losses"].append(metrics["loss"])

        tr = self.ctx.traffic
        with contextlib.redirect_stdout(sys.stderr):
            try:
                self.trainer.run(iterations=self.trainer.opt.iterations, first_iteration=first,
                                 callback=callback, pre_step=pre_step, rasterizer="auto",
                                 log_every=tr["log_every"], adapt_tiers_every=tr["adapt_every"])
            except _Stop:
                pass
        self.ctx.sync()
        rec["end"] = time.perf_counter()
        calls = len(self.calls) - rec["from"]
        rec["steps"] = calls - rec["prologue"]
        rec["work_gap"] = abs(calls - rec["iterations"])
        timed_from = rec["from"] + rec["prologue"]
        rec["dropped"] = sum(self._dropped(i) for i in range(timed_from, len(self.calls)))
        rec["read"] = sum(f is not None for f in self.flags[timed_from:])
        self.iteration = rec["last"] + 1
        return rec

    def window(self, seconds):
        rec = self._call(self.iteration, lambda n: False, timed=max(seconds, 1e-9))
        steps, prologue = rec["steps"], rec["prologue"]
        self.work_gap += rec["work_gap"]
        self.dropped += rec["dropped"]
        failed = sum(1 for x in rec["losses"] if not math.isfinite(x))
        wall = rec["end"] - rec["start"]
        traced = self.calls[len(self.calls) - steps:]
        self.traced_work = CameraWork(self, traced)
        work = {"steps": steps, "prologue": prologue, "dropped": rec["dropped"],
                "camera_work": self.traced_work}
        return {"values": {"gs_step_ms": wall / max(steps, 1) * 1e3},
                "attempted": steps, "failed": failed, "seconds": wall, "work": work,
                "iterations": [rec["first"], rec["last"]], "work_gap": rec["work_gap"],
                "dropped_read": [rec["dropped"], rec["read"]],
                "budgets": sorted({c[2] for c in traced}), "logged_demand": rec["demand"]}

    def camera_work(self, steps):
        """Per-call bounds of B3, B4 and B5 and a step's counted flops,
        averaged over ``steps`` [(camera, tiers, nc_pairs)], measured on
        the trainer's state now."""
        cfg, ds = self.ctx.config, self.ctx.config["dataset"]
        params = self.trainer.state.scene.params()
        per = {}
        for cam, tiers, nc_pairs in steps:
            key = (cam, tiers)
            if key not in per:
                per[key] = counts.camera_work(params, self._ref_camera(cam), ds["width"],
                                              ds["height"], cfg["model"]["sh_degree"], tiers)
        return counts.step_bounds([(per[(c, t)], t, nc) for c, t, nc in steps],
                                  self.count, ds["width"], ds["height"])

    def _ref_camera(self, i):
        return reference_camera(self.c2w[i], self.fov_x, self.fov_y, self.ctx.device)

    def outputs(self):
        """One more call of ``run``: its untimed first steps, then
        ``check_steps`` steps kept for the reference."""
        gt = self.gt
        keep = {}

        def render_params(*a, **k):
            out = render(*a, **k)
            keep["image"] = out[0].detach().clone()
            return out

        def adam_update(params, grads, state, lrs):
            keep["grads"] = {k: g.detach().clone() for k, g in grads.items()}
            return update(params, grads, state, lrs)

        def observed(*a, **k):
            out = step(*a, **k)
            self.captured[-1].update(image=keep.pop("image"), grads=keep.pop("grads"))
            return out

        render, update, step = gt._render_params, gt.adam_update, gt.train_step
        self.captured = []
        gt._render_params, gt.adam_update, gt.train_step = render_params, adam_update, observed
        try:
            rec = self._call(self.iteration, lambda n: n >= self.ctx.traffic["check_steps"])
            steps = self.captured
        finally:
            gt._render_params, gt.adam_update, gt.train_step = render, update, step
            self.captured = None
        self.work_gap += rec["work_gap"]
        return {"steps": steps, "dropped": self.dropped, "work_gap": self.work_gap,
                "prologue": rec["prologue"]}

    def release(self):
        self.gt.train_step = self._train_step
        self.trainer = None
        if self.traced_work is not None:  # it holds the job: no cycle past the readers
            self.traced_work = dict(self.traced_work)

    # ------------------------------------------------------------ reference

    def _reference_step(self, step, dt, dtype=torch.float32):
        cfg, ds, dev = self.ctx.config, self.ctx.config["dataset"], self.ctx.device
        st = step["state"]

        def cast(tree):
            return {k: x.to(dtype) if torch.is_tensor(x) else x for k, x in tree.items()}

        gt_image = torch.tensor(self.images[step["camera"]], device=dev, dtype=dtype)
        lrs = ref.learning_rates(step["iteration"], self.extent, cfg["optimization"])
        return ref.train_step(cast(st.scene.params()), cast(st.adam.m), cast(st.adam.v),
                              int(st.adam.step) + 1, cast(self._ref_camera(step["camera"])),
                              gt_image, ds["width"], ds["height"], step["sh_degree"],
                              step["tiers"], lrs, torch.zeros(3, device=dev, dtype=dtype),
                              cfg["optimization"]["lambda_dssim"], dt)

    @staticmethod
    def _norm_gaps(got, want, kept):
        med = float(np.median([want[k] for k in kept]))
        return {k: abs(got[k] - want[k]) / max(want[k], med) for k in kept}

    def judge(self, out):
        self.last_outputs = out
        names = ("render_gap", "loss_gap", "grad_gap", "grad_diff", "change_gap", "change_diff")
        gaps = dict.fromkeys(names, 0.0)
        look = []
        for step in out["steps"]:
            r = self._reference_step(step, None)
            before = step["state"].scene.params()
            after = step["out"].scene.params()
            g_ref = {k: float(g.double().norm()) for k, g in r["grads"].items()}
            g_got = {k: float(step["grads"][k].double().norm()) for k in g_ref}
            med = float(np.median(list(g_ref.values())))
            kept = [k for k in g_ref if g_ref[k] >= 1e-3 * med]
            c_ref = {k: float((r["params"][k] - before[k]).double().norm()) for k in ref.PARAMS}
            c_got = {k: float((after[k] - before[k]).double().norm()) for k in ref.PARAMS}
            g_diff = {k: float((step["grads"][k] - r["grads"][k]).double().norm()) / g_ref[k]
                      for k in kept}
            c_diff = {k: float((after[k] - r["params"][k]).double().norm()) / c_ref[k]
                      for k in kept}
            diff = (step["image"] - r["image"]).abs()
            now = {"render_gap": float(diff.max()),
                   "loss_gap": abs(step["loss"] - r["loss"]) / abs(r["loss"]),
                   "grad_gap": max(self._norm_gaps(g_got, g_ref, list(g_ref)).values()),
                   "grad_diff": max(g_diff.values()),
                   "change_gap": max(self._norm_gaps(c_got, c_ref, kept).values()),
                   "change_diff": max(c_diff.values())}
            gaps = {k: max(gaps[k], v) if v == v else float("nan") for k, v in now.items()}
            look.append({"iteration": step["iteration"], "camera": step["camera"],
                         "render_mean_gap": float(diff.mean()), "grad_diff_leaves": g_diff,
                         "change_diff_leaves": c_diff, "grad_norms": g_ref,
                         "left_out": sorted(set(g_ref) - set(kept)), **now})
        if not out["steps"]:
            gaps = dict.fromkeys(names, float("nan"))
        self.look = {"steps": look, "prologue": out["prologue"],
                     "traced_camera_work": dict(self.traced_work or {})}
        return dict(gaps, dropped_steps=float(out["dropped"]), work_gap=float(out["work_gap"]))
