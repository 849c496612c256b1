"""Traffic kind ``train_job``: the per-scene id-module training job.

``sixdgs_torch.pose.trainer.PoseTrainer.run`` as ``pretrain_single_object``
runs it: backbone features cached, fused scorer, a batch of images a step,
rays renewed every ``renewal_every_n_iterations`` steps, and after every
``val_every_n_iterations`` steps a validation over every train and test
view. The scene's cameras stand on a ring with uint8 photographs from the
seed; every ``test_every``-th is held out for test.

The window covers whole validation periods (the period's steps and the
validation after them): it starts on a period boundary and closes at the
last period end that the longest period so far predicts to fall inside
``--seconds``. The window's work is counted as it runs, not worked out:
steps and renewals through ``run``'s callback (a renewal is a new
``trainer.rays``), validations around ``PoseTrainer.validate``, evaluated
views by the per-view results ``test_pose_estimation`` returns.
``step_ms`` is the window's wall time over its counted steps.

Parameters (the traffic file): ``cameras``, ``test_every``, ``height``,
``width``, ``ring_radius``, ``ring_height``, ``fov``, ``check_steps``,
``warmup_evals``, ``check_views``, ``trace_seconds`` (a traced run holds
one period).

``correct`` judges the start and the window, each against the plain
reference repeating what the program did from the same weights, images,
batch picks and ray draws:

- the start: set-up drives the trainer through its first ``check_steps``
  steps through ``run`` itself; ``loss_gap`` (the first step's loss,
  relative), ``grad_gap`` (the worst leaf's gap of first-gradient norms,
  read from Adafactor's state after step 1, g^2 + 1e-30, over the larger
  of that leaf's and the median leaf's reference norm), ``change_gap``
  (the median leaf's gap of change norms after the last of those steps)
  and ``rays_unmatched`` (the first renewal);
- the window: at the start of every period the parameters, Adafactor's
  state, the batch-pick generator and the ray generator are snapshot, and
  the last period's first step is kept as the program made it (its loss,
  each leaf's gradient norm from ``.grad``, each leaf's change). The
  reference repeats that step from the snapshot: ``step_loss_gap``,
  ``step_grad_gap`` (worst leaf), ``step_change_gap`` (worst leaf) and
  ``step_rays_unmatched`` (both renewals of the period). ``val_loss_gap``:
  the worst relative gap of the per-view score loss over ``check_views``
  views of the last validation drawn from the seed, the reference scoring
  them with the parameters the window ended on and the rays it re-casts
  from the generator's state before the period's last renewal.
  ``work_gap``: the counted steps, validations, evaluated views and
  renewals against the whole periods the window held (exact, limit 0).

Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adafactor by round-off alone and are left out of the
change gaps. The start's later losses and worst leaf's change swing from
seed to seed (a camera-up ReLU input within rounding of 0 flips and
Adafactor's per-entry normalisation turns the flip into a full step), so
the start holds the median leaf; the window's one step from one state
holds the worst.
"""

from __future__ import annotations

import copy
import math
import time

import numpy as np
import torch

from benchmark import inputs, program
from benchmark.reference import pose_common as ref

SPANS = ("sixdgs_torch.pose.trainer.PoseTrainer.run",
         "sixdgs_torch.pose.trainer.PoseTrainer._sample_batch",
         "sixdgs_torch.pose.trainer.pose_train_step_cached",
         "sixdgs_torch.pose.trainer.batch_loss_cached",
         "sixdgs_torch.pose.evaluate.test_pose_estimation",
         "sixdgs_torch.pose.evaluate.prepare_image_mask",
         "sixdgs_torch.pose.evaluate.eval_image")


def leaf_name(param_name: str) -> str:
    """The program's parameter name -> the 6DGS checkpoint leaf name
    ("ray_mlp.l1.weight" -> "ray_mlp/l1/w")."""
    return param_name.replace(".weight", "/w").replace(".bias", "/b").replace(".", "/")


def as_leaf(p):
    """A program parameter in the checkpoint's layout: ``nn.Linear`` holds
    [out, in], the checkpoint tree [in, out]."""
    return p.T if p.dim() == 2 else p


def as_reference_state(p, st):
    """Program Adafactor state of parameter ``p`` -> the reference's
    (``{"step", "v"}`` or ``{"step", "r", "c"}`` in the checkpoint layout).
    Both factor over the two largest axes; a transposed [out, in] leaf
    reduces the same physical axes, so each reference vector is the program
    vector reduced over the same axis."""
    out = {"step": float(st["step"])}
    if "v" in st:
        out["v"] = as_leaf(st["v"])
        return out
    shape = tuple(as_leaf(p).shape)
    dims = np.argsort(shape)
    d1, d0 = int(dims[-2]), int(dims[-1])
    pd = np.argsort(tuple(p.shape))
    p_d0 = int(pd[-1])

    def program_axis(axis):
        return 1 - axis if p.dim() == 2 else axis

    out["r"] = st["v_row"] if program_axis(d0) == p_d0 else st["v_col"]
    out["c"] = st["v_row"] if program_axis(d1) == p_d0 else st["v_col"]
    return out


def _cameras(tr, gen, device):
    from sixdgs_torch.scene.structures import CameraInfo

    n, h, w = tr["cameras"], tr["height"], tr["width"]
    c2w = inputs.ring_c2w(n, tr["ring_radius"], tr["ring_height"])
    images = inputs.host_images(n, h, w, gen, device, "uint8")
    fov_x = tr["fov"]
    fov_y = 2 * math.atan(math.tan(fov_x / 2) * h / w)
    cams = []
    for i in range(n):
        R = c2w[i, :3, :3].astype(np.float64)
        cams.append(CameraInfo(uid=i, R=R, T=-R.T @ c2w[i, :3, 3].astype(np.float64),
                               FovY=fov_y, FovX=fov_x, image=images[i], image_path="",
                               image_name=f"cam{i:03d}", width=w, height=h))
    test = [c for i, c in enumerate(cams) if i % tr["test_every"] == 0]
    train = [c for i, c in enumerate(cams) if i % tr["test_every"] != 0]
    return train, test


class Tally:
    """Inside one window: counts the work as it runs and keeps what the
    reference repeats (see the module's docstring). ``step`` is ``run``'s
    callback; ``period(it)`` snapshots the trainer at a period's start."""

    def __init__(self, trainer, renew):
        self.trainer, self.renew = trainer, renew
        self.counts = {"steps": 0, "renewals": 0, "validations": 0, "evaluations": 0}
        self.snap = None
        self._undo = []

    def __enter__(self):
        from sixdgs_torch.pose import evaluate

        tr = self.trainer
        self._rays = tr.rays
        validate = tr.validate

        def counted_validate(*a, **k):
            self.counts["validations"] += 1
            self.snap["views"] = []
            return validate(*a, **k)

        tested = evaluate.test_pose_estimation

        def counted_test(cam_infos, *a, **k):
            out = tested(cam_infos, *a, **k)
            self.counts["evaluations"] += len(out[0])
            if self.snap is not None and "views" in self.snap:
                self.snap["views"] += [(info, r["scores_loss"]) for info, r in zip(cam_infos, out[0])]
            return out

        tr.validate = counted_validate
        evaluate.test_pose_estimation = counted_test
        self._undo = [lambda: tr.__dict__.pop("validate", None),
                      lambda: setattr(evaluate, "test_pose_estimation", tested)]
        return self

    def __exit__(self, *exc):
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    def period(self, it):
        tr = self.trainer
        named = list(tr.id_module.named_parameters())
        self.snap = {
            "iteration": it,
            "params": {leaf_name(n): p.detach().clone() for n, p in named},
            "state": {leaf_name(n): {k: v.clone() if torch.is_tensor(v) else v
                                     for k, v in tr.optimizer.state[p].items()}
                      for n, p in named},
            "rng": copy.deepcopy(tr.rng),
            "generators": {it: tr.generator.get_state()}}

    def step(self, it, aux, tr):
        self.counts["steps"] += 1
        if tr.rays is not self._rays:
            self.counts["renewals"] += 1
            self._rays = tr.rays
            self.snap.setdefault("rays", {})[it] = program.as_ray_dict(tr.rays)
        if it == self.snap["iteration"]:
            named = list(tr.id_module.named_parameters())
            self.snap["loss"] = aux["loss"]
            self.snap["grad_norms"] = torch.stack(
                [p.grad.norm() if p.grad is not None else p.new_zeros(()) for _, p in named])
            self.snap["change_norms"] = torch.stack(
                [(p.detach() - self.snap["params"][leaf_name(n)]).norm() for n, p in named])
            self.snap["names"] = [leaf_name(n) for n, _ in named]
        if it % self.renew == self.renew - 1:
            self.snap["generators"][it + 1] = tr.generator.get_state()


class Job:
    def __init__(self, ctx):
        from sixdgs_torch.pose import trainer as tmod

        cfg, tr, dev, gen = ctx.config, ctx.traffic, ctx.device, ctx.generator
        self.ctx = ctx
        self.bweights, self.iweights = inputs.weights(cfg, gen, dev)
        self.scene = inputs.scene(cfg, gen, dev)
        self.train, self.test = _cameras(tr, gen, dev)
        self.trainer_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=dev))
        self.period = cfg["pose"]["val_every_n_iterations"]
        self.renew = cfg["pose"]["renewal_every_n_iterations"]

        self.trainer = tmod.PoseTrainer(
            program.backbone(cfg, self.bweights, dev), program.id_module(self.iweights, dev),
            program.gaussian_scene(cfg, self.scene), self.train, cfg=program.pose_config(cfg),
            seed=self.trainer_seed, cache_features=True, backbone=program.backbone_name(cfg),
            fused_attention=cfg["pose"]["fused_attention"], device=dev)
        self.captured = {"losses": []}
        last = tr["check_steps"] - 1

        def keep(it, aux, trainer):
            self.captured["losses"].append(aux["loss"])
            if it == 0:
                self.captured["rays"] = program.as_ray_dict(trainer.rays)
                self.captured["grad_norms"] = self._grad_norms(trainer)
            if it == last:
                self.captured["change_norms"] = {
                    leaf_name(n): self._change(p.detach(), self.iweights[leaf_name(n)])
                    for n, p in trainer.id_module.named_parameters()}

        self.trainer.run(n_iterations=tr["check_steps"], callback=keep, log_every=1,
                         validate_every=0)
        self.trainer.validate(0, test_cam_infos=self.test, max_images=tr["warmup_evals"])
        self.iteration = self.period
        self.work_gap, self.last = 0, None
        self.setup_counts = {"train_views": len(self.train), "test_views": len(self.test),
                             "warmup_steps": tr["check_steps"],
                             "warmup_evals": 2 * tr["warmup_evals"],
                             "valid_rays": int(self.trainer.rays.valid.sum())}

    @staticmethod
    def _change(p, start):
        return float((as_leaf(p) - start).double().norm())

    @staticmethod
    def _grad_norms(trainer):
        """Each leaf's first gradient norm from Adafactor's state after one
        step: its second moment is then g^2 + eps, whole or as row means."""
        out = {}
        for name, p in trainer.id_module.named_parameters():
            st = trainer.optimizer.state.get(p, {})
            if "v" in st:
                sq = float(st["v"].double().sum()) - p.numel() * 1e-30
            elif "v_row" in st:
                sq = float(st["v_row"].double().sum()) * p.numel() / st["v_row"].numel() \
                    - p.numel() * 1e-30
            else:
                sq = float("nan")
            out[leaf_name(name)] = math.sqrt(max(sq, 0.0)) if sq == sq else sq
        return out

    def window(self, seconds):
        tally = Tally(self.trainer, self.renew)
        periods, longest, walls = 0, 0.0, []
        with tally:
            start = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                tally.period(self.iteration)
                self.trainer.run(n_iterations=self.iteration + self.period,
                                 start_iteration=self.iteration, test_cam_infos=self.test,
                                 validate_every=self.period, callback=tally.step, log_every=1)
                self.ctx.sync()
                self.iteration += self.period
                periods += 1
                now = time.perf_counter()
                walls.append(now - t0)
                longest = max(longest, now - t0)
                if now - start + longest > seconds:
                    break
        work = dict(tally.counts)
        expected = {"steps": periods * self.period, "validations": periods,
                    "evaluations": periods * (len(self.train) + len(self.test)),
                    "renewals": periods * math.ceil(self.period / self.renew)}
        self.work_gap += sum(abs(work[k] - expected[k]) for k in expected)
        self.last = tally.snap
        steps = max(work["steps"], 1)
        failed = 0 if math.isfinite(self.trainer.running_loss) else steps
        return {"values": {"step_ms": (now - start) / steps * 1e3},
                "attempted": work["steps"], "failed": failed, "periods": periods,
                "seconds": now - start, "period_s": walls, "work": work,
                "expected": expected}

    def outputs(self):
        out = dict(self.captured)
        snap = self.last
        out["window"] = {
            "loss": snap["loss"],
            "grad_norms": dict(zip(snap["names"], snap["grad_norms"].tolist())),
            "change_norms": dict(zip(snap["names"], snap["change_norms"].tolist())),
            "rays": dict(snap.get("rays", {})),
            "views": self._sampled_views(snap.get("views", []))}
        out["work_gap"] = self.work_gap
        # the parameters the window ended on, which the last validation scored
        self.end_leaves = {leaf_name(n): as_leaf(p.detach()).clone()
                           for n, p in self.trainer.id_module.named_parameters()}
        return out

    def _sampled_views(self, views):
        """``check_views`` (camera, program score loss) pairs of the last
        validation, drawn from the seed."""
        n = min(self.ctx.traffic["check_views"], len(views))
        pick = np.random.default_rng(self.ctx.seed).choice(len(views), size=n, replace=False)
        return [views[int(i)] for i in sorted(pick)]

    def release(self):
        self.trainer = None

    # ------------------------------------------------------------ reference

    def _features(self, cache, info, dt):
        """Reference backbone features of one camera's photograph (no mask:
        the photographs are RGB), its patch mask, feature map and c2w."""
        backbone, dev = self.ctx.reference, self.ctx.device
        key = info.uid
        if key not in cache:
            img = torch.tensor(info.image, device=dev).to(torch.float32) / 255.0
            with torch.no_grad():
                x, pmask = ref.preprocess(img, torch.ones(img.shape[:2], dtype=torch.bool,
                                                          device=dev), backbone.GRID)
                f = backbone.features(self.bweights, x, dt)
            c2w = torch.tensor(np.linalg.inv(np.concatenate(
                [np.concatenate([info.R.T, info.T[:, None]], 1),
                 [[0, 0, 0, 1]]]).astype(np.float32)), device=dev)
            cache[key] = (torch.cat([f, ref.position_encoding(backbone.GRID, dev)], -1), pmask,
                          f.reshape(backbone.GRID, backbone.GRID, -1).permute(2, 0, 1), c2w)
        return cache[key]

    def _step(self, params, state, rays, picks, cache, dt):
        """One reference step in place on ``params`` (leaves, checkpoint
        layout): (loss, {leaf: gradient norm})."""
        model_up = torch.tensor(np.mean([c.R[:3, 1] for c in self.train], 0),
                                dtype=torch.float32, device=self.ctx.device)
        tree = inputs.nest(params)
        ray_feats = ref.ray_features(tree, rays, dt)
        losses = []
        for i in picks:
            fp, pmask, fmap, c2w = self._features(cache, self.train[int(i)], dt)
            s = ref.ray_scores(tree, fp, ray_feats, pmask, rays["valid"], dt)
            up = ref.cam_up(tree, fmap, dt)
            losses.append(ref.score_loss(s, c2w, rays, pmask.sum())
                          + 0.1 * ref.up_loss(model_up, up))
        losses = torch.stack(losses)
        ok = torch.isfinite(losses)
        total = torch.where(ok, losses, 0.0).sum() / ok.sum().clamp_min(1)
        grads = torch.autograd.grad(total, list(params.values()))
        with torch.no_grad():
            grads = [torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0) for g in grads]
            for (k, p), g in zip(params.items(), grads):
                p.copy_(ref.adafactor(p, g, state[k]))
        return float(total.detach()), {k: float(g.double().norm()) for k, g in zip(params, grads)}

    def _cast(self, generator_state, dt):
        cfg, dev = self.ctx.config, self.ctx.device
        gen = torch.Generator(device=dev)
        gen.set_state(generator_state)
        with torch.no_grad():
            return ref.cast_rays(self.scene, *inputs.ray_draws(cfg, gen, dev), cfg["pose"], dt)

    def reference_steps(self, dt):
        """The reference's first ``check_steps`` steps: the same outputs as
        the start's part of ``outputs()``, with products in ``dt``."""
        cfg, tr, dev = self.ctx.config, self.ctx.traffic, self.ctx.device
        ref.no_tf32()
        gen = torch.Generator(device=dev).manual_seed(self.trainer_seed)
        params = {k: v.detach().clone().requires_grad_(True) for k, v in self.iweights.items()}
        state = {k: {} for k in params}
        rng, cache = np.random.default_rng(self.trainer_seed), {}
        out = {"losses": []}
        for step in range(tr["check_steps"]):
            if step % self.renew == 0:
                with torch.no_grad():
                    rays = ref.cast_rays(self.scene, *inputs.ray_draws(cfg, gen, dev),
                                         cfg["pose"], dt)
                out.setdefault("rays", rays)
            picks = rng.integers(0, len(self.train), size=cfg["pose"]["gradient_accumulation_steps"])
            loss, norms = self._step(params, state, rays, picks, cache, dt)
            out["losses"].append(loss)
            if step == 0:
                out["grad_norms"] = norms
        out["change_norms"] = {k: float((p.detach() - self.iweights[k]).double().norm())
                               for k, p in params.items()}
        return out

    def reference_window(self, dt):
        """The last period's first step repeated from its snapshot, the
        period's renewals re-cast, and the sampled views of the last
        validation scored with the parameters the window ended on: the
        same outputs as ``outputs()["window"]``, with products in ``dt``."""
        cfg = self.ctx.config
        ref.no_tf32()
        snap = self.last
        params = {k: as_leaf(snap["params"][k]).clone().requires_grad_(True)
                  for k in self.iweights}
        state = {}
        for k in params:
            st = snap["state"][k]
            state[k] = as_reference_state(snap["params"][k], st) if st else {}
        out = {"rays": {}}
        for it, gstate in sorted(snap["generators"].items()):
            if it % self.renew == 0 and it < snap["iteration"] + self.period:
                out["rays"][it] = self._cast(gstate, dt)
        picks = copy.deepcopy(snap["rng"]).integers(
            0, len(self.train), size=cfg["pose"]["gradient_accumulation_steps"])
        cache = {}
        start = {k: p.detach().clone() for k, p in params.items()}
        out["loss"], out["grad_norms"] = self._step(params, state, out["rays"][snap["iteration"]],
                                                    picks, cache, dt)
        out["change_norms"] = {k: float((p.detach() - start[k]).double().norm())
                               for k, p in params.items()}
        last_rays = out["rays"][max(out["rays"])]
        tree = inputs.nest(self.end_leaves)
        views = []
        with torch.no_grad():
            ray_feats = ref.ray_features(tree, last_rays, dt)
            for info, _ in self._sampled_views(snap.get("views", [])):
                fp, pmask, _fmap, c2w = self._features(cache, info, dt)
                s = ref.ray_scores(tree, fp, ray_feats, pmask, last_rays["valid"], dt)
                views.append((info, float(ref.score_loss(s, c2w, last_rays, pmask.sum()))))
        out["views"] = views
        return out

    def control_outputs(self, dt=torch.bfloat16):
        out = self.reference_steps(dt)
        out["window"] = self.reference_window(dt)
        out["work_gap"] = self.work_gap
        return out

    @staticmethod
    def _leaf_gaps(got, want, kept):
        """Per leaf: the gap of norms over the larger of the leaf's and the
        median kept leaf's reference norm."""
        med = float(np.median([want[k] for k in kept]))
        return {k: abs(got.get(k, float("nan")) - want[k]) / max(want[k], med) for k in kept}

    @staticmethod
    def _worst(gaps):
        return max(gaps.values(), key=lambda v: float("inf") if v != v else v)

    def judge(self, out):
        want = self.reference_steps(torch.float32)
        unmatched, _ = ref.match_rays(out["rays"], want["rays"])
        g_ref = want["grad_norms"]
        g_med = float(np.median(list(g_ref.values())))
        # leaves whose gradient is nought to rounding move by round-off alone
        kept = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
        changes = self._leaf_gaps(out["change_norms"], want["change_norms"], kept)
        median_change = float("nan") if any(v != v for v in changes.values()) \
            else float(np.median(list(changes.values())))

        got, w = out["window"], self.reference_window(torch.float32)
        w_kept = [k for k in w["grad_norms"]
                  if w["grad_norms"][k] >= 1e-3 * float(np.median(list(w["grad_norms"].values())))]
        step_rays = 1.0 if set(got["rays"]) != set(w["rays"]) else max(
            (ref.match_rays(got["rays"][it], w["rays"][it])[0] for it in w["rays"]), default=1.0)
        val_gap = 1.0 if len(got["views"]) != len(w["views"]) or not w["views"] else max(
            abs(a - b) / abs(b) for (_, a), (_, b) in zip(got["views"], w["views"]))
        step_changes = self._leaf_gaps(got["change_norms"], w["change_norms"], w_kept)
        self.look = {
            "later_loss_gap": max(abs(a - b) / abs(b) for a, b in zip(out["losses"], want["losses"])),
            "start_change_worst": max(changes.items(), key=lambda kv: kv[1]),
            "start_change_worst_but": sorted(changes.items(), key=lambda kv: -kv[1])[1:2],
            "step_change_worst": max(step_changes.items(), key=lambda kv: kv[1]),
            "left_out": sorted(set(g_ref) - set(kept)), "step_left_out": sorted(set(w["grad_norms"]) - set(w_kept))}
        return {"loss_gap": abs(out["losses"][0] - want["losses"][0]) / abs(want["losses"][0]),
                "grad_gap": self._worst(self._leaf_gaps(out["grad_norms"], g_ref, list(g_ref))),
                "change_gap": median_change,
                "rays_unmatched": unmatched,
                "step_loss_gap": abs(got["loss"] - w["loss"]) / abs(w["loss"]),
                "step_grad_gap": self._worst(self._leaf_gaps(got["grad_norms"], w["grad_norms"],
                                                             list(w["grad_norms"]))),
                "step_change_gap": self._worst(step_changes),
                "step_rays_unmatched": step_rays,
                "val_loss_gap": val_gap,
                "work_gap": float(out["work_gap"])}
