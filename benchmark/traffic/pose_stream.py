"""Traffic kind ``pose_stream``: single-image pose requests, closed loop.

One client sends a request as soon as the last one's pose is on the host,
as the reference evaluator times it (pose_estimation/test.py:304-311). A
request is one host photograph (float32 [H, W, 3] in [0, 1]) with its mask
and ring pose, handed to ``sixdgs_torch.pose.evaluate.eval_image`` the way
``test_pose_estimation`` hands it (``torch.tensor(..., device)``), and ends
when its ``c2w`` is on the host. Requests cycle through a pool of distinct
images made from the seed; the rays are cast once at set-up.

Parameters (the traffic file): ``pool``, ``height``, ``width``,
``mask_cover`` (share of the frame inside each image's elliptic mask),
``ring_radius``, ``ring_height``, ``warmup_requests``, ``trace_seconds``.

``correct``: after the window the last answer of every pool image is judged
against the plain reference, which casts its own rays from the scene and
the same draws: ``rays_unmatched`` (share of the reference's rays the
program did not cast), ``scores_gap`` (largest per-ray score gap over the
largest reference score), ``cam_up_gap`` (largest component gap of the unit
camera-up) and ``c2w_gap`` (the reference's solve on the program's own
scores, camera-up and rays against the program's pose: rotation entries,
translation over max(1, |t|)).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import inputs, program
from benchmark.reference import pose_common as ref

SPANS = ("sixdgs_torch.pose.evaluate.eval_image",
         "sixdgs_torch.pose.evaluate.score_image",
         "sixdgs_torch.pose.evaluate.distance_score_loss",
         "sixdgs_torch.pose.evaluate.solve_pose",
         "sixdgs_torch.pose.id_module.backbone_features",
         "sixdgs_torch.ops.attention_kernel.fused_ray_scores")


class Job:
    def __init__(self, ctx):
        from sixdgs_torch.pose import evaluate

        cfg, tr, dev, gen = ctx.config, ctx.traffic, ctx.device, ctx.generator
        self.ctx, self.evaluate = ctx, evaluate
        self.bweights, self.iweights = inputs.weights(cfg, gen, dev)
        self.scene = inputs.scene(cfg, gen, dev)
        self.draws = inputs.ray_draws(cfg, gen, dev)
        n, h, w = tr["pool"], tr["height"], tr["width"]
        self.images = inputs.host_images(n, h, w, gen, dev, "float32")
        self.masks = inputs.host_masks(n, h, w, tr["mask_cover"], gen, dev)
        self.c2w = inputs.ring_c2w(n, tr["ring_radius"], tr["ring_height"])

        self.model = program.backbone(cfg, self.bweights, dev)
        self.idm = program.id_module(self.iweights, dev)
        self.rays = program.rays(cfg, program.gaussian_scene(cfg, self.scene), *self.draws)
        self.kw = dict(k=cfg["pose"]["rays_to_output"],
                       fused_attention=cfg["pose"]["fused_attention"],
                       backbone=program.backbone_name(cfg))
        self.answers, self.next, self.failed, self.copy_s = {}, 0, 0, []
        for _ in range(tr["warmup_requests"]):
            self.request()
        self.setup_counts = {"pool": n, "valid_rays": int(self.rays.valid.sum()),
                             "warmup_requests": tr["warmup_requests"]}

    def request(self) -> float:
        """One request; returns its latency in seconds."""
        i = self.next % len(self.images)
        self.next += 1
        dev = self.ctx.device
        t0 = time.perf_counter()
        img = torch.tensor(self.images[i], device=dev)
        self.copy_s.append(time.perf_counter() - t0)
        mask = torch.tensor(self.masks[i], device=dev)
        gt = torch.tensor(self.c2w[i], device=dev)
        out = self.evaluate.eval_image(self.model, self.idm, img, mask, gt, self.rays,
                                       **self.kw)
        c2w = out["c2w"].cpu()
        t1 = time.perf_counter()
        self.answers[i] = (out["scores"], out["cam_up"], c2w)
        self.failed += not bool(torch.isfinite(c2w).all())
        return t1 - t0

    def window(self, seconds):
        lat, failed = [], self.failed
        self.copy_s = []
        start = time.perf_counter()
        while True:
            lat.append(self.request())
            end = time.perf_counter()
            if end - start >= seconds:
                break
        return {"values": {"image_p95_ms": float(np.percentile(lat, 95)) * 1e3},
                "images_per_s": len(lat) / (end - start),
                "attempted": len(lat), "failed": self.failed - failed,
                "median_ms": float(np.median(lat)) * 1e3, "seconds": end - start,
                "halves_median_ms": [float(np.median(h)) * 1e3 for h in np.array_split(lat, 2)],
                "image_copy_median_ms": float(np.median(self.copy_s)) * 1e3,
                "work": {"images": len(lat)}}

    def outputs(self):
        return {"rays": program.as_ray_dict(self.rays), "answers": dict(self.answers)}

    def release(self):
        self.model = self.idm = self.rays = None
        self.answers = {}

    # ------------------------------------------------------------ reference

    def _reference(self, dt):
        cfg = self.ctx.config
        ref.no_tf32()
        with torch.no_grad():
            rays = ref.cast_rays(self.scene, *self.draws, cfg["pose"], dt)
            feats = ref.ray_features(inputs.nest(self.iweights), rays, dt)
        return rays, feats

    def _score(self, i, rays, feats, dt):
        dev = self.ctx.device
        with torch.no_grad():
            return ref.score_image(self.ctx.reference, self.bweights, inputs.nest(self.iweights),
                                   torch.tensor(self.images[i], device=dev),
                                   torch.tensor(self.masks[i], device=dev), rays, feats, dt)

    def control_outputs(self, indices, dt=torch.bfloat16):
        """The reference computed with bfloat16 products, in the program's
        place: the control that the comparison has to fail."""
        rays, feats = self._reference(dt)
        answers = {}
        for i in indices:
            s, u, _ = self._score(i, rays, feats, dt)
            with torch.no_grad():
                c = ref.solve(s, rays, u, self.ctx.config["pose"]["rays_to_output"], dt)
            answers[i] = (s, u, c.cpu())
        return {"rays": rays, "answers": answers}

    def judge(self, out):
        rays, feats = self._reference(torch.float32)
        unmatched, idx = ref.match_rays(out["rays"], rays)
        hit = idx >= 0
        k = self.ctx.config["pose"]["rays_to_output"]
        worst = {"scores_gap": 0.0, "cam_up_gap": 0.0, "c2w_gap": 0.0}
        for i, (s, u, c2w) in sorted(out["answers"].items()):
            s_ref, u_ref, _ = self._score(i, rays, feats, torch.float32)
            scale = s_ref[rays["valid"]].abs().max()
            gap = float(((s[idx[hit]] - s_ref[hit]).abs().max() / scale).cpu()) if hit.any() else 1.0
            with torch.no_grad():
                solved = ref.solve(s.float(), out["rays"], u.float(), k).cpu()
            c2w = c2w.float()
            t_scale = max(1.0, float(solved[:3, 3].norm()))
            c_gap = ref.worse(float((c2w[:3, :3] - solved[:3, :3]).abs().max()),
                              float((c2w[:3, 3] - solved[:3, 3]).abs().max()) / t_scale)
            worst["scores_gap"] = ref.worse(worst["scores_gap"], gap)
            worst["cam_up_gap"] = ref.worse(worst["cam_up_gap"], float((u - u_ref).abs().max()))
            worst["c2w_gap"] = ref.worse(worst["c2w_gap"], c_gap)
        if not out["answers"]:
            worst = {name: float("nan") for name in worst}
        return dict(worst, rays_unmatched=unmatched)
