#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sixdgs_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU and nvcc
(``CUDA_HOME`` or /usr/local/cuda). Phases, each of which raises on failure:

  1. build every CUDA kernel of the ported paths from ``sixdgs_torch/csrc``
     (one nvcc per source, all started together): B1, B2, B5, B3;
  2. hold each kernel against its plain PyTorch version on the card: B1
     and B2 at the pose paths' shapes (P=256, d=384, N in {32768, 131072},
     all three precision modes, a partial patch mask and a padded tail of
     invalid rays, plus B2 with every ray invalid); B5 on a truncated
     1232x816 layout and on all-empty tiles (equal); B3 on 64 tiles of
     2,000-2,600 pairs each, opaque (tiles exit early) and translucent;
  3. the pose serving path at full width: a random 262,144-Gaussian SH-3
     scene written with save_ply and read back with load_ply, rays from the
     default config (32,768-ray budget, 1,000 ellipsoids, 20-NN normals),
     DINOv2-S/14 (12 blocks, 384 wide, 6 heads, the hub checkpoint's 37x37
     pos-embed grid) and the 384-wide id module with random seeded weights,
     then eval_image(fused_attention=True) on 4 random 800x800 images with
     random masks. Launch counts are zeroed just before and read just after;
     scores are held against the fused_attention=False path, and the
     target-score solve must recover the ground-truth camera;
  4. the training path at full width: PoseTrainer(fused_attention=True) on
     the same scene and models, 16 cameras on a ring with random 800x800
     RGBA images, the default config (32 images per step, rays renewed
     every 10 iterations), 12 steps. Launch counts are zeroed just before
     and read just after (B1 and B2 each 32 x 12); every loss must be
     finite; a twin trainer with fused_attention=False from the same seed
     must agree on the first step's loss and gradients; one validate();
     per-step time and peak memory, fused and plain;
  5. the 3DGS render path at full width: render_eval(rasterizer="auto") of
     the same scene through 16 cameras on the ring at 1232x816 (3,927
     tiles). Per camera the aligned pair demand must fit nc and the binning
     tiers must drop no coverage; launch counts are zeroed just before and
     read just after (B5 and B3 each 16); one image is held against
     rasterize_scan (the golden model, plain torch, the same projection);
     B5 and B3 against their plain versions on that camera's layout;
  6. timing with CUDA events (each kernel, its plain version, its bound),
     per-image eval_image and render_eval time, and profiles of one image,
     one training step and one render. B1's ``launches`` counts calls of
     its wrapper, each three CUDA kernels; B2's, each eight; B5's and B3's,
     one each.

The last three lines of standard output are the card's name and power limit
(nvidia-smi), one JSON object with a record per kernel, and the result line
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when no
CUDA device is present or any phase fails.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 20261016
N_GAUSSIANS = 262_144
N_IMAGES = 4
IMAGE_HW = 800
KERNEL_NS = (32768, 131072)
P, D = 256, 384
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 FMA flop/s
# outside the tensor cores, bf16 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# kernel vs plain: f32-class modes differ only in summation order; bf16
# rounds K inside the kernel and in the plain version at the same points,
# but an f32 K that lands on a bf16 rounding boundary can round apart
TOL = {"f32": 1e-5, "bf16_split3": 1e-5, "bf16": 1e-3}
STAT_TOL = {"f32": 1e-5, "bf16_split3": 1e-5, "bf16": 1e-2}
# B2 vs plain, each gradient against its max |plain|: sums over up to 131k
# rays in another order than cuBLAS; in bf16 a dlog or dk on a rounding
# boundary rounds apart. dbk is zero in exact arithmetic (a shift of every
# logit of a patch by q_p . bk leaves its softmax unchanged), so it is held
# against max_col sum_j |dk_j| instead
B2_TOL = {"f32": 1e-4, "bf16_split3": 1e-4, "bf16": 1e-2}
# full pipeline, fused vs plain scorer: both f32, but the q/k projections,
# logits and softmax sums run in different orders (cuBLAS vs the kernel)
PIPELINE_TOL = 1e-4
# training, fused vs plain: first-step loss (relative) and each parameter's
# gradient against its max |grad|; the k-projection bias and the ray MLP's
# last bias have a true gradient of zero (as dbk above), so they are held
# against the largest gradient entry of the module
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
ZERO_GRAD_PARAMS = ("attention.k.bias", "ray_mlp.l4.bias")
N_TRAIN_CAMERAS = 16
N_TRAIN_STEPS = 12
N_PLAIN_STEPS = 4
KERNEL_SOURCES = ("attention_scores", "attention_scores_bwd", "align_compact",
                  "composite_fwd")
# render path: the JAX package's Mip-NeRF 360 render size (bench.py), 77 x 51
# = 3,927 tiles of 16 x 16, 16 cameras on the ring at radius 3.1, FoVs that
# follow the aspect ratio, a white background
RENDER_W, RENDER_H = 1232, 816
N_RENDER_CAMERAS = 16
RENDER_FOVX = 0.9
RENDER_BG = (1.0, 1.0, 1.0)
# B3 against its plain version (both f32 on the card): the kernel multiplies
# the transmittance serially (with FMA contraction) where the plain version
# takes a cumulative product per 128-pair chunk, so a pixel whose
# T (1 - alpha) lands within rounding of T_EPS = 1e-4 can stop one pair
# apart. A flip moves a channel by T alpha (c - bg) with T (1 - alpha) ~ T_EPS,
# at most 9.9e-3 |c - bg| <= 2e-2 here; everywhere else the two agree to
# ~1e-6. Such flips are rare (3 of 3,015,936 values off by > 1e-4 on the
# render scene, none on the deep cases), while one faulty tile is 768 of
# them (2.5e-4 of the scene's values). So: max abs error <= B3_MAX_ERR and
# at most a B3_FLIP_SHARE of the values off by more than 1e-4
B3_MAX_ERR = 2e-2
B3_FLIP_SHARE = 1e-5
# the rendered image against rasterize_scan (the golden model, every
# gaussian on every pixel): the flips above, plus pixels just outside a
# gaussian's tile rect (3 sigma, rounded out to tiles) where alpha is still
# >= 1/255 (up to 3.33 sigma): the tile path drops those, each worth at most
# exp(-4.5) opacity |c - bg| ~ 1.1e-2 |c - bg|. Both are rare (a share of
# 3.2e-5 of the values off by > 1e-3, max 3.65e-3, on camera 0), while one
# faulty tile is 2.5e-4 of the image
RENDER_MAX_ERR = 2e-2
RENDER_SHARE_OVER_1E3 = 1e-4
# B3's operation count (composite_fwd.cu): 14 f32 operations per (pixel,
# pair) evaluation up to the pixel's stop, 14 more per contributing pair
B3_OPS_PER_EVAL = 14
B3_OPS_PER_CONTRIB = 14


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def b1_inputs(n: int, gen):
    dev = "cuda"
    q = torch.randn(P, D, generator=gen, device=dev)
    feats = torch.randn(n, D, generator=gen, device=dev)
    wk = torch.randn(D, D, generator=gen, device=dev) * 0.05
    bk = torch.randn(D, generator=gen, device=dev) * 0.1
    pmask = (torch.rand(P, generator=gen, device=dev) > 0.3).float()
    valid = torch.ones(n, device=dev)
    valid[n - n // 8:] = 0.0  # padded tail of invalid rays
    return q, feats, wk, bk, pmask, valid


def b1_flops(n: int) -> int:
    """Flops the function needs: K = feats Wk and the logits q K^T, once."""
    return 2 * (n * D * D + P * n * D)


def b1_bound(n: int, mode: str):
    """(bound_ms, bound_by) of one B1 call: the function's flops at the peak
    rate of its operand type (bf16 tensor cores in "bf16", f32 FMA in the
    f32-class modes), against each input read once and each output written
    once."""
    rate = BF16_FLOPS_PER_S if mode == "bf16" else F32_FLOPS_PER_S
    nbytes = 4 * (P * D + n * D + D * D + D + P + n + n + 2 * P)
    t_ops, t_bytes = b1_flops(n) / rate, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(ak, gen):
    """B1 against its plain version on the card; returns the max abs error
    at the main path's shape and mode."""
    main_err = None
    for n in KERNEL_NS:
        ins = b1_inputs(n, gen)
        for mode in ak.MODES:
            s, m, ss = ak.attention_scores_fwd(*ins, mode=mode)
            rs, rm, rss = ak.attention_scores_plain(*ins, mode=mode)
            torch.cuda.synchronize()
            err = (s - rs).abs().max().item()
            scale = rs.abs().max().item()
            m_err = (m - rm).abs().max().item()
            s_rel = ((ss - rss).abs() / rss).max().item()
            log(f"B1 n={n} mode={mode}: max_abs_err={err:.3e} (max|ref|={scale:.3e}, "
                f"rel={err / scale:.3e}) m_err={m_err:.3e} s_relerr={s_rel:.3e}")
            if not (err <= TOL[mode] * scale):
                raise AssertionError(f"B1 scores off at n={n} {mode}: {err} > "
                                     f"{TOL[mode]} * {scale}")
            if not (m_err <= STAT_TOL[mode] * rm.abs().max().item()
                    and s_rel <= STAT_TOL[mode]):
                raise AssertionError(f"B1 stats off at n={n} {mode}")
            if n == KERNEL_NS[0] and mode == "bf16_split3":
                main_err = err
    return main_err


def b2_flops(n: int) -> int:
    """Flops the backward needs: K, dfeats = dk Wk^T and dWk = feats^T dk
    (3 N d^2), the logits, dk = dlog^T q and dq = dlog K (3 P N d)."""
    return 2 * (3 * n * D * D + 3 * P * n * D)


def b2_bound(n: int, mode: str):
    """(bound_ms, bound_by) of one B2 call, as b1_bound: inputs q, feats,
    Wk, bk, pmask, valid, m, s, g read once, dq, dfeats, dWk, dbk written
    once."""
    rate = BF16_FLOPS_PER_S if mode == "bf16" else F32_FLOPS_PER_S
    nbytes = 4 * (2 * P * D + 2 * n * D + 2 * D * D + 2 * D + 3 * P + 2 * n)
    t_ops, t_bytes = b2_flops(n) / rate, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def dbk_scale(ins, m, s, g) -> float:
    """max_col sum_j |dk_j|, the size of the terms dbk sums."""
    q, feats, wk, bk, pmask, valid = ins
    logits = q @ (feats @ wk + bk).T / math.sqrt(D)
    logits = torch.where(valid[None] > 0, logits, torch.full_like(logits, -9e15))
    probs = torch.exp(logits - m) / s
    c = (probs * g).sum(1, keepdim=True)
    dlog = pmask[:, None] * probs * (g - c) / math.sqrt(D)
    return (dlog.T @ q).abs().sum(0).max().item()


def b2_case(ak, ins, g, mode):
    """B2 on B1's residuals against its plain version; returns the max abs
    error over the four gradients."""
    _, m, s = ak.attention_scores_fwd(*ins, mode=mode)
    out = ak.attention_scores_bwd(*ins, m, s, g, mode=mode)
    ref = ak.attention_scores_bwd_plain(*ins, m, s, g, mode=mode)
    torch.cuda.synchronize()
    worst, msgs = 0.0, []
    for name, a, b in zip(("dq", "dfeats", "dwk", "dbk"), out, ref):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"B2 {name}: shape {tuple(a.shape)} or non-finite")
        err = (a - b).abs().max().item()
        scale = dbk_scale(ins, m, s, g) if name == "dbk" else b.abs().max().item()
        msgs.append(f"{name} {err:.2e}/{scale:.2e}")
        if not err <= B2_TOL[mode] * scale:
            raise AssertionError(f"B2 {name} off at n={ins[1].shape[0]} {mode}: "
                                 f"{err} > {B2_TOL[mode]} * {scale}")
        worst = max(worst, err)
    return worst, out, " ".join(msgs)


def phase_b2(ak, gen):
    """B2 against its plain version; returns the max abs error at the main
    path's shape and mode."""
    main_err = None
    for n in KERNEL_NS:
        ins = b1_inputs(n, gen)
        g = torch.randn(n, generator=gen, device="cuda")
        for mode in ak.MODES:
            err, _, msg = b2_case(ak, ins, g, mode)
            log(f"B2 n={n} mode={mode}: max_abs_err={err:.3e} (err/scale: {msg})")
            if n == KERNEL_NS[0] and mode == "bf16_split3":
                main_err = err
    # every ray invalid: P = 1/N, and the unmasked dlog gives invalid rays
    # a nonzero dfeats, as the TPU kernel does
    ins = list(b1_inputs(4096, gen))
    ins[5] = torch.zeros_like(ins[5])
    err, out, msg = b2_case(ak, ins, torch.randn(4096, generator=gen, device="cuda"),
                            "f32")
    log(f"B2 all-invalid n=4096 f32: max_abs_err={err:.3e} (err/scale: {msg}); "
        f"max|dfeats| {out[1].abs().max().item():.3e}")
    if not out[1].abs().max().item() > 0:
        raise AssertionError("B2 all-invalid: dfeats should be nonzero (unmasked dlog)")
    return main_err


def random_scene_arrays(rng) -> dict:
    n = N_GAUSSIANS
    return {
        "xyz": rng.normal(size=(n, 3)).astype(np.float32),
        "features_dc": (rng.normal(size=(n, 1, 3)) * 0.5).astype(np.float32),
        "features_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32),
        "opacity": rng.uniform(-2.0, 3.0, size=(n, 1)).astype(np.float32),
        # 8-10 px radii at the render size: ~119 real pairs per tile, the
        # JAX package's Mip-NeRF 360 bench figure
        "scaling": rng.uniform(-5.8, -4.8, size=(n, 3)).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
    }


def look_at_c2w(pos: np.ndarray) -> np.ndarray:
    """Camera at ``pos`` looking at the origin (OpenCV axes: z forward)."""
    z = -pos / np.linalg.norm(pos)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.stack([x, y, z], axis=1)
    c2w[:3, 3] = pos
    return c2w


def random_mask(rng) -> np.ndarray:
    yy, xx = np.mgrid[:IMAGE_HW, :IMAGE_HW] / IMAGE_HW
    cy, cx = rng.uniform(0.3, 0.7, size=2)
    ry, rx = rng.uniform(0.15, 0.4, size=2)
    return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0


def train_cameras(rng):
    """N_TRAIN_CAMERAS CameraInfos on a ring at radius 3.1 looking at the
    origin, each with a random 800x800 RGBA image whose alpha is a random
    ellipse (prepare_image_mask turns it into the mask)."""
    from sixdgs_torch.scene.structures import CameraInfo

    infos = []
    for i in range(N_TRAIN_CAMERAS):
        ang = 2 * math.pi * i / N_TRAIN_CAMERAS
        pos = np.array([3 * math.cos(ang), 0.8, 3 * math.sin(ang)])
        c2w = look_at_c2w(pos)
        rgba = np.empty((IMAGE_HW, IMAGE_HW, 4), np.uint8)
        rgba[..., :3] = rng.integers(0, 256, size=(IMAGE_HW, IMAGE_HW, 3))
        rgba[..., 3] = np.where(random_mask(rng), 255, 0)
        R = c2w[:3, :3].astype(np.float64)
        infos.append(CameraInfo(uid=i, R=R, T=-R.T @ pos, FovY=0.9, FovX=0.9, image=rgba,
                                image_path="", image_name=f"cam{i}", width=IMAGE_HW,
                                height=IMAGE_HW))
    return infos


def run_trainer(trainer, n_steps: int):
    """Run ``n_steps`` iterations with a callback after each: returns per-step
    (aux, wall ms, peak device memory bytes), the first step's gradients and
    the rays it used."""
    steps, first = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_last = [time.perf_counter()]

    def callback(it, aux, tr):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps.append((aux, 1e3 * (now - t_last[0]), torch.cuda.max_memory_allocated()))
        if it == 0:
            first["grads"] = {n: p.grad.detach().clone()
                              for n, p in tr.id_module.named_parameters()}
            first["rays"] = [x.clone() for x in tr.rays]
        torch.cuda.reset_peak_memory_stats()
        t_last[0] = time.perf_counter()

    trainer.run(n_iterations=n_steps, validate_every=0, log_every=1, callback=callback)
    return steps, first


def phase_training(ak, scene, dino_model, id_module, rng):
    """The training path at full width; returns ((B1 launches, B2
    launches), per-step ms and peak GiB for fused and plain, the two
    trainers)."""
    from sixdgs_torch.pose.trainer import PoseTrainer
    from sixdgs_torch.utils.config import PoseEstimationConfig

    cfg = PoseEstimationConfig()
    infos = train_cameras(rng)
    t0 = time.perf_counter()
    fused = PoseTrainer(dino_model, id_module, scene, infos, cfg, seed=SEED,
                        fused_attention=True, device="cuda")
    torch.cuda.synchronize()
    log(f"trainer set-up (features of {len(infos)} cameras): "
        f"{time.perf_counter() - t0:.2f} s; patches per camera "
        f"{fused._feat_cache[1].sum(1).tolist()}")

    ak.attention_scores_fused.launches = 0
    ak.attention_scores_bwd.launches = 0
    steps, first = run_trainer(fused, N_TRAIN_STEPS)
    launches = (ak.attention_scores_fused.launches, ak.attention_scores_bwd.launches)
    expected = cfg.gradient_accumulation_steps * N_TRAIN_STEPS
    log(f"phase 4 training: B1 launches {launches[0]}, B2 launches {launches[1]} "
        f"(expected {expected} each)")
    if launches != (expected, expected):
        raise AssertionError(f"training launched B1/B2 {launches}, expected {expected} each")
    for it, (aux, ms, peak) in enumerate(steps):
        log(f"  step {it}: loss {aux['loss']:.6e} score {aux['loss_score']:.6e} "
            f"cam_up {aux['cam_up']:.4f} n_nan {aux['n_nan']} {ms:.1f} ms "
            f"peak {peak / 2**30:.2f} GiB")
        if not math.isfinite(aux["loss"]) or aux["n_nan"] != 0:
            raise AssertionError(f"step {it}: loss {aux['loss']} n_nan {aux['n_nan']}")
    if len(steps) != N_TRAIN_STEPS:
        raise AssertionError(f"{len(steps)} steps logged, expected {N_TRAIN_STEPS}")

    plain = PoseTrainer(dino_model, id_module, scene, infos, cfg, seed=SEED,
                        fused_attention=False, device="cuda")
    plain_steps, plain_first = run_trainer(plain, N_PLAIN_STEPS)
    for a, b in zip(first["rays"], plain_first["rays"]):
        if not torch.equal(a, b):
            raise AssertionError("the twin trainer drew other rays from the same seed")
    f_loss, p_loss = steps[0][0]["loss"], plain_steps[0][0]["loss"]
    rel = abs(f_loss - p_loss) / abs(p_loss)
    log(f"first step fused vs plain: loss {f_loss:.8e} vs {p_loss:.8e} (rel {rel:.2e})")
    if not rel <= TRAIN_LOSS_TOL:
        raise AssertionError(f"first-step loss differs by {rel} relative")
    top = max(g.abs().max().item() for g in plain_first["grads"].values())
    worst = 0.0
    for name, g in plain_first["grads"].items():
        err = (first["grads"][name] - g).abs().max().item()
        scale = top if name in ZERO_GRAD_PARAMS else g.abs().max().item()
        worst = max(worst, err / scale)
        if not err <= TRAIN_GRAD_TOL * scale:
            raise AssertionError(f"first-step gradient of {name}: {err} > "
                                 f"{TRAIN_GRAD_TOL} * {scale}")
    log(f"first step fused vs plain gradients: worst err / scale {worst:.2e} "
        f"over {len(plain_first['grads'])} parameters")

    val = fused.validate(N_TRAIN_STEPS - 1, max_images=2)
    tr = val["train_imgs"]
    log(f"validate (2 train images, target scores): t_err {tr['translation_error']:.4f} "
        f"a_err {tr['angular_error']:.2f} recall {tr['recall']:.3f}")
    if not math.isfinite(tr["translation_error"]):
        raise AssertionError("validate returned a non-finite translation error")

    # steady-state steps: skip the first (warm-up) and the ray renewals
    renew = {i for i in range(N_TRAIN_STEPS) if i % cfg.renewal_every_n_iterations == 0}
    timing = {
        "fused_step_ms": statistics.median(ms for i, (_, ms, _) in enumerate(steps)
                                           if i not in renew),
        "plain_step_ms": statistics.median(ms for i, (_, ms, _) in enumerate(plain_steps)
                                           if i not in renew),
        "fused_peak_gib": max(p for i, (_, _, p) in enumerate(steps)
                              if i not in renew) / 2**30,
        "plain_peak_gib": max(p for i, (_, _, p) in enumerate(plain_steps)
                              if i not in renew) / 2**30,
    }
    log("training per step (median of steady steps; peak of one step): "
        + json.dumps(timing))
    log("phase 4 training: ok")
    return launches, timing, {"fused": fused, "plain": plain}


def synthetic_records(counts, nx: int, ny: int, rng, opacity=(0.1, 0.99)):
    """Aligned synthetic B3 inputs on the card: records [16, NC] with, per
    tile, pair means around the tile, conics 0.05-0.3 and colors in [0, 1];
    starts (KB-aligned) and counts int32."""
    counts = np.asarray(counts, np.int64)
    starts = np.concatenate([[0], np.cumsum(-(-counts // 128) * 128)])
    rec = np.zeros((16, int(starts[-1]) + 128), np.float32)
    t = np.repeat(np.arange(nx * ny), counts)
    idx = np.concatenate([np.arange(a, a + c) for a, c in zip(starts[:-1], counts)])
    n = idx.size
    rec[0, idx] = (t % nx) * 16 + rng.uniform(-4, 20, n)
    rec[1, idx] = (t // nx) * 16 + rng.uniform(-4, 20, n)
    rec[2, idx] = rng.uniform(0.05, 0.3, n)
    rec[3, idx] = rng.uniform(-0.05, 0.05, n)
    rec[4, idx] = rng.uniform(0.05, 0.3, n)
    rec[5:8, idx] = rng.uniform(0, 1, (3, n))
    rec[8, idx] = rng.uniform(*opacity, n)
    return (torch.tensor(rec, device="cuda"),
            torch.tensor(starts, dtype=torch.int32, device="cuda"),
            torch.tensor(counts, dtype=torch.int32, device="cuda"))


def b3_check(label: str, got, want) -> float:
    """B3 against its plain version (B3_MAX_ERR, B3_FLIP_SHARE); returns the
    max abs error."""
    err = (got - want).abs()
    worst = err.max().item()
    share = (err > 1e-4).float().mean().item()
    log(f"B3 {label}: max_abs_err={worst:.3e}, share of values off by > 1e-4: "
        f"{share:.2e} ({int((err > 1e-4).sum())} of {err.numel()})")
    if not (torch.isfinite(got).all() and worst <= B3_MAX_ERR and share <= B3_FLIP_SHARE):
        raise AssertionError(f"B3 {label} off its plain version: {worst}, {share}")
    return worst


def phase_raster_kernels(pt, rng):
    """B5 and B3 against their plain versions on synthetic layouts: B5 on a
    truncated full-size layout and on all-empty tiles, B3 on segments of
    2,000-2,600 pairs per tile, opaque (tiles exit early) and translucent."""
    n_tiles = 77 * 51
    for label, counts, nc in (("truncated 1232x816", rng.poisson(300, n_tiles), 1 << 20),
                              ("all-empty", np.zeros(64, np.int64), 1024)):
        starts = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32,
                              device="cuda")
        gidx = torch.tensor(rng.integers(0, N_GAUSSIANS, nc), dtype=torch.int32,
                            device="cuda")
        starts_al, demand = pt._aligned_starts(starts, nc)
        got = pt._align_compact(gidx, starts, starts_al, len(counts), N_GAUSSIANS)
        want = pt.align_compact_plain(gidx, starts, starts_al, len(counts), N_GAUSSIANS)
        torch.cuda.synchronize()
        log(f"B5 {label}: nc {nc}, aligned demand {int(demand)}, equal to plain: "
            f"{torch.equal(got, want)}")
        if not torch.equal(got, want):
            raise AssertionError(f"B5 {label} differs from its plain version")
    bg = torch.tensor([0.1, 0.5, 0.9], device="cuda")
    for label, opacity in (("deep opaque", (0.3, 0.99)), ("deep translucent", (0.001, 0.02))):
        rec, starts, counts = synthetic_records(rng.integers(2000, 2600, 64), 8, 8, rng,
                                                opacity)
        got = pt.pallas_composite_fwd(rec, starts, counts, 8, 8, bg)
        want, (evals, contribs) = pt.composite_fwd_plain(rec, starts, counts, 8, 8, bg,
                                                         return_work=True)
        torch.cuda.synchronize()
        log(f"B3 {label}: 64 tiles of {int(counts.min())}-{int(counts.max())} pairs, "
            f"{evals / (64 * 256):.0f} evaluations per pixel")
        b3_check(label, got, want)


def render_cameras():
    """N_RENDER_CAMERAS cameras on the ring of the training cameras (radius
    3.1, looking at the origin), between their positions, at RENDER_W x
    RENDER_H."""
    from sixdgs_torch.scene.cameras import make_synthetic_camera

    fovy = 2 * math.atan(math.tan(RENDER_FOVX / 2) * RENDER_H / RENDER_W)
    cams = []
    for i in range(N_RENDER_CAMERAS):
        ang = 2 * math.pi * (i + 0.5) / N_RENDER_CAMERAS
        pos = np.array([3 * math.cos(ang), 0.8, 3 * math.sin(ang)])
        R = look_at_c2w(pos)[:3, :3].astype(np.float64)
        cams.append(make_synthetic_camera(RENDER_W, RENDER_H, RENDER_FOVX, fovy, R,
                                          -R.T @ pos, uid=i, name=f"render{i}"))
    return cams


def layout_of(scene, cam):
    """(projection, compact layout, binning telemetry) of ``cam``: what
    rasterize_pallas builds before B5, with no kernel launched."""
    from sixdgs_torch.ops.rasterizer import pallas_tiles as pt
    from sixdgs_torch.ops.rasterizer import tiles as tl
    from sixdgs_torch.train import gs_trainer as gs

    t_max, mid_k, t_max_mid, overflow_k, t_max_big = gs.DEFAULT_TIERS
    proj = gs._project_params(scene.params(), scene.active, gs.camera_arrays(cam, "cuda"),
                              cam.width, cam.height, scene.max_sh_degree)
    lay = pt._compact_layout(proj, cam.width, cam.height, t_max, overflow_k, t_max_big,
                             mid_k, t_max_mid, 0)
    sat = tl.binning_saturation(lay.records[:, 0:2], proj.radii[lay.order].float(),
                                (proj.radii > 0)[lay.order], lay.nx, lay.ny, pt.TILE,
                                t_max, overflow_k, t_max_big, mid_k, t_max_mid)
    return proj, lay, {k: int(v) for k, v in sat.items()}


def phase_render(ak, scene):
    """The render path at full width: 16 render_eval calls at 1232x816 on
    the SH-3 scene, counted; one image against rasterize_scan; B5 and B3
    against their plain versions at the scene's shapes. Returns what the
    timing phase needs."""
    from sixdgs_torch.ops.rasterizer import pallas_tiles as pt
    from sixdgs_torch.ops.rasterizer.compositing import rasterize_scan
    from sixdgs_torch.ops.rasterizer.projection import ProjectedGaussians
    from sixdgs_torch.train.gs_trainer import render_eval

    cams = render_cameras()
    first = None
    for i, cam in enumerate(cams):
        proj, lay, sat = layout_of(scene, cam)
        real, demand = int(lay.starts[-1]), int(lay.al_total)
        log(f"camera {i}: {int((proj.radii > 0).sum())} visible; nc_real {real}, mean "
            f"segment {real / lay.n_tiles:.1f} pairs per tile (max "
            f"{int(lay.counts_k.max())}); nc_demand {demand} <= nc {lay.nc}: "
            f"{demand <= lay.nc}; binning {json.dumps(sat)}")
        if demand > lay.nc:
            raise AssertionError(f"camera {i}: aligned demand {demand} > nc {lay.nc}")
        if sat["dropped_main"] or sat["dropped_mid"] or sat["dropped_big"] or (
                sat["overflow_spill"]):
            raise AssertionError(f"camera {i}: the binning tiers dropped coverage")
        if i == 0:
            first = (proj, lay)
        del proj, lay

    bg = torch.tensor(RENDER_BG, device="cuda")
    torch.cuda.synchronize()
    counters = (pt._align_compact, pt.pallas_composite_fwd, ak.attention_scores_fused,
                ak.attention_scores_bwd)
    for c in counters:
        c.launches = 0
    imgs = [render_eval(scene, cam, bg, scene.max_sh_degree, rasterizer="auto")
            for cam in cams]
    torch.cuda.synchronize()
    launches = [c.launches for c in counters]
    log(f"phase 5 render: B5 launches {launches[0]}, B3 launches {launches[1]} "
        f"(expected {N_RENDER_CAMERAS} each); B1 {launches[2]}, B2 {launches[3]}")
    if launches != [N_RENDER_CAMERAS, N_RENDER_CAMERAS, 0, 0]:
        raise AssertionError(f"render path launches {launches}")
    for i, img in enumerate(imgs):
        if img.shape != (3, RENDER_H, RENDER_W) or not torch.isfinite(img).all():
            raise AssertionError(f"image {i}: shape {tuple(img.shape)} or non-finite")
    covered = (imgs[0] - bg[:, None, None]).abs().amax(0) > 1e-3
    log(f"image 0: mean {imgs[0].mean().item():.4f}, {covered.float().mean().item():.3f} "
        f"of pixels differ from the background")

    proj, lay = first
    vis = proj.radii > 0
    t0 = time.perf_counter()
    # invisible gaussians (radius 0, opacity 0) sort last and add nothing
    ref = rasterize_scan(ProjectedGaussians(*[f[vis] for f in proj]), RENDER_W, RENDER_H, bg)
    torch.cuda.synchronize()
    err = (imgs[0] - ref).abs()
    render_err = err.max().item()
    share = (err > 1e-3).float().mean().item()
    log(f"image 0 vs rasterize_scan ({int(vis.sum())} gaussians, "
        f"{time.perf_counter() - t0:.1f} s): max_abs_err={render_err:.3e}; values off by "
        f"> 1e-3: {int((err > 1e-3).sum())} ({share:.2e}), by > 1e-4: "
        f"{int((err > 1e-4).sum())} of {err.numel()}")
    if not (render_err <= RENDER_MAX_ERR and share <= RENDER_SHARE_OVER_1E3):
        raise AssertionError(f"render off the golden model: {render_err}, {share}")
    del ref, err

    # the kernels at the scene's shapes (camera 0)
    gidx_al = pt._align_compact(lay.gidx_c, lay.starts, lay.starts_al, lay.n_tiles, lay.P)
    want = pt.align_compact_plain(lay.gidx_c, lay.starts, lay.starts_al, lay.n_tiles, lay.P)
    torch.cuda.synchronize()
    b5_err = (gidx_al.long() - want.long()).abs().max().item()
    log(f"B5 scene layout (nc {lay.nc}, {lay.n_tiles} tiles): equal to plain: "
        f"{torch.equal(gidx_al, want)}")
    if not torch.equal(gidx_al, want):
        raise AssertionError("B5 differs from its plain version on the scene's layout")
    records_t = pt._gather_records(lay.records, gidx_al)
    out = pt.pallas_composite_fwd(records_t, lay.starts_al, lay.counts_k, lay.nx, lay.ny, bg)
    want, work = pt.composite_fwd_plain(records_t, lay.starts_al, lay.counts_k, lay.nx,
                                        lay.ny, bg, return_work=True)
    b3_err = b3_check("scene records", out, want)
    log(f"B3 scene work: {work[0]} evaluations ({work[0] / (lay.n_tiles * 256):.1f} per "
        f"pixel), {work[1]} contributions")
    log("phase 5 render: ok")
    return {"cams": cams, "bg": bg, "lay": lay, "records_t": records_t, "work": work,
            "launches": launches, "b3_err": b3_err, "b5_err": b5_err,
            "render_err": render_err}


def b3_bound(work, lay):
    """(bound_ms, bound_by) of one B3 call on ``lay``: the operations these
    inputs need (B3_OPS_PER_EVAL per evaluation up to each pixel's stop,
    B3_OPS_PER_CONTRIB per contributing pair) at the f32 peak, against the
    live record rows (9 floats per real pair), starts and counts read once
    and the image written once."""
    evals, contribs = work
    ops = B3_OPS_PER_EVAL * evals + B3_OPS_PER_CONTRIB * contribs
    nbytes = 4 * (9 * int(lay.counts_k.sum()) + 2 * lay.n_tiles + 3 + lay.n_tiles * 256 * 3)
    t_ops, t_bytes = ops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def b5_bound(lay):
    """(bound_ms, bound_by) of one B5 call: the real indices and both start
    arrays read once, nc indices written (no arithmetic to speak of)."""
    nbytes = 4 * (int(lay.starts[-1]) + 2 * (lay.n_tiles + 1) + lay.nc)
    return 1e3 * nbytes / HBM_BYTES_PER_S, "bytes"


def profile_run(label: str, run, unprofiled_ms: float) -> None:
    """Device time by kernel over one call of ``run`` (torch.profiler), and
    the device's busy share of the unprofiled time of one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # user-annotated ranges (Optimizer.step#...) span kernels counted in
    # their own rows: leave them out of the busy time
    rows = [r for r in prof.key_averages() if r.device_type == DeviceType.CUDA
            and not getattr(r, "is_user_annotation", False)
            and not r.key.startswith("Optimizer.")]
    rows.sort(key=lambda r: -r.self_device_time_total)
    busy_ms = sum(r.self_device_time_total for r in rows) / 1e3
    log(f"profile of one {label}: {sum(r.count for r in rows)} kernels, device busy "
        f"{busy_ms:.3f} ms = {100 * busy_ms / unprofiled_ms:.1f}% of {unprofiled_ms:.3f} ms")
    for r in rows[:15]:
        log(f"  {r.self_device_time_total / 1e3:8.3f} ms x{r.count:<4d} {r.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sixdgs_torch.ops import _build
    from sixdgs_torch.ops import attention_kernel as ak
    from sixdgs_torch.ops.rasterizer import pallas_tiles as pt
    from sixdgs_torch.pose import dino
    from sixdgs_torch.pose.evaluate import eval_image
    from sixdgs_torch.pose.modules import init_id_module
    from sixdgs_torch.rays.engine import generate_rays_from_scene
    from sixdgs_torch.scene.gaussians import from_arrays, load_ply

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, f32 matmul precision "
        f"{torch.get_float32_matmul_precision()}")
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmuls must not use TF32")

    # 1. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        secs = dict(zip(KERNEL_SOURCES, pool.map(_build.build, KERNEL_SOURCES)))
    log(f"phase 1 build: {json.dumps(secs)} s "
        f"({time.perf_counter() - t0:.2f} s wall)")

    # 2. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_abs_err = phase_kernels(ak, gen)
    b2_max_abs_err = phase_b2(ak, gen)
    phase_raster_kernels(pt, np.random.default_rng(SEED))
    log("phase 2 kernels vs plain: ok")

    # 3. main path at full width
    rng = np.random.default_rng(SEED)
    arrays = random_scene_arrays(rng)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "point_cloud.ply")
        from_arrays(arrays, max_sh_degree=3, device="cpu").save_ply(path)
        scene = load_ply(path, max_sh_degree=3, device="cuda")
    for name, arr in arrays.items():
        if not np.array_equal(scene.params()[name][:N_GAUSSIANS].cpu().numpy(), arr):
            raise AssertionError(f"PLY round trip changed {name}")
    rays = generate_rays_from_scene(scene, torch.Generator(device="cuda").manual_seed(SEED))
    n_valid = int(rays.valid.sum())
    log(f"scene: {scene.capacity} slots, {int(scene.num_active())} active; rays "
        f"{tuple(rays.ori.shape)}, {n_valid} valid")
    if rays.ori.shape[0] != 32768 or n_valid == 0 or not torch.isfinite(rays.ori).all():
        raise AssertionError("ray generation failed")

    cpu_gen = torch.Generator().manual_seed(SEED)
    dino_model = dino.init_params(cpu_gen, embed_dim=384, depth=12,
                                  num_patches=37 * 37, device="cuda").eval()
    id_module = init_id_module(cpu_gen, feature_dim=384, grid=16, device="cuda").eval()
    images, masks, c2ws = [], [], []
    for i in range(N_IMAGES):
        images.append(torch.tensor(rng.uniform(size=(IMAGE_HW, IMAGE_HW, 3)),
                                   dtype=torch.float32, device="cuda"))
        masks.append(torch.tensor(random_mask(rng), device="cuda"))
        ang = 2 * math.pi * i / N_IMAGES
        c2ws.append(torch.tensor(look_at_c2w(np.array([3 * math.cos(ang), 0.8,
                                                       3 * math.sin(ang)])),
                                 device="cuda"))
    torch.cuda.synchronize()

    ak.attention_scores_fused.launches = 0
    ak.attention_scores_bwd.launches = 0
    fused = [eval_image(dino_model, id_module, images[i], masks[i], c2ws[i], rays,
                        fused_attention=True) for i in range(N_IMAGES)]
    torch.cuda.synchronize()
    launches = ak.attention_scores_fused.launches
    log(f"phase 3 main path: B1 launches {launches}, B2 launches "
        f"{ak.attention_scores_bwd.launches}")
    if launches != N_IMAGES or ak.attention_scores_bwd.launches != 0:
        raise AssertionError(f"serving launched B1 {launches} times (expected "
                             f"{N_IMAGES}) and B2 {ak.attention_scores_bwd.launches} (0)")

    for i, out in enumerate(fused):
        c2w = out["c2w"]
        if c2w.shape != (4, 4) or not torch.isfinite(c2w).all():
            raise AssertionError(f"image {i}: bad c2w {c2w}")
        plain = eval_image(dino_model, id_module, images[i], masks[i], c2ws[i], rays,
                           fused_attention=False)
        err = (out["scores"] - plain["scores"]).abs().max().item()
        scale = plain["scores"].abs().max().item()
        score_sum = torch.sum(out["scores"]).item()  # = number of masked patches
        log(f"image {i}: t_err={out['translation_error'].item():.4f} "
            f"a_err={out['angular_error'].item():.2f} loss={out['loss_score'].item():.4e} "
            f"recall={out['recall'].item():.3f} scores sum={score_sum:.3f} "
            f"fused-vs-plain max_abs={err:.3e} (max {scale:.3e})")
        if not err <= PIPELINE_TOL * scale:
            raise AssertionError(f"image {i}: fused scores off the plain path by {err}")
        if not abs(out["loss_score"].item() - plain["loss_score"].item()) <= (
                1e-4 * abs(plain["loss_score"].item())):
            raise AssertionError(f"image {i}: loss_score differs")
    # the target-score solve (the reference's validation mode) recovers the
    # ground-truth camera from the same rays through the same solver
    tgt = eval_image(dino_model, id_module, images[0], masks[0], c2ws[0], rays,
                     use_target_scores=True, fused_attention=True)
    t_err = tgt["translation_error"].item()
    log(f"target-score solve: t_err={t_err:.4f} (camera radius 3.1) "
        f"a_err={tgt['angular_error'].item():.2f}")
    if not t_err < 0.5:
        raise AssertionError(f"target-score solve missed the camera by {t_err}")
    log("phase 3 main path: ok")

    # 4. training path at full width
    (train_b1, train_b2), train_timing, trainers = phase_training(
        ak, scene, dino_model, id_module, rng)

    # 5. render path at full width
    render = phase_render(ak, scene)

    # 6. timing
    n = KERNEL_NS[0]
    ins = b1_inputs(n, gen)
    ms = cuda_ms(lambda: ak.attention_scores_fused(*ins))
    plain_ms = cuda_ms(lambda: ak.attention_scores_plain(*ins, mode="bf16_split3"))
    bound_ms, bound_by = b1_bound(n, "bf16_split3")
    # the kernel recomputes K and the logits in its second pass, so it
    # executes twice the flops the bound counts (bench.py's formula)
    log(f"B1 n={n}: needed {b1_flops(n) / 1e9:.2f} GFLOP, executed "
        f"{2 * b1_flops(n) / 1e9:.2f} GFLOP; split3 kernel at "
        f"{2 * b1_flops(n) / ms / 1e9:.2f} TFLOP/s executed, "
        f"{bound_ms / ms:.3f} of its bound")
    times = {}
    for nn in KERNEL_NS:
        big = ins if nn == n else b1_inputs(nn, gen)
        for mode in ak.MODES:
            times[f"n={nn} {mode}"] = cuda_ms(
                lambda: ak.attention_scores_fused(*big, mode=mode), reps=10)
            times[f"n={nn} {mode} bound"] = b1_bound(nn, mode)[0]
        times[f"n={nn} plain"] = cuda_ms(
            lambda: ak.attention_scores_plain(*big, mode="bf16_split3"), reps=10)
    log("B1 times ms: " + json.dumps(times))

    g = torch.randn(n, generator=gen, device="cuda")
    _, m, s = ak.attention_scores_fwd(*ins)
    b2_ms = cuda_ms(lambda: ak.attention_scores_bwd(*ins, m, s, g))
    b2_plain_ms = cuda_ms(lambda: ak.attention_scores_bwd_plain(*ins, m, s, g))
    b2_bound_ms, b2_bound_by = b2_bound(n, "bf16_split3")
    log(f"B2 n={n}: needed {b2_flops(n) / 1e9:.2f} GFLOP, executed "
        f"{2 * (4 * n * D * D + 4 * P * n * D) / 1e9:.2f} GFLOP; split3 kernel at "
        f"{b2_flops(n) / b2_ms / 1e9:.2f} TFLOP/s needed, {b2_bound_ms / b2_ms:.3f} "
        f"of its bound")
    times = {}
    for nn in KERNEL_NS:
        big = ins if nn == n else b1_inputs(nn, gen)
        gg = torch.randn(nn, generator=gen, device="cuda")
        for mode in ak.MODES:
            _, mm, ss = ak.attention_scores_fwd(*big, mode=mode)
            times[f"n={nn} {mode}"] = cuda_ms(
                lambda: ak.attention_scores_bwd(*big, mm, ss, gg, mode=mode), reps=10)
            times[f"n={nn} {mode} bound"] = b2_bound(nn, mode)[0]
        times[f"n={nn} plain"] = cuda_ms(
            lambda: ak.attention_scores_bwd_plain(*big, mm, ss, gg), reps=10)
    log("B2 times ms: " + json.dumps(times))

    per_image = {}
    for label, flag in (("fused", True), ("plain", False)):
        walls = []
        for rep in range(3):
            for i in range(N_IMAGES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eval_image(dino_model, id_module, images[i], masks[i], c2ws[i], rays,
                           fused_attention=flag)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
        per_image[label] = statistics.median(walls)
    log(f"eval_image ms per image (median of {3 * N_IMAGES}): " + json.dumps(per_image))
    profile_run("fused eval_image",
                lambda: eval_image(dino_model, id_module, images[0], masks[0], c2ws[0],
                                   rays, fused_attention=True), per_image["fused"])
    # one more step of each trainer, after the counted runs
    for label in ("fused", "plain"):
        trainer = trainers[label]
        nxt = trainer.optimizer.state[next(trainer.id_module.parameters())]["step"]
        profile_run(f"{label} training step",
                    lambda: trainer.run(n_iterations=nxt + 1, start_iteration=nxt,
                                        validate_every=0),
                    train_timing[f"{label}_step_ms"])
    from sixdgs_torch.train.gs_trainer import render_eval

    cams, bg, lay = render["cams"], render["bg"], render["lay"]
    render_eval(scene, cams[0], bg, scene.max_sh_degree)  # warm-up
    walls = []
    for cam in cams:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_eval(scene, cam, bg, scene.max_sh_degree)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    render_ms = statistics.median(walls)
    log(f"render_eval ms per {RENDER_W}x{RENDER_H} image (median of {len(walls)}): "
        f"{render_ms:.3f} (min {min(walls):.3f}, max {max(walls):.3f})")
    profile_run("render_eval", lambda: render_eval(scene, cams[0], bg, scene.max_sh_degree),
                render_ms)
    b5_args = (lay.gidx_c, lay.starts, lay.starts_al, lay.n_tiles, lay.P)
    b3_args = (render["records_t"], lay.starts_al, lay.counts_k, lay.nx, lay.ny, bg)
    b5_ms = cuda_ms(lambda: pt._align_compact(*b5_args))
    b5_plain_ms = cuda_ms(lambda: pt.align_compact_plain(*b5_args))
    b3_ms = cuda_ms(lambda: pt.pallas_composite_fwd(*b3_args))
    b3_plain_ms = cuda_ms(lambda: pt.composite_fwd_plain(*b3_args), reps=5, warmup=1)
    b5_bound_ms, b5_bound_by = b5_bound(lay)
    b3_bound_ms, b3_bound_by = b3_bound(render["work"], lay)
    log(f"B5 (nc {lay.nc}): {b5_ms:.4f} ms, plain {b5_plain_ms:.4f} ms, bound "
        f"{b5_bound_ms:.4f} ms ({b5_bound_by})")
    log(f"B3 ({lay.n_tiles} tiles, {int(lay.counts_k.sum())} pairs, {render['work'][0]} "
        f"evaluations): {b3_ms:.4f} ms, plain {b3_plain_ms:.3f} ms, bound "
        f"{b3_bound_ms:.4f} ms ({b3_bound_by})")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"total {time.perf_counter() - t_start:.1f} s")

    records = [{
        "name": "B1 attention_scores_fused (_fwd_kernel_train; 3 CUDA kernels per launch)",
        "route": "cuda",
        "source": "sixdgs_torch/csrc/attention_scores.cu",
        "replaces": "sixdgs_tpu/ops/attention_kernel.py:116",
        # this slice's path (training); the serving path's count beside it
        "launches": train_b1,
        "launches_by_path": {"serving": launches, "training": train_b1},
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        # no single PyTorch call computes the masked softmax column sums
        "library_ms": None,
    }, {
        "name": "B2 attention_scores_bwd (_bwd_kernel; 8 CUDA kernels per launch)",
        "route": "cuda",
        "source": "sixdgs_torch/csrc/attention_scores_bwd.cu",
        "replaces": "sixdgs_tpu/ops/attention_kernel.py:136",
        "launches": train_b2,
        "launches_by_path": {"serving": 0, "training": train_b2},
        "max_abs_err": b2_max_abs_err,
        "ms": b2_ms,
        "plain_ms": b2_plain_ms,
        "bound_ms": b2_bound_ms,
        "bound_by": b2_bound_by,
        # no single PyTorch call computes the softmax-column-sum VJP
        "library_ms": None,
    }, {
        "name": "B5 _align_compact (_align_kernel)",
        "route": "cuda",
        "source": "sixdgs_torch/csrc/align_compact.cu",
        "replaces": "sixdgs_tpu/ops/rasterizer/pallas_tiles.py:892",
        "launches": render["launches"][0],
        "max_abs_err": render["b5_err"],
        "ms": b5_ms,
        "plain_ms": b5_plain_ms,
        "bound_ms": b5_bound_ms,
        "bound_by": b5_bound_by,
        # no single PyTorch call computes the aligned relocation
        "library_ms": None,
    }, {
        "name": "B3 pallas_composite_fwd (_fwd_kernel, store_t=False)",
        "route": "cuda",
        "source": "sixdgs_torch/csrc/composite_fwd.cu",
        "replaces": "sixdgs_tpu/ops/rasterizer/pallas_tiles.py:404",
        "launches": render["launches"][1],
        "max_abs_err": render["b3_err"],
        "ms": b3_ms,
        "plain_ms": b3_plain_ms,
        "bound_ms": b3_bound_ms,
        "bound_by": b3_bound_by,
        # no single PyTorch call composites depth-ordered splats per tile
        "library_ms": None,
    }]
    log("training step: " + json.dumps(train_timing))
    log(f"render_eval per image: {render_ms:.3f} ms; image vs golden model max abs "
        f"{render['render_err']:.3e}")
    log(gpu_line())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
