#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sixdgs_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU and nvcc
(``CUDA_HOME`` or /usr/local/cuda). Phases, each of which raises on failure:

  1. build every CUDA kernel of the pose path from ``sixdgs_torch/csrc``
     (one source, one nvcc);
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (B1: P=256, d=384, N in {32768, 131072}, all three
     precision modes, a partial patch mask and a padded tail of invalid
     rays);
  3. the main path at full width: a random 262,144-Gaussian SH-3 scene
     written with save_ply and read back with load_ply, rays from the
     default config (32,768-ray budget, 1,000 ellipsoids, 20-NN normals),
     DINOv2-S/14 (12 blocks, 384 wide, 6 heads, the hub checkpoint's 37x37
     pos-embed grid) and the 384-wide id module with random seeded weights,
     then eval_image(fused_attention=True) on 4 random 800x800 images with
     random masks. Launch counts are zeroed just before and read just after;
     scores are held against the fused_attention=False path, and the
     target-score solve must recover the ground-truth camera;
  4. timing with CUDA events (kernel, plain version, bound) and per-image
     eval_image time. B1's ``launches`` counts calls of its wrapper; each is
     three CUDA kernels (b1_stats, b1_combine, b1_emit).

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
# full pipeline, fused vs plain scorer: both f32, but the q/k projections,
# logits and softmax sums run in different orders (cuBLAS vs the kernel)
PIPELINE_TOL = 1e-4


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


def random_scene_arrays(rng) -> dict:
    n = N_GAUSSIANS
    return {
        "xyz": rng.normal(size=(n, 3)).astype(np.float32),
        "features_dc": (rng.normal(size=(n, 1, 3)) * 0.5).astype(np.float32),
        "features_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32),
        "opacity": rng.uniform(-2.0, 3.0, size=(n, 1)).astype(np.float32),
        "scaling": rng.uniform(-4.5, -3.0, size=(n, 3)).astype(np.float32),
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


def profile_eval(run, unprofiled_ms: float) -> None:
    """Device time by kernel over one call of ``run`` (torch.profiler), and
    the device's busy share of the unprofiled per-image time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages() if r.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r.self_device_time_total)
    busy_ms = sum(r.self_device_time_total for r in rows) / 1e3
    log(f"profile of one fused eval_image: {sum(r.count for r in rows)} kernels, device busy "
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

    # 1. build
    t0 = time.perf_counter()
    secs = _build.build("attention_scores")
    log(f"phase 1 build: attention_scores {secs:.2f} s "
        f"({time.perf_counter() - t0:.2f} s wall)")

    # 2. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_abs_err = phase_kernels(ak, gen)
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
    fused = [eval_image(dino_model, id_module, images[i], masks[i], c2ws[i], rays,
                        fused_attention=True) for i in range(N_IMAGES)]
    torch.cuda.synchronize()
    launches = ak.attention_scores_fused.launches
    log(f"phase 3 main path: B1 launches {launches}")
    if launches != N_IMAGES:
        raise AssertionError(f"B1 launched {launches} times, expected {N_IMAGES}")

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

    # 4. timing
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
    profile_eval(lambda: eval_image(dino_model, id_module, images[0], masks[0], c2ws[0],
                                    rays, fused_attention=True), per_image["fused"])
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"total {time.perf_counter() - t_start:.1f} s")

    record = {
        "name": "B1 attention_scores_fused (_fwd_kernel_train; 3 CUDA kernels per launch)",
        "route": "cuda",
        "source": "sixdgs_torch/csrc/attention_scores.cu",
        "replaces": "sixdgs_tpu/ops/attention_kernel.py:116",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        # no single PyTorch call computes the masked softmax column sums
        "library_ms": None,
    }
    log(gpu_line())
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
