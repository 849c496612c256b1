#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sixdgs_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU and nvcc
(``CUDA_HOME`` or /usr/local/cuda). Phases, each of which raises on failure:

  1. build every CUDA kernel of the ported paths from ``sixdgs_torch/csrc``
     (one nvcc per source, all started together): B1, B2, B5, B3, B4, and
     beside them the builds of B3 and B4 with their other compile-time
     choices (pixels per thread, B4's pairs per round) that phase 7 times;
  2. hold each kernel against its plain PyTorch version on the card: B1
     and B2 at the pose paths' shapes (P=256, d=384, N in {32768, 131072},
     all three precision modes, a partial patch mask and a padded tail of
     invalid rays, plus B2 with every ray invalid, and each launched twice
     on the same inputs bitwise equal in each mode); B1 at a ragged
     N = 5000 with its invalid tail scored exactly 0; in each mode the
     probabilities of the logits tile that B1 and B2 share summing to 1
     against B1's m and s (MASS_TOL); B5 on a truncated
     1232x816 layout and on all-empty tiles (equal); B3 on 64 tiles of
     2,000-2,600 pairs each, opaque (tiles exit early) and translucent, and
     on the same tiles B3 with the transmittance store (``out`` bitwise as
     without it, the store against the plain version's) and B4 under a
     random cotangent (replay against its plain version, stored against
     replay bitwise, a second launch bitwise); B3 and B4, all four modes,
     on the compositor's design cases: means far from the tile origin,
     every pixel contributing to every pair, half the tile stopped early,
     and (B3 without the store, B4 replaying) the packed layout, segments
     starting anywhere in an odd nc;
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
     B5, B3 (with and without the store) and B4 (both modes) against
     their plain versions on that camera's layout;
  6. the 3DGS training path at full width: GSTrainer on a 262,144-point
     cloud (create_from_pcd with the 3-NN at full size, held against
     torch.cdist on a subset), its state set to the render scene perturbed
     (colours, opacities, a little position noise) at SH degree 3, ground
     truth from render_eval of the unperturbed scene through the 16 ring
     cameras at 1232x816, then GSTrainer.run(rasterizer="auto") from
     iteration 577 to 612: one adaptation iteration (595) and one
     densification event (600). Launch counts are zeroed just before and
     read just after: B3 with the store and B4 once per step, B5 once per
     step plus the evaluation renders. Gates: grad_dropped 0 on every
     telemetry step, the loss at the end below the loss at the start (and
     the two evaluation cameras' PSNR above its value before the run), the
     first step's gradients of all six parameter groups against a twin
     step through the plain versions of B3 and B4, a densify event that
     changes the Gaussian count and keeps the Adam moments' shapes, and a
     finite eval_psnr on two cameras;
  7. timing with CUDA events (each kernel, its plain version, its bound),
     per-image eval_image and render_eval time, the 3DGS step time, and
     profiles of one image, one id-module training step, one render and
     one 3DGS training step, with each CUDA kernel's share of one B2 call
     and B1's and B2's share of the id-module step's device time, and the
     registers and shared memory of B1's, B2's, B3's and B4's kernels
     (ptxas), each CUDA kernel's share of one B1 call, B1's share of a
     served image's device time, B3's and B4's of a render's and a 3DGS
     step's, and B3 and B4 at each of their compile-time choices on camera
     0's layout, timed in turns. B1's ``launches`` counts calls of its wrapper,
     each four CUDA kernels; B2's, each ten; B5's, B3's and B4's, one each.

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
# bf16 tensor-core products per operand pair that each mode's accuracy
# needs (mma_pieces.cuh): the attention kernels' bounds take the bf16 rate
# divided by these
PRODUCTS = {"bf16": 1, "bf16_split3": 3, "f32": 6}
# B1 vs plain: both take the reassociated order (q'' = q Wk^T, logits =
# (q'' feats^T + q bk) / sqrt(d)) and the same operand pieces (split3: the
# TPU kernel's hi/lo split of q'' and feats, 3 products; f32: plain in the
# plain version, 3 pieces and 6 products in the kernel, ~2^-24), so the
# f32-class modes differ only in summation order; bf16 rounds q'' and
# feats, in the kernel and in the plain version at the same points, but a
# q'' computed in another order (f32 FMA in the kernel, cuBLAS in the plain
# version) that lands on a bf16 rounding boundary can round apart. Each
# mode's reading against plain f32 is logged beside it
TOL = {"f32": 1e-5, "bf16_split3": 1e-5, "bf16": 1e-3}
STAT_TOL = {"f32": 1e-5, "bf16_split3": 1e-5, "bf16": 1e-2}
# max_p |sum_j P_pj - 1| for the probabilities of the shared logits tile
# against B1's m and s, read through B1 itself (softmax_mass_error): in
# exact arithmetic 0 in every mode, since the logits are one tile. What is
# left is f32 rounding: s_p is a chain of at most ~540 roundings (16 rays a
# thread per block over up to 16 blocks of a CTA's run, the rescales, 2
# lane steps, 132 CTA partials), 540 x 2^-24 = 3.2e-5 relative at worst,
# plus expf (2 ulp) and the division in each P_pj, ~5e-7; the sum over j
# is taken in float64
MASS_TOL = 5e-5
# B2 vs plain, each gradient against its max |plain|: both take the same
# reassociated order (q'' = q Wk^T, A = dlog feats), but the kernel sums the
# logits, dfeats and A over 16-wide mma k-steps of bf16 pieces in f32 (split3
# drops the lo.lo products, ~2^-18 relative), then A and c over its CTAs'
# partials in CTA order, and the epilogue in k order, where cuBLAS sums in
# its own order; in bf16 a dlog on a rounding boundary rounds apart. dbk is
# zero in exact arithmetic (a shift of every logit of a patch by q_p . bk
# leaves its softmax unchanged), so it is held against max_col sum_j |dk_j|
# instead
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
                  "composite_fwd", "composite_bwd")
# the compile-time choices of B3 and B4 that phase 7 times (-D of a build
# beside the default one): pixels per thread, and B4's pairs per round
B3_VARIANTS = tuple((f"B3_PPT={p}", f"B3_STORE_PPT={p}") for p in (1, 2, 4))
B4_VARIANTS = tuple((f"B4_PPT={p}", f"B4_SB={sb}") for sb in (16, 32) for p in (1, 2, 4))
VARIANT_BUILDS = (tuple(("composite_fwd", d) for d in B3_VARIANTS)
                  + tuple(("composite_bwd", d) for d in B4_VARIANTS))
# render path: the JAX package's Mip-NeRF 360 render size (bench.py), 77 x 51
# = 3,927 tiles of 16 x 16, 16 cameras on the ring at radius 3.1, FoVs that
# follow the aspect ratio, a white background
RENDER_W, RENDER_H = 1232, 816
N_RENDER_CAMERAS = 16
RENDER_FOVX = 0.9
RENDER_BG = (1.0, 1.0, 1.0)
# B3 against its plain version (both f32 on the card): the kernel multiplies
# the transmittance serially where the plain version
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


# B3's stored transmittance against the plain version's, on every lane a
# pixel reaches: a serial product against a cumulative one, relative to
# max(T, T_EPS)
TEXCL_REL_ERR = 1e-5
# B4 against its plain version (both f32 on the card, on the kernel's own
# forward output): the nine sums run in another order, which shows at ~3e-6
# of a gradient row's largest magnitude. A stop that flips at T_EPS (as for
# B3) adds or drops one pixel's term of one pair, of size ~T |dout| with
# T <= 1e-2, against row magnitudes of 1-50. So per row: max abs error <=
# B4_MAX_ERR of the row's largest magnitude, and at most a B4_FLIP_SHARE of
# the real lanes off by more than 1e-5 of it (one faulty tile of the render
# scene is ~1.7e-4 of them)
B4_MAX_ERR = 1e-3
B4_FLIP_SHARE = 1e-5
# B4's operation count (composite_bwd.cu): 14 f32 operations per (pixel,
# pair) evaluation up to the pixel's stop, 50 more per contributing pair
B4_OPS_PER_EVAL = 14
B4_OPS_PER_CONTRIB = 50
# 3DGS training path: the window of iterations, its adaptation iteration
# and what the perturbation of the ground-truth scene adds
GS_FIRST_IT, GS_LAST_IT, GS_ADAPT_EVERY, GS_LOG_EVERY = 577, 612, 595, 4
GS_NOISE = {"features_dc": 0.3, "opacity": 0.5, "xyz": 0.002}
# first step, kernels against the plain twin: each parameter group's
# gradient against the group's largest magnitude (sums in another order
# through B4, the segment sum and the projection's backward; a flipped stop
# moves single pairs)
GS_GRAD_TOL = 1e-3
# mean_sq_dist_3nn against torch.cdist: the matrix-product form rounds at
# eps |x|^2 ~ 1e-6 absolute, against squared distances of ~1e-3
KNN_ATOL, KNN_RTOL = 4e-6, 1e-4


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


def cuda_ms_back_to_back(fn, calls: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``calls`` calls issued back to back between
    one pair of CUDA events: the host's work for a call overlaps the
    device's for the one before, so a kernel longer than its wrapper's host
    work reads its own time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def variant_times(pt, b3_args, out, dout, tex) -> dict:
    """B3 and B4 built with each compile-time choice of VARIANT_BUILDS, on
    camera 0's layout (``b3_args``; B4 on the default B3's ``out``, the
    cotangent ``dout`` and its store ``tex``), launched as the wrappers
    launch them and timed in turns (cuda_ms, 10 calls each, every variant
    once in order and once in reverse). Each variant's B3 output must
    equal the default build's bitwise with and without its store, and its
    B4 gradients must be bitwise equal in both modes and within B4_MAX_ERR
    of each row's largest magnitude of the default build's. Returns
    {label: [ms, ms]}."""
    from sixdgs_torch.ops import _build

    rec, starts, counts, nx, ny, bg = b3_args
    n_tiles, nc = nx * ny, rec.shape[1]
    ref_out = pt.pallas_composite_fwd(*b3_args)
    ref_g = pt.pallas_composite_bwd(rec, starts, counts, nx, ny, out, dout, aligned=True,
                                    texcl=tex)
    scale = ref_g.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    calls = {}
    for name, defs in VARIANT_BUILDS:
        lib = _build.library(name, defs)
        (fname, (restype, argtypes)), = pt._SIGNATURES[name].items()
        fn = getattr(lib, fname)
        fn.restype, fn.argtypes = restype, argtypes
        label = " ".join(defs)
        if name == "composite_fwd":
            def b3(store, fn=fn):
                o = torch.empty(n_tiles, 256, 3, device="cuda")
                tx = torch.empty(nc // 128, 256, 128, device="cuda") if store else None
                _build.launch(fn, rec, nc, starts, counts, n_tiles, nx, bg, o, tx)
                return o
            same = (torch.equal(b3(False), ref_out), torch.equal(b3(True), ref_out))
            if not all(same):
                raise AssertionError(f"B3 {label}: out differs from the default build {same}")
            calls[f"B3 {label}"] = lambda b3=b3: b3(False)
            calls[f"B3 store {label}"] = lambda b3=b3: b3(True)
        else:
            def b4(texcl, fn=fn):
                g = torch.zeros(16, nc, device="cuda")
                _build.launch(fn, rec, nc, starts, counts, n_tiles, nx, out, dout, texcl, g)
                return g
            stored, replay = b4(tex), b4(None)
            rel = ((stored - ref_g).abs() / scale)[:9].max().item()
            if not (torch.equal(stored, replay) and rel <= B4_MAX_ERR):
                raise AssertionError(f"B4 {label}: modes equal {torch.equal(stored, replay)}, "
                                     f"{rel} of the row max off the default build")
            calls[f"B4 stored {label}"] = lambda b4=b4: b4(tex)
            calls[f"B4 replay {label}"] = lambda b4=b4: b4(None)
    times = {k: [] for k in calls}
    for order in (list(calls), list(reversed(calls))):
        for k in order:
            times[k].append(cuda_ms(calls[k], reps=10))
    return times


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


def b1_flops_k_path(n: int) -> int:
    """Flops of the function through K = feats Wk and the logits q K^T,
    once; the earlier design executed them twice."""
    return 2 * (n * D * D + P * n * D)


def b1_flops_reassociated(n: int) -> int:
    """Flops the function needs, without K: q'' = q Wk^T, then the logits
    (q'' feats^T + q bk) / sqrt(d)."""
    return 2 * (P * n * D + P * D * D)


def b1_executed_flops(n: int) -> int:
    """Flops the kernel executes: the logits twice (stats pass, emit pass)
    on the tensor cores (each times the mode's products), q'' and qb in
    f32 FMA."""
    return 2 * 2 * P * n * D + 2 * P * D * (D + 1)


def b1_bound(n: int, mode: str):
    """(bound_ms, bound_by) of one B1 call, on B2's terms: the reassociated
    flops at the bf16 tensor-core rate divided by the products the mode's
    accuracy needs (PRODUCTS), against each input read once and each output
    written once."""
    rate = BF16_FLOPS_PER_S / PRODUCTS[mode]
    nbytes = 4 * (P * D + n * D + D * D + D + P + n + n + 2 * P)
    t_ops, t_bytes = b1_flops_reassociated(n) / rate, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def b1_case(ak, ins, mode, n):
    """B1 against its plain version at the gates' limits, its invalid tail
    scored exactly 0, and a second launch on the same inputs bitwise equal
    to the first; returns the max abs error of the scores."""
    out = ak.attention_scores_fwd(*ins, mode=mode)
    again = ak.attention_scores_fwd(*ins, mode=mode)
    rs, rm, rss = ak.attention_scores_plain(*ins, mode=mode)
    fs, fm, fss = ak.attention_scores_plain(*ins, mode="f32")
    torch.cuda.synchronize()
    s, m, ss = out
    err = (s - rs).abs().max().item()
    scale = rs.abs().max().item()
    m_err = (m - rm).abs().max().item()
    s_rel = ((ss - rss).abs() / rss).max().item()
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    log(f"B1 n={n} mode={mode}: max_abs_err={err:.3e} (max|ref|={scale:.3e}, "
        f"rel={err / scale:.3e}) m_err={m_err:.3e} s_relerr={s_rel:.3e}; against plain "
        f"f32: rel={(s - fs).abs().max().item() / fs.abs().max().item():.3e} m_err="
        f"{(m - fm).abs().max().item():.3e} s_relerr={((ss - fss).abs() / fss).max().item():.3e}"
        f"; second launch bitwise equal: {same}")
    if not same:
        raise AssertionError(f"B1 at n={n} {mode}: a second launch on the same inputs differs")
    if not (err <= TOL[mode] * scale):
        raise AssertionError(f"B1 scores off at n={n} {mode}: {err} > {TOL[mode]} * {scale}")
    if not (m_err <= STAT_TOL[mode] * rm.abs().max().item() and s_rel <= STAT_TOL[mode]):
        raise AssertionError(f"B1 stats off at n={n} {mode}")
    tail = n // 8  # b1_inputs' invalid tail
    if not bool((s[n - tail:] == 0).all()):
        raise AssertionError(f"B1 at n={n} {mode}: an invalid ray scored nonzero")
    return err


def softmax_mass_error(ak, ins, mode):
    """max_p |sum_j P_pj - 1| read two ways. Kernel: B1 launched once per
    patch with that patch alone in the mask, so that its scores are the
    row P_pj = exp(l_pj - m_p) / s_p of the logits tile it shares with B2
    (the same code, q'' fragments and feats pieces; B2's passes form the
    same P_pj from it with B1's m and s), summed in float64. Plain: the
    plain logits helper with B1's m and s (cuBLAS logits, which round
    apart from the tile's)."""
    q, feats, wk, bk, _, valid = ins
    _, m, s = ak.attention_scores_fwd(*ins, mode=mode)
    eye = torch.eye(P, device="cuda")
    mass = torch.stack([ak.attention_scores_fwd(q, feats, wk, bk, eye[p], valid,
                                                mode=mode)[0].double().sum()
                        for p in range(P)])
    kernel = (mass - 1).abs().max().item()
    _, logits = ak._plain_logits(q, feats, wk, bk, valid, mode)
    plain = (torch.exp(logits - m) / s).double().sum(1).sub(1).abs().max().item()
    return kernel, plain


def phase_kernels(ak, gen):
    """B1 against its plain version on the card, and the probability mass
    of the shared logits tile; returns the max abs error at the main
    path's shape and mode."""
    main_err = None
    for n in KERNEL_NS:
        ins = b1_inputs(n, gen)
        for mode in ak.MODES:
            err = b1_case(ak, ins, mode, n)
            if n == KERNEL_NS[0] and mode == "bf16_split3":
                main_err = err
            if n == KERNEL_NS[0]:
                kernel, plain = softmax_mass_error(ak, ins, mode)
                log(f"B1/B2 shared logits n={n} mode={mode}: max_p |sum_j P_pj - 1| "
                    f"{kernel:.3e} (limit {MASS_TOL:.0e}); from the plain logits helper "
                    f"{plain:.3e}")
                if not kernel <= MASS_TOL:
                    raise AssertionError(f"softmax mass off by {kernel} in {mode}")
    # a ragged ray count with a zero-padded (invalid) tail
    ins = b1_inputs(5000, gen)
    for mode in ak.MODES:
        b1_case(ak, ins, mode, 5000)
    return main_err


def b2_flops(n: int) -> int:
    """Flops the backward needs, reassociated so that K is never formed: the
    logits, dfeats = dlog^T q'' and A = dlog feats (3 P N d), q'' = q Wk^T,
    dq = A Wk and dWk = A^T q (3 P d^2)."""
    return 2 * (3 * P * n * D + 3 * P * D * D)


def b2_executed_flops(n: int) -> int:
    """Flops the kernel executes: the logits twice (c pass, gradient pass),
    dfeats and A on the tensor cores (each times the mode's products), the
    prologue and epilogue on the CUDA cores."""
    return 2 * (4 * P * n * D + 3 * P * D * D)


def b2_flops_k_path(n: int) -> int:
    """The count of the earlier design, which formed K: 2 (3 N d^2 + 3 P N d)."""
    return 2 * (3 * n * D * D + 3 * P * n * D)


def b2_bound(n: int, mode: str):
    """(bound_ms, bound_by) of one B2 call: b2_flops at the bf16 tensor-core
    rate divided by the products the mode's accuracy needs (PRODUCTS),
    against inputs q, feats, Wk, bk, pmask, valid, m, s, g read once and dq,
    dfeats, dWk, dbk written once."""
    rate = BF16_FLOPS_PER_S / PRODUCTS[mode]
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
    """B2 on B1's residuals against its plain version, and a second launch
    on the same inputs bitwise equal to the first; returns the max abs
    error over the four gradients."""
    _, m, s = ak.attention_scores_fwd(*ins, mode=mode)
    out = ak.attention_scores_bwd(*ins, m, s, g, mode=mode)
    again = ak.attention_scores_bwd(*ins, m, s, g, mode=mode)
    ref = ak.attention_scores_bwd_plain(*ins, m, s, g, mode=mode)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"B2 at n={ins[1].shape[0]} {mode}: a second launch on the "
                             f"same inputs differs")
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
    return worst, out, " ".join(msgs + ["second launch bitwise equal"])


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


def backward_checks(pt, label: str, args, out_nostore) -> float:
    """B3 with the store and B4 on one set of compositor inputs ``args`` =
    (records, starts, counts, nx, ny, bg), aligned: ``out`` with the store
    bitwise equal to ``out_nostore``; the store against the plain version's
    on reached lanes (TEXCL_REL_ERR); B4 replay against its plain version
    under a random cotangent (B4_MAX_ERR, B4_FLIP_SHARE); stored against
    replay and a second launch, bitwise. Returns B4's max abs error."""
    rec, starts, counts, nx, ny, bg = args
    out, tex = pt.pallas_composite_fwd(*args, store_t=True)
    torch.cuda.synchronize()
    same = torch.equal(out, out_nostore)
    walk = pt._SegmentWalk(rec, starts, counts, nx, ny)
    tex_err, reached = 0.0, 0
    for k, c in enumerate(walk):
        got = tex[walk.starts[c.act] // pt.KB + k]
        rel = (got - c.texcl).abs() / c.texcl.clamp_min(1e-4)
        tex_err = max(tex_err, torch.where(c.reached, rel, torch.zeros_like(rel)).max().item())
        reached += int(c.reached.sum())
    log(f"B3 store {label}: out bitwise equal to store_t=False: {same}; stored "
        f"transmittance vs plain on {reached} reached lanes: max rel err {tex_err:.2e} "
        f"(limit {TEXCL_REL_ERR})")
    if not same or not tex_err <= TEXCL_REL_ERR:
        raise AssertionError(f"B3 store {label}: out equal {same}, texcl err {tex_err}")
    dout = torch.randn(out.shape, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(SEED))
    replay = pt.pallas_composite_bwd(rec, starts, counts, nx, ny, out, dout)
    stored = pt.pallas_composite_bwd(rec, starts, counts, nx, ny, out, dout, aligned=True,
                                     texcl=tex)
    again = pt.pallas_composite_bwd(rec, starts, counts, nx, ny, out, dout)
    want = pt.composite_bwd_plain(rec, starts, counts, nx, ny, out, dout)
    torch.cuda.synchronize()
    return b4_check(label, replay, want, int(counts.sum()),
                    {"stored == replay": torch.equal(replay, stored),
                     "second launch": torch.equal(replay, again)})


def b4_check(label: str, got, want, real: int, bitwise: dict) -> float:
    """B4 against its plain version (per row: B4_MAX_ERR of the row's
    largest magnitude, at most a B4_FLIP_SHARE of the ``real`` lanes off by
    more than 1e-5 of it), rows 9-15 zero, and the ``bitwise`` readings all
    true; returns the max abs error."""
    scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    err = (got - want).abs()
    rel = (err / scale)[:9]
    share = (rel > 1e-5).sum().item() / max(9 * real, 1)
    log(f"B4 {label}: bitwise {json.dumps(bitwise)}; vs plain max_abs_err="
        f"{err.max().item():.3e}, max err / row max {rel.max().item():.2e} (limit "
        f"{B4_MAX_ERR}), share of real lanes off by > 1e-5 of the row max: {share:.2e} "
        f"(limit {B4_FLIP_SHARE}); rows 9-15 zero: {not got[9:].any().item()}")
    if not (all(bitwise.values()) and torch.isfinite(got).all() and not got[9:].any()
            and rel.max().item() <= B4_MAX_ERR and share <= B4_FLIP_SHARE):
        raise AssertionError(f"B4 {label} failed: bitwise {bitwise}, {rel.max().item()}, {share}")
    return err.max().item()


def design_case(case: str, seed: int = 6):
    """The compositor's design cases on the card: (records [16, NC], starts,
    counts, nx, ny). far_means: means up to 40 px from the tile origin, wide
    footprints; all_contribute: translucent splats over the whole tile,
    every pixel contributing to every pair (B4's reduce at full load);
    half_stopped: two passes of opaque one-row splats over the tile's top
    half first, so that its pixels stop early and the bottom half walks on;
    packed: segments starting anywhere (not at multiples of 4) in an odd
    NC. The same cases as tests/test_torch_cuda_kernels.py's."""
    rng = np.random.default_rng(seed)
    nx = ny = 3 if case == "packed" else 4
    n_tiles = nx * ny
    counts = rng.integers(150, 400, n_tiles)
    if case == "packed":
        counts[[1, 4]] = [0, 3]
        gaps = rng.integers(1, 6, n_tiles)
        starts = 3 + np.concatenate([[0], np.cumsum(counts + gaps)])
        nc = int(starts[-1]) | 1
    else:
        starts = np.concatenate([[0], np.cumsum(-(-counts // 128) * 128)])
        nc = int(starts[-1]) + 128
    rec = np.zeros((16, nc), np.float32)
    t = np.repeat(np.arange(n_tiles), counts)
    idx = np.concatenate([np.arange(s, s + c) for s, c in zip(starts[:-1], counts)])
    n = idx.size
    ox, oy = (t % nx) * 16.0, (t // nx) * 16.0
    A, C = rng.uniform(0.05, 0.3, n), rng.uniform(0.05, 0.3, n)
    x, y = ox + rng.uniform(-4, 20, n), oy + rng.uniform(-4, 20, n)
    opac = rng.uniform(0.1, 0.99, n)
    if case == "far_means":
        x, y = ox + rng.uniform(-40, 40, n), oy + rng.uniform(-40, 40, n)
        A, C = rng.uniform(0.002, 0.02, n), rng.uniform(0.002, 0.02, n)
        opac = rng.uniform(0.05, 0.6, n)
    elif case == "all_contribute":
        x, y = ox + 8 + rng.uniform(-2, 2, n), oy + 8 + rng.uniform(-2, 2, n)
        A, C = rng.uniform(0.001, 0.003, n), rng.uniform(0.001, 0.003, n)
        opac = rng.uniform(0.008, 0.02, n)
    B = rng.uniform(-0.5, 0.5, n) * np.sqrt(A * C)
    if case == "half_stopped":
        # the first 16 pairs of each segment: rows 0-7, twice, opaque; the
        # rest translucent
        opac = rng.uniform(0.02, 0.1, n)
        k = np.concatenate([np.arange(c) for c in counts])
        row = k < 16
        x[row], y[row] = ox[row] + 8, oy[row] + k[row] % 8
        A[row], B[row], C[row], opac[row] = 1e-4, 0.0, 2.0, 1.0
    rec[0, idx], rec[1, idx] = x, y
    rec[2, idx], rec[3, idx], rec[4, idx] = A, B, C
    rec[5:8, idx] = rng.uniform(0, 1, (3, n))
    rec[8, idx] = opac
    return (torch.tensor(rec, device="cuda"),
            torch.tensor(starts, dtype=torch.int32, device="cuda"),
            torch.tensor(counts, dtype=torch.int32, device="cuda"), nx, ny)


def phase_design_cases(pt):
    """B3 (with and without the store) and B4 (both modes) on the aligned
    design cases; B3 without the store and B4 replaying on the packed one,
    where the stored modes must refuse the layout."""
    bg = torch.tensor([0.1, 0.5, 0.9], device="cuda")
    for case in ("far_means", "all_contribute", "half_stopped"):
        rec, starts, counts, nx, ny = design_case(case)
        got = pt.pallas_composite_fwd(rec, starts, counts, nx, ny, bg)
        want, (evals, contribs) = pt.composite_fwd_plain(rec, starts, counts, nx, ny, bg,
                                                         return_work=True)
        torch.cuda.synchronize()
        log(f"B3 {case}: {nx * ny} tiles of {int(counts.min())}-{int(counts.max())} pairs, "
            f"{evals} evaluations, {contribs} contributions of {256 * int(counts.sum())} "
            f"(pixel, pair)")
        b3_check(case, got, want)
        backward_checks(pt, case, (rec, starts, counts, nx, ny, bg), got)
    rec, starts, counts, nx, ny = design_case("packed")
    got = pt.pallas_composite_fwd(rec, starts, counts, nx, ny, bg)
    want = pt.composite_fwd_plain(rec, starts, counts, nx, ny, bg)
    torch.cuda.synchronize()
    log(f"packed layout: nc {rec.shape[1]}, segment starts {starts[:-1].tolist()}")
    b3_check("packed", got, want)
    dout = torch.randn(got.shape, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(SEED))
    replay = pt.pallas_composite_bwd(rec, starts, counts, nx, ny, got, dout)
    again = pt.pallas_composite_bwd(rec, starts, counts, nx, ny, got, dout)
    want = pt.composite_bwd_plain(rec, starts, counts, nx, ny, got, dout)
    torch.cuda.synchronize()
    lane = torch.arange(rec.shape[1], device="cuda")
    walked = ((lane[None] >= starts[:-1, None].long())
              & (lane[None] < (starts[:-1] + counts).long()[:, None])).any(0)
    b4_check("packed", replay, want, int(counts.sum()),
             {"second launch": torch.equal(replay, again),
              "lanes between segments zero": not replay[:, ~walked].any().item()})
    refused = []
    for call in (lambda: pt.pallas_composite_fwd(rec, starts, counts, nx, ny, bg, store_t=True),
                 lambda: pt.pallas_composite_bwd(
                     rec, starts, counts, nx, ny, got, dout,
                     texcl=torch.zeros(rec.shape[1] // 128, 256, 128, device="cuda"))):
        try:
            call()
            refused.append(False)
        except ValueError:
            refused.append(True)
    log(f"packed layout: the stored modes refuse it: {refused}")
    if not all(refused):
        raise AssertionError(f"a stored mode took the packed layout: {refused}")


def phase_raster_kernels(pt, rng):
    """B5, B3 and B4 against their plain versions on synthetic layouts: B5
    on a truncated full-size layout and on all-empty tiles, B3 (with and
    without the store) and B4 on segments of 2,000-2,600 pairs per tile,
    opaque (tiles exit early) and translucent."""
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
        backward_checks(pt, label, (rec, starts, counts, 8, 8, bg), got)
    phase_design_cases(pt)


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
    records_t = pt._gather_records(lay, gidx_al)
    out = pt.pallas_composite_fwd(records_t, lay.starts_al, lay.counts_k, lay.nx, lay.ny, bg)
    want, work = pt.composite_fwd_plain(records_t, lay.starts_al, lay.counts_k, lay.nx,
                                        lay.ny, bg, return_work=True)
    b3_err = b3_check("scene records", out, want)
    log(f"B3 scene work: {work[0]} evaluations ({work[0] / (lay.n_tiles * 256):.1f} per "
        f"pixel), {work[1]} contributions")
    b4_err = backward_checks(pt, "scene records", (records_t, lay.starts_al, lay.counts_k,
                                                   lay.nx, lay.ny, bg), out)
    log("phase 5 render: ok")
    return {"cams": cams, "bg": bg, "lay": lay, "records_t": records_t, "work": work,
            "launches": launches, "b3_err": b3_err, "b5_err": b5_err, "b4_err": b4_err,
            "render_err": render_err, "imgs": imgs}


def b3_bound(work, lay, store: bool = False):
    """(bound_ms, bound_by) of one B3 call on ``lay``: the operations these
    inputs need (B3_OPS_PER_EVAL per evaluation up to each pixel's stop,
    B3_OPS_PER_CONTRIB per contributing pair) at the f32 peak, against the
    live record rows (9 floats per real pair), starts and counts read once
    and the image written once; with the store, one transmittance written
    per evaluation too."""
    evals, contribs = work
    ops = B3_OPS_PER_EVAL * evals + B3_OPS_PER_CONTRIB * contribs
    nbytes = 4 * (9 * int(lay.counts_k.sum()) + 2 * lay.n_tiles + 3
                  + lay.n_tiles * 256 * 3 + (evals if store else 0))
    t_ops, t_bytes = ops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def b5_bound(lay):
    """(bound_ms, bound_by) of one B5 call: the real indices and both start
    arrays read once, nc indices written (no arithmetic to speak of)."""
    nbytes = 4 * (int(lay.starts[-1]) + 2 * (lay.n_tiles + 1) + lay.nc)
    return 1e3 * nbytes / HBM_BYTES_PER_S, "bytes"


def b4_bound(work, lay, stored: bool):
    """(bound_ms, bound_by) of one B4 call on ``lay``: B4_OPS_PER_EVAL per
    evaluation up to each pixel's stop and B4_OPS_PER_CONTRIB per
    contributing pair at the f32 peak, against the live record rows, starts,
    counts, out and dout read once and dpairs [16, nc] written once; the
    stored mode also reads one transmittance per evaluation."""
    evals, contribs = work
    ops = B4_OPS_PER_EVAL * evals + B4_OPS_PER_CONTRIB * contribs
    nbytes = 4 * (9 * int(lay.counts_k.sum()) + 2 * lay.n_tiles
                  + 2 * lay.n_tiles * 256 * 3 + 16 * lay.nc + (evals if stored else 0))
    t_ops, t_bytes = ops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


class plain_compositor:
    """Within the block the compositor's wrappers run their plain versions
    on the card (the twin that the kernels' training step is held against).
    Used nowhere but here."""

    def __init__(self, pt):
        self.pt = pt

    def __enter__(self):
        pt = self.pt
        self.saved = (pt.pallas_composite_fwd, pt.pallas_composite_bwd)

        def fwd(records, starts, counts, nx, ny, bg, store_t=False):
            return pt.composite_fwd_plain(records, starts, counts, nx, ny, bg, store_t=store_t)

        def bwd(records, starts, counts, nx, ny, out, dout, aligned=False, texcl=None):
            return pt.composite_bwd_plain(records, starts, counts, nx, ny, out, dout, texcl)

        pt.pallas_composite_fwd, pt.pallas_composite_bwd = fwd, bwd

    def __exit__(self, *exc):
        self.pt.pallas_composite_fwd, self.pt.pallas_composite_bwd = self.saved


def phase_gs_training(ak, pt, arrays, render, rng):
    """The 3DGS training path at full width; returns what the timing phase
    and the kernel records need."""
    import dataclasses

    from sixdgs_torch.ops.knn import mean_sq_dist_3nn
    from sixdgs_torch.scene.gaussians import PARAM_NAMES, from_arrays
    from sixdgs_torch.scene.structures import BasicPointCloud, SceneInfo
    from sixdgs_torch.train import gs_trainer as gs
    from sixdgs_torch.utils.config import ModelConfig, OptimizationConfig

    # ground truth: the render phase's images of the unperturbed scene
    cams = [dataclasses.replace(cam, image=img.cpu().numpy())
            for cam, img in zip(render["cams"], render["imgs"])]
    pcd = BasicPointCloud(points=arrays["xyz"], colors=rng.uniform(size=(N_GAUSSIANS, 3)),
                          normals=np.zeros((N_GAUSSIANS, 3)))
    info = SceneInfo(pcd, [], [], {"radius": 3.1, "translate": np.zeros(3)}, "")
    opt = OptimizationConfig()
    t0 = time.perf_counter()
    trainer = gs.GSTrainer(ModelConfig(sh_degree=3, white_background=True), opt, info,
                           cams, cams[:2], seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init = trainer.state.scene
    log(f"GSTrainer set-up (create_from_pcd, 3-NN of {N_GAUSSIANS} points): "
        f"{time.perf_counter() - t0:.2f} s; capacity {init.capacity}, "
        f"{int(init.num_active())} active")
    pts = torch.tensor(arrays["xyz"], device="cuda")
    sub = torch.arange(0, N_GAUSSIANS, N_GAUSSIANS // 2048, device="cuda")
    d = torch.cdist(pts[sub], pts, compute_mode="donot_use_mm_for_euclid_dist")
    want = torch.topk(d, 4, dim=1, largest=False).values[:, 1:].square().mean(1)
    got = mean_sq_dist_3nn(pts)[sub]
    knn_err = (got - want).abs().max().item()
    log(f"mean_sq_dist_3nn vs torch.cdist on {sub.numel()} points: max abs err "
        f"{knn_err:.2e} (mean value {want.mean().item():.3e}; limit {KNN_ATOL} + "
        f"{KNN_RTOL} rel)")
    if not bool(((got - want).abs() <= KNN_ATOL + KNN_RTOL * want).all()):
        raise AssertionError(f"mean_sq_dist_3nn off torch.cdist by {knn_err}")
    scales = np.log(np.sqrt(np.maximum(got.cpu().numpy(), 1e-7)))
    if not np.allclose(init.scaling[sub].cpu().numpy(), scales[:, None], atol=1e-5):
        raise AssertionError("create_from_pcd's scales do not follow the 3-NN distances")
    del d, pts

    # the state to train: the render scene perturbed, SH degree 3
    noisy = dict(arrays)
    for name, sigma in GS_NOISE.items():
        noisy[name] = (arrays[name] + rng.normal(size=arrays[name].shape) * sigma).astype(
            np.float32)
    start_state = gs.init_train_state(from_arrays(noisy, max_sh_degree=3, device="cuda"))
    trainer.state = start_state
    trainer.active_sh_degree = 3
    psnr_before = trainer.eval_psnr()

    steps, logged, grabbed = [], [], {}

    def pre_step(it, tr):
        torch.cuda.synchronize()
        steps.append((it, time.perf_counter(), torch.cuda.max_memory_allocated(),
                      int(tr.state.scene.capacity)))
        if it == GS_FIRST_IT + 1:
            grabbed["m"] = dict(tr.state.adam.m)  # 0.1 x the first step's gradients
        torch.cuda.reset_peak_memory_stats()

    def callback(it, metrics, tr):
        torch.cuda.synchronize()
        logged.append((it, metrics, int(tr.state.scene.num_active())))

    counters = (pt._align_compact, pt.pallas_composite_bwd, ak.attention_scores_fused,
                ak.attention_scores_bwd)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    pt.pallas_composite_fwd.launches = pt.pallas_composite_fwd.store_launches = 0
    trainer.run(iterations=GS_LAST_IT, first_iteration=GS_FIRST_IT, log_every=GS_LOG_EVERY,
                callback=callback, pre_step=pre_step, rasterizer="auto",
                adapt_tiers_every=GS_ADAPT_EVERY)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    psnr_after = trainer.eval_psnr()
    torch.cuda.synchronize()
    n_steps = GS_LAST_IT - GS_FIRST_IT + 1
    launches = {"b5": pt._align_compact.launches, "b4": pt.pallas_composite_bwd.launches,
                "b3_store": pt.pallas_composite_fwd.store_launches,
                "b3": pt.pallas_composite_fwd.launches}
    log(f"phase 6 3DGS training: {n_steps} steps; launches {json.dumps(launches)} "
        f"(expected B3 store {n_steps}, B4 {n_steps}, B5 {n_steps} + 2 evaluation renders, "
        f"B3 without the store 2); B1 {ak.attention_scores_fused.launches}, "
        f"B2 {ak.attention_scores_bwd.launches}")
    if launches != {"b5": n_steps + 2, "b4": n_steps, "b3_store": n_steps, "b3": 2} or (
            ak.attention_scores_fused.launches or ak.attention_scores_bwd.launches):
        raise AssertionError(f"3DGS training path launches {launches}")

    for it, m, n_active in logged:
        log(f"  it {it}: loss {m['loss']:.6f} l1 {m['l1']:.6f} psnr {m['psnr']:.3f} "
            f"nc_demand {m['binning_nc_demand']} nc_real {m['binning_nc_real']} "
            f"grad_dropped {m['binning_grad_dropped']} dropped "
            f"{m['binning_dropped_main']}/{m['binning_dropped_mid']}/"
            f"{m['binning_dropped_big']} active {n_active}")
        if m["binning_grad_dropped"] != 0 or not math.isfinite(m["loss"]):
            raise AssertionError(f"iteration {it}: grad_dropped "
                                 f"{m['binning_grad_dropped']}, loss {m['loss']}")
    if [x[0] for x in logged] != [it for it in range(GS_FIRST_IT, GS_LAST_IT + 1)
                                  if it % GS_LOG_EVERY == 0 or it == GS_LAST_IT]:
        raise AssertionError(f"telemetry iterations {[x[0] for x in logged]}")
    first_loss, last_loss = logged[0][1]["loss"], logged[-1][1]["loss"]
    log(f"loss {first_loss:.6f} (it {logged[0][0]}) -> {last_loss:.6f} (it {logged[-1][0]}); "
        f"eval_psnr on 2 cameras (psnr, l1) before {psnr_before} after {psnr_after}")
    if not (last_loss < first_loss and all(map(math.isfinite, psnr_after))
            and psnr_after[0] > psnr_before[0]):
        raise AssertionError(f"loss {first_loss} -> {last_loss}, eval {psnr_before} -> "
                             f"{psnr_after}")

    # the densification event at iteration 600
    before = next(n for it, _, n in logged if it == 600)
    state = trainer.state
    n_after = int(state.scene.num_active())
    log(f"densify event at it 600: active {before} -> {n_after}, capacity "
        f"{start_state.scene.capacity} -> {state.scene.capacity}")
    if n_after == before:
        raise AssertionError("the densification event left the Gaussian count unchanged")
    for k in PARAM_NAMES:
        shape = getattr(state.scene, k).shape
        if not (state.adam.m[k].shape == state.adam.v[k].shape == shape
                and shape[0] == state.scene.capacity):
            raise AssertionError(f"Adam moments of {k} lost the scene's shape")

    # first step against the plain twin: Adam's m after one step is 0.1 g
    first_cam = list(cams).pop(int(np.random.default_rng(SEED).integers(len(cams))))
    with plain_compositor(pt):
        twin, _ = gs.train_step(
            start_state, gs.camera_arrays(first_cam, "cuda", with_image=True), trainer.bg,
            gs.lr_dict(opt, trainer.spatial_lr_scale, GS_FIRST_IT), width=RENDER_W,
            height=RENDER_H, sh_degree=3, rasterizer="auto", with_telemetry=False)
    torch.cuda.synchronize()
    if pt.pallas_composite_bwd.launches != n_steps:
        raise AssertionError("the plain twin launched B4")
    worst = 0.0
    for k in PARAM_NAMES:
        g, w = 10 * grabbed["m"][k], 10 * twin.adam.m[k]
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        log(f"  first-step gradient of {k}: max |g| {scale:.3e}, kernels vs plain twin max "
            f"abs err {err:.3e} ({err / scale:.2e} of it; limit {GS_GRAD_TOL})")
        worst = max(worst, err / scale)
        if not (scale > 0 and err <= GS_GRAD_TOL * scale):
            raise AssertionError(f"first-step gradient of {k}: {err} > {GS_GRAD_TOL} * {scale}")

    # steady steps: not the first (warm-up), not the adaptation iteration,
    # not the densification iteration (its host event) and the step after
    # it (new shapes)
    ms = {it: 1e3 * (t1 - t0) for (it, t0, _, _), (_, t1, _, _)
          in zip(steps, steps[1:] + [(None, t_end, None, None)])}
    peaks = {it: p for (it, _, _, _), (_, _, p, _) in zip(steps, steps[1:])}
    steady = [it for it in ms if it not in (GS_FIRST_IT, GS_ADAPT_EVERY, 600, 601)]
    quiet = [it for it in steady if it % GS_LOG_EVERY]
    timing = {
        "gs_step_ms": statistics.median(ms[it] for it in quiet),
        "gs_step_ms_with_telemetry": statistics.median(
            ms[it] for it in steady if it % GS_LOG_EVERY == 0),
        "gs_step_ms_min": min(ms[it] for it in quiet),
        "gs_step_ms_max": max(ms[it] for it in quiet),
        "gs_densify_iteration_ms": ms[600],
        "gs_peak_gib": max(peaks[it] for it in steady if it in peaks) / 2**30,
    }
    log("3DGS training per step (host clock, median of steady steps without telemetry): "
        + json.dumps(timing))
    log("  per iteration ms: " + " ".join(f"{it}:{v:.1f}" for it, v in ms.items()))
    log("phase 6 3DGS training: ok")
    return {"launches": launches, "timing": timing, "trainer": trainer,
            "start_state": start_state, "first_cam": first_cam, "grad_err": worst,
            "n_steps": n_steps}


def ptxas_report(build, name: str, defines: tuple = ()) -> list:
    """Registers, spills and static shared memory of each kernel of
    csrc/<name>.cu (built with ``defines``), from the ptxas report that the
    build keeps; a template instance is labelled by its int and bool
    arguments (<true, 1, 256>)."""
    import re

    lines = build._lib_path(name, defines).with_suffix(".log").read_text().splitlines()
    out, fn, spill = [], None, ""
    for line in lines:
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            m = re.search(r"\d(b\d_[a-z_]+)(I.*?E)?E", entry.group(1))
            args = re.findall(r"L([ib])(\d+)E", (m.group(2) or "") if m else "")
            label = ", ".join(v if t == "i" else "true" if v == "1" else "false"
                              for t, v in args)
            fn = (m.group(1) + (f"<{label}>" if args else "")) if m else entry.group(1)
        elif "spill" in line and fn:
            spill = line.strip()
        elif "Used" in line and fn:
            out.append(f"{fn}: {line.split('Used', 1)[1].strip()} ({spill})")
            fn = None
    return out


def profile_run(label: str, run, unprofiled_ms: float, shares: bool = False) -> dict:
    """Device time by kernel over one call of ``run`` (torch.profiler), and
    the device's busy share of the unprofiled time of one call; with
    ``shares``, each kernel's share of the device time. Returns the device
    ms of the whole call and of B1's and B2's kernels."""
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
        share = f" {100 * r.self_device_time_total / 1e3 / busy_ms:5.1f}%" if shares else ""
        log(f"  {r.self_device_time_total / 1e3:8.3f} ms{share} x{r.count:<4d} {r.key[:100]}")
    by = {k: sum(r.self_device_time_total for r in rows if k in r.key) / 1e3
          for k in ("b1_", "b2_", "b3_", "b4_", "b5_")}
    return {"busy_ms": busy_ms, **{f"{k}ms": v for k, v in by.items()}}


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

    # 1. build: one nvcc per source and per variant, all started together
    t0 = time.perf_counter()
    jobs = [(name, ()) for name in KERNEL_SOURCES] + list(VARIANT_BUILDS)
    with ThreadPoolExecutor(len(jobs)) as pool:
        secs = list(pool.map(lambda job: _build.build(*job), jobs))
    variants = {f"{n} {' '.join(d)}": x for (n, d), x in zip(VARIANT_BUILDS,
                                                             secs[len(KERNEL_SOURCES):])}
    log(f"phase 1 build: {json.dumps(dict(zip(KERNEL_SOURCES, secs)))} s; variants "
        f"{json.dumps(variants)} s ({time.perf_counter() - t0:.2f} s wall)")

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

    # 6. 3DGS training path at full width
    gs_run = phase_gs_training(ak, pt, arrays, render, rng)

    # 7. timing
    n = KERNEL_NS[0]
    ins = b1_inputs(n, gen)
    ms = cuda_ms(lambda: ak.attention_scores_fused(*ins))
    plain_ms = cuda_ms(lambda: ak.attention_scores_plain(*ins, mode="bf16_split3"))
    bound_ms, bound_by = b1_bound(n, "bf16_split3")
    # the emit pass recomputes the logits, so the kernel executes them twice
    log(f"B1 n={n}: needed {b1_flops_reassociated(n) / 1e9:.2f} GFLOP (the bound's count, "
        f"at {BF16_FLOPS_PER_S / PRODUCTS['bf16_split3'] / 1e12:.1f} TFLOP/s), executed "
        f"{b1_executed_flops(n) / 1e9:.2f} GFLOP ({2 * 2 * P * n * D / 1e9:.2f} of them on "
        f"the tensor cores, times 3 products in split3); the earlier design formed K and "
        f"executed {2 * b1_flops_k_path(n) / 1e9:.2f} GFLOP in f32 FMA; split3 kernel at "
        f"{b1_flops_reassociated(n) / ms / 1e9:.2f} TFLOP/s needed, "
        f"{bound_ms / ms:.3f} of its bound ({bound_ms:.4f} ms, {bound_by})")
    profile_run("B1 call (n=32768, split3)", lambda: ak.attention_scores_fused(*ins), ms,
                shares=True)
    log("B1 kernels (ptxas; dynamic shared memory of b1_stats and b1_emit: NP x 50,176 "
        "bytes for NP bf16 pieces, <1> bf16, <2> split3, <3> f32): " + "; ".join(
            ptxas_report(_build, "attention_scores")))
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
    log(f"B2 n={n}: needed {b2_flops(n) / 1e9:.2f} GFLOP reassociated (the earlier "
        f"design's count with K: {b2_flops_k_path(n) / 1e9:.2f}), executed "
        f"{b2_executed_flops(n) / 1e9:.2f} GFLOP ({2 * 4 * P * n * D / 1e9:.2f} of them on "
        f"the tensor cores, times 3 products in split3); split3 kernel at "
        f"{b2_flops(n) / b2_ms / 1e9:.2f} TFLOP/s needed, {b2_bound_ms / b2_ms:.3f} "
        f"of its bound ({b2_bound_ms:.4f} ms, {b2_bound_by})")
    profile_run("B2 call (n=32768, split3)", lambda: ak.attention_scores_bwd(*ins, m, s, g),
                b2_ms, shares=True)
    log("B2 kernels (ptxas; dynamic shared memory of b2_c and b2_grad: NP x 50,176 bytes "
        "for NP bf16 pieces, <1> bf16, <2> split3, <3> f32): " + "; ".join(ptxas_report(
            _build, "attention_scores_bwd")))
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
    prof = profile_run("fused eval_image",
                       lambda: eval_image(dino_model, id_module, images[0], masks[0], c2ws[0],
                                          rays, fused_attention=True), per_image["fused"])
    log(f"fused eval_image: device {prof['busy_ms']:.3f} ms, B1 {prof['b1_ms']:.3f} ms "
        f"({100 * prof['b1_ms'] / prof['busy_ms']:.1f}%) of it")
    # one more step of each trainer, after the counted runs
    for label in ("fused", "plain"):
        trainer = trainers[label]
        nxt = trainer.optimizer.state[next(trainer.id_module.parameters())]["step"]
        prof = profile_run(f"{label} training step",
                           lambda: trainer.run(n_iterations=nxt + 1, start_iteration=nxt,
                                               validate_every=0),
                           train_timing[f"{label}_step_ms"])
        if label == "fused":
            busy = prof["busy_ms"]
            train_timing["fused_device_ms"] = busy
            train_timing["fused_busy_share"] = busy / train_timing["fused_step_ms"]
            train_timing["b1_share_of_device"] = prof["b1_ms"] / busy
            train_timing["b2_share_of_device"] = prof["b2_ms"] / busy
            log(f"fused id-module step: device {busy:.3f} ms of {train_timing['fused_step_ms']:.3f}"
                f" ms ({100 * busy / train_timing['fused_step_ms']:.1f}% busy); B1 "
                f"{prof['b1_ms']:.3f} ms ({100 * prof['b1_ms'] / busy:.1f}%), B2 "
                f"{prof['b2_ms']:.3f} ms ({100 * prof['b2_ms'] / busy:.1f}%) of the device time")
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
    prof = profile_run("render_eval", lambda: render_eval(scene, cams[0], bg,
                                                          scene.max_sh_degree), render_ms)
    render_device = {"device_ms": prof["busy_ms"], "b3_ms": prof["b3_ms"],
                     "b5_ms": prof["b5_ms"]}
    log(f"render_eval: device {prof['busy_ms']:.3f} ms; B3 {prof['b3_ms']:.3f} ms "
        f"({100 * prof['b3_ms'] / prof['busy_ms']:.1f}%), B5 {prof['b5_ms']:.3f} ms of it")
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
    # the compositor's training variants on camera 0's layout
    b3s_ms = cuda_ms(lambda: pt.pallas_composite_fwd(*b3_args, store_t=True))
    b3s_plain_ms = cuda_ms(lambda: pt.composite_fwd_plain(*b3_args, store_t=True), reps=5,
                           warmup=1)
    out, tex = pt.pallas_composite_fwd(*b3_args, store_t=True)
    dout = torch.randn(out.shape, device="cuda", generator=gen)
    b4_args = (render["records_t"], lay.starts_al, lay.counts_k, lay.nx, lay.ny, out, dout)
    b4_ms = cuda_ms(lambda: pt.pallas_composite_bwd(*b4_args, aligned=True, texcl=tex))
    b4_replay_ms = cuda_ms(lambda: pt.pallas_composite_bwd(*b4_args))
    b4_plain_ms = cuda_ms(lambda: pt.composite_bwd_plain(*b4_args, texcl=tex), reps=5,
                          warmup=1)
    b4_plain_replay_ms = cuda_ms(lambda: pt.composite_bwd_plain(*b4_args), reps=5, warmup=1)
    b3s_bound_ms, b3s_bound_by = b3_bound(render["work"], lay, store=True)
    b4_bound_ms, b4_bound_by = b4_bound(render["work"], lay, stored=True)
    b4_replay_bound_ms, _ = b4_bound(render["work"], lay, stored=False)
    log(f"B3 with the store: {b3s_ms:.4f} ms (without {b3_ms:.4f}), plain "
        f"{b3s_plain_ms:.3f} ms, bound {b3s_bound_ms:.4f} ms ({b3s_bound_by})")
    log(f"B4 stored: {b4_ms:.4f} ms, plain {b4_plain_ms:.3f} ms, bound {b4_bound_ms:.4f} ms "
        f"({b4_bound_by}); replay: {b4_replay_ms:.4f} ms, plain {b4_plain_replay_ms:.3f} "
        f"ms, bound {b4_replay_bound_ms:.4f} ms")
    back = {
        "B3": cuda_ms_back_to_back(lambda: pt.pallas_composite_fwd(*b3_args)),
        "B3 store": cuda_ms_back_to_back(lambda: pt.pallas_composite_fwd(*b3_args,
                                                                          store_t=True)),
        "B4 stored": cuda_ms_back_to_back(lambda: pt.pallas_composite_bwd(
            *b4_args, aligned=True, texcl=tex)),
        "B4 replay": cuda_ms_back_to_back(lambda: pt.pallas_composite_bwd(*b4_args)),
    }
    log("compositor ms per call, 20 calls back to back between two events: "
        + json.dumps(back))
    log("compositor builds, ms in turns (order, reverse) on camera 0's layout: "
        + json.dumps(variant_times(pt, b3_args, out, dout, tex)))
    for name, defines in (("composite_fwd", ()), ("composite_bwd", ())) + VARIANT_BUILDS:
        log(f"{name} {' '.join(defines) or 'default'} (ptxas; B4's shared memory is "
            f"dynamic): " + "; ".join(ptxas_report(_build, name, defines)))
    del out, tex, dout, b4_args

    # one more 3DGS step after the counted run, profiled
    from sixdgs_torch.train import gs_trainer as gs

    tr = gs_run["trainer"]
    cam_arrays = tr._camera_arrays(gs_run["first_cam"])
    lrs = gs.lr_dict(tr.opt, tr.spatial_lr_scale, GS_LAST_IT + 1)

    def gs_step():
        gs.train_step(tr.state, cam_arrays, tr.bg, lrs, width=RENDER_W, height=RENDER_H,
                      sh_degree=3, rasterizer="auto", with_telemetry=False)

    gs_step()
    prof = profile_run("3DGS training step", gs_step, gs_run["timing"]["gs_step_ms"])
    gs_run["timing"].update({"device_ms": prof["busy_ms"], "b3_ms": prof["b3_ms"],
                             "b4_ms": prof["b4_ms"], "b5_ms": prof["b5_ms"]})
    log(f"3DGS step: device {prof['busy_ms']:.3f} ms; B4 {prof['b4_ms']:.3f} ms "
        f"({100 * prof['b4_ms'] / prof['busy_ms']:.1f}%), B3 {prof['b3_ms']:.3f} ms "
        f"({100 * prof['b3_ms'] / prof['busy_ms']:.1f}%), B5 {prof['b5_ms']:.3f} ms of it")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"total {time.perf_counter() - t_start:.1f} s")

    records = [{
        "name": "B1 attention_scores_fused (_fwd_kernel_train; 4 CUDA kernels per launch, "
                "reassociated, mma.sync in bf16 pieces, one logits tile with B2)",
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
        "name": "B2 attention_scores_bwd (_bwd_kernel; 10 CUDA kernels per launch, "
                "reassociated, mma.sync in bf16 pieces)",
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
        # this slice's path (3DGS training); the render path's count beside it
        "launches": gs_run["launches"]["b5"],
        "launches_by_path": {"render": render["launches"][0],
                             "gs_training": gs_run["launches"]["b5"]},
        "max_abs_err": render["b5_err"],
        "ms": b5_ms,
        "plain_ms": b5_plain_ms,
        "bound_ms": b5_bound_ms,
        "bound_by": b5_bound_by,
        # no single PyTorch call computes the aligned relocation
        "library_ms": None,
    }, {
        "name": "B3 pallas_composite_fwd (_fwd_kernel; ms is store_t=False, store_t_* "
                "the training variant)",
        "route": "cuda",
        "source": "sixdgs_torch/csrc/composite_fwd.cu",
        "replaces": "sixdgs_tpu/ops/rasterizer/pallas_tiles.py:404",
        "launches": gs_run["launches"]["b3_store"] + gs_run["launches"]["b3"],
        "launches_by_path": {"render": render["launches"][1],
                             "gs_training_store_t": gs_run["launches"]["b3_store"],
                             "gs_training_eval": gs_run["launches"]["b3"]},
        "max_abs_err": render["b3_err"],
        "ms": b3_ms,
        "plain_ms": b3_plain_ms,
        "bound_ms": b3_bound_ms,
        "bound_by": b3_bound_by,
        "store_t_ms": b3s_ms,
        "store_t_plain_ms": b3s_plain_ms,
        "store_t_bound_ms": b3s_bound_ms,
        "store_t_bound_by": b3s_bound_by,
        # device time per call with 20 calls issued back to back
        "ms_back_to_back": back["B3"],
        "store_t_ms_back_to_back": back["B3 store"],
        # no single PyTorch call composites depth-ordered splats per tile
        "library_ms": None,
    }, {
        "name": "B4 pallas_composite_bwd (_bwd_kernel; ms is the stored mode, replay_* "
                "the replaying one)",
        "route": "cuda",
        "source": "sixdgs_torch/csrc/composite_bwd.cu",
        "replaces": "sixdgs_tpu/ops/rasterizer/pallas_tiles.py:503",
        "launches": gs_run["launches"]["b4"],
        "max_abs_err": render["b4_err"],
        "ms": b4_ms,
        "plain_ms": b4_plain_ms,
        "bound_ms": b4_bound_ms,
        "bound_by": b4_bound_by,
        "replay_ms": b4_replay_ms,
        "replay_plain_ms": b4_plain_replay_ms,
        "replay_bound_ms": b4_replay_bound_ms,
        "ms_back_to_back": back["B4 stored"],
        "replay_ms_back_to_back": back["B4 replay"],
        # no single PyTorch call differentiates a per-tile compositor
        "library_ms": None,
    }]
    for r in records:
        r["card_ms"] = r["ms"]
    log("training step: " + json.dumps(train_timing))
    log("3DGS training step: " + json.dumps(gs_run["timing"])
        + f"; first-step gradients vs plain twin, worst err / scale {gs_run['grad_err']:.2e}")
    log(f"render_eval per image: {render_ms:.3f} ms, {json.dumps(render_device)}; image vs "
        f"golden model max abs {render['render_err']:.3e}")
    log(gpu_line())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
