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
     N = 5000 with its invalid tail scored exactly 0; B1 and B2 at
     SuperPoint's shape (P = 784 patches of width 256, N = 32768, all three
     modes: the wrapper pads the width to 384 and launches once per 256
     patches) under the same limits, two calls bitwise equal; in each mode the
     probabilities of the logits tile that B1 and B2 share summing to 1
     against B1's m and s (MASS_TOL); B5 on a truncated
     1232x816 layout and on all-empty tiles (equal), and on the layouts of
     tests/align_layouts.py that its CPU and card tests share (empty tiles
     between full ones, exact multiples of 128, a tile over three chunks,
     aligned demand exactly nc and over it, one tile, no tile): equal, a
     second launch bitwise, the tail all sentinel; B3 on 64 tiles of
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
     0's layout, timed in turns, and B5's wrapper's host time per call.
     The ``kernel.*`` counters of ``utils.profiling`` count launches: B1's
     (``kernel.b1``) each four CUDA kernels; B2's, each ten; B5's, B3's and
     B4's, one each;
  8. the pose driver at full width: a Blender-format dataset of the render
     scene written with the port's PNG writer (4 train and 2 test 800x800
     RGBA images from render_eval on a ring), an experiment directory
     (cfg_args, point_cloud/iteration_30000/point_cloud.ply), then
     ``apps.pose_eval.main`` with --fused_attention, 32,768 rays, 32
     images per step and 4 steps (depth cut from 1,500), DINOv2-S/14 and
     the 384-wide id module with random weights. The driver swallows a
     scene's RuntimeError, so the run is held to its output, not its
     return: one result per test image, finite errors, id_module.npz and
     pose_metrics.jsonl written, no traceback, and launch counts zeroed
     just before and read just after (B1 132, B2 128, B3, B4, B5 none);
     then the same driver with --backbone superpoint and random SuperPoint
     weights written as the JAX package's flat npz (--superpoint_weights):
     784 patches of width 256, the 256-wide id module, four launches a call
     (B1 528, B2 512);
  9. the 3DGS apps at full width on that dataset, whose points3d.ply holds
     the scene's 262,144 points: ``apps.train_gs.main`` (--rasterizer auto,
     --eval, 30 iterations from the cloud, --binning_tiers cut so that the
     fresh cloud's frames fit the default pair budget; held to its PLY,
     cfg_args, cameras.json, a finite metrics.jsonl loss that falls from the
     first epoch to the last, no dropped gradient, and launches: B3 with the
     store, B4 and B5 once per step, B5 and B3 once per evaluation render;
     the share of tile coverage the cut tiers drop is logged from every
     step's binning telemetry, which is held to its own arithmetic), then 4
     steps at the app's default tiers (held to the documented rule: a step
     whose aligned demand passes the 2^20 pair budget has its raster
     gradients dropped; launches, a finite loss, the PLY),
     ``apps.render.main`` (B5 and B3 once per image; the PNGs' count and
     size) and ``apps.metrics.main`` with a random VGG LPIPS npz written by
     the port's save_params (finite SSIM, PSNR and LPIPS); then on the render
     cell's camera 0 at 1232x816 render() through "tiled" (plain PyTorch)
     against "pallas" (the kernels), and one train step's gradients the
     same way, with the train step's, each render's and each metric's time,
     and the tiled render's time and peak memory;
 10. the rest of the CLIs at full width: a Cambridge Landmarks dataset of
     the render scene (9 ring cameras as a VisualSFM reconstruction.nvm
     stores them, 800x800 RGB PNGs, every 16th of its points), its loaded
     R and T held to the written cameras (1e-5), and phase 8's driver run
     and gates with --data_type cambridge_landmark (B1 132, B2 128);
     ``apps.full_eval.main`` on a Tanks-and-Temples root holding the phase
     8 dataset as ``truck``, 50 iterations at the default tiers (its one
     logged step held to the grad_dropped rule), render and metrics (the
     PLY, 2 test renders, finite SSIM, PSNR and LPIPS; B3 with the store,
     B4 and B5 once per step, B5 and B3 once per render); the GUI server
     over sockets on 127.0.0.1: one viewer message for the render cell's
     camera 0 decoded by ``NetworkGUI.receive`` and rendered by
     ``render_gui_camera`` through B5 and B3, held against rasterize_scan,
     its bytes and verify string read back, then ``apps.train_gs.main
     --gui`` for 8 iterations with a viewer thread reading a frame a step
     (size, verify string, not all background; B5 and B3 once per frame on
     top of the training's launches; every socket operation and the thread
     time-limited); one eval_image inside ``utils.profiling.trace``, whose
     trace names B1's four CUDA kernels, and ``time_fn`` of it;
     ``apps.convert.main`` against a stub colmap (the four stages, the
     move into sparse/0);
 11. parallel/ at full width, each path twice: NCCL at world size 1 in this
     process, then gloo at world size 2 in two spawned processes on the
     same card (a rank that fails or outlives PAR_RANK_TIMEOUT fails the
     phase). (a) the DP 3DGS step (make_sharded_gs_step, rasterizer
     "auto") on phase 6's perturbed state, 4 render cameras with phase 5's
     images as ground truth, 2 steps: gloo-2 against NCCL-1 (loss rtol
     1e-5, xyz atol 1e-5, xyz_grad_accum rtol 1e-4 atol 1e-6, denom and max
     radii equal, both ranks' states bitwise equal), no dropped gradient,
     and B5, B3 with the store and B4 8 launches each at either world size
     (summed over the ranks); (b) the Gaussian-parallel render of camera 0
     (make_sharded_render: each rank projects half the scene and
     composites its band of 408 rows) against render_eval's image (2e-5),
     B5 and B3 once per rank; (c) the sharded id-module step (DINOv2-S/14,
     the 384-wide id module, 4 images at 800x800, 32,768 rays) on meshes
     (1, 2) and (2, 1) and the cached step on (2, 1) against the NCCL-1
     step (loss rtol 2e-4, parameters atol 1.5e-3 rtol 5e-3, the summed
     gradients within TRAIN_GRAD_TOL of each one's largest), B1 and B2
     never launched. Each path's times at both world sizes are logged;
 12. the workflow tools (sixdgs_torch/tools/) through their main, each cut
     in depth: (a) pose_accuracy_experiment --fused_attention at 100
     iterations, held to tests/test_pose_e2e.py's 100-iteration assertions
     (B1 824, B2 800; B5 and B3 8 for the ring renders); (b)
     quality_workflow at 400x400, 1,000 iterations from a sparse init of
     500 points with the opacity reset at 800 (two adaptations, five
     densifications, a reset and an SH step, counted from inside the run),
     held to a PSNR floor read against full runs of the same configuration,
     a Gaussian count that changed and finite logged losses (B5, B3 with the
     store and B4 once per step, B5 and B3 once per render); (c)
     pose_stage_artifact --fused_attention at 300 3DGS and 30 pose
     iterations per backbone, held to 8 results each with finite errors
     and exact launches (B1 1,008 (30 steps of 32, one validation of 32
     views, two evaluations of 8) and B2 960 for DINO, four times that for
     SuperPoint), with each driver call's step time and peak host RSS and
     device memory logged. After the counted runs, the kernels on the
     tools' own inputs against their plain versions: one training batch of
     (a)'s trained module (features 78 wide, which B1 and B2 take
     zero-padded to 384): scores, batch loss and gradients, fused against
     the plain scorer (phases 3 and 4's limits); on (b)'s first 400x400 GT
     view and its trained state, B5, B3, B3 with the store and B4 (phase
     5's limits), and one step from the trained state through the kernels
     against a plain twin (phase 6's gradient limit). Then the determinism
     gate: (b)'s training (apps.train_gs.main with the tool's arguments) a
     second time in this process, its state digested every 25 iterations
     (GSDigests: the loss, the active count, each parameter group's sum and
     sum of squares, a hash of every byte of the state) across the
     densifications at 600-1,000, the reset at 800 and the SH step at
     1,000, equal to (b)'s digest for digest.

The last three lines of standard output are the card's name and power limit
(nvidia-smi), one JSON object with a record per kernel, and the result line
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when no
CUDA device is present or any phase fails.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 20261016
N_GAUSSIANS = 262_144
N_IMAGES = 4
IMAGE_HW = 800
KERNEL_NS = (32768, 131072)
# SuperPoint's shape (28 x 28 patches of 256-dim descriptors): the B1/B2
# wrappers pad the width to 384 and launch once per 256 patches (4 here)
SP_P, SP_D = 784, 256
SP_CHUNKS = -(-SP_P // 256)
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
# the pose driver (phase 8): POSE_TRAIN + POSE_TEST images of the render
# scene, the default ray budget and batch, the depth cut from 1,500 steps
POSE_TRAIN, POSE_TEST, POSE_FOV = 4, 2, 0.9
POSE_RAYS, POSE_BATCH, POSE_STEPS = 32768, 32, 4
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
# the 3DGS apps (phase 9): train_gs on the phase 8 dataset, the depth cut
# from 30,000 iterations to APPS_ITERS. Its tiers are cut too (the
# --binning_tiers a user sets from the binning_* counters): the cloud's 3-NN
# scales make splats of tens of pixels at 800x800, whose frame at the
# default tiers wants more aligned pair slots than the 2^20 default budget
# (phase 9 logs the trained model's demand), which drops the raster
# gradients of every step until the trainer widens the budget on an
# adaptation iteration (every 500); a main tier of 4 tiles keeps the
# demand under 2^20 (phase 9 gates on no dropped gradient), at the price of
# the tile coverage that the cut tiers drop (phase 9 logs its share)
APPS_ITERS = 30
APPS_TIERS = ("4", "4096", "16", "256", "64")
# ... and a few steps at the app's default tiers, held to the documented
# grad_dropped rule
APPS_DEFAULT_ITERS = 4
# phase 10: a Cambridge Landmarks dataset of the render scene, whose loader
# holds every 8th camera out for test (9 cameras leave POSE_TEST = 2), with
# every 16th of the scene's points (16,384) in its NVM file; R and T read
# back through the quaternion and the centre, against float64 cameras whose
# numbers are written to 17 digits: rounding of ~1e-15, while a wrong
# convention (the centre taken for T) is off by ~1
CAMBRIDGE_CAMERAS = 9
CAMBRIDGE_POINT_STRIDE = 16
CAMBRIDGE_POSE_TOL = 1e-5
# full_eval's depth, cut from 30,000 iterations: one telemetry step at
# train_gs's default --log_every of 50
FULL_EVAL_ITERS = 50
# train_gs --gui: iterations (one viewer frame each), the viewer's time
# limit for each socket operation and for its thread, and the share of a
# frame's pixels that must differ from the background
GUI_ITERS = 8
GUI_CLIENT_TIMEOUT = 120.0
GUI_MIN_COVER = 0.01
# phase 11: parallel/ at full width, each path twice: NCCL at world size 1
# in the script's process and gloo at world size 2 in two spawned processes
# on the same card (NCCL does not put two ranks on one GPU). The DP 3DGS
# step takes PAR_CAMERAS render cameras for PAR_STEPS steps; the render is
# timed over PAR_RENDER_FRAMES frames; the pose step runs on each mesh of
# PAR_POSE_MESHES (name, gloo-2 shape, cached features). The gates are the
# JAX package's tests/test_parallel.py limits, quoted where they are used
PAR_CAMERAS, PAR_STEPS, PAR_RANKS, PAR_RENDER_FRAMES = 4, 2, 2, 5
PAR_POSE_MESHES = (("pose_sp", (1, 2), False), ("pose_dp", (2, 1), False),
                   ("cached_dp", (2, 1), True))
PAR_RANK_TIMEOUT = 240.0  # seconds for the spawned ranks, start to exit
# phase 12: the workflow tools (sixdgs_torch/tools/) through their main, at
# a cut depth. The accuracy experiment at 100 iterations with the fused
# scorer, held to tests/test_pose_e2e.py's 100-iteration assertions (the
# relative ones, and the pins t_err < 0.95, a_err < 45 deg, recall > 0.30,
# calibrated at ~0.80 / ~28 / ~0.42): its ring is 8 views of 64x64 and its
# batch 8, so B1 100 x 8 + 3 x 8 (three evaluations) and B2 100 x 8
TOOLS_ACC_ITERS, TOOLS_ACC_VIEWS, TOOLS_ACC_BATCH = 100, 8, 8
# the quality workflow at 400x400 cut from 3,000 to 1,000 iterations, from a
# sparse init of 500 of the 3,000 GT means, with the opacity reset moved from
# 3,000 to 800: one run crosses the adaptations at 500 and 1,000, the
# densifications at 600-1,000 (5), the reset at 800 and the SH step at
# 1,000 (workflow_depth.py runs the same arguments as quality_cut)
TOOLS_QW_ITERS, TOOLS_QW_INIT, TOOLS_QW_RESET = 1000, 500, 800
TOOLS_QW_ARGS = ["--iterations", str(TOOLS_QW_ITERS), "--n_init", str(TOOLS_QW_INIT),
                 "--extra_train_args", f"--opacity_reset_interval {TOOLS_QW_RESET}"]
TOOLS_QW_TRAIN, TOOLS_QW_TEST = 28, 6
TOOLS_QW_DENSIFY = 5
# held-out PSNR floor of the cut run. Since the host's exp and log are
# taken in float64 (ops/transforms.py exp32, log32) this configuration
# reads 20.18 dB on an H100 (700 W) (19.94 before, in every run on several
# machines; PERF.md §6), against 28.17 for the tool's full 3,000
# iterations from the whole cloud. The floor sits TOOLS_QW_PSNR_MARGIN
# below the cut run's reading: room for another card, driver or torch to
# reorder float sums along 1,000 steps; a drop past it is a regression of
# the trainer, not noise
TOOLS_QW_PSNR_CARD = 20.18
TOOLS_QW_PSNR_MARGIN = 1.5
# the pose stage cut to 300 3DGS iterations and 30 pose iterations per
# backbone (24 train, 8 test views at 400x400; batch 32; B1 once per image
# of a step and per evaluated image, twice evaluated; SuperPoint 4 launches
# a call)
TOOLS_PS_GS_ITERS, TOOLS_PS_POSE_ITERS = 300, 30
TOOLS_PS_TRAIN, TOOLS_PS_TEST, TOOLS_PS_BATCH = 24, 8, 32
# host RSS sampling period of phase 12's memory windows (and
# workflow_depth.py's): a pose step takes ~100 ms or more
RSS_SAMPLE_S = 0.1
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


def write_blender_dataset(scene, root: str) -> None:
    """A Blender-format dataset of ``scene`` with the port's PNG writer:
    POSE_TRAIN + POSE_TEST 800x800 RGBA images rendered with render_eval
    from cameras on a ring at radius 3.1, and transforms_{train,test}.json
    in the Blender convention (OpenGL camera axes). The alpha is the
    render's coverage, 1 - T, from one render over black and one over
    white; the colour is stored straight (divided by the alpha)."""
    from sixdgs_torch.scene.cameras import make_synthetic_camera
    from sixdgs_torch.scene.png import write_png
    from sixdgs_torch.train.gs_trainer import render_eval

    black = torch.zeros(3, device=scene.xyz.device)
    white = torch.ones(3, device=scene.xyz.device)
    n = POSE_TRAIN + POSE_TEST
    frames = {"train": [], "test": []}
    for i in range(n):
        split = "train" if i < POSE_TRAIN else "test"
        ang = 2 * math.pi * (i + 0.25) / n
        pos = np.array([3 * math.cos(ang), 0.8, 3 * math.sin(ang)])
        c2w = look_at_c2w(pos).astype(np.float64)
        R = c2w[:3, :3]
        cam = make_synthetic_camera(IMAGE_HW, IMAGE_HW, POSE_FOV, POSE_FOV, R, -R.T @ pos,
                                    uid=i, name=f"r_{i}")
        over_black = render_eval(scene, cam, black, scene.max_sh_degree)
        over_white = render_eval(scene, cam, white, scene.max_sh_degree)
        alpha = (1.0 - (over_white - over_black).mean(0)).clamp(0.0, 1.0)
        rgb = (over_black / alpha.clamp_min(1e-6)).clamp(0.0, 1.0)
        rgba = torch.cat([rgb, alpha[None]]).permute(1, 2, 0)
        os.makedirs(os.path.join(root, split), exist_ok=True)
        write_png(os.path.join(root, split, f"r_{i}.png"),
                  (rgba * 255.0 + 0.5).to(torch.uint8).cpu().numpy())
        gl = c2w.copy()
        gl[:3, 1:3] *= -1  # OpenCV -> OpenGL camera axes
        frames[split].append({"file_path": f"./{split}/r_{i}",
                              "transform_matrix": gl.tolist()})
    for split, fr in frames.items():
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as fh:
            json.dump({"camera_angle_x": POSE_FOV, "frames": fr}, fh)


def c2w_errors(results) -> np.ndarray:
    """Per-entry (translation error, angular error in degrees) of a results
    list, from its predicted and ground-truth camera-to-world matrices."""
    out = []
    for r in results:
        p, g = np.asarray(r["pred_c2w"]), np.asarray(r["gt_c2w"])
        cos = (np.trace(p[:3, :3].T @ g[:3, :3]) - 1) / 2
        out.append((np.linalg.norm(p[:3, 3] - g[:3, 3]),
                    math.degrees(math.acos(min(1.0, max(-1.0, cos))))))
    return np.asarray(out)


def write_dataset(scene, arrays) -> str:
    """The Blender-format dataset that phases 8 and 9 share (POSE_TRAIN +
    POSE_TEST 800x800 RGBA images of the scene, write_blender_dataset), with
    the scene's 262,144 points and their colours as its points3d.ply, so
    that 3DGS training starts from them; returns its directory."""
    from sixdgs_torch.scene.ply_io import store_point_cloud_ply

    tmp = tempfile.mkdtemp(prefix="ring_dataset_")
    data = os.path.join(tmp, "ring")
    t0 = time.perf_counter()
    write_blender_dataset(scene, data)
    rgb = np.clip(arrays["features_dc"][:, 0] * 0.28209479177387814 + 0.5, 0, 1)
    store_point_cloud_ply(os.path.join(data, "points3d.ply"), arrays["xyz"],
                          (rgb * 255).astype(np.uint8))
    log(f"dataset: {POSE_TRAIN} train, {POSE_TEST} test images of {IMAGE_HW}x{IMAGE_HW} and "
        f"{arrays['xyz'].shape[0]} points written in {time.perf_counter() - t0:.1f} s")
    return data


def phase_pose_driver(scene, data, backbone: str = "dino",
                      data_type: str = "blender", label: str = "") -> dict:
    """The pose driver at full width: ``apps.pose_eval.main`` on an
    experiment directory of the render scene over the dataset ``data`` of
    type ``data_type`` (the phase 8 Blender dataset, or phase 10's
    Cambridge one), with --fused_attention; with ``backbone="superpoint"``,
    from random SuperPoint weights written as the JAX package's flat npz.

    The driver catches a RuntimeError per scene (as the JAX driver does),
    prints it and exits normally, and torch reports CUDA faults as
    RuntimeError: so the run is held to what it must have written, not to
    its return. Launches: POSE_STEPS steps of POSE_BATCH images, each image
    one B1 forward and one B2 backward (no validation: it runs every 20
    steps), then two evaluations (target scores, predicted scores) of the
    POSE_TEST test images, one B1 each under no_grad: B1 POSE_STEPS *
    POSE_BATCH + 2 * POSE_TEST = 132 calls, B2 POSE_STEPS * POSE_BATCH =
    128, B3, B4 and B5 none. A DINO call is one launch; a SuperPoint call
    (784 patches of width 256) SP_CHUNKS = 4: B1 528, B2 512."""
    import contextlib
    import io

    from sixdgs_torch.apps import pose_eval
    from sixdgs_torch.pose import evaluate, superpoint, trainer
    from sixdgs_torch.utils.config import ModelConfig, write_cfg_args

    label = label or f"phase 8 pose driver ({backbone})"
    tmp = tempfile.mkdtemp(prefix=f"pose_driver_{backbone}_")
    exp = os.path.join(tmp, "exp", f"{pose_eval.PREFIXES[data_type]}ring_0001")
    cfg = vars(ModelConfig(source_path=data, model_path=exp, eval=True))
    write_cfg_args(exp, cfg)
    ply = os.path.join(exp, "point_cloud", "iteration_30000", "point_cloud.ply")
    os.makedirs(os.path.dirname(ply))
    scene.save_ply(ply)
    extra, per_call = [], 1
    if backbone == "superpoint":
        npz = os.path.join(tmp, "superpoint.npz")
        np.savez(npz, **superpoint.flatten_params(superpoint.init_params(
            torch.Generator().manual_seed(SEED), device="cpu")))
        extra, per_call = ["--backbone", "superpoint", "--superpoint_weights", npz], SP_CHUNKS

    # time the training run and each evaluation from inside the driver
    timing = {"train_s": [], "eval_s_per_image": []}
    run, test = trainer.PoseTrainer.run, evaluate.test_pose_estimation

    def timed_run(self, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run(self, *a, **k)
        torch.cuda.synchronize()
        timing["train_s"].append(time.perf_counter() - t)
        return out

    def timed_test(*a, **k):
        out = test(*a, **k)
        timing["eval_s_per_image"].append(out[5])
        return out

    out_json = os.path.join(tmp, "pose_results.json")
    argv = ["--exp_path", os.path.dirname(exp), "--out_path", out_json, "--data_type",
            data_type, "--fused_attention", "--ray_budget", str(POSE_RAYS), "--batch",
            str(POSE_BATCH), "--n_iterations", str(POSE_STEPS)] + extra
    err = io.StringIO()
    trainer.PoseTrainer.run, evaluate.test_pose_estimation = timed_run, timed_test
    try:
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            pose_eval.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = launch_counts()
        launches = [counted[k] for k in ("b1", "b2", "b5", "b3", "b4")]
    finally:
        trainer.PoseTrainer.run, evaluate.test_pose_estimation = run, test
    log(f"{label}: pose_eval.main({' '.join(argv)}) in {wall:.2f} s; launches "
        f"B1 {launches[0]}, B2 {launches[1]}, B5 {launches[2]}, B3 {launches[3]}, "
        f"B4 {launches[4]}")
    stderr = err.getvalue()
    if stderr:
        log("driver stderr:\n" + stderr[-4000:])
    if "Traceback" in stderr:
        raise AssertionError("the driver printed a traceback")
    with open(out_json) as fh:
        results = json.load(fh)
    errors = c2w_errors(results)
    if len(results) != POSE_TEST or not np.isfinite(errors).all():
        raise AssertionError(f"{len(results)} results (expected {POSE_TEST}), errors "
                             f"{errors.tolist()}")
    for name in ("id_module.npz", "pose_metrics.jsonl"):
        if not os.path.exists(os.path.join(exp, name)):
            raise AssertionError(f"the driver wrote no {name}")
    expected = [per_call * (POSE_STEPS * POSE_BATCH + 2 * POSE_TEST),
                per_call * POSE_STEPS * POSE_BATCH, 0, 0, 0]
    if launches != expected:
        raise AssertionError(f"{label} launches {launches}, expected {expected}")
    step_ms = 1e3 * timing["train_s"][0] / POSE_STEPS
    image_ms = [1e3 * t for t in timing["eval_s_per_image"]]
    log(f"{label}: {len(results)} results, per-image (translation, angular "
        f"deg) errors {errors.tolist()} (random weights, 4 steps); wall {wall:.2f} s, "
        f"{step_ms:.1f} ms per training step (mean of {POSE_STEPS}, the first ray "
        f"generation included), {image_ms[0]:.1f} and {image_ms[1]:.1f} ms per evaluated "
        f"image (target and predicted scores); {gpu_line()}")
    shutil.rmtree(tmp)
    log(f"{label}: ok")
    return {"launches": launches, "wall_s": wall, "step_ms": step_ms,
            "image_ms": image_ms}


def launch_counts() -> dict:
    """Launches of each hand-written kernel since the last
    ``zero_launch_counts()``: the ``kernel.*`` counters of ``utils.profiling``
    (B3 without the transmittance store as ``b3``, with it as ``b3_store``)."""
    from sixdgs_torch.utils import profiling

    counters = profiling.snapshot()["counters"]
    return {k: counters.get("kernel." + k, 0) for k in ("b1", "b2", "b5", "b3", "b3_store", "b4")}


def zero_launch_counts() -> None:
    """Zero ``utils.profiling``'s counters (and its spans)."""
    from sixdgs_torch.utils import profiling

    profiling.snapshot(reset=True)


def image_gate(label: str, got, want) -> float:
    """Two renders of one camera through two compositors: the T_EPS stop
    flips and nothing else (B3_MAX_ERR, RENDER_SHARE_OVER_1E3)."""
    err = (got - want).abs()
    worst, share = err.max().item(), (err > 1e-3).float().mean().item()
    log(f"{label}: max_abs_err={worst:.3e}; values off by > 1e-3: {int((err > 1e-3).sum())}"
        f" ({share:.2e}), by > 1e-4: {int((err > 1e-4).sum())} of {err.numel()}")
    if not (torch.isfinite(got).all() and worst <= B3_MAX_ERR
            and share <= RENDER_SHARE_OVER_1E3):
        raise AssertionError(f"{label}: {worst}, {share}")
    return worst


def observe_gs_run(call, before_run=None):
    """``call()`` (an app that trains through GSTrainer.run) with every
    step's start time and metrics read from inside the run (its pre_step
    and callback hooks), and the launch counts zeroed just before the call
    and read at the end of the run and at the end of the call; with
    ``before_run``, called as the run starts -> (wall s, launches of the
    call, launches of the run, [(iteration, start time)] then (None, end
    time), [(iteration, metrics)] of the logged steps)."""
    from sixdgs_torch.train import gs_trainer as gs

    run = gs.GSTrainer.run
    steps, logged, at_run_end = [], [], {}

    def observed_run(self, *a, callback=None, pre_step=None, **k):
        def pre(it, tr):
            torch.cuda.synchronize()
            steps.append((it, time.perf_counter()))
            if pre_step is not None:
                pre_step(it, tr)

        def cb(it, metrics, tr):
            logged.append((it, metrics))
            if callback is not None:
                callback(it, metrics, tr)

        if before_run is not None:
            before_run()
        out = run(self, *a, callback=cb, pre_step=pre, **k)
        torch.cuda.synchronize()
        steps.append((None, time.perf_counter()))
        at_run_end.update(launch_counts())
        return out

    gs.GSTrainer.run = observed_run
    try:
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return wall, launch_counts(), at_run_end, steps, logged
    finally:
        gs.GSTrainer.run = run


def phase_gs_apps(pt, scene, data, render, gs_run) -> dict:
    """The 3DGS apps at full width, as a user calls them: ``apps.train_gs``
    (--rasterizer auto --eval, APPS_ITERS iterations from the dataset's
    262,144-point cloud, --binning_tiers APPS_TIERS; then APPS_DEFAULT_ITERS
    steps at the default tiers, held to the grad_dropped rule), ``apps.render`` of the
    trained model's train and test sets, and ``apps.metrics`` with LPIPS
    from a random VGG npz written by the port's save_params. Launch counts
    are zeroed just before each app and read just after: train_gs B3 with
    the store, B4 and B5 once per step, plus B5 and B3 once per evaluation
    render (the POSE_TEST test cameras at the last iteration); render B5
    and B3 once per image. Every step's metrics and time are read from
    inside the CLI (its trainer's callback and pre_step). Then, on the
    render cell's camera 0 at 1232x816, render() and one train step through
    "tiled" (plain PyTorch) against "pallas" (the kernels)."""
    from sixdgs_torch.apps import metrics as metrics_app
    from sixdgs_torch.apps import render as render_app
    from sixdgs_torch.apps import train_gs
    from sixdgs_torch.pose import lpips
    from sixdgs_torch.renderer import render as render_fn
    from sixdgs_torch.scene.cameras import camera_list_from_infos
    from sixdgs_torch.scene.dataset_loader import load_data
    from sixdgs_torch.scene.gaussians import PARAM_NAMES, load_ply
    from sixdgs_torch.scene.png import read_png
    from sixdgs_torch.train import gs_trainer as gs
    from sixdgs_torch.utils.config import dotdict, read_cfg_args

    tmp = tempfile.mkdtemp(prefix="gs_apps_")
    model = os.path.join(tmp, "model")
    n_images = POSE_TRAIN + POSE_TEST

    # train_gs
    def train_app(argv):
        """train_gs.main(argv) observed -> (wall s, launches, steps, logged)."""
        wall, launches, _, steps, logged = observe_gs_run(lambda: train_gs.main(argv))
        return wall, launches, steps, logged

    def binning(logged):
        """Every logged step's binning telemetry, held to its own
        arithmetic: a gaussian emits at most its tier's budget of its tile
        rectangle, and each dropped_* counts the area past that budget, so
        the emitted pairs and the dropped counts add up to no more than the
        visible gaussians' rectangle area -> {counter: [per step]}."""
        tel = {k: [int(m[f"binning_{k}"]) for _, m in logged]
               for k in ("dropped_main", "dropped_mid", "dropped_big", "overflow_spill",
                         "total_area", "real_pairs", "nc_demand", "grad_dropped")}
        for i in range(len(logged)):
            dropped = [tel[k][i] for k in ("dropped_main", "dropped_mid", "dropped_big")]
            if (min(dropped) < 0 or tel["overflow_spill"][i] < 0
                    or tel["real_pairs"][i] + sum(dropped) > tel["total_area"][i]):
                raise AssertionError(f"binning telemetry of step {logged[i][0]}: "
                                     f"{ {k: v[i] for k, v in tel.items()} }")
        return tel

    def spread(values):
        return f"{min(values)}-{max(values)}"

    argv = ["--source_path", data, "--model_path", model, "--eval", "--iterations",
            str(APPS_ITERS), "--test_iterations", str(APPS_ITERS), "--save_iterations",
            str(APPS_ITERS), "--rasterizer", "auto", "--log_every", "1", "--quiet",
            "--binning_tiers", *APPS_TIERS]
    train_wall, launches, steps, logged = train_app(argv)
    expected = {"b1": 0, "b2": 0, "b5": APPS_ITERS + POSE_TEST, "b3": POSE_TEST,
                "b3_store": APPS_ITERS, "b4": APPS_ITERS}
    log(f"phase 9 train_gs.main({' '.join(argv)}) in {train_wall:.2f} s; launches "
        f"{json.dumps(launches)} (expected {json.dumps(expected)})")
    if launches != expected:
        raise AssertionError(f"train_gs launches {launches}, expected {expected}")
    for f in ("cfg_args", "cameras.json", "input.ply", "metrics.jsonl",
              f"point_cloud/iteration_{APPS_ITERS}/point_cloud.ply"):
        if not os.path.exists(os.path.join(model, f)):
            raise AssertionError(f"train_gs wrote no {f}")
    with open(os.path.join(model, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    loss = {r["step"]: r["value"] for r in recs
            if r.get("tag") == "train_loss_patches/total_loss"}
    if sorted(loss) != list(range(1, APPS_ITERS + 1)) or not all(
            map(math.isfinite, loss.values())):
        raise AssertionError(f"metrics.jsonl losses {loss}")
    # each train camera once per epoch of POSE_TRAIN steps: compare epochs
    first = statistics.mean(loss[i] for i in range(1, POSE_TRAIN + 1))
    last_epoch = range((APPS_ITERS // POSE_TRAIN - 1) * POSE_TRAIN + 1,
                       APPS_ITERS // POSE_TRAIN * POSE_TRAIN + 1)
    last = statistics.mean(loss[i] for i in last_epoch)
    tel = binning(logged)
    dropped, demand = tel["grad_dropped"], tel["nc_demand"]
    # the share of the visible gaussians' tile coverage that the cut tiers
    # emit: the rest is composited nowhere
    emitted = [r / t for r, t in zip(tel["real_pairs"], tel["total_area"])]
    test_psnr = [r["value"] for r in recs if r.get("tag") == "test/loss_viewpoint - psnr"]
    log(f"phase 9 train_gs: mean loss of the first epoch {first:.6f}, of iterations "
        f"{last_epoch.start}-{last_epoch.stop - 1} {last:.6f}; nc_demand "
        f"{spread(demand)}, grad_dropped {dropped}; test PSNR {test_psnr}; "
        f"points {[r['value'] for r in recs if r.get('tag') == 'total_points'][::10]}")
    log(f"phase 9 train_gs binning under --binning_tiers {' '.join(APPS_TIERS)} (per step, "
        f"min-max): emitted pairs {spread(tel['real_pairs'])} of a tile coverage of "
        f"{spread(tel['total_area'])}, a share of {min(emitted):.4f}-{max(emitted):.4f}; "
        f"dropped_main {spread(tel['dropped_main'])}, dropped_mid "
        f"{spread(tel['dropped_mid'])}, dropped_big {spread(tel['dropped_big'])}, "
        f"overflow_spill {spread(tel['overflow_spill'])} gaussians")
    if not (last < first and not any(dropped) and len(test_psnr) == 1
            and math.isfinite(test_psnr[0])):
        raise AssertionError(f"train_gs: loss {first} -> {last}, grad_dropped {dropped}, "
                             f"test PSNR {test_psnr}")
    ms = [1e3 * (t1 - t0) for (it, t0), (_, t1) in zip(steps, steps[1:])]
    # not the first step (warm-up) nor the last (the evaluation renders)
    step_ms = statistics.median(ms[1:-1])

    # train_gs again at its default tiers, as a user runs it: held to the
    # documented rule (ROADMAP C) that a step whose aligned demand passes
    # the pair budget (2^20 until an adaptation iteration widens it) has
    # its raster gradients zeroed, and to its launches and a finite loss
    model_default = os.path.join(tmp, "model_default")
    argv = ["--source_path", data, "--model_path", model_default, "--eval", "--iterations",
            str(APPS_DEFAULT_ITERS), "--test_iterations", "-1", "--save_iterations",
            str(APPS_DEFAULT_ITERS), "--rasterizer", "auto", "--log_every", "1", "--quiet"]
    wall, launches_default, _, logged = train_app(argv)
    expected = {"b1": 0, "b2": 0, "b5": APPS_DEFAULT_ITERS, "b3": 0,
                "b3_store": APPS_DEFAULT_ITERS, "b4": APPS_DEFAULT_ITERS}
    tel_default = binning(logged)
    rule = [int(d > pt.DEFAULT_NC) for d in tel_default["nc_demand"]]
    emitted = [r / t for r, t in zip(tel_default["real_pairs"], tel_default["total_area"])]
    log(f"phase 9 train_gs.main({' '.join(argv)}) in {wall:.2f} s; launches "
        f"{json.dumps(launches_default)}; per step: loss "
        f"{[round(m['loss'], 6) for _, m in logged]}, nc_demand {tel_default['nc_demand']} "
        f"against {pt.DEFAULT_NC}, grad_dropped {tel_default['grad_dropped']}; emitted "
        f"pairs {tel_default['real_pairs']} of a tile coverage of "
        f"{tel_default['total_area']} (share {min(emitted):.4f}-{max(emitted):.4f}); "
        f"dropped_main {tel_default['dropped_main']}, dropped_mid "
        f"{tel_default['dropped_mid']}, dropped_big {tel_default['dropped_big']}, "
        f"overflow_spill {tel_default['overflow_spill']}")
    if launches_default != expected:
        raise AssertionError(f"train_gs (default tiers) launches {launches_default}, "
                             f"expected {expected}")
    if (tel_default["grad_dropped"] != rule or len(rule) != APPS_DEFAULT_ITERS
            or not all(math.isfinite(m["loss"]) for _, m in logged)
            or not os.path.exists(os.path.join(
                model_default, f"point_cloud/iteration_{APPS_DEFAULT_ITERS}/point_cloud.ply"))):
        raise AssertionError(f"train_gs (default tiers): grad_dropped "
                             f"{tel_default['grad_dropped']}, expected {rule}; losses "
                             f"{[m['loss'] for _, m in logged]}")
    shutil.rmtree(model_default)

    # render
    render_times = []
    render_eval = render_app.render_eval

    def timed_render(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = render_eval(*a, **k)
        torch.cuda.synchronize()
        render_times.append(1e3 * (time.perf_counter() - t))
        return out

    render_app.render_eval = timed_render
    try:
        zero_launch_counts()
        t0 = time.perf_counter()
        render_app.main(["--model_path", model, "--quiet"])
        torch.cuda.synchronize()
        render_wall = time.perf_counter() - t0
        launches_render = launch_counts()
    finally:
        render_app.render_eval = render_eval
    expected = {"b1": 0, "b2": 0, "b5": n_images, "b3": n_images, "b3_store": 0, "b4": 0}
    if launches_render != expected:
        raise AssertionError(f"render launches {launches_render}, expected {expected}")
    for split, n in (("train", POSE_TRAIN), ("test", POSE_TEST)):
        for sub in ("renders", "gt"):
            d = os.path.join(model, split, f"ours_{APPS_ITERS}", sub)
            names = sorted(os.listdir(d))
            shapes = {read_png(os.path.join(d, nm)).shape for nm in names}
            if len(names) != n or shapes != {(IMAGE_HW, IMAGE_HW, 3)}:
                raise AssertionError(f"{d}: {names}, {shapes}")
    # the pair budget of those renders: render_eval passes no nc_pairs, so a
    # frame whose aligned demand passes the default budget has its trailing
    # tiles cut (the reference caveat); read it on the first test camera
    trained = load_ply(os.path.join(model, "point_cloud", f"iteration_{APPS_ITERS}",
                                    "point_cloud.ply"), device="cuda")
    test_cam = camera_list_from_infos(
        load_data(dotdict(read_cfg_args(model))).test_cameras)[0]
    _, lay, _ = layout_of(trained, test_cam)
    seg = lay.starts[1:] - lay.starts[:-1]
    cut = int(((lay.counts_k < seg) & (seg > 0)).sum())
    log(f"phase 9 render.main: {n_images} images in {render_wall:.2f} s, "
        f"{statistics.median(render_times):.2f} ms per render_eval (median); launches "
        f"{json.dumps(launches_render)}; the trained model's aligned pair demand on test "
        f"camera 0 ({IMAGE_HW}x{IMAGE_HW}, default tiers) {int(lay.al_total)} against nc "
        f"{lay.nc}: {cut} of {lay.n_tiles} tiles cut short or emptied")
    del trained, lay

    # metrics
    npz = os.path.join(tmp, "lpips_vgg.npz")
    lpips.save_params(npz, lpips.init_params(torch.Generator().manual_seed(SEED), "vgg",
                                             device="cpu"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics_app.main(["--model_paths", model, "--lpips_weights", npz])
    torch.cuda.synchronize()
    metrics_ms = 1e3 * (time.perf_counter() - t0) / n_images
    with open(os.path.join(model, "results.json")) as fh:
        results = json.load(fh)
    log(f"phase 9 metrics.main: {metrics_ms:.1f} ms per image (PNG reads, SSIM, PSNR, "
        f"LPIPS VGG); {json.dumps(results)}")
    if sorted(results) != [f"test/ours_{APPS_ITERS}", f"train/ours_{APPS_ITERS}"] or not all(
            v is not None and math.isfinite(v) for r in results.values() for v in r.values()):
        raise AssertionError(f"results.json {results}")
    shutil.rmtree(tmp)

    # tiled against pallas on the render cell's camera 0 at 1232x816
    cam, bg = render["cams"][0], render["bg"]
    with torch.no_grad():
        want = render_fn(cam, scene, bg, rasterizer="pallas")["render"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = render_fn(cam, scene, bg, rasterizer="tiled")["render"]
        torch.cuda.synchronize()
        tiled_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        tiled_ms = cuda_ms(lambda: render_fn(cam, scene, bg, rasterizer="tiled"), reps=5,
                           warmup=1)
        pallas_ms = cuda_ms(lambda: render_fn(cam, scene, bg, rasterizer="pallas"), reps=5,
                            warmup=1)
    tiled_err = image_gate(f"render() tiled vs pallas, camera 0 at {RENDER_W}x{RENDER_H}",
                           got, want)
    tr, start = gs_run["trainer"], gs_run["start_state"]
    cam_arrays = tr._camera_arrays(gs_run["first_cam"])
    lrs = gs.lr_dict(tr.opt, tr.spatial_lr_scale, GS_FIRST_IT)
    step = {}
    for name in ("pallas", "tiled"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        new, m = gs.train_step(start, cam_arrays, tr.bg, lrs, width=RENDER_W, height=RENDER_H,
                               sh_degree=3, rasterizer=name, with_telemetry=False)
        torch.cuda.synchronize()
        step[name] = {"ms": 1e3 * (time.perf_counter() - t0), "loss": float(m["loss"]),
                      "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
                      "m": new.adam.m}
    rel = abs(step["tiled"]["loss"] - step["pallas"]["loss"]) / step["pallas"]["loss"]
    worst = 0.0
    for k in PARAM_NAMES:
        g, w = 10 * step["tiled"]["m"][k], 10 * step["pallas"]["m"][k]
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        worst = max(worst, err / scale)
        if not (scale > 0 and err <= GS_GRAD_TOL * scale):
            raise AssertionError(f"train step tiled vs pallas, {k}: {err} > {GS_GRAD_TOL} * "
                                 f"{scale}")
    if not rel <= TRAIN_LOSS_TOL:
        raise AssertionError(f"train step tiled vs pallas: loss differs by {rel} relative")
    timing = {"apps_step_ms": step_ms, "apps_step_ms_min": min(ms[1:-1]),
              "train_gs_wall_s": train_wall,
              "render_ms_per_image": statistics.median(render_times),
              "render_wall_s": render_wall, "metrics_ms_per_image": metrics_ms,
              "tiled_render_ms": tiled_ms, "pallas_render_ms": pallas_ms,
              "tiled_render_peak_gib": tiled_peak,
              **{f"{n}_step_{k}": v[k] for n, v in step.items() for k in ("ms", "peak_gib")}}
    log(f"phase 9 tiled vs pallas at {RENDER_W}x{RENDER_H}: image max abs {tiled_err:.3e}; "
        f"one train step's loss rel {rel:.2e}, gradients worst err / scale {worst:.2e} "
        f"(limit {GS_GRAD_TOL}); {json.dumps(timing)}; {gpu_line()}")
    log("phase 9 3DGS apps: ok")
    return {"launches": launches, "launches_render": launches_render, "timing": timing,
            "results": results, "tiled_err": tiled_err, "tiled_grad_err": worst,
            "binning": {k: [min(v), max(v)] for k, v in tel.items()},
            "default_tiers": tel_default}


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix (COLMAP's rotmat2qvec)."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = R.flat
    K = np.array([[rxx - ryy - rzz, 0, 0, 0],
                  [ryx + rxy, ryy - rxx - rzz, 0, 0],
                  [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
                  [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def write_cambridge_dataset(scene, arrays, root: str) -> list:
    """A Cambridge Landmarks (VisualSFM) dataset of ``scene``:
    CAMBRIDGE_CAMERAS RGB PNGs of IMAGE_HW x IMAGE_HW rendered with
    render_eval over black from cameras on a ring at radius 3.1 (the port's
    PNG writer), and reconstruction.nvm holding each camera as the format
    stores it (file name, one focal, the world->camera quaternion, the
    camera centre) and every CAMBRIDGE_POINT_STRIDE-th point of the scene
    with its colour -> [(R_c2w, centre)] in file-name order."""
    from sixdgs_torch.ops.cameras import fov2focal
    from sixdgs_torch.scene.cameras import make_synthetic_camera
    from sixdgs_torch.scene.png import write_png
    from sixdgs_torch.train.gs_trainer import render_eval

    def nums(v):
        return " ".join(repr(float(x)) for x in v)

    os.makedirs(os.path.join(root, "seq1"))
    black = torch.zeros(3, device=scene.xyz.device)
    focal = fov2focal(POSE_FOV, IMAGE_HW)
    lines, written = ["NVM_V3", "", str(CAMBRIDGE_CAMERAS)], []
    for i in range(CAMBRIDGE_CAMERAS):
        ang = 2 * math.pi * (i + 0.25) / CAMBRIDGE_CAMERAS
        pos = np.array([3 * math.cos(ang), 0.8, 3 * math.sin(ang)])
        R = look_at_c2w(pos)[:3, :3].astype(np.float64)
        cam = make_synthetic_camera(IMAGE_HW, IMAGE_HW, POSE_FOV, POSE_FOV, R, -R.T @ pos,
                                    uid=i, name=f"frame{i:05d}")
        img = render_eval(scene, cam, black, scene.max_sh_degree)
        name = f"seq1/frame{i:05d}.png"
        write_png(os.path.join(root, name), (img.clamp(0.0, 1.0) * 255.0 + 0.5).to(
            torch.uint8).permute(1, 2, 0).cpu().numpy())
        lines.append(f"{name} {focal!r} {nums(rotmat_to_qvec(R.T))} {nums(pos)} 0 0")
        written.append((R, pos))
    pts = arrays["xyz"][::CAMBRIDGE_POINT_STRIDE]
    rgb = np.clip(arrays["features_dc"][::CAMBRIDGE_POINT_STRIDE, 0] * 0.28209479177387814
                  + 0.5, 0, 1)
    lines.append(str(len(pts)))
    lines += [f"{nums(p)} {r} {g} {b} 0" for p, (r, g, b) in zip(pts, (rgb * 255).astype(int))]
    lines.append("0")
    with open(os.path.join(root, "reconstruction.nvm"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return written


def phase_cambridge_driver(scene, arrays) -> dict:
    """The pose driver on a Cambridge Landmarks dataset of the render scene
    (write_cambridge_dataset): the loader's cameras held to the ones the
    file was written from (the NVM stores the camera centre, so
    T = -R_w2c c), then phase 8's driver run and gates with --data_type
    cambridge_landmark on an experiment directory cl_ring_0001. Every 8th
    camera is a test camera, POSE_TEST of CAMBRIDGE_CAMERAS, so the
    launches are phase 8's: B1 POSE_STEPS * POSE_BATCH + 2 * POSE_TEST =
    132, B2 128."""
    from sixdgs_torch.scene.dataset_loader import load_data
    from sixdgs_torch.utils.config import dotdict

    tmp = tempfile.mkdtemp(prefix="cambridge_")
    data = os.path.join(tmp, "ring")
    t0 = time.perf_counter()
    written = write_cambridge_dataset(scene, arrays, data)
    t_write = time.perf_counter() - t0
    info = load_data(dotdict(source_path=data, images=None, eval=True,
                             white_background=False))
    cams = info.train_cameras + info.test_cameras
    worst = 0.0
    for c in cams:
        R, centre = written[int(c.image_name[len("frame"):])]
        worst = max(worst, float(np.abs(c.R - R).max()),
                    float(np.abs(c.T + R.T @ centre).max()))
    log(f"phase 10 Cambridge dataset: {CAMBRIDGE_CAMERAS} images of {IMAGE_HW}x{IMAGE_HW} "
        f"and {len(info.point_cloud.points)} points written in {t_write:.1f} s; loaded "
        f"{len(info.train_cameras)} train and {len(info.test_cameras)} test cameras; their R "
        f"and T against the written cameras: max abs {worst:.3e} (limit "
        f"{CAMBRIDGE_POSE_TOL})")
    if len(info.test_cameras) != POSE_TEST or len(cams) != CAMBRIDGE_CAMERAS or not (
            worst <= CAMBRIDGE_POSE_TOL):
        raise AssertionError(f"Cambridge loader: {len(info.train_cameras)} train, "
                             f"{len(info.test_cameras)} test cameras, pose error {worst}")
    out = phase_pose_driver(scene, data, data_type="cambridge_landmark",
                            label="phase 10 pose driver (cambridge_landmark)")
    shutil.rmtree(tmp)
    return {**out, "pose_err": worst, "write_s": t_write}


def phase_full_eval(pt, data) -> dict:
    """``apps.full_eval.main`` on a Tanks-and-Temples root whose one scene
    directory, ``truck``, is the phase 8 dataset, at FULL_EVAL_ITERS
    iterations with a random VGG LPIPS npz: train_gs (its default tiers;
    its default --log_every of 50 logs the last step only), render
    --skip_train, metrics. Launches: B3 with the store, B4 and B5 once per
    step; B5 and B3 once per rendered test image. The fresh 262,144-point
    cloud passes the 2^20 pair budget at the default tiers, so the logged
    step is held to the grad_dropped rule, not to a falling loss."""
    from sixdgs_torch.apps import full_eval
    from sixdgs_torch.pose import lpips

    tmp = tempfile.mkdtemp(prefix="full_eval_")
    tat = os.path.join(tmp, "tat")
    os.makedirs(tat)
    os.symlink(data, os.path.join(tat, "truck"))
    npz = os.path.join(tmp, "lpips_vgg.npz")
    lpips.save_params(npz, lpips.init_params(torch.Generator().manual_seed(SEED), "vgg",
                                             device="cpu"))
    out = os.path.join(tmp, "eval")
    argv = ["--tanksandtemples", tat, "--output_path", out, "--iterations",
            str(FULL_EVAL_ITERS), "--lpips_weights", npz]
    wall, launches, launches_run, steps, logged = observe_gs_run(
        lambda: full_eval.main(argv))
    n = FULL_EVAL_ITERS
    expected_run = {"b1": 0, "b2": 0, "b5": n, "b3": 0, "b3_store": n, "b4": n}
    expected = {**expected_run, "b5": n + POSE_TEST, "b3": POSE_TEST}
    train_s = steps[-1][1] - steps[0][1]
    ms = [1e3 * (t1 - t0) for (_, t0), (_, t1) in zip(steps, steps[1:])]
    step_ms = statistics.median(ms[1:])
    model = os.path.join(out, "truck")
    renders = os.path.join(model, "test", f"ours_{n}", "renders")
    with open(os.path.join(model, "results.json")) as fh:
        results = json.load(fh)
    rule = [(it, int(m["binning_grad_dropped"]), int(m["binning_nc_demand"] > pt.DEFAULT_NC))
            for it, m in logged]
    log(f"phase 10 full_eval.main({' '.join(argv)}) in {wall:.2f} s (training {train_s:.2f} "
        f"s, {step_ms:.1f} ms per step, median of the steps after the first); launches "
        f"{json.dumps(launches)} (expected {json.dumps(expected)}), of which the "
        f"training's {json.dumps(launches_run)}; logged steps (iteration, grad_dropped, "
        f"nc_demand > {pt.DEFAULT_NC}): {rule}, nc_demand "
        f"{[int(m['binning_nc_demand']) for _, m in logged]}; {json.dumps(results)}")
    if launches != expected or launches_run != expected_run:
        raise AssertionError(f"full_eval launches {launches} (training {launches_run})")
    if not os.path.exists(os.path.join(model, "point_cloud", f"iteration_{n}",
                                       "point_cloud.ply")):
        raise AssertionError("full_eval wrote no PLY at the last iteration")
    if len(os.listdir(renders)) != POSE_TEST or os.path.exists(os.path.join(model, "train")):
        raise AssertionError(f"full_eval rendered {sorted(os.listdir(renders))}")
    res = results.get(f"test/ours_{n}", {})
    if list(results) != [f"test/ours_{n}"] or not all(
            res.get(k) is not None and math.isfinite(res[k]) for k in ("SSIM", "PSNR", "LPIPS")):
        raise AssertionError(f"results.json {results}")
    if [it for it, _, _ in rule] != [n] or any(d != want for _, d, want in rule):
        raise AssertionError(f"full_eval's logged steps break the grad_dropped rule: {rule}")
    shutil.rmtree(tmp)
    return {"launches": launches, "launches_run": launches_run, "wall_s": wall,
            "train_s": train_s, "step_ms": step_ms, "results": results,
            "grad_dropped": [d for _, d, _ in rule]}


def viewer_message(cam, train: bool = True, keep_alive: bool = True,
                   scaling: float = 1.0) -> dict:
    """The JSON a SIBR viewer sends for a camera: glm-order (transposed)
    matrices with the OpenGL axis flips that NetworkGUI.receive undoes."""
    wvt = np.asarray(cam.view, np.float32).T.copy()
    wvt[:, 1:3] *= -1
    fpt = np.asarray(cam.full_proj, np.float32).T.copy()
    fpt[:, 1] *= -1
    return {"resolution_x": cam.width, "resolution_y": cam.height, "train": train,
            "fov_y": cam.FoVy, "fov_x": cam.FoVx, "z_near": cam.znear, "z_far": cam.zfar,
            "shs_python": False, "rot_scale_python": False, "keep_alive": keep_alive,
            "scaling_modifier": scaling, "view_matrix": wvt.flatten().tolist(),
            "view_projection_matrix": fpt.flatten().tolist()}


def recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError(f"the server closed after {len(buf)} of {n} bytes")
        buf += chunk
    return bytes(buf)


def viewer(port: int, messages, connected, out: dict) -> None:
    """A viewer on 127.0.0.1:port (a thread's body): connect, retrying until
    the server listens, within GUI_CLIENT_TIMEOUT; set ``connected``; then
    send each message and read its answer, each socket operation within
    GUI_CLIENT_TIMEOUT. out["frames"]: [(image bytes, verify string)];
    out["ms"]: per message, from its send to the end of its answer; an
    exception goes to out["error"]."""
    import socket

    try:
        deadline = time.monotonic() + GUI_CLIENT_TIMEOUT
        while True:
            try:
                sock = socket.create_connection(("127.0.0.1", port),
                                                timeout=GUI_CLIENT_TIMEOUT)
                break
            except ConnectionRefusedError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.005)
        connected.set()
        out["frames"], out["ms"] = [], []
        with sock:
            for msg in messages:
                t0 = time.perf_counter()
                payload = json.dumps(msg).encode()
                sock.sendall(len(payload).to_bytes(4, "little") + payload)
                img = recv_exact(sock, msg["resolution_x"] * msg["resolution_y"] * 3)
                length = int.from_bytes(recv_exact(sock, 4), "little")
                out["frames"].append((img, recv_exact(sock, length).decode("ascii")))
                out["ms"].append(1e3 * (time.perf_counter() - t0))
    except Exception as e:  # check_viewer raises it in the phase
        out["error"] = e


def start_viewer(port: int, messages):
    """A viewer thread on ``port`` -> (thread, connected event, its out)."""
    import threading

    connected, out = threading.Event(), {}
    th = threading.Thread(target=viewer, args=(port, messages, connected, out), daemon=True)
    th.start()
    return th, connected, out


def check_viewer(label: str, th, out: dict) -> None:
    """Raise if the viewer thread (joined already) is still running or
    failed."""
    if th.is_alive():
        raise AssertionError(f"{label}: the viewer did not finish within "
                             f"{GUI_CLIENT_TIMEOUT} s")
    if "error" in out:
        raise AssertionError(f"{label}: the viewer failed: {out['error']!r}")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_gui(scene, data, render) -> dict:
    """The GUI server over real sockets on 127.0.0.1. (a) One viewer message
    for the render cell's camera 0 at 1232x816, decoded by the port's
    NetworkGUI.receive and rendered by render_gui_camera (B5 and B3 without
    the store, once each), held against phase 5's rasterize_scan image of
    that camera (image_gate); the bytes the viewer reads equal
    image_to_bytes of that image, and the verify string comes back. (b)
    ``apps.train_gs.main --gui`` for GUI_ITERS iterations on the phase 8
    dataset at the cut tiers, a viewer thread sending one message a step
    for the dataset's first test camera (train, keep_alive false on the
    last) and reading each frame: every frame W*H*3 bytes and not all
    background, the dataset's absolute path as the verify string, and B5
    and B3 once per frame on top of the training's launches."""
    from sixdgs_torch.apps import train_gs
    from sixdgs_torch.renderer.network_gui import NetworkGUI, image_to_bytes
    from sixdgs_torch.scene.cameras import camera_list_from_infos
    from sixdgs_torch.scene.dataset_loader import load_data
    from sixdgs_torch.train.gs_trainer import render_gui_camera
    from sixdgs_torch.utils.config import dotdict

    verify = os.path.abspath(data)
    # (a) one frame of the render scene
    cam0, bg = render["cams"][0], render["bg"]
    port = free_port()
    gui = NetworkGUI("127.0.0.1", port)
    th, connected, out = start_viewer(port, [viewer_message(cam0)])
    try:
        if not connected.wait(GUI_CLIENT_TIMEOUT):
            raise AssertionError("phase 10 GUI (a): the viewer never connected")
        deadline = time.monotonic() + GUI_CLIENT_TIMEOUT
        while gui.conn is None and time.monotonic() < deadline:
            gui.try_connect()
            time.sleep(0.001)
        gui_cam, do_training, _, _, keep_alive, scaling = gui.receive()
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        img = render_gui_camera(scene, gui_cam, bg, scene.max_sh_degree,
                                scaling_modifier=scaling)
        torch.cuda.synchronize()
        frame_ms = 1e3 * (time.perf_counter() - t0)
        launches_a = launch_counts()
        frame = image_to_bytes(img.cpu().numpy())
        gui.send(frame, verify)
    finally:
        gui.close()
        th.join(GUI_CLIENT_TIMEOUT)
    check_viewer("phase 10 GUI (a)", th, out)
    expected = {"b1": 0, "b2": 0, "b5": 1, "b3": 1, "b3_store": 0, "b4": 0}
    vs_render_eval = (img - render["imgs"][0]).abs().max().item()
    log(f"phase 10 GUI (a): viewer camera {gui_cam.width}x{gui_cam.height} (train "
        f"{do_training}, keep_alive {keep_alive}, scaling {scaling}); render_gui_camera "
        f"{frame_ms:.2f} ms, launches {json.dumps(launches_a)}; {out['ms'][0]:.1f} ms from "
        f"the viewer's send to the end of its frame; max abs against render_eval's image "
        f"of the camera {vs_render_eval:.3e}")
    if launches_a != expected or (gui_cam.width, gui_cam.height) != (RENDER_W, RENDER_H):
        raise AssertionError(f"phase 10 GUI (a): launches {launches_a}, camera "
                             f"{gui_cam.width}x{gui_cam.height}")
    gui_err = image_gate("phase 10 GUI (a) frame vs rasterize_scan", img, render["ref"])
    if out["frames"] != [(frame, verify)]:
        raise AssertionError("phase 10 GUI (a): the viewer read other bytes than were sent")

    # (b) train_gs --gui
    info = load_data(dotdict(source_path=data, images=None, eval=True, white_background=False))
    cam = camera_list_from_infos(info.test_cameras)[0]
    messages = [viewer_message(cam, keep_alive=i < GUI_ITERS - 1) for i in range(GUI_ITERS)]
    tmp = tempfile.mkdtemp(prefix="gui_")
    port = free_port()
    argv = ["--source_path", data, "--model_path", os.path.join(tmp, "model"), "--eval",
            "--iterations", str(GUI_ITERS), "--test_iterations", "-1", "--save_iterations",
            str(GUI_ITERS), "--rasterizer", "auto", "--quiet", "--binning_tiers", *APPS_TIERS,
            "--gui", "--ip", "127.0.0.1", "--port", str(port)]
    th, connected, out_b = start_viewer(port, messages)

    def wait_for_viewer():
        # the viewer connects once the server listens; the first step's
        # pre_step then accepts it
        if not connected.wait(GUI_CLIENT_TIMEOUT):
            raise AssertionError("phase 10 GUI (b): the viewer never connected")

    try:
        wall, launches, _, steps, _ = observe_gs_run(
            lambda: train_gs.main(argv), before_run=wait_for_viewer)
    finally:
        th.join(GUI_CLIENT_TIMEOUT)
    check_viewer("phase 10 GUI (b)", th, out_b)
    n = GUI_ITERS
    expected = {"b1": 0, "b2": 0, "b5": 2 * n, "b3": n, "b3_store": n, "b4": n}
    # train_gs composites over black: a pixel is background where all three
    # channels are 0
    shares = [float(np.frombuffer(f, np.uint8).reshape(-1, 3).any(1).mean())
              for f, _ in out_b["frames"]]
    ms = [1e3 * (t1 - t0) for (_, t0), (_, t1) in zip(steps, steps[1:])]
    log(f"phase 10 GUI (b): train_gs.main({' '.join(argv)}) in {wall:.2f} s; launches "
        f"{json.dumps(launches)} (expected {json.dumps(expected)}); {len(out_b['frames'])} "
        f"frames of {cam.width}x{cam.height}; ms from the viewer's send to the end of each "
        f"frame {[round(x, 1) for x in out_b['ms']]}; ms per step (its frame and its "
        f"training step) {[round(x, 1) for x in ms]}; share of each frame's pixels off the "
        f"background {[round(x, 4) for x in shares]}; {gpu_line()}")
    if launches != expected or len(out_b["frames"]) != n:
        raise AssertionError(f"phase 10 GUI (b): launches {launches}, "
                             f"{len(out_b['frames'])} frames")
    for (f, v), share in zip(out_b["frames"], shares):
        if len(f) != cam.width * cam.height * 3 or v != verify or not share > GUI_MIN_COVER:
            raise AssertionError(f"phase 10 GUI (b): a frame of {len(f)} bytes, verify "
                                 f"{v!r}, {share} of its pixels off the background")
    if not os.path.exists(os.path.join(tmp, "model", "point_cloud", f"iteration_{n}",
                                       "point_cloud.ply")):
        raise AssertionError("phase 10 GUI (b): train_gs wrote no PLY")
    shutil.rmtree(tmp)
    return {"launches_frame": launches_a, "launches_train_gs": launches, "gui_err": gui_err,
            "frame_ms": frame_ms, "viewer_ms": out["ms"][0],
            "train_gs_viewer_ms": out_b["ms"], "train_gs_step_ms": ms, "train_gs_wall_s": wall}


def phase_profiling(run_image) -> dict:
    """``utils.profiling`` on the serving path: one ``run_image()`` (an
    eval_image call with fused_attention) inside ``profiling.trace``, whose
    trace must name B1's four CUDA kernels; then ``time_fn`` of it."""
    from sixdgs_torch.utils import profiling

    tmp = tempfile.mkdtemp(prefix="trace_")
    torch.cuda.synchronize()
    zero_launch_counts()
    with profiling.trace(tmp):
        run_image()
        torch.cuda.synchronize()
    launches = launch_counts()["b1"]
    traces = [os.path.join(d, f) for d, _, fs in os.walk(tmp) for f in fs
              if f.endswith(".json")]
    text = "".join(open(f).read() for f in traces)
    names = ("b1_gemm_tile", "b1_pack_q", "b1_stats", "b1_emit")
    missing = [k for k in names if k not in text]
    timing = profiling.time_fn(run_image, iters=5)
    log(f"phase 10 profiling.trace: {len(traces)} trace file(s), {len(text)} bytes, B1 "
        f"launches {launches}, kernels named {[k for k in names if k in text]}; "
        f"time_fn of eval_image {json.dumps(timing)}")
    if not traces or missing or launches != 1:
        raise AssertionError(f"profiling.trace: files {traces}, B1 kernels missing "
                             f"{missing}, B1 launches {launches}")
    shutil.rmtree(tmp)
    return {"launches": launches, **timing}


def phase_convert() -> dict:
    """``apps.convert.main`` against a stub ``colmap`` (a Python script that
    logs its arguments and makes each stage's outputs, since the card's
    machine has no COLMAP): the four stages in order, with the reference's
    flags, and the undistorted model moved into sparse/0."""
    import contextlib
    import io

    from sixdgs_torch.apps import convert

    tmp = tempfile.mkdtemp(prefix="convert_")
    src = os.path.join(tmp, "scene")
    os.makedirs(os.path.join(src, "input"))
    with open(os.path.join(src, "input", "0.png"), "wb") as fh:
        fh.write(b"stub")
    calls = os.path.join(tmp, "colmap_calls.log")
    stub = os.path.join(tmp, "colmap")
    with open(stub, "w") as fh:
        fh.write(f"""#!{sys.executable}
import os, sys
with open({calls!r}, "a") as fh:
    fh.write(" ".join(sys.argv[1:]) + "\\n")
made = {{"mapper": "distorted/sparse/0", "image_undistorter": "sparse"}}.get(sys.argv[1])
if made:
    os.makedirs(os.path.join({src!r}, made), exist_ok=True)
    os.makedirs(os.path.join({src!r}, "images"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        open(os.path.join({src!r}, made, name), "w").close()
""")
    os.chmod(stub, 0o755)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        convert.main(["--source_path", src, "--colmap_executable", stub, "--no_gpu"])
    with open(calls) as fh:
        lines = fh.read().splitlines()
    stages = [c.split()[0] for c in lines]
    moved = sorted(os.listdir(os.path.join(src, "sparse", "0")))
    log(f"phase 10 convert.main with a stub colmap: stages {stages}, sparse/0 {moved}; "
        f"printed {printed.getvalue().splitlines()[-1]!r}")
    if (stages != ["feature_extractor", "exhaustive_matcher", "mapper", "image_undistorter"]
            or "--SiftExtraction.use_gpu 0" not in lines[0]
            or "--Mapper.ba_global_function_tolerance=0.000001" not in lines[2]
            or moved != ["cameras.bin", "images.bin", "points3D.bin"]
            or os.path.exists(os.path.join(src, "sparse", "cameras.bin"))):
        raise AssertionError(f"convert: {lines}, sparse/0 {moved}")
    shutil.rmtree(tmp)
    return {"stages": stages}


def phase_rest_of_clis(pt, scene, arrays, data, render, run_image) -> dict:
    """Phase 10: the Cambridge pose driver, full_eval, the GUI server,
    profiling and convert."""
    t0 = time.perf_counter()
    out = {"cambridge": phase_cambridge_driver(scene, arrays),
           "full_eval": phase_full_eval(pt, data),
           "gui": phase_gui(scene, data, render),
           "profiling": phase_profiling(run_image),
           "convert": phase_convert()}
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 10 the rest of the CLIs: ok in {out['wall_s']:.1f} s")
    return out


def host_ms(fn, calls: int = 200) -> float:
    """Host time per call of ``calls`` calls issued back to back: the
    wrapper's own work, where the device finishes each call before the host
    issues the next."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / calls


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


def b1_inputs(n: int, gen, p: int = P, d: int = D):
    dev = "cuda"
    q = torch.randn(p, d, generator=gen, device=dev)
    feats = torch.randn(n, d, generator=gen, device=dev)
    wk = torch.randn(d, d, generator=gen, device=dev) * 0.05
    bk = torch.randn(d, generator=gen, device=dev) * 0.1
    pmask = (torch.rand(p, generator=gen, device=dev) > 0.3).float()
    valid = torch.ones(n, device=dev)
    valid[n - n // 8:] = 0.0  # padded tail of invalid rays
    return q, feats, wk, bk, pmask, valid


def b1_flops_k_path(n: int) -> int:
    """Flops of the function through K = feats Wk and the logits q K^T,
    once; the earlier design executed them twice."""
    return 2 * (n * D * D + P * n * D)


def b1_flops_reassociated(n: int, p: int = P, d: int = D) -> int:
    """Flops the function needs, without K: q'' = q Wk^T, then the logits
    (q'' feats^T + q bk) / sqrt(d), at p patches of width d."""
    return 2 * (p * n * d + p * d * d)


def b1_executed_flops(n: int) -> int:
    """Flops the kernel executes: the logits twice (stats pass, emit pass)
    on the tensor cores (each times the mode's products), q'' and qb in
    f32 FMA."""
    return 2 * 2 * P * n * D + 2 * P * D * (D + 1)


def b1_bound(n: int, mode: str, p: int = P, d: int = D):
    """(bound_ms, bound_by) of one B1 call at p patches of width d, on B2's
    terms: the reassociated flops at the bf16 tensor-core rate divided by
    the products the mode's accuracy needs (PRODUCTS), against each input
    read once and each output written once (the true shape's: the padding
    and chunking are the kernel's, not the function's)."""
    rate = BF16_FLOPS_PER_S / PRODUCTS[mode]
    nbytes = 4 * (p * d + n * d + d * d + d + p + n + n + 2 * p)
    t_ops, t_bytes = b1_flops_reassociated(n, p, d) / rate, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def b1_case(ak, ins, mode, n):
    """B1 against its plain version at the gates' limits, its invalid tail
    scored exactly 0, and a second launch on the same inputs bitwise equal
    to the first; returns the max abs error of the scores. Any (P, d) the
    wrapper takes: at SuperPoint's the call is SP_CHUNKS launches."""
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
    log(f"B1 n={n} P={ins[0].shape[0]} d={ins[0].shape[1]} mode={mode}: "
        f"max_abs_err={err:.3e} (max|ref|={scale:.3e}, "
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
    # SuperPoint's shape: padded width, patches in chunks, the same gates
    ins = b1_inputs(KERNEL_NS[0], gen, SP_P, SP_D)
    for mode in ak.MODES:
        before = launch_counts()["b1"]
        b1_case(ak, ins, mode, KERNEL_NS[0])
        if launch_counts()["b1"] - before != 2 * SP_CHUNKS:
            raise AssertionError(f"B1 at P={SP_P}: {launch_counts()['b1'] - before}"
                                 f" launches for two calls, expected {2 * SP_CHUNKS}")
    return main_err


def b2_flops(n: int, p: int = P, d: int = D) -> int:
    """Flops the backward needs, reassociated so that K is never formed: the
    logits, dfeats = dlog^T q'' and A = dlog feats (3 P N d), q'' = q Wk^T,
    dq = A Wk and dWk = A^T q (3 P d^2), at p patches of width d."""
    return 2 * (3 * p * n * d + 3 * p * d * d)


def b2_executed_flops(n: int) -> int:
    """Flops the kernel executes: the logits twice (c pass, gradient pass),
    dfeats and A on the tensor cores (each times the mode's products), the
    prologue and epilogue on the CUDA cores."""
    return 2 * (4 * P * n * D + 3 * P * D * D)


def b2_flops_k_path(n: int) -> int:
    """The count of the earlier design, which formed K: 2 (3 N d^2 + 3 P N d)."""
    return 2 * (3 * n * D * D + 3 * P * n * D)


def b2_bound(n: int, mode: str, p: int = P, d: int = D):
    """(bound_ms, bound_by) of one B2 call at p patches of width d: b2_flops
    at the bf16 tensor-core rate divided by the products the mode's accuracy
    needs (PRODUCTS), against inputs q, feats, Wk, bk, pmask, valid, m, s, g
    read once and dq, dfeats, dWk, dbk written once."""
    rate = BF16_FLOPS_PER_S / PRODUCTS[mode]
    nbytes = 4 * (2 * p * d + 2 * n * d + 2 * d * d + 2 * d + 3 * p + 2 * n)
    t_ops, t_bytes = b2_flops(n, p, d) / rate, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def dbk_scale(ins, m, s, g) -> float:
    """max_col sum_j |dk_j|, the size of the terms dbk sums."""
    q, feats, wk, bk, pmask, valid = ins
    d = q.shape[1]
    logits = q @ (feats @ wk + bk).T / math.sqrt(d)
    logits = torch.where(valid[None] > 0, logits, torch.full_like(logits, -9e15))
    probs = torch.exp(logits - m) / s
    c = (probs * g).sum(1, keepdim=True)
    dlog = pmask[:, None] * probs * (g - c) / math.sqrt(d)
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
    # SuperPoint's shape: padded width, patches in chunks, the same gates
    n = KERNEL_NS[0]
    ins = b1_inputs(n, gen, SP_P, SP_D)
    g = torch.randn(n, generator=gen, device="cuda")
    for mode in ak.MODES:
        before = launch_counts()["b2"]
        err, out, msg = b2_case(ak, ins, g, mode)
        log(f"B2 n={n} P={SP_P} d={SP_D} mode={mode}: max_abs_err={err:.3e} (err/scale: "
            f"{msg})")
        if launch_counts()["b2"] - before != 2 * SP_CHUNKS:
            raise AssertionError(f"B2 at P={SP_P}: {launch_counts()['b2'] - before}"
                                 f" launches for two calls, expected {2 * SP_CHUNKS}")
        if [tuple(t.shape) for t in out] != [(SP_P, SP_D), (n, SP_D), (SP_D, SP_D), (SP_D,)]:
            raise AssertionError(f"B2 at P={SP_P}: shapes {[tuple(t.shape) for t in out]}")
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


def phase_training(scene, dino_model, id_module, rng):
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

    zero_launch_counts()
    steps, first = run_trainer(fused, N_TRAIN_STEPS)
    counted = launch_counts()
    launches = (counted["b1"], counted["b2"])
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
    worst = id_grad_gate("first-step", first["grads"], plain_first["grads"])
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
    # the layouts of the CPU parity test and the card test: empty tiles
    # between full ones, exact multiples of 128, a tile over three chunks,
    # aligned demand exactly nc and over it (clamp-cut tiles), one tile, none
    from align_layouts import ALIGN_LAYOUTS, align_layout

    for label, (counts, nc) in ALIGN_LAYOUTS.items():
        gidx, starts, starts_al = (torch.tensor(a, device="cuda")
                                   for a in align_layout(counts, nc, P=N_GAUSSIANS))
        got = pt._align_compact(gidx, starts, starts_al, len(counts), N_GAUSSIANS)
        again = pt._align_compact(gidx, starts, starts_al, len(counts), N_GAUSSIANS)
        want = pt.align_compact_plain(gidx, starts, starts_al, len(counts), N_GAUSSIANS)
        torch.cuda.synchronize()
        tail = got[int(starts_al[-1]):]
        ok = (torch.equal(got, want) and torch.equal(again, got)
              and bool((tail == N_GAUSSIANS).all()))
        log(f"B5 layout {label}: {len(counts)} tiles, nc {nc}, tail {tail.numel()}; equal "
            f"to plain, second launch bitwise, tail all sentinel: {ok}")
        if not ok:
            raise AssertionError(f"B5 layout {label} failed")
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


def phase_render(scene):
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
    zero_launch_counts()
    imgs = [render_eval(scene, cam, bg, scene.max_sh_degree, rasterizer="auto")
            for cam in cams]
    torch.cuda.synchronize()
    counted = launch_counts()
    launches = [counted[k] for k in ("b5", "b3", "b1", "b2")]
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
    del err

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
            "render_err": render_err, "imgs": imgs, "ref": ref}


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


def phase_gs_training(pt, arrays, render, rng):
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

    torch.cuda.synchronize()
    zero_launch_counts()
    trainer.run(iterations=GS_LAST_IT, first_iteration=GS_FIRST_IT, log_every=GS_LOG_EVERY,
                callback=callback, pre_step=pre_step, rasterizer="auto",
                adapt_tiers_every=GS_ADAPT_EVERY)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    psnr_after = trainer.eval_psnr()
    torch.cuda.synchronize()
    n_steps = GS_LAST_IT - GS_FIRST_IT + 1
    counted = launch_counts()
    launches = {k: counted[k] for k in ("b5", "b4", "b3_store", "b3")}
    log(f"phase 6 3DGS training: {n_steps} steps; launches {json.dumps(launches)} "
        f"(expected B3 store {n_steps}, B4 {n_steps}, B5 {n_steps} + 2 evaluation renders, "
        f"B3 without the store 2); B1 {counted['b1']}, B2 {counted['b2']}")
    if launches != {"b5": n_steps + 2, "b4": n_steps, "b3_store": n_steps, "b3": 2} or (
            counted["b1"] or counted["b2"]):
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
    if launch_counts()["b4"] != n_steps:
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


def same_on_every_rank(t: torch.Tensor) -> bool:
    """Whether ``t`` is bitwise rank 0's on this rank (a broadcast)."""
    import torch.distributed as dist

    ref = t.clone()
    dist.broadcast(ref, 0)
    return bool(torch.equal(ref, t))


def parallel_inputs(scene, render, gs_run, pose) -> dict:
    """What both runs of phase 11 start from, as CPU tensors: the render
    scene, phase 6's perturbed start state, PAR_CAMERAS render cameras with
    their ground truth, phase 6's learning rates, and phase 3's images,
    rays and weights."""
    from sixdgs_torch.parallel.gs_sharding import stack_camera_batch
    from sixdgs_torch.train import gs_trainer as gs

    import dataclasses

    def cpu(params):
        return {k: v.detach().cpu() for k, v in params.items()}

    tr = gs_run["trainer"]
    cams = [dataclasses.replace(cam, image=img.cpu().numpy())
            for cam, img in zip(render["cams"][:PAR_CAMERAS], render["imgs"])]
    start = gs_run["start_state"].scene
    return {
        "scene": cpu(scene.params()), "active": scene.active.cpu(),
        "start": cpu(start.params()), "start_active": start.active.cpu(),
        "cams": list(stack_camera_batch(cams, "cpu")),
        "render_cam": list(gs.camera_arrays(render["cams"][0], "cpu"))[:5],
        "lrs": gs.lr_dict(tr.opt, tr.spatial_lr_scale, GS_FIRST_IT),
        "bg": list(RENDER_BG),
        "images": torch.stack(pose["images"]).cpu(), "masks": torch.stack(pose["masks"]).cpu(),
        "c2w": torch.stack(pose["c2ws"]).cpu(), "rays": [x.cpu() for x in pose["rays"]],
        "dino": cpu(pose["dino"].state_dict()), "idm": cpu(pose["id_module"].state_dict()),
    }


def parallel_paths(inp: dict, world: int) -> dict:
    """parallel/'s three paths in this process's group of ``world`` ranks on
    the card, each with its launch counts zeroed just before and read just
    after: (a) PAR_STEPS DP 3DGS steps of the PAR_CAMERAS cameras, (b) the
    Gaussian-parallel render of camera 0, (c) one sharded id-module step
    per mesh of PAR_POSE_MESHES (at world size 1 on a (1, 1) mesh, once for
    the full step and once for the cached one). Rank 0 also returns the
    arrays the gates compare."""
    import torch.distributed as dist

    from sixdgs_torch.parallel import gs_sharding, pose_sharding
    from sixdgs_torch.parallel.mesh import make_mesh
    from sixdgs_torch.pose import trainer as ttr
    from sixdgs_torch.pose.dino import DinoViT
    from sixdgs_torch.pose.modules import init_id_module
    from sixdgs_torch.rays.engine import Rays
    from sixdgs_torch.scene.gaussians import GaussianScene
    from sixdgs_torch.train import gs_trainer as gs

    rank0 = dist.get_rank() == 0
    bg = torch.tensor(inp["bg"], device="cuda")
    res = {}

    def cuda(params):
        return {k: v.cuda() for k, v in params.items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    # (a) the DP 3DGS step
    mesh = make_mesh(axis_names=("data",))
    step = gs_sharding.make_sharded_gs_step(mesh, width=RENDER_W, height=RENDER_H,
                                            sh_degree=3, rasterizer="auto")
    cams = gs_sharding.shard_camera_batch(mesh, gs.CameraArrays(*(x.cuda() for x in inp["cams"])))
    state = gs.init_train_state(GaussianScene(active=inp["start_active"].cuda(),
                                              max_sh_degree=3, **cuda(inp["start"])))
    zero_launch_counts()
    a = {"ms": [], "loss": [], "grad_dropped": [], "cameras": int(cams.view.shape[0])}
    for _ in range(PAR_STEPS):
        (state, m), ms = timed(lambda: step(state, cams, bg, inp["lrs"]))
        a["ms"].append(ms)
        a["loss"].append(float(m["loss"]))
        a["grad_dropped"].append(int(m["grad_dropped"]))
    a["launches"] = launch_counts()
    arrays = {k: getattr(state.scene, k) for k in ("xyz",)}
    arrays.update(xyz_grad_accum=state.xyz_grad_accum, denom=state.denom,
                  max_radii2d=state.max_radii2d)
    a["replicated"] = same_on_every_rank(torch.cat(
        [v.reshape(-1).to(torch.float32) for v in state.scene.params().values()]
        + [v.reshape(-1).to(torch.float32) for v in arrays.values()]))
    if rank0:
        a["arrays"] = {k: v.cpu() for k, v in arrays.items()}
    res["gs"] = a
    del state, cams, step

    # (b) the sharded render: this rank's band of camera 0
    mesh = make_mesh(axis_names=("gaussians",))
    params, active = pose_sharding.shard_scene(mesh, cuda(inp["scene"]),
                                               inp["active"].cuda())
    render = pose_sharding.make_sharded_render(mesh, RENDER_W, RENDER_H, 3)
    cam = gs.CameraArrays(*(x.cuda() for x in inp["render_cam"]))
    render(params, active, cam, bg)  # warm-up
    zero_launch_counts()
    band, _ = timed(lambda: render(params, active, cam, bg))
    b = {"launches": launch_counts(), "band": band.cpu(),
         "rows": pose_sharding.band_rows(RENDER_H, world, dist.get_rank()),
         "gaussians": int(active.shape[0]),
         "ms": statistics.median(timed(lambda: render(params, active, cam, bg))[1]
                                 for _ in range(PAR_RENDER_FRAMES))}
    res["render"] = b
    del params, active

    # (c) the sharded id-module steps
    dino_model = DinoViT(384, 12, 37 * 37)
    dino_model.load_state_dict(inp["dino"])
    dino_model = dino_model.cuda().eval()
    batch = ttr.PoseBatch(inp["images"].cuda(), inp["masks"].cuda(), inp["c2w"].cuda())
    rays = Rays(*(x.cuda() for x in inp["rays"]))
    up = torch.tensor([0.0, 1.0, 0.0], device="cuda")
    meshes = PAR_POSE_MESHES if world > 1 else (("pose", (1, 1), False),
                                                ("cached", (1, 1), True))
    c = {}
    for name, shape, cached in meshes:
        mesh = make_mesh(shape=shape)
        idm = init_id_module(None, feature_dim=384, grid=16, device="cuda")
        idm.load_state_dict(inp["idm"])
        opt = ttr.make_adafactor(idm.parameters())
        if cached:
            fb = ttr.FeatureBatch(*ttr._features(dino_model, batch.images, batch.masks,
                                                 "dino"), batch.c2w)
            fb, r = pose_sharding.shard_feature_inputs(mesh, fb, rays)
            step = pose_sharding.make_sharded_pose_step_cached(mesh)
            run = lambda: step(idm, opt, fb, r, up)  # noqa: E731
        else:
            bt, r = pose_sharding.shard_pose_inputs(mesh, batch, rays)
            step = pose_sharding.make_sharded_pose_step(mesh)
            run = lambda: step(idm, opt, dino_model, bt, r, up)  # noqa: E731
        zero_launch_counts()
        aux, ms = timed(run)
        names = [n for n, _ in idm.named_parameters()]
        flat = torch.cat([p.detach().reshape(-1) for p in idm.parameters()])
        one = {"ms": ms, "loss": float(aux["loss"]), "n_nan": int(aux["n_nan"]),
               "launches": launch_counts(), "replicated": same_on_every_rank(flat)}
        if rank0:
            one["params"] = {n: p.detach().cpu() for n, p in idm.named_parameters()}
            one["grads"] = {n: p.grad.cpu() for n, p in zip(names, idm.parameters())}
        one["steady_ms"] = timed(run)[1]  # a second step, after the first's warm-up
        c[name] = one
    res["pose"] = c
    return res


def parallel_rank(rank: int, world: int, workdir: str) -> None:
    """One gloo rank of phase 11, in a spawned process on the card."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/init", rank=rank,
                            world_size=world)
    res = parallel_paths(torch.load(os.path.join(workdir, "inputs.pt")), world)
    torch.save(res, os.path.join(workdir, f"out{rank}.pt"))
    dist.destroy_process_group()


def spawn_gloo_ranks(workdir: str) -> list:
    """PAR_RANKS gloo ranks in spawned processes, all stopped within
    PAR_RANK_TIMEOUT; each rank's results, or an error."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=parallel_rank, args=(r, PAR_RANKS, workdir))
             for r in range(PAR_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PAR_RANK_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * PAR_RANKS:
        raise AssertionError(f"phase 11 gloo ranks exited with {codes} (None: killed "
                             f"at the {PAR_RANK_TIMEOUT} s limit)")
    return [torch.load(os.path.join(workdir, f"out{r}.pt")) for r in range(PAR_RANKS)]


def phase_parallel(scene, render, gs_run, pose) -> dict:
    """Phase 11: parallel/ at full width, NCCL at world size 1 here, then
    gloo at world size 2 in spawned processes on the same card, held to each
    other and to render_eval."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        torch.save(parallel_inputs(scene, render, gs_run, pose),
                   os.path.join(workdir, "inputs.pt"))
        inp = torch.load(os.path.join(workdir, "inputs.pt"))
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                rank=0, world_size=1)
        try:
            one = parallel_paths(inp, 1)
        finally:
            dist.destroy_process_group()
        del inp
        t_gloo = time.perf_counter()
        ranks = spawn_gloo_ranks(workdir)
        gloo_s = time.perf_counter() - t_gloo
    two = ranks[0]

    # (a) the DP 3DGS step
    a1, a2 = one["gs"], two["gs"]
    launches = {k: sum(r["gs"]["launches"][k] for r in ranks) for k in a2["launches"]}
    n = PAR_CAMERAS * PAR_STEPS
    want = {"b1": 0, "b2": 0, "b5": n, "b3": 0, "b3_store": n, "b4": n}
    log(f"phase 11 (a) DP 3DGS step, {PAR_CAMERAS} cameras at {RENDER_W}x{RENDER_H}, "
        f"{PAR_STEPS} steps: NCCL-1 loss {a1['loss']} step ms {a1['ms']}; gloo-2 loss "
        f"{a2['loss']} step ms {[r['gs']['ms'] for r in ranks]} (cameras per rank "
        f"{[r['gs']['cameras'] for r in ranks]}); launches NCCL-1 "
        f"{json.dumps(a1['launches'])}, gloo-2 summed over ranks {json.dumps(launches)}")
    if a1["launches"] != want or launches != want:
        raise AssertionError(f"sharded 3DGS step launches {a1['launches']} / {launches}, "
                             f"expected {want}")
    if any(r["grad_dropped"] != [0] * PAR_STEPS for r in (a1, *(x["gs"] for x in ranks))):
        raise AssertionError("a sharded 3DGS step dropped its raster gradients")
    if not all(r["gs"]["replicated"] for r in ranks):
        raise AssertionError("the gloo ranks' 3DGS states differ")
    errs = {"loss_rel": max(abs(x - y) / abs(y) for x, y in zip(a2["loss"], a1["loss"]))}
    g, w = a2["arrays"], a1["arrays"]
    errs["xyz"] = (g["xyz"] - w["xyz"]).abs().max().item()
    acc = (g["xyz_grad_accum"] - w["xyz_grad_accum"]).abs()
    errs["accum_excess"] = (acc - 1e-4 * w["xyz_grad_accum"].abs()).max().item()
    log(f"  gloo-2 vs NCCL-1: {json.dumps(errs)} (limits loss rtol 1e-5, xyz atol 1e-5, "
        f"accum rtol 1e-4 atol 1e-6); denom and max radii equal: "
        f"{torch.equal(g['denom'], w['denom'])}, "
        f"{torch.equal(g['max_radii2d'], w['max_radii2d'])}")
    if not (all(map(math.isfinite, a2["loss"])) and errs["loss_rel"] <= 1e-5
            and errs["xyz"] <= 1e-5 and errs["accum_excess"] <= 1e-6
            and torch.equal(g["denom"], w["denom"])
            and torch.equal(g["max_radii2d"], w["max_radii2d"])):
        raise AssertionError(f"sharded 3DGS step, gloo-2 vs NCCL-1: {errs}")

    # (b) the sharded render
    ref = render["imgs"][0].cpu()
    img = torch.cat([r["render"]["band"] for r in ranks], dim=1)
    b_err = {"gloo2": (img - ref).abs().max().item(),
             "nccl1": (one["render"]["band"] - ref).abs().max().item()}
    log(f"phase 11 (b) sharded render of camera 0: {one['render']['gaussians']} Gaussians "
        f"and {RENDER_H} rows at world size 1, per rank "
        f"{[r['render']['gaussians'] for r in ranks]} Gaussians, rows "
        f"{[r['render']['rows'] for r in ranks]}; ms per frame NCCL-1 "
        f"{one['render']['ms']:.3f}, gloo-2 {[r['render']['ms'] for r in ranks]}; launches "
        f"per rank {[r['render']['launches'] for r in ranks]}; max abs err vs render_eval "
        f"{json.dumps(b_err)} (limit 2e-5)")
    want = {"b1": 0, "b2": 0, "b5": 1, "b3": 1, "b3_store": 0, "b4": 0}
    if any(r["render"]["launches"] != want for r in (one, *ranks)):
        raise AssertionError("sharded render launches")
    if not (img.shape == ref.shape and max(b_err.values()) <= 2e-5):
        raise AssertionError(f"sharded render off render_eval: {b_err}")

    # (c) the sharded id-module steps
    c_err = {}
    for name, shape, cached in PAR_POSE_MESHES:
        got, want = two["pose"][name], one["pose"]["cached" if cached else "pose"]
        loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        p_excess = max(((got["params"][k] - v).abs() - 5e-3 * v.abs()).max().item()
                       for k, v in want["params"].items())
        top = max(v.abs().max().item() for v in want["grads"].values())
        g_err = max(((got["grads"][k] - v).abs().max().item()
                     / (top if k in ZERO_GRAD_PARAMS else v.abs().max().item()))
                    for k, v in want["grads"].items())
        c_err[name] = {"mesh": shape, "loss": got["loss"], "loss_rel": loss_rel,
                       "param_excess": p_excess, "grad_rel": g_err,
                       "ms": [r["pose"][name]["ms"] for r in ranks],
                       "steady_ms": [r["pose"][name]["steady_ms"] for r in ranks]}
        launches = [r["pose"][name]["launches"] for r in ranks] + [
            one["pose"]["cached" if cached else "pose"]["launches"]]
        if any(x["b1"] or x["b2"] for x in launches):
            raise AssertionError(f"{name}: B1/B2 launched {launches}")
        if not (math.isfinite(got["loss"]) and loss_rel <= 2e-4 and p_excess <= 1.5e-3
                and g_err <= TRAIN_GRAD_TOL and got["n_nan"] == 0
                and all(r["pose"][name]["replicated"] for r in ranks)):
            raise AssertionError(f"{name}: gloo-2 vs NCCL-1 {c_err[name]}")
    log(f"phase 11 (c) sharded id-module step, 4 images at {IMAGE_HW}x{IMAGE_HW}, 32,768 "
        f"rays: NCCL-1 loss {one['pose']['pose']['loss']} (ms, first and second step: "
        f"{one['pose']['pose']['ms']:.1f}, {one['pose']['pose']['steady_ms']:.1f}), cached "
        f"{one['pose']['cached']['loss']} ({one['pose']['cached']['ms']:.1f}, "
        f"{one['pose']['cached']['steady_ms']:.1f}); gloo-2 " + json.dumps(c_err) + " (limits loss rtol 2e-4, params atol 1.5e-3 "
        f"rtol 5e-3, gradients {TRAIN_GRAD_TOL} of each one's largest)")
    wall = time.perf_counter() - t_phase
    log(f"phase 11 parallel: ok ({wall:.1f} s, of it {gloo_s:.1f} s for the gloo ranks)")
    return {"gs_launches": {k: sum(r["gs"]["launches"][k] for r in ranks)
                            for k in ("b5", "b3_store", "b4")},
            "gs_launches_nccl1": a1["launches"],
            "render_launches": {k: sum(r["render"]["launches"][k] for r in ranks)
                                for k in ("b5", "b3")},
            "render_launches_nccl1": one["render"]["launches"],
            "timing": {"gs_step_ms_nccl1": a1["ms"], "gs_step_ms_gloo2":
                       [r["gs"]["ms"] for r in ranks],
                       "render_ms_nccl1": one["render"]["ms"],
                       "render_ms_gloo2": [r["render"]["ms"] for r in ranks],
                       "pose_ms_nccl1": {k: [v["ms"], v["steady_ms"]]
                                         for k, v in one["pose"].items()},
                       "pose_ms_gloo2": {k: [v["ms"], v["steady_ms"]]
                                         for k, v in c_err.items()},
                       "wall_s": wall, "gloo_s": gloo_s},
            "errors": {"gs": errs, "render": b_err, "pose": c_err}}


def rss_bytes() -> int:
    """This process's resident set (VmRSS) in bytes."""
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def gib(n: float) -> float:
    return n / 2**30


class Peaks:
    """Peak host RSS (VmRSS sampled every RSS_SAMPLE_S) and peak device
    memory of nested windows of this process: each window's peak covers
    its whole life, although the device's peak counter is reset whenever a
    window opens."""

    def __init__(self):
        self.rss, self.dev = {}, {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(RSS_SAMPLE_S):
            now = rss_bytes()
            with self._lock:
                for k in self.rss:
                    self.rss[k] = max(self.rss[k], now)

    def _fold(self) -> None:
        m = torch.cuda.max_memory_allocated()
        for k in self.dev:
            self.dev[k] = max(self.dev[k], m)

    def open(self, name: str) -> None:
        torch.cuda.synchronize()
        self._fold()
        torch.cuda.reset_peak_memory_stats()
        self.dev[name] = torch.cuda.memory_allocated()
        with self._lock:
            self.rss[name] = rss_bytes()

    def close(self, name: str):
        """(peak RSS bytes, peak device bytes) of the window."""
        torch.cuda.synchronize()
        self._fold()
        with self._lock:
            rss = max(self.rss.pop(name), rss_bytes())
        return rss, self.dev.pop(name)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


class ToolObserver:
    """What a workflow tool's run costs, read from inside it. Within the
    block every call of ``apps.pose_eval.main`` and ``apps.train_gs.main``
    is recorded in ``calls``: its argv, wall, peak host RSS and device
    memory, the launches of the counted kernels (``counts``, a function
    returning launch counts, when given), the id-module training inside it
    (PoseTrainer.run: steps, seconds, ms a step) and its ray renewals
    (PoseTrainer._regen_rays: host RSS, device memory allocated and seconds
    at each; first, last and max). ``trains`` holds every training run of
    the block, ``trainer`` the last PoseTrainer that ran. Used by phase 12
    and by workflow_depth.py."""

    def __init__(self, peaks: Peaks, counts=None):
        self.peaks, self.counts = peaks, counts
        self.calls, self.trains, self.renewals = [], [], []
        self.trainer = None

    def train_summary(self, start: int = 0) -> dict:
        steps = sum(n for n, _ in self.trains[start:])
        secs = sum(s for _, s in self.trains[start:])
        return {"train_steps": steps, "train_s": secs,
                "train_ms_per_step": 1e3 * secs / steps} if steps else {}

    def _app(self, kind, fn):
        def wrapped(argv=None):
            self.peaks.open(kind)
            self.renewals.clear()
            first_train = len(self.trains)
            before = self.counts() if self.counts else None
            t0 = time.perf_counter()
            try:
                return fn(argv)
            finally:
                rss, dev = self.peaks.close(kind)
                rec = {"call": kind, "argv": argv, "wall_s": time.perf_counter() - t0,
                       "peak_rss_gib": gib(rss), "peak_device_gib": gib(dev),
                       **self.train_summary(first_train)}
                if before is not None:
                    after = self.counts()
                    rec["launches"] = {k: after[k] - before[k] for k in after}
                if self.renewals:
                    rss = [r[0] for r in self.renewals]
                    dev = [r[1] for r in self.renewals]
                    rec["renewals"] = {
                        "count": len(self.renewals),
                        "ms_mean": 1e3 * sum(r[2] for r in self.renewals)
                        / len(self.renewals),
                        "rss_gib_first_last_max": [gib(rss[0]), gib(rss[-1]), gib(max(rss))],
                        "device_gib_first_last_max": [gib(dev[0]), gib(dev[-1]),
                                                      gib(max(dev))]}
                self.calls.append(rec)
        return wrapped

    def __enter__(self):
        from sixdgs_torch.apps import pose_eval, train_gs
        from sixdgs_torch.pose import trainer

        cls = trainer.PoseTrainer
        self._saved = [(pose_eval, "main", pose_eval.main), (train_gs, "main", train_gs.main),
                       (cls, "run", cls.run), (cls, "_regen_rays", cls._regen_rays)]
        run, regen, obs = cls.run, cls._regen_rays, self

        def timed_run(tr, n_iterations=None, start_iteration=0, **kw):
            obs.trainer = tr
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run(tr, n_iterations, start_iteration, **kw)
            torch.cuda.synchronize()
            n = n_iterations if n_iterations is not None else tr.cfg.n_iterations
            obs.trains.append((n - start_iteration, time.perf_counter() - t))
            return out

        def timed_regen(tr):
            torch.cuda.synchronize()
            t = time.perf_counter()
            regen(tr)
            torch.cuda.synchronize()
            obs.renewals.append((rss_bytes(), torch.cuda.memory_allocated(),
                                 time.perf_counter() - t))

        pose_eval.main = self._app("pose_eval", pose_eval.main)
        train_gs.main = self._app("train_gs", train_gs.main)
        cls.run, cls._regen_rays = timed_run, timed_regen
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)


def state_digest(state, loss) -> dict:
    """What a 3DGS training state holds, compared across runs: the loss of
    the step that made it (float64 repr), the active count, the float64
    sum and sum of squares of each parameter group, and a blake2b of every
    byte of the state (parameters, mask, both Adam moments and the step,
    the densification statistics)."""
    from sixdgs_torch.scene.gaussians import PARAM_NAMES

    sc = state.scene
    groups = [getattr(sc, k) for k in PARAM_NAMES]
    tensors = (groups + [sc.active] + [state.adam.m[k] for k in PARAM_NAMES]
               + [state.adam.v[k] for k in PARAM_NAMES]
               + [state.adam.step, state.xyz_grad_accum, state.denom, state.max_radii2d])
    sums = torch.stack([f(g.double()) for g in groups
                        for f in (torch.sum, lambda x: torch.sum(x * x))]).tolist()
    h = hashlib.blake2b(digest_size=16)
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return {"loss": None if loss is None else repr(float(loss)),
            "num_active": int(sc.num_active()),
            "sums": {k: [repr(sums[2 * i]), repr(sums[2 * i + 1])]
                     for i, k in enumerate(PARAM_NAMES)},
            "hash": h.hexdigest()}


class GSDigests:
    """Digests (``state_digest``) of every GSTrainer.run inside the block,
    read through the run's own ``pre_step`` hook: the state entering
    iteration it + 1 for every it that is a multiple of ``every`` (so each
    densification at a multiple of 100 is digested just after it), and the
    final state when the run returns. ``runs`` holds one list per run, each
    entry with its ``it``. ``timing`` holds per run its iterations, wall
    (the digests included), digest seconds and densification events and
    seconds (densify_event), so that the ms a step without the digests
    shows."""

    def __init__(self, every: int = 25):
        self.every, self.runs, self.timing = every, [], []
        self._loss = None

    def _take(self, it: int, state) -> None:
        t0 = time.perf_counter()
        self.runs[-1].append({"it": it, **state_digest(state, self._loss)})
        self.timing[-1]["digest_s"] += time.perf_counter() - t0

    def __enter__(self):
        from sixdgs_torch.train import gs_trainer as gs

        self._saved = (gs.GSTrainer.run, gs.train_step, gs.densify_event)
        run, step, densify, obs = gs.GSTrainer.run, gs.train_step, gs.densify_event, self

        def digested_step(*a, **k):
            state, metrics = step(*a, **k)
            obs._loss = metrics["loss"]
            return state, metrics

        def timed_densify(*a, **k):
            t0 = time.perf_counter()
            out = densify(*a, **k)
            obs.timing[-1]["densify_n"] += 1
            obs.timing[-1]["densify_s"] += time.perf_counter() - t0
            return out

        def digested_run(tr, *a, pre_step=None, **k):
            obs.runs.append([])
            obs._loss = None
            first = k.get("first_iteration", 1)
            last = k.get("iterations") or tr.opt.iterations
            obs.timing.append({"iterations": last - first + 1, "run_s": 0.0, "digest_s": 0.0,
                               "densify_n": 0, "densify_s": 0.0})

            def hook(it, trainer):
                if (it - 1) % obs.every == 0:
                    obs._take(it - 1, trainer.state)
                if pre_step is not None:
                    pre_step(it, trainer)

            t0 = time.perf_counter()
            out = run(tr, *a, pre_step=hook, **k)
            obs._take(last, tr.state)
            obs.timing[-1]["run_s"] = time.perf_counter() - t0
            return out

        gs.GSTrainer.run, gs.train_step, gs.densify_event = (digested_run, digested_step,
                                                             timed_densify)
        return self

    def __exit__(self, *exc):
        from sixdgs_torch.train import gs_trainer as gs

        gs.GSTrainer.run, gs.train_step, gs.densify_event = self._saved


def first_divergence(a: list, b: list):
    """The first digest of run ``b`` that differs from run ``a``'s at the
    same iteration, as (iteration, [differing fields]), or None when every
    common iteration agrees."""
    for da, db in zip(a, b):
        if da["it"] != db["it"]:
            return da["it"], ["it"]
        diff = [k for k in ("loss", "num_active", "hash") if da[k] != db[k]]
        diff += [f"sums.{g}" for g in da["sums"] if da["sums"][g] != db["sums"][g]]
        if diff:
            return da["it"], diff
    return None


def id_grad_gate(label: str, got: dict, want: dict) -> float:
    """The id module's gradients through the fused scorer (``got``) against
    the plain scorer's (``want``): each parameter's within TRAIN_GRAD_TOL
    of its own largest magnitude (ZERO_GRAD_PARAMS: of the module's
    largest); returns the worst ratio."""
    top = max(g.abs().max().item() for g in want.values())
    worst = 0.0
    for name, g in want.items():
        err = (got[name] - g).abs().max().item()
        scale = top if name in ZERO_GRAD_PARAMS else g.abs().max().item()
        worst = max(worst, err / scale)
        if not err <= TRAIN_GRAD_TOL * scale:
            raise AssertionError(f"{label} gradient of {name}: {err} > "
                                 f"{TRAIN_GRAD_TOL} * {scale}")
    return worst


def accuracy_batch_check(trainer) -> dict:
    """One training batch of the accuracy tool's trained id module (its
    64-wide features, which B1 and B2 take zero-padded to 384) and its
    current rays, on the card: each image's scores through the fused
    wrapper against the plain scorer (PIPELINE_TOL of the largest, as phase
    3), and the batch loss and the module's gradients, the VJP of those
    scores, fused against plain (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, as phase
    4)."""
    from sixdgs_torch.pose.id_module import score_image_cached
    from sixdgs_torch.pose.trainer import batch_loss_cached

    batch, rays, module = trainer._sample_batch(), trainer.rays, trainer.id_module
    score_err = 0.0
    with torch.no_grad():
        for b in range(batch.c2w.shape[0]):
            args = (module, batch.feats_pe[b], batch.patch_mask[b], batch.fmap[b], rays)
            got = score_image_cached(*args, fused_attention=True).scores
            want = score_image_cached(*args, fused_attention=False).scores
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            score_err = max(score_err, err / scale)
            if not err <= PIPELINE_TOL * scale:
                raise AssertionError(f"accuracy batch image {b}: fused scores off the plain "
                                     f"scorer by {err} (max {scale})")

    def loss_grads(fused: bool):
        module.zero_grad(set_to_none=True)
        loss, _ = batch_loss_cached(module, batch, rays, trainer.model_up, fused)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in module.named_parameters()}

    (f_loss, f_grads), (p_loss, p_grads) = loss_grads(True), loss_grads(False)
    module.zero_grad(set_to_none=True)
    rel = abs(f_loss - p_loss) / abs(p_loss)
    if not rel <= TRAIN_LOSS_TOL:
        raise AssertionError(f"accuracy batch loss fused {f_loss} vs plain {p_loss}")
    worst = id_grad_gate("accuracy batch", f_grads, p_grads)
    return {"images": int(batch.c2w.shape[0]), "patches": int(batch.feats_pe.shape[1]),
            "width": int(batch.feats_pe.shape[2]), "rays": int(rays.valid.numel()),
            "score_err_rel": score_err, "loss_rel": rel, "grad_err_rel": worst}


def tools_accuracy() -> dict:
    """Phase 12 (a): tools.pose_accuracy_experiment through its main, fused,
    at TOOLS_ACC_ITERS iterations, held to the JAX test's assertions; then
    one batch of its trained module fused against plain."""
    from sixdgs_torch.tools import pose_accuracy_experiment

    peaks = Peaks()
    try:
        with ToolObserver(peaks) as obs:
            torch.cuda.synchronize()
            zero_launch_counts()
            t0 = time.perf_counter()
            out = pose_accuracy_experiment.main(["--iterations", str(TOOLS_ACC_ITERS),
                                                 "--fused_attention"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
    finally:
        peaks.stop()
    n = TOOLS_ACC_VIEWS
    want = {"b1": TOOLS_ACC_ITERS * TOOLS_ACC_BATCH + 3 * n,
            "b2": TOOLS_ACC_ITERS * TOOLS_ACC_BATCH, "b5": n, "b3": n, "b3_store": 0, "b4": 0}
    t, a, r = out["value"], out["angular_error_deg"], out["recall_at_100"]
    u = out["untrained"]
    log(f"phase 12 (a) pose_accuracy_experiment, {TOOLS_ACC_ITERS} iterations, fused: "
        f"t_err {t} a_err {a} recall {r} (untrained {u['t_err']} / {u['a_err']} / "
        f"{u['recall']}; target-score solve {out['target_score_solve_t_err']}); wall "
        f"{wall:.2f} s; training {json.dumps(obs.train_summary())}; launches "
        f"{json.dumps(launches)}")
    if launches != want:
        raise AssertionError(f"accuracy tool launches {launches}, expected {want}")
    checks = {"t_err < 0.6 untrained": t < 0.6 * u["t_err"],
              "a_err < 0.6 untrained": a < 0.6 * u["a_err"],
              "recall > 0.15 > untrained": r > 0.15 > u["recall"],
              "t_err < 6 target": t < 6.0 * out["target_score_solve_t_err"],
              "t_err < 0.95": t < 0.95, "a_err < 45": a < 45.0, "recall > 0.30": r > 0.30}
    if not all(checks.values()):
        raise AssertionError(f"accuracy tool missed {[k for k, v in checks.items() if not v]}")
    kernels = accuracy_batch_check(obs.trainer)
    log(f"phase 12 (a) one batch of the trained module, fused vs plain: {json.dumps(kernels)} "
        f"(limits: scores {PIPELINE_TOL}, loss {TRAIN_LOSS_TOL}, gradients {TRAIN_GRAD_TOL})")
    return {"launches": launches, "wall_s": wall, "result": out, "kernels": kernels,
            **obs.train_summary()}


def raster_kernel_checks(pt, label: str, scene, cam, bg) -> dict:
    """B5, B3 and B3 with the store and B4 against their plain versions on
    the layout that ``scene`` through ``cam`` gives (phase 5's gates)."""
    proj, lay, _ = layout_of(scene, cam)
    gidx_al = pt._align_compact(lay.gidx_c, lay.starts, lay.starts_al, lay.n_tiles, lay.P)
    want = pt.align_compact_plain(lay.gidx_c, lay.starts, lay.starts_al, lay.n_tiles, lay.P)
    torch.cuda.synchronize()
    if not torch.equal(gidx_al, want):
        raise AssertionError(f"B5 {label}: differs from its plain version")
    records = pt._gather_records(lay, gidx_al)
    args = (records, lay.starts_al, lay.counts_k, lay.nx, lay.ny, bg)
    out = pt.pallas_composite_fwd(*args)
    b3_err = b3_check(label, out, pt.composite_fwd_plain(*args))
    b4_err = backward_checks(pt, label, args, out)
    return {"tiles": lay.n_tiles, "pairs": int(lay.starts[-1]), "b5_equal": True,
            "b3_err": b3_err, "b4_err": b4_err}


def tools_quality(pt) -> dict:
    """Phase 12 (b): tools.quality_workflow through its main at 400x400,
    TOOLS_QW_ITERS iterations from a sparse init with the opacity reset at
    TOOLS_QW_RESET; the trainer's densifications, resets and SH steps are
    counted from inside the run. Then the kernels against their plain
    versions on the run's inputs: the layout of the first GT render, and
    one step from the trained state (the layout of its camera, and the
    step's gradients against a twin through the plain B3 and B4)."""
    from sixdgs_torch.apps import train_gs
    from sixdgs_torch.scene.cameras import camera_list_from_infos
    from sixdgs_torch.scene.gaussians import PARAM_NAMES
    from sixdgs_torch.train import gs_trainer as gs
    from sixdgs_torch.tools import quality_workflow

    events = {"densify": 0, "reset": 0}
    densify, reset, run = gs.densify_event, gs.reset_opacity, gs.GSTrainer.run
    render_gt, train_main = quality_workflow.render_gt_images, train_gs.main
    trainers, gt, train_argvs = [], [], []

    def counted_densify(*a, **k):
        events["densify"] += 1
        return densify(*a, **k)

    def counted_reset(*a, **k):
        events["reset"] += 1
        return reset(*a, **k)

    def kept_run(self, *a, **k):
        trainers.append(self)
        return run(self, *a, **k)

    def kept_render(scene, infos, *a, **k):
        gt.append((scene, infos[0]))
        return render_gt(scene, infos, *a, **k)

    def kept_train(argv=None):
        train_argvs.append(list(argv))
        return train_main(argv)

    workdir = tempfile.mkdtemp(prefix="quality_workflow_")
    gs.densify_event, gs.reset_opacity, gs.GSTrainer.run = (counted_densify, counted_reset,
                                                            kept_run)
    quality_workflow.render_gt_images, train_gs.main = kept_render, kept_train
    try:
        with GSDigests() as digests:
            torch.cuda.synchronize()
            zero_launch_counts()
            t0 = time.perf_counter()
            out = quality_workflow.main(["--workdir", workdir] + TOOLS_QW_ARGS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
    finally:
        gs.densify_event, gs.reset_opacity, gs.GSTrainer.run = densify, reset, run
        quality_workflow.render_gt_images, train_gs.main = render_gt, train_main
    losses = []
    with open(os.path.join(workdir, "out", "metrics.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec["tag"] == "train_loss_patches/total_loss":
                losses.append(rec["value"])
    gate = determinism_gate(train_argvs, digests.runs, workdir)
    shutil.rmtree(workdir)
    views = TOOLS_QW_TRAIN + TOOLS_QW_TEST
    # GT renders of every view, the test renders at the last iteration, and
    # the render app's renders of every view: B5 and B3 without the store;
    # each step B5, B3 with the store and B4
    renders = views + TOOLS_QW_TEST + views
    want = {"b1": 0, "b2": 0, "b5": TOOLS_QW_ITERS + renders, "b3": renders,
            "b3_store": TOOLS_QW_ITERS, "b4": TOOLS_QW_ITERS}
    floor = TOOLS_QW_PSNR_CARD - TOOLS_QW_PSNR_MARGIN
    sh = trainers[0].active_sh_degree if trainers else None
    log(f"phase 12 (b) quality_workflow, {TOOLS_QW_ITERS} iterations at 400x400 from "
        f"{TOOLS_QW_INIT} points: {json.dumps(out)}; wall {wall:.2f} s; events "
        f"{json.dumps(events)}, active SH degree {sh}; {len(losses)} logged losses "
        f"{losses[0] if losses else None} -> {losses[-1] if losses else None}; PSNR floor "
        f"{floor}; launches {json.dumps(launches)}")
    if launches != want:
        raise AssertionError(f"quality workflow launches {launches}, expected {want}")
    if not (len(losses) == TOOLS_QW_ITERS // 50 and all(map(math.isfinite, losses))):
        raise AssertionError(f"quality workflow losses {losses}")
    if events != {"densify": TOOLS_QW_DENSIFY, "reset": 1} or sh != 1:
        raise AssertionError(f"quality workflow events {events}, SH degree {sh}")
    if out["final_gaussians"] == out["init_points"]:
        raise AssertionError("densification left the Gaussian count unchanged")
    if not (math.isfinite(out["value"]) and 0 <= out["ssim"] <= 1 and out["value"] >= floor):
        raise AssertionError(f"quality workflow PSNR {out['value']} (floor {floor}), SSIM "
                             f"{out['ssim']}")

    # the kernels on the run's own inputs: the first GT view (black
    # background, as the tool renders it), then one step from the trained
    # state with fresh Adam moments (m = 0.1 g after one step) through the
    # kernels and through a plain twin
    gt_scene, gt_info = gt[0]
    kernels = {"gt_render": raster_kernel_checks(
        pt, "quality GT view", gt_scene, camera_list_from_infos([gt_info])[0],
        torch.zeros(3, device="cuda"))}
    tr = trainers[0]
    cam = tr.train_cams[0]
    kernels["trained_step"] = raster_kernel_checks(pt, "quality trained state", tr.state.scene,
                                                   cam, tr.bg)
    start = gs.init_train_state(tr.state.scene)
    step = dict(width=cam.width, height=cam.height, sh_degree=tr.active_sh_degree,
                rasterizer="auto")
    arrays = gs.camera_arrays(cam, "cuda", with_image=True)
    lrs = gs.lr_dict(tr.opt, tr.spatial_lr_scale, TOOLS_QW_ITERS)
    b4_before = launch_counts()["b4"]
    got, metrics = gs.train_step(start, arrays, tr.bg, lrs, **step)
    with plain_compositor(pt):
        twin, _ = gs.train_step(start, arrays, tr.bg, lrs, with_telemetry=False, **step)
    torch.cuda.synchronize()
    if launch_counts()["b4"] != b4_before + 1:
        raise AssertionError("the plain twin launched B4, or the kernels' step did not")
    if int(metrics["binning_grad_dropped"]):
        raise AssertionError("the trained state's step dropped its raster gradients")
    worst = 0.0
    for k in PARAM_NAMES:
        g, w = 10 * got.adam.m[k], 10 * twin.adam.m[k]
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        # a group the plain twin gives no gradient (SH bands above the
        # active degree) must get none through the kernels either
        if not err <= GS_GRAD_TOL * scale:
            raise AssertionError(f"quality trained-state gradient of {k}: {err} > "
                                 f"{GS_GRAD_TOL} * {scale}")
        worst = max(worst, err / scale) if scale else worst
    kernels["trained_step"]["grad_err_rel"] = worst
    log(f"phase 12 (b) kernels on the run's inputs against their plain versions: "
        f"{json.dumps(kernels)} (gradient limit {GS_GRAD_TOL})")
    return {"launches": launches, "wall_s": wall, "events": events, "result": out,
            "kernels": kernels, "determinism": gate}


def determinism_gate(train_argvs: list, runs: list, workdir: str) -> dict:
    """The quality cut's training once more in this process, through
    apps.train_gs.main with the tool's arguments (another model path),
    held to the first run digest for digest (GSDigests)."""
    from sixdgs_torch.apps import train_gs

    if len(train_argvs) != 1 or len(runs) != 1:
        raise AssertionError(f"determinism gate: {len(train_argvs)} train_gs calls, "
                             f"{len(runs)} digested runs")
    argv = list(train_argvs[0])
    argv[argv.index("--model_path") + 1] = os.path.join(workdir, "again")
    t0 = time.perf_counter()
    with GSDigests() as again:
        train_gs.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    first, second = runs[0], again.runs[0]
    div = first_divergence(first, second)
    log(f"phase 12 (b) determinism: train_gs.main again, {len(second)} digests (iterations "
        f"{first[0]['it']}-{first[-1]['it']}: densifications, the reset, the SH step), first "
        f"divergent {div}, final {second[-1]['num_active']} Gaussians, loss "
        f"{second[-1]['loss']}, hash {second[-1]['hash']}; {wall:.2f} s")
    if div is not None or len(first) != len(second):
        raise AssertionError(f"determinism gate: the second run leaves the first at {div} "
                             f"({len(first)} against {len(second)} digests)")
    return {"digests": len(second), "final": second[-1], "wall_s": wall}


def tools_pose_stage() -> dict:
    """Phase 12 (c): tools.pose_stage_artifact through its main, fused, at
    TOOLS_PS_GS_ITERS 3DGS and TOOLS_PS_POSE_ITERS pose iterations per
    backbone; each pose driver call's launches, training time and peak host
    RSS and device memory read from inside the run."""
    from sixdgs_torch.tools import pose_stage_artifact
    from sixdgs_torch.utils.config import PoseEstimationConfig

    workdir = tempfile.mkdtemp(prefix="pose_stage_")
    peaks = Peaks()
    try:
        with ToolObserver(peaks, counts=lambda: launch_counts()) as obs:
            torch.cuda.synchronize()
            zero_launch_counts()
            t0 = time.perf_counter()
            art = pose_stage_artifact.main(
                ["--workdir", workdir, "--gs_iterations", str(TOOLS_PS_GS_ITERS),
                 "--n_iterations", str(TOOLS_PS_POSE_ITERS), "--fused_attention"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
    finally:
        peaks.stop()
    shutil.rmtree(workdir)
    calls = [{"backbone": c["argv"][c["argv"].index("--backbone") + 1],
              **{k: v for k, v in c.items() if k not in ("call", "argv")}}
             for c in obs.calls if c["call"] == "pose_eval"]
    brief = {k: {kk: vv for kk, vv in v.items() if kk != "results"} for k, v in art.items()
             if k in ("stages", "dino", "superpoint")}
    log(f"phase 12 (c) pose_stage_artifact, {TOOLS_PS_GS_ITERS} 3DGS and "
        f"{TOOLS_PS_POSE_ITERS} pose iterations, fused: {json.dumps(brief)}; wall "
        f"{wall:.2f} s; driver calls {json.dumps(calls)}; launches {json.dumps(launches)}")
    views = TOOLS_PS_TRAIN + TOOLS_PS_TEST
    # the GT renders and the test renders at the last 3DGS iteration (B5,
    # B3); each 3DGS step B5, B3 with the store, B4
    renders = views + TOOLS_PS_TEST
    calls_per = {"dino": 1, "superpoint": SP_CHUNKS}
    # each image of a step, each train and test view at every validation
    # (the trainer's target-score pass every val_every_n_iterations), and
    # the test views twice at the end
    val = TOOLS_PS_POSE_ITERS // PoseEstimationConfig().val_every_n_iterations
    b1 = (TOOLS_PS_POSE_ITERS * TOOLS_PS_BATCH + val * (TOOLS_PS_TRAIN + TOOLS_PS_TEST)
          + 2 * TOOLS_PS_TEST)
    b2 = TOOLS_PS_POSE_ITERS * TOOLS_PS_BATCH
    want = {"b1": b1 * sum(calls_per.values()), "b2": b2 * sum(calls_per.values()),
            "b5": TOOLS_PS_GS_ITERS + renders, "b3": renders,
            "b3_store": TOOLS_PS_GS_ITERS, "b4": TOOLS_PS_GS_ITERS}
    if launches != want:
        raise AssertionError(f"pose stage launches {launches}, expected {want}")
    # a renewal at every renewal_every_n_iterations-th step from step 0
    renewals = -(-TOOLS_PS_POSE_ITERS // PoseEstimationConfig().renewal_every_n_iterations)
    if [c["backbone"] for c in calls] != list(calls_per):
        raise AssertionError(f"pose stage driver calls {[c['backbone'] for c in calls]}")
    for call in calls:
        per = calls_per[call["backbone"]]
        got = {k: call["launches"][k] for k in ("b1", "b2")}
        if got != {"b1": b1 * per, "b2": b2 * per}:
            raise AssertionError(f"pose stage {call['backbone']} driver launches {got}")
        if call["renewals"]["count"] != renewals:
            raise AssertionError(f"pose stage {call['backbone']}: {call['renewals']['count']} "
                                 f"ray renewals, expected {renewals}")
    for backbone in calls_per:
        rec = art[backbone]
        errs = [rec[k] for k in ("overfit_t_err", "overfit_a_err", "test_t_err",
                                 "test_a_err", "test_recall", "time_per_image_s")]
        if not (rec["n_results"] == len(rec["results"]) == TOOLS_PS_TEST
                and all(e is not None and math.isfinite(e) for e in errs)
                and np.isfinite(c2w_errors(rec["results"])).all()):
            raise AssertionError(f"pose stage {backbone}: {rec['n_results']} results, "
                                 f"errors {errs}")
    return {"launches": launches, "wall_s": wall, "calls": calls, "artifact": brief}


def phase_tools(pt) -> dict:
    """Phase 12: the workflow tools through their main, at a cut depth."""
    t0 = time.perf_counter()
    out = {"accuracy": tools_accuracy(), "quality": tools_quality(pt),
           "pose_stage": tools_pose_stage()}
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 12 workflow tools: ok in {out['wall_s']:.1f} s; {gpu_line()}")
    return out


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
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(root, "tests"))  # align_layouts, B5's shared layouts
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

    zero_launch_counts()
    fused = [eval_image(dino_model, id_module, images[i], masks[i], c2ws[i], rays,
                        fused_attention=True) for i in range(N_IMAGES)]
    torch.cuda.synchronize()
    counted = launch_counts()
    launches = counted["b1"]
    log(f"phase 3 main path: B1 launches {launches}, B2 launches {counted['b2']}")
    if launches != N_IMAGES or counted["b2"] != 0:
        raise AssertionError(f"serving launched B1 {launches} times (expected "
                             f"{N_IMAGES}) and B2 {counted['b2']} (0)")

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
        scene, dino_model, id_module, rng)

    # 5. render path at full width
    render = phase_render(scene)

    # 6. 3DGS training path at full width
    gs_run = phase_gs_training(pt, arrays, render, rng)

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
    sp_ins = b1_inputs(n, gen, SP_P, SP_D)
    sp_b1 = {"ms": cuda_ms(lambda: ak.attention_scores_fused(*sp_ins)),
             "plain_ms": cuda_ms(lambda: ak.attention_scores_plain(*sp_ins,
                                                                   mode="bf16_split3")),
             "bound_ms": b1_bound(n, "bf16_split3", SP_P, SP_D)[0],
             **{f"{mode}_ms": cuda_ms(lambda: ak.attention_scores_fused(*sp_ins, mode=mode),
                                      reps=10) for mode in ak.MODES}}
    prof = profile_run(f"B1 call (P={SP_P}, d={SP_D}, n={n}, split3)",
                       lambda: ak.attention_scores_fused(*sp_ins), sp_b1["ms"])
    # device time of the call outside B1's own CUDA kernels: the wrapper's
    # padding copies, fills and chunk sums
    sp_b1["device_ms"], sp_b1["wrapper_device_ms"] = prof["b1_ms"], (
        prof["busy_ms"] - prof["b1_ms"])
    log(f"B1 at P={SP_P} d={SP_D} n={n} ({SP_CHUNKS} launches per call on the width padded "
        f"to {D}; the bound counts the true shape's {b1_flops_reassociated(n, SP_P, SP_D) / 1e9:.2f}"
        f" GFLOP, the launches execute {SP_CHUNKS * b1_executed_flops(n) / 1e9:.2f}): "
        + json.dumps(sp_b1))

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
    g = torch.randn(n, generator=gen, device="cuda")
    _, sm, ss = ak.attention_scores_fwd(*sp_ins)
    sp_b2 = {"ms": cuda_ms(lambda: ak.attention_scores_bwd(*sp_ins, sm, ss, g)),
             "plain_ms": cuda_ms(lambda: ak.attention_scores_bwd_plain(*sp_ins, sm, ss, g)),
             "bound_ms": b2_bound(n, "bf16_split3", SP_P, SP_D)[0]}
    for mode in ak.MODES:
        _, mm, ss2 = ak.attention_scores_fwd(*sp_ins, mode=mode)
        sp_b2[f"{mode}_ms"] = cuda_ms(lambda: ak.attention_scores_bwd(*sp_ins, mm, ss2, g,
                                                                      mode=mode), reps=10)
    prof = profile_run(f"B2 call (P={SP_P}, d={SP_D}, n={n}, split3)",
                       lambda: ak.attention_scores_bwd(*sp_ins, sm, ss, g), sp_b2["ms"])
    sp_b2["device_ms"], sp_b2["wrapper_device_ms"] = prof["b2_ms"], (
        prof["busy_ms"] - prof["b2_ms"])
    log(f"B2 at P={SP_P} d={SP_D} n={n} ({SP_CHUNKS} launches per call; the bound counts "
        f"{b2_flops(n, SP_P, SP_D) / 1e9:.2f} GFLOP, the launches execute "
        f"{SP_CHUNKS * b2_executed_flops(n) / 1e9:.2f}): " + json.dumps(sp_b2))
    del sp_ins

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
    b5_back_ms = cuda_ms_back_to_back(lambda: pt._align_compact(*b5_args))
    b5_host = host_ms(lambda: pt._align_compact(*b5_args))
    log(f"B5 (nc {lay.nc}): {b5_ms:.4f} ms, back to back {b5_back_ms:.4f} ms, device "
        f"{render_device['b5_ms']:.4f} ms in the render's profile, plain {b5_plain_ms:.4f} "
        f"ms, bound {b5_bound_ms:.4f} ms ({b5_bound_by}); wrapper host time {b5_host:.4f} "
        f"ms per call; ptxas: " + "; ".join(ptxas_report(_build, "align_compact")))
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

    # 8. the pose driver at full width, DINO and SuperPoint, on one dataset
    data = write_dataset(scene, arrays)
    driver = phase_pose_driver(scene, data)
    sp_driver = phase_pose_driver(scene, data, backbone="superpoint")

    # 9. the 3DGS apps at full width on the same dataset
    apps = phase_gs_apps(pt, scene, data, render, gs_run)

    # 10. the rest of the CLIs at full width: the Cambridge pose driver,
    # full_eval, the GUI server, profiling and convert
    rest = phase_rest_of_clis(
        pt, scene, arrays, data, render,
        lambda: eval_image(dino_model, id_module, images[0], masks[0], c2ws[0], rays,
                           fused_attention=True))
    shutil.rmtree(os.path.dirname(data))
    cl, fe, gui = rest["cambridge"], rest["full_eval"], rest["gui"]

    # 11. parallel/ at full width: NCCL at world size 1, gloo at world size 2
    par = phase_parallel(scene, render, gs_run,
                         {"images": images, "masks": masks, "c2ws": c2ws, "rays": rays,
                          "dino": dino_model, "id_module": id_module})

    # 12. the workflow tools through their main, at a cut depth
    tools = phase_tools(pt)
    acc, qw, ps = (tools[k]["launches"] for k in ("accuracy", "quality", "pose_stage"))

    records = [{
        "name": "B1 attention_scores_fused (_fwd_kernel_train; 4 CUDA kernels per launch, "
                "reassociated, mma.sync in bf16 pieces, one logits tile with B2)",
        "route": "cuda",
        "source": "sixdgs_torch/csrc/attention_scores.cu",
        "replaces": "sixdgs_tpu/ops/attention_kernel.py:116",
        # the pose driver's run; each other path's count beside it
        "launches": driver["launches"][0],
        "launches_by_path": {"serving": launches, "training": train_b1,
                             "pose_driver": driver["launches"][0],
                             "pose_driver_superpoint": sp_driver["launches"][0],
                             "pose_driver_cambridge": cl["launches"][0],
                             "profiling_trace": rest["profiling"]["launches"],
                             "tools_accuracy": acc["b1"], "tools_pose_stage": ps["b1"]},
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        # P=784, d=256 (SuperPoint), split3, N=32768: SP_CHUNKS launches a call
        "superpoint_ms": sp_b1["ms"],
        "superpoint_device_ms": sp_b1["device_ms"],
        "superpoint_wrapper_device_ms": sp_b1["wrapper_device_ms"],
        "superpoint_plain_ms": sp_b1["plain_ms"],
        "superpoint_bound_ms": sp_b1["bound_ms"],
        # no single PyTorch call computes the masked softmax column sums
        "library_ms": None,
    }, {
        "name": "B2 attention_scores_bwd (_bwd_kernel; 10 CUDA kernels per launch, "
                "reassociated, mma.sync in bf16 pieces)",
        "route": "cuda",
        "source": "sixdgs_torch/csrc/attention_scores_bwd.cu",
        "replaces": "sixdgs_tpu/ops/attention_kernel.py:136",
        "launches": driver["launches"][1],
        "launches_by_path": {"serving": 0, "training": train_b2,
                             "pose_driver": driver["launches"][1],
                             "pose_driver_superpoint": sp_driver["launches"][1],
                             "pose_driver_cambridge": cl["launches"][1],
                             "tools_accuracy": acc["b2"], "tools_pose_stage": ps["b2"]},
        "max_abs_err": b2_max_abs_err,
        "ms": b2_ms,
        "plain_ms": b2_plain_ms,
        "bound_ms": b2_bound_ms,
        "bound_by": b2_bound_by,
        "superpoint_ms": sp_b2["ms"],
        "superpoint_device_ms": sp_b2["device_ms"],
        "superpoint_wrapper_device_ms": sp_b2["wrapper_device_ms"],
        "superpoint_plain_ms": sp_b2["plain_ms"],
        "superpoint_bound_ms": sp_b2["bound_ms"],
        # no single PyTorch call computes the softmax-column-sum VJP
        "library_ms": None,
    }, {
        "name": "B5 _align_compact (_align_kernel; tile-major, one warp per tile, "
                "16-byte stores)",
        "route": "cuda",
        "source": "sixdgs_torch/csrc/align_compact.cu",
        "replaces": "sixdgs_tpu/ops/rasterizer/pallas_tiles.py:892",
        # the 3DGS training path; the render path's count beside it
        "launches": gs_run["launches"]["b5"],
        "launches_by_path": {"render": render["launches"][0],
                             "gs_training": gs_run["launches"]["b5"],
                             "pose_driver": driver["launches"][2],
                             "train_gs_app": apps["launches"]["b5"],
                             "render_app": apps["launches_render"]["b5"],
                             "full_eval": fe["launches"]["b5"],
                             "gui_frame": gui["launches_frame"]["b5"],
                             "gui_train_gs": gui["launches_train_gs"]["b5"],
                             # phase 11: summed over the gloo-2 ranks, and at NCCL-1
                             "sharded_gs_step": par["gs_launches"]["b5"],
                             "sharded_gs_step_nccl1": par["gs_launches_nccl1"]["b5"],
                             "sharded_render": par["render_launches"]["b5"],
                             "sharded_render_nccl1": par["render_launches_nccl1"]["b5"],
                             "tools_accuracy": acc["b5"], "tools_quality": qw["b5"],
                             "tools_pose_stage": ps["b5"]},
        "max_abs_err": render["b5_err"],
        "ms": b5_ms,
        "plain_ms": b5_plain_ms,
        "bound_ms": b5_bound_ms,
        "bound_by": b5_bound_by,
        "ms_back_to_back": b5_back_ms,
        "render_profile_ms": render_device["b5_ms"],
        "host_ms": b5_host,
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
                             "gs_training_eval": gs_run["launches"]["b3"],
                             "train_gs_app_store_t": apps["launches"]["b3_store"],
                             "train_gs_app_eval": apps["launches"]["b3"],
                             "render_app": apps["launches_render"]["b3"],
                             "full_eval_store_t": fe["launches"]["b3_store"],
                             "full_eval_render": fe["launches"]["b3"],
                             "gui_frame": gui["launches_frame"]["b3"],
                             "gui_train_gs_frames": gui["launches_train_gs"]["b3"],
                             "gui_train_gs_store_t": gui["launches_train_gs"]["b3_store"],
                             "sharded_gs_step_store_t": par["gs_launches"]["b3_store"],
                             "sharded_gs_step_store_t_nccl1":
                                 par["gs_launches_nccl1"]["b3_store"],
                             "sharded_render": par["render_launches"]["b3"],
                             "sharded_render_nccl1": par["render_launches_nccl1"]["b3"],
                             "tools_accuracy": acc["b3"], "tools_quality": qw["b3"],
                             "tools_quality_store_t": qw["b3_store"],
                             "tools_pose_stage": ps["b3"],
                             "tools_pose_stage_store_t": ps["b3_store"]},
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
        "launches_by_path": {"gs_training": gs_run["launches"]["b4"],
                             "train_gs_app": apps["launches"]["b4"],
                             "full_eval": fe["launches"]["b4"],
                             "gui_train_gs": gui["launches_train_gs"]["b4"],
                             "sharded_gs_step": par["gs_launches"]["b4"],
                             "sharded_gs_step_nccl1": par["gs_launches_nccl1"]["b4"],
                             "tools_quality": qw["b4"], "tools_pose_stage": ps["b4"]},
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
    log("pose driver: " + json.dumps(driver))
    log("pose driver (superpoint): " + json.dumps(sp_driver))
    log(f"B1 / B2 at P={SP_P} d={SP_D}: " + json.dumps({"b1": sp_b1, "b2": sp_b2}))
    log("3DGS apps: " + json.dumps({**apps["timing"], "binning": apps["binning"]}))
    log("the rest of the CLIs: " + json.dumps(rest))
    log("parallel/ (phase 11): " + json.dumps({"timing": par["timing"],
                                                "errors": par["errors"]}))
    log("workflow tools (phase 12): " + json.dumps(tools))
    log(f"whole script {time.perf_counter() - t_start:.1f} s")
    log(gpu_line())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
