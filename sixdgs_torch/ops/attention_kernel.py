"""Fused patches x rays attention scores: forward (B1) and backward (B2).

Port of sixdgs_tpu/ops/attention_kernel.py. For q [P, d], ray features
[N, d] and the k-projection (Wk [d, d] as (in, out), bk [d]):

    K        = ray_feats @ Wk + bk
    logits   = q K^T / sqrt(d), invalid rays -> NEG = -9e15
    score_j  = sum_p patch_mask_p softmax_row_p(logits)_j

``attention_scores_fused`` is differentiable in q, ray_feats, Wk and bk: a
``torch.autograd.Function`` whose forward is B1 and whose backward is B2,
so neither direction writes the [P, N] logits to device memory.

Both kernels form the logits reassociated, so that K is never formed:
q'' = q Wk^T and qb = q bk give logits = (q'' feats^T + qb) / sqrt(d). They
share one logits tile (``csrc/attention_tiles.cuh``: q'' and qb by the same
f32 FMA order, the same bf16 pieces, the same mma.sync products), so their
logits are bitwise equal in every mode and B2's probabilities sum to 1
against B1's m and s up to the rounding of the exponentials and sums.

On a CUDA tensor the forward launches the hand-written kernel in
``csrc/attention_scores.cu``, which replaces the TPU kernel
``_fwd_kernel_train`` (launched by ``_fused_fwd_call_train``). The TPU
kernel's sequential two-pass grid becomes at most 132 CTAs, each a
contiguous run of 64-ray blocks: the prologue (q'' with qb, then q''
packed into bf16 pieces), a stats pass (online per-patch max and sum-exp
over the run), and an emit pass that combines the CTAs' partials in order,
recomputes the logits and writes the masked column sums. One counted
launch is four CUDA kernels (b1_gemm_tile, b1_pack_q, b1_stats, b1_emit).
The function needs 2 (P N d + P d^2) flops (6.52 GFLOP at N=32768,
d=384); the kernel executes the logits twice on the tensor cores (times
the mode's products), as the TPU kernel's second pass recomputes them.
Bound: those flops at the bf16 tensor-core rate divided by the mode's
products, 0.020 ms in split3, bound by operations.

The backward launches ``csrc/attention_scores_bwd.cu``, which replaces the
TPU kernel ``_bwd_kernel`` (launched by ``_fused_scores_bwd``): on the same
logits, c_p = sum_j P_pj g_j, dlog = pmask P (g - c) / sqrt(d), dfeats =
dlog^T q'', A = dlog feats and r = rowsum(dlog), then dq = A Wk + r bk^T,
dWk = A^T q and dbk = q^T r. One counted launch is ten CUDA kernels.
Bound: 2 (3 P N d + 3 P d^2) flops, 19.56 GFLOP at N=32768, at the bf16
tensor-core rate divided by the products the mode needs (1, 3 or 6): 0.059
ms in split3. As in the TPU kernel, dlog is not masked by ray validity:
with every ray invalid, invalid rays get a nonzero dfeats where autodiff of
the masked formula gives zero.

Every cross-CTA sum of both kernels is taken in a fixed order, so two
launches agree bitwise. On a CPU tensor each direction runs its plain
PyTorch version (``attention_scores_plain``, ``attention_scores_bwd_plain``,
both on the logits of ``_plain_logits``). A CUDA tensor never falls back to
the plain version.

Shapes: the kernels are compiled for P = 256 patches (the 16 x 16 DINOv2
grid) and d = 384. The wrappers take any P and any d <= 384 (SuperPoint:
P = 28 x 28 = 784, d = 256, as the TPU kernel takes any shape): the width
is zero-padded to 384 and the patches split into chunks of 256, the last
padded with zero rows and pmask 0, one launch per chunk with the true
sqrt(d) (``chunked_fwd``, ``chunked_bwd``). Scores and every gradient are
sums over patches, so the chunks' sums add up exactly by linearity; the
DINO shape is one launch of the inputs themselves. Each counter counts
launches, so a SuperPoint call counts 4.

Precision ``mode``: both kernels run their P N d products on the tensor
cores (mma.sync over bf16 pieces, ``csrc/mma_pieces.cuh``) with f32
accumulation: "bf16" one bf16 piece per operand (q'', feats and, in the
backward, dlog rounded once, as the plain versions round them; the TPU
kernel rounds feats, Wk, q and K instead), "bf16_split3" the TPU kernel's
hi/lo split (3 products, ~2^-18 relative), "f32" three pieces (6
products). The plain versions round or split the same operands through
``_dot`` (in "f32", plain f32), so a kernel and its plain version differ
in the order of their sums.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from sixdgs_torch.ops import _build

NEG = -9e15
MODES = ("f32", "bf16", "bf16_split3")
N_PATCHES = 256  # the kernels' compiled patch count (16 x 16 DINOv2 grid)
KERNEL_WIDTH = 384  # their compiled width (DINOv2-S); narrower widths are padded


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _dot(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b with the operand rounding of the mode, as the TPU kernel's
    _dot takes it and the CUDA kernels' bf16 pieces give it: "bf16" rounds
    both operands to bf16; "bf16_split3" splits each into bf16 hi + lo (the
    TPU kernel's _split_bf16) and sums hi hi + hi lo + lo hi; "f32" is
    plain. Products of bf16 values are exact in f32, so what is left
    between this and a kernel is the order of the sums."""
    if mode == "bf16":
        return _bf16(a) @ _bf16(b)
    if mode == "bf16_split3":
        a_hi, b_hi = _bf16(a), _bf16(b)
        a_lo, b_lo = _bf16(a - a_hi), _bf16(b - b_hi)
        return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
    return a @ b


def _plain_logits(q, ray_feats, wk, bk, valid, mode, sqrt_d=None):
    """(q'', logits) of both plain versions, in the kernels' reassociated
    order: q'' = q Wk^T [P, d] and the masked logits (q'' feats^T + q bk) /
    sqrt(d), invalid rays NEG. K is never formed. The product on the ray
    stream goes through ``_dot`` (q'' and feats rounded or split as the
    kernels take them); q'' and q bk are plain f32. ``sqrt_d`` defaults to
    sqrt of q's width; a caller that zero-pads the width passes the true
    one, as the kernels take it."""
    qpp = q @ wk.T
    sqrt_d = math.sqrt(q.shape[-1]) if sqrt_d is None else sqrt_d
    logits = (_dot(qpp, ray_feats.T, mode) + (q @ bk)[:, None]) / sqrt_d
    logits = torch.where(valid[None, :] > 0.0, logits,
                         torch.full_like(logits, NEG))
    return qpp, logits


def attention_scores_plain(q, ray_feats, wk, bk, pmask, valid,
                           mode: str = "bf16_split3", sqrt_d=None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: (scores [N], m [P, 1],
    s [P, 1]) with m, s the per-patch max and sum-exp residuals, from the
    logits of ``_plain_logits``. ``pmask`` [P] and ``valid`` [N] are
    float32; ``sqrt_d`` as in ``_plain_logits``."""
    _, logits = _plain_logits(q, ray_feats, wk, bk, valid, mode, sqrt_d)
    m = logits.amax(dim=1, keepdim=True)
    e = torch.exp(logits - m)
    s = e.sum(dim=1, keepdim=True)
    scores = (e / s * pmask[:, None]).sum(dim=0)
    return scores, m, s


def attention_scores_bwd_plain(q, ray_feats, wk, bk, pmask, valid, m, s, g,
                               mode: str = "bf16_split3", sqrt_d=None):
    """The backward kernel's function in plain PyTorch, in the kernel's
    reassociated order: (dq [P, d], dfeats [N, d], dwk [d, d], dbk [d]) for
    the score cotangent ``g`` [N], with m, s the forward's [P, 1] (or [P])
    residuals. q'' and the logits come from ``_plain_logits``, as in the
    forward; dfeats = dlog^T q'', A = dlog feats and r = rowsum(dlog) give
    dq = A Wk + r bk^T, dWk = A^T q and dbk = q^T r. The products on the ray
    stream go through ``_dot`` (q'', feats and dlog rounded or split as
    the kernel takes them); the small ones are plain f32. Like the TPU kernel
    (and unlike autodiff of the masked formula), dlog is not masked by
    ``valid``. ``sqrt_d`` as in ``_plain_logits``."""
    P, d = q.shape
    sqrt_d = math.sqrt(d) if sqrt_d is None else sqrt_d
    inv_sqrt_d = 1.0 / sqrt_d
    qpp, logits = _plain_logits(q, ray_feats, wk, bk, valid, mode, sqrt_d)
    probs = torch.exp(logits - m.reshape(P, 1)) / s.reshape(P, 1)
    c = torch.sum(probs * g[None, :], dim=1, keepdim=True)
    dlog = pmask[:, None] * probs * (g[None, :] - c) * inv_sqrt_d
    dfeats = _dot(dlog.T, qpp, mode)
    a = _dot(dlog, ray_feats, mode)
    r = torch.sum(dlog, dim=1)
    dq = a @ wk + r[:, None] * bk[None, :]
    dwk = a.T @ q
    dbk = r @ q
    return dq, dfeats, dwk, dbk


def _check_kernel_inputs(q, ray_feats, wk, bk, pmask, valid):
    P, d = q.shape
    if d > KERNEL_WIDTH:
        raise ValueError(f"the kernels take d <= {KERNEL_WIDTH}, got d={d}")
    for name, t in (("q", q), ("ray_feats", ray_feats), ("wk", wk),
                    ("bk", bk), ("pmask", pmask), ("valid", valid)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if ray_feats.shape[1] != d or wk.shape != (d, d) or bk.shape != (d,):
        raise ValueError(f"shapes q {tuple(q.shape)}, ray_feats "
                         f"{tuple(ray_feats.shape)}, wk {tuple(wk.shape)}, "
                         f"bk {tuple(bk.shape)} do not agree")


def _patch_chunks(q, ray_feats, wk, bk, pmask):
    """The inputs at the kernels' compiled shape: q and pmask split into
    chunks of N_PATCHES patches (the last padded with zero rows and
    pmask 0), and the width zero-padded to KERNEL_WIDTH (zero columns of q
    and feats, Wk zero outside its [d, d] block, zeros in bk). Returns
    (q chunks, pmask chunks, feats, wk, bk); the DINO shape comes back as
    one chunk of the inputs themselves."""
    P, d = q.shape
    if P == N_PATCHES and d == KERNEL_WIDTH:
        return (q,), (pmask,), ray_feats, wk, bk
    pad_p, pad_d = -P % N_PATCHES, KERNEL_WIDTH - d
    q = F.pad(q, (0, pad_d, 0, pad_p))
    pmask = F.pad(pmask, (0, pad_p))
    ray_feats = F.pad(ray_feats, (0, pad_d))
    wk = F.pad(wk, (0, pad_d, 0, pad_d))
    bk = F.pad(bk, (0, pad_d))
    return q.split(N_PATCHES), pmask.split(N_PATCHES), ray_feats, wk, bk


def chunked_fwd(q, ray_feats, wk, bk, pmask, valid, mode, run):
    """The forward's function at any P and any d <= KERNEL_WIDTH through
    ``run(q, feats, wk, bk, pmask, valid, mode, sqrt_d)``, which takes
    exactly N_PATCHES patches of width KERNEL_WIDTH (the kernel's shape):
    one call per chunk of patches, on zero-padded widths, with the true
    sqrt(d). Exact by linearity: the scores are a sum over patches, to
    which a padded patch (pmask 0) adds 0, and zero columns add exact zeros
    to the logits. The chunks' scores are summed in chunk order; their m
    and s concatenate."""
    P, d = q.shape
    qs, pms, feats, wk, bk = _patch_chunks(q, ray_feats, wk, bk, pmask)
    scores, ms, ss = None, [], []
    for qc, pc in zip(qs, pms):
        sc, m, s = run(qc, feats, wk, bk, pc, valid, mode, math.sqrt(d))
        scores = sc if scores is None else scores + sc
        ms.append(m)
        ss.append(s)
    return scores, torch.cat(ms)[:P], torch.cat(ss)[:P]


def chunked_bwd(q, ray_feats, wk, bk, pmask, valid, m, s, g, mode, run):
    """The backward's function at any P and any d <= KERNEL_WIDTH through
    ``run(q, feats, wk, bk, pmask, valid, m, s, g, mode, sqrt_d)`` at the
    kernel's shape, chunked and padded as ``chunked_fwd``: dq concatenates
    over the chunks; dfeats, dWk and dbk, sums over patches, add up in chunk
    order (a padded patch has dlog = 0); the padding is sliced off."""
    P, d = q.shape
    qs, pms, feats, wk, bk = _patch_chunks(q, ray_feats, wk, bk, pmask)
    pad = len(qs) * N_PATCHES - P
    m = F.pad(m.reshape(P), (0, pad), value=1.0).split(N_PATCHES)
    s = F.pad(s.reshape(P), (0, pad), value=1.0).split(N_PATCHES)
    dqs, dfeats, dwk, dbk = [], None, None, None
    for qc, pc, mc, sc in zip(qs, pms, m, s):
        dq, df, dw, db = run(qc, feats, wk, bk, pc, valid, mc, sc, g, mode, math.sqrt(d))
        dqs.append(dq)
        if dfeats is None:
            dfeats, dwk, dbk = df, dw, db
        else:
            dfeats, dwk, dbk = dfeats + df, dwk + dw, dbk + db
    return (torch.cat(dqs)[:P, :d], dfeats[:, :d], dwk[:d, :d], dbk[:d])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous float32 with a 16-byte aligned base (the kernel loads
    float4)."""
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


_SIGNATURES = {
    # name -> {C function: (restype, argtypes)}
    "attention_scores": {
        "b1_attention_scores_fwd": (ctypes.c_int, [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                                    + [ctypes.c_float, ctypes.c_void_p]),
        "b1_scratch_floats": (ctypes.c_longlong, [ctypes.c_int]),
    },
    "attention_scores_bwd": {
        "b2_attention_scores_bwd": (ctypes.c_int, [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                                    + [ctypes.c_float, ctypes.c_void_p]),
        "b2_scratch_floats": (ctypes.c_longlong, [ctypes.c_int]),
    },
}

# both kernels' mode argument: bf16 pieces per operand less one
_MODE_ARG = {"bf16": 0, "bf16_split3": 1, "f32": 2}


def _library(name: str) -> ctypes.CDLL:
    """csrc/<name>.cu, built and loaded at first use."""
    return _build.bound_library(name, _SIGNATURES[name])


def _launch_fwd(q, ray_feats, wk, bk, pmask, valid, mode, sqrt_d):
    """One B1 launch at the kernel's shape (P = N_PATCHES, d = KERNEL_WIDTH)."""
    lib = _library("attention_scores")
    P, d = q.shape
    N = ray_feats.shape[0]
    new = functools.partial(torch.empty, dtype=torch.float32, device=q.device)
    # Wk^T is the k-projection's own (out, in) weight: no copy on the main path
    ins = [_aligned(t) for t in (q, ray_feats, wk.T, bk, pmask, valid)]
    scores, m, s = new(N), new(P, 1), new(P, 1)
    _build.launch(lib.b1_attention_scores_fwd, *ins, scores, m, s,
                  new(lib.b1_scratch_floats(N)), N, d, P, _MODE_ARG[mode], sqrt_d)
    attention_scores_fused.launches += 1
    return scores, m, s


def _launch_bwd(q, ray_feats, wk, bk, pmask, valid, m, s, g, mode, sqrt_d):
    """One B2 launch at the kernel's shape."""
    lib = _library("attention_scores_bwd")
    P, d = q.shape
    N = ray_feats.shape[0]
    new = functools.partial(torch.empty, dtype=torch.float32, device=q.device)
    ins = [_aligned(t) for t in (q, ray_feats, wk, wk.T, bk, pmask, valid,
                                 m.reshape(P), s.reshape(P), g.reshape(N))]
    dfeats, dq, dwk, dbk = new(N, d), new(P, d), new(d, d), new(d)
    _build.launch(lib.b2_attention_scores_bwd, *ins, dfeats, dq, dwk, dbk,
                  new(lib.b2_scratch_floats(N)), N, d, P, _MODE_ARG[mode], sqrt_d)
    attention_scores_bwd.launches += 1
    return dq, dfeats, dwk, dbk


def _kernel_fwd(q, ray_feats, wk, bk, pmask, valid, mode):
    _check_kernel_inputs(q, ray_feats, wk, bk, pmask, valid)
    return chunked_fwd(q, ray_feats, wk, bk, pmask, valid, mode, _launch_fwd)


def _kernel_bwd(q, ray_feats, wk, bk, pmask, valid, m, s, g, mode):
    _check_kernel_inputs(q, ray_feats, wk, bk, pmask, valid)
    return chunked_bwd(q, ray_feats, wk, bk, pmask, valid, m, s, g, mode, _launch_bwd)


def _masks(q, ray_feats, patch_mask, ray_valid):
    P, N = q.shape[0], ray_feats.shape[0]
    return (patch_mask.to(torch.float32).reshape(P),
            ray_valid.to(torch.float32).reshape(N))


def _check_mode_and_device(q, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no attention-score path for device {q.device}")


def attention_scores_fwd(q, ray_feats, wk, bk, patch_mask, ray_valid,
                         mode: str = "bf16_split3"):
    """(scores [N], m [P, 1], s [P, 1]): the forward kernel on CUDA
    tensors, the plain version on CPU tensors. m and s are the residuals the
    backward reads. Not differentiable itself: ``attention_scores_fused``
    is."""
    _check_mode_and_device(q, mode)
    pmask, valid = _masks(q, ray_feats, patch_mask, ray_valid)
    if q.device.type == "cuda":
        return _kernel_fwd(q, ray_feats, wk, bk, pmask, valid, mode)
    f32 = [t.to(torch.float32) for t in (q, ray_feats, wk, bk)]
    return attention_scores_plain(*f32, pmask, valid, mode)


def attention_scores_bwd(q, ray_feats, wk, bk, patch_mask, ray_valid, m, s, g,
                         mode: str = "bf16_split3"):
    """(dq, dfeats, dwk, dbk) for the score cotangent ``g`` [N]: the
    backward kernel on CUDA tensors, the plain version on CPU tensors.
    ``m``, ``s`` are the residuals of ``attention_scores_fwd``."""
    _check_mode_and_device(q, mode)
    pmask, valid = _masks(q, ray_feats, patch_mask, ray_valid)
    if q.device.type == "cuda":
        return _kernel_bwd(q, ray_feats, wk, bk, pmask, valid, m, s, g, mode)
    f32 = [t.to(torch.float32) for t in (q, ray_feats, wk, bk)]
    return attention_scores_bwd_plain(*f32, pmask, valid, m, s,
                                      g.to(torch.float32), mode)


# launches on CUDA tensors; each is ten CUDA kernels (four b2_gemm_tile,
# b2_pack_q, b2_c, b2_grad, three b2_sum_parts)
attention_scores_bwd.launches = 0


class _FusedScores(torch.autograd.Function):
    """B1 forward, B2 backward (the TPU package's custom VJP). Saves the
    same residuals as the TPU kernel: the inputs and the per-patch m, s."""

    @staticmethod
    def forward(ctx, q, ray_feats, wk, bk, pmask, valid, mode):
        scores, m, s = attention_scores_fwd(q, ray_feats, wk, bk, pmask, valid, mode)
        ctx.save_for_backward(q, ray_feats, wk, bk, pmask, valid, m, s)
        ctx.mode = mode
        return scores

    @staticmethod
    def backward(ctx, g):
        q, ray_feats, wk, bk, pmask, valid, m, s = ctx.saved_tensors
        grads = attention_scores_bwd(q, ray_feats, wk, bk, pmask, valid, m, s, g,
                                     ctx.mode)
        # pmask/valid are data masks, not differentiable inputs
        return (*(gr.to(t.dtype) for gr, t in zip(grads, (q, ray_feats, wk, bk))),
                None, None, None)


def attention_scores_fused(q, ray_feats, wk, bk, patch_mask, ray_valid,
                           mode: str = "bf16_split3") -> torch.Tensor:
    """Per-ray scores [N]; padded rays get ~0. Differentiable in q,
    ray_feats, wk and bk (backward kernel B2 on CUDA tensors).

    Args:
        q: [P, d] projected image-patch queries.
        ray_feats: [N, d] ray features (any N: the kernels mask the tail).
        wk/bk: k-projection weights [d, d] (in, out) and [d].
        patch_mask: [P] bool/float mask of image patches.
        ray_valid: [N] bool/float validity of rays.
        mode: "f32" | "bf16" | "bf16_split3" (default).
    """
    pmask, valid = _masks(q, ray_feats, patch_mask, ray_valid)
    return _FusedScores.apply(q, ray_feats, wk, bk, pmask, valid, mode)


# launches on CUDA tensors; each is four CUDA kernels (b1_gemm_tile,
# b1_pack_q, b1_stats, b1_emit)
attention_scores_fused.launches = 0


def fused_ray_scores(id_module, img_feats_pe, ray_feats, patch_mask, ray_valid,
                     mode: str = "bf16_split3") -> torch.Tensor:
    """Drop-in for the plain scorer in id_module.score_image: applies the
    q-projection of ``id_module.attention`` then the fused kernels. Its
    gradients reach the q-projection through dq, and Wk through the
    transposed view of ``attention.k.weight``."""
    attention = id_module.attention
    q = attention.q(img_feats_pe)
    return attention_scores_fused(q, ray_feats, attention.k.weight.T,
                                  attention.k.bias, patch_mask, ray_valid,
                                  mode=mode)
