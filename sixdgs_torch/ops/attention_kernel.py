"""Fused patches x rays attention scores (B1), forward.

Port of sixdgs_tpu/ops/attention_kernel.py. For q [P, d], ray features
[N, d] and the k-projection (Wk [d, d] as (in, out), bk [d]):

    K        = ray_feats @ Wk + bk
    logits   = q K^T / sqrt(d), invalid rays -> NEG = -9e15
    score_j  = sum_p patch_mask_p softmax_row_p(logits)_j

On a CUDA tensor ``attention_scores_fused`` launches the hand-written
kernel in ``csrc/attention_scores.cu``, which replaces the TPU kernel
``_fwd_kernel_train`` (launched by ``_fused_fwd_call_train``). The TPU
kernel's sequential two-pass grid becomes split-N on the card: per-CTA
partial (max, sum-exp), a combine, and an emit pass that recomputes K and
the logits, so the [P, N] logits never reach device memory. One counted
launch is three CUDA kernels (b1_stats, b1_combine, b1_emit).

Bound: the function needs 2 (N d^2 + P N d) flops (16.1 GFLOP at N=32768,
d=384) against ~2 N d * 4 bytes, so it is bound by compute on the card:
0.240 ms at the 67 TFLOP/s f32 peak. The kernel executes twice those flops
(bench.py's 2 (2 N d^2 + 2 P N d)), because its second pass recomputes K
and the logits, as the TPU kernel's does.

On a CPU tensor it runs ``attention_scores_plain``, the same arithmetic in
plain PyTorch. A CUDA tensor never falls back to the plain version.

Precision ``mode``: "f32" and "bf16_split3" both compute in plain f32 (the
TPU's split3 exists to reach f32-class accuracy on a bf16 MXU); "bf16"
rounds every matmul operand to bf16 and accumulates in f32.

Forward only: the backward kernel (B2) and its autograd.Function come with
the pose trainer, so an input that requires grad is refused.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

NEG = -9e15
MODES = ("f32", "bf16", "bf16_split3")
N_PATCHES = 256  # the kernel's patch count (16 x 16 DINOv2 grid)
KERNEL_WIDTH = 384  # DINOv2-S


def _dot(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "bf16":
        a = a.to(torch.bfloat16).to(torch.float32)
        b = b.to(torch.bfloat16).to(torch.float32)
    return a @ b


def attention_scores_plain(q, ray_feats, wk, bk, pmask, valid,
                           mode: str = "bf16_split3"
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (scores [N], m [P, 1],
    s [P, 1]) with m, s the per-patch max and sum-exp residuals.
    ``pmask`` [P] and ``valid`` [N] are float32."""
    d = q.shape[-1]
    k = _dot(ray_feats, wk, mode) + bk
    logits = _dot(q, k.T, mode) / math.sqrt(d)
    logits = torch.where(valid[None, :] > 0.0, logits,
                         torch.full_like(logits, NEG))
    m = logits.amax(dim=1, keepdim=True)
    e = torch.exp(logits - m)
    s = e.sum(dim=1, keepdim=True)
    scores = (e / s * pmask[:, None]).sum(dim=0)
    return scores, m, s


def _check_kernel_inputs(q, ray_feats, wk, bk, pmask, valid):
    P, d = q.shape
    if P != N_PATCHES or d != KERNEL_WIDTH:
        raise ValueError(f"kernel takes P={N_PATCHES} and d={KERNEL_WIDTH}, "
                         f"got P={P}, d={d}")
    for name, t in (("q", q), ("ray_feats", ray_feats), ("wk", wk),
                    ("bk", bk), ("pmask", pmask), ("valid", valid)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if ray_feats.shape[1] != d or wk.shape != (d, d) or bk.shape != (d,):
        raise ValueError(f"shapes q {tuple(q.shape)}, ray_feats "
                         f"{tuple(ray_feats.shape)}, wk {tuple(wk.shape)}, "
                         f"bk {tuple(bk.shape)} do not agree")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous float32 with a 16-byte aligned base (the kernel loads
    float4)."""
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


_lib = None


def _library() -> ctypes.CDLL:
    """csrc/attention_scores.cu, built and loaded at first use, with its C
    signatures set once."""
    global _lib
    if _lib is None:
        from sixdgs_torch.ops._build import library

        lib = library("attention_scores")
        lib.b1_attention_scores_fwd.restype = ctypes.c_int
        lib.b1_attention_scores_fwd.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p])
        lib.b1_rays_per_block.restype = ctypes.c_int
        _lib = lib
    return _lib


def _kernel_fwd(q, ray_feats, wk, bk, pmask, valid, mode):
    _check_kernel_inputs(q, ray_feats, wk, bk, pmask, valid)
    lib = _library()
    P, d = q.shape
    N = ray_feats.shape[0]
    nb = -(-N // lib.b1_rays_per_block())
    dev = q.device
    ins = [_aligned(t) for t in (q.T, ray_feats, wk, bk, pmask, valid)]
    scores = torch.empty(N, dtype=torch.float32, device=dev)
    m = torch.empty(P, 1, dtype=torch.float32, device=dev)
    s = torch.empty(P, 1, dtype=torch.float32, device=dev)
    m_part = torch.empty(P, nb, dtype=torch.float32, device=dev)
    s_part = torch.empty(P, nb, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.b1_attention_scores_fwd(
            *[t.data_ptr() for t in ins], scores.data_ptr(), m.data_ptr(),
            s.data_ptr(), m_part.data_ptr(), s_part.data_ptr(),
            N, d, P, int(mode == "bf16"), math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"attention-score kernel launch failed: CUDA error {err}")
    attention_scores_fused.launches += 1
    return scores, m, s


def attention_scores_fwd(q, ray_feats, wk, bk, patch_mask, ray_valid,
                         mode: str = "bf16_split3"):
    """(scores [N], m [P, 1], s [P, 1]): the kernel on CUDA tensors, the
    plain version on CPU tensors. m and s are the residuals the backward
    kernel reads."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, ray_feats, wk, bk)):
        raise RuntimeError("attention_scores_fused is forward only; run it "
                           "under torch.no_grad()")
    P, N = q.shape[0], ray_feats.shape[0]
    pmask = patch_mask.to(torch.float32).reshape(P)
    valid = ray_valid.to(torch.float32).reshape(N)
    if q.device.type == "cuda":
        return _kernel_fwd(q, ray_feats, wk, bk, pmask, valid, mode)
    if q.device.type != "cpu":
        raise ValueError(f"no attention-score path for device {q.device}")
    f32 = [t.to(torch.float32) for t in (q, ray_feats, wk, bk)]
    return attention_scores_plain(*f32, pmask, valid, mode)


def attention_scores_fused(q, ray_feats, wk, bk, patch_mask, ray_valid,
                           mode: str = "bf16_split3") -> torch.Tensor:
    """Per-ray scores [N]; padded rays get ~0.

    Args:
        q: [P, d] projected image-patch queries.
        ray_feats: [N, d] ray features (any N: the kernel masks the tail).
        wk/bk: k-projection weights [d, d] (in, out) and [d].
        patch_mask: [P] bool/float mask of image patches.
        ray_valid: [N] bool/float validity of rays.
        mode: "f32" | "bf16" | "bf16_split3" (default).
    """
    return attention_scores_fwd(q, ray_feats, wk, bk, patch_mask, ray_valid,
                                mode)[0]


# launches on CUDA tensors; each is three CUDA kernels (stats, combine, emit)
attention_scores_fused.launches = 0


def fused_ray_scores(id_module, img_feats_pe, ray_feats, patch_mask, ray_valid,
                     mode: str = "bf16_split3") -> torch.Tensor:
    """Drop-in for the plain scorer in id_module.score_image: applies the
    q-projection of ``id_module.attention`` then the fused kernel."""
    attention = id_module.attention
    q = attention.q(img_feats_pe)
    return attention_scores_fused(q, ray_feats, attention.k.weight.T,
                                  attention.k.bias, patch_mask, ray_valid,
                                  mode=mode)
