// Fused patches x rays attention-score forward (B1) for Hopper, sm_90a.
//
// Replaces the TPU kernel sixdgs_tpu/ops/attention_kernel.py::_fwd_kernel_train
// (launched by _fused_fwd_call_train). For q [P, D], ray features [N, D],
// Wk [D, D] (in, out) and bk [D] it computes
//
//     K        = feats @ Wk + bk
//     logits   = q K^T / sqrt(D), invalid rays -> NEG = -9e15
//     m_p, s_p = max_j logits_pj, sum_j exp(logits_pj - m_p)
//     score_j  = sum_p pmask_p exp(logits_pj - m_p) / s_p
//
// without ever writing the [P, N] logits (or K) to device memory.
//
// The TPU kernel walks a sequential grid (2 passes, N/block) and carries the
// per-patch (m, s) in VMEM scratch. Blocks on the card run in no order, so the
// ray axis is split across CTAs instead:
//   1. b1_stats:   each CTA owns BN rays, computes its K block and the
//                  [P, BN] logits in registers, and writes per-patch partial
//                  (max, sum-exp) to [P, nb];
//   2. b1_combine: one CTA per patch folds the nb partials into m_p, s_p
//                  (the [P] residuals the backward reads);
//   3. b1_emit:    recomputes the K block and logits and writes the masked
//                  column sums for its BN rays.
// Every reduction runs in a fixed order, so results are deterministic.
//
// Bound: the function needs 2 * (N D^2 + P N D) flops (16.1 GFLOP at
// N = 32768, D = 384) against ~2 N D * 4 bytes of traffic, so it is bound by
// compute on the card: 0.240 ms at the 67 TFLOP/s f32 peak. This kernel
// executes twice those flops, since b1_emit recomputes K and the logits (as
// the TPU kernel's second pass does).
// This first version stages tiles in shared memory and runs plain f32 FMA on
// the CUDA cores with a 4x12 / 4x8 register tile per thread; tensor cores
// (wgmma) and TMA are left for a later version. The tile code (block_logits)
// is in attention_tiles.cuh, shared with the backward kernel (B2).
//
// Precision: "f32" and "bf16_split3" both run as plain f32 FMA here (split3
// exists to get f32-class accuracy out of a bf16 MXU). "bf16" rounds every
// matmul operand (feats, Wk, q and K) to bf16 with round-to-nearest-even and
// accumulates in f32, as the TPU kernel's bf16 mode does. No TF32 anywhere.

#include "attention_tiles.cuh"

namespace {

using namespace attn;

template <int D, bool BF16>
__global__ void __launch_bounds__(THREADS)
b1_stats(const float* __restrict__ q_t, const float* __restrict__ feats,
         const float* __restrict__ wk, const float* __restrict__ bk,
         const float* __restrict__ valid, int n, float sqrt_d,
         float* __restrict__ m_part, float* __restrict__ s_part) {
  extern __shared__ float4 smem4[];
  float* r1 = reinterpret_cast<float*>(smem4);
  float* r2 = r1 + region1_floats<D>();
  const int nb = gridDim.x;
  const int b = blockIdx.x;
  const int r0 = b * BN;
  float acc[4][8];
  block_logits<D, BF16>(q_t, feats, wk, bk, valid, n, r0, sqrt_d, r1, r2, acc);

  const int tid = threadIdx.x;
  const int pg = tid / 4;
  const int rg = tid % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // rays past N take no part; ray r0 is always in range, so the combined
    // max over the 4 lanes of a patch is finite
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (r0 + rg * 8 + j < n) m = fmaxf(m, acc[i][j]);
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (r0 + rg * 8 + j < n) s += expf(acc[i][j] - m);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (rg == 0) {
      const int p = pg * 4 + i;
      m_part[(size_t)p * nb + b] = m;
      s_part[(size_t)p * nb + b] = s;
    }
  }
}

// One CTA per patch: m_p = max_b m_bp, s_p = sum_b s_bp exp(m_bp - m_p).
__global__ void __launch_bounds__(THREADS)
b1_combine(const float* __restrict__ m_part, const float* __restrict__ s_part,
           int nb, float* __restrict__ m_out, float* __restrict__ s_out) {
  __shared__ float red[THREADS];
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const float* mp = m_part + (size_t)p * nb;
  const float* sp = s_part + (size_t)p * nb;

  float m = -INFINITY;
  for (int b = tid; b < nb; b += THREADS) m = fmaxf(m, mp[b]);
  red[tid] = m;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w /= 2) {
    if (tid < w) red[tid] = fmaxf(red[tid], red[tid + w]);
    __syncthreads();
  }
  const float mall = red[0];
  __syncthreads();

  float s = 0.f;
  for (int b = tid; b < nb; b += THREADS) s += sp[b] * expf(mp[b] - mall);
  red[tid] = s;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w /= 2) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) {
    m_out[p] = mall;
    s_out[p] = red[0];
  }
}

template <int D, bool BF16>
__global__ void __launch_bounds__(THREADS)
b1_emit(const float* __restrict__ q_t, const float* __restrict__ feats,
        const float* __restrict__ wk, const float* __restrict__ bk,
        const float* __restrict__ pmask, const float* __restrict__ valid,
        const float* __restrict__ m_in, const float* __restrict__ s_in, int n,
        float sqrt_d, float* __restrict__ scores) {
  extern __shared__ float4 smem4[];
  float* r1 = reinterpret_cast<float*>(smem4);
  float* r2 = r1 + region1_floats<D>();
  const int r0 = blockIdx.x * BN;
  float acc[4][8];
  block_logits<D, BF16>(q_t, feats, wk, bk, valid, n, r0, sqrt_d, r1, r2, acc);

  const int tid = threadIdx.x;
  const int pg = tid / 4;
  const int rg = tid % 4;
  float col[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) col[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = pg * 4 + i;
    const float m = m_in[p];
    const float s = s_in[p];
    const float pm = pmask[p];
#pragma unroll
    for (int j = 0; j < 8; ++j) col[j] += expf(acc[i][j] - m) / s * pm;
  }
  // column sums over the 64 patch groups, in a fixed order (r1 is free: the
  // last read of K^T finished before block_logits returned)
#pragma unroll
  for (int j = 0; j < 8; ++j) r1[pg * BN + rg * 8 + j] = col[j];
  __syncthreads();
  if (tid < BN && r0 + tid < n) {
    float sum = 0.f;
    for (int g = 0; g < P / 4; ++g) sum += r1[g * BN + tid];
    scores[r0 + tid] = sum;
  }
}

template <int D, bool BF16>
cudaError_t launch(const float* q_t, const float* feats, const float* wk,
                   const float* bk, const float* pmask, const float* valid,
                   float* scores, float* m_out, float* s_out, float* m_part,
                   float* s_part, int n, float sqrt_d, cudaStream_t stream) {
  const int nb = (n + BN - 1) / BN;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      b1_stats<D, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      b1_emit<D, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  b1_stats<D, BF16><<<nb, THREADS, smem, stream>>>(q_t, feats, wk, bk, valid, n,
                                                   sqrt_d, m_part, s_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  b1_combine<<<P, THREADS, 0, stream>>>(m_part, s_part, nb, m_out, s_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  b1_emit<D, BF16><<<nb, THREADS, smem, stream>>>(
      q_t, feats, wk, bk, pmask, valid, m_out, s_out, n, sqrt_d, scores);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mode(int bf16, const float* q_t, const float* feats,
                        const float* wk, const float* bk, const float* pmask,
                        const float* valid, float* scores, float* m_out,
                        float* s_out, float* m_part, float* s_part, int n,
                        float sqrt_d, cudaStream_t stream) {
  if (bf16) {
    return launch<D, true>(q_t, feats, wk, bk, pmask, valid, scores, m_out,
                           s_out, m_part, s_part, n, sqrt_d, stream);
  }
  return launch<D, false>(q_t, feats, wk, bk, pmask, valid, scores, m_out,
                          s_out, m_part, s_part, n, sqrt_d, stream);
}

}  // namespace

extern "C" {

// Rays per CTA: the caller sizes the [P, nb] partial buffers with it.
int b1_rays_per_block() { return BN; }

// All pointers are device pointers to contiguous float32, 16-byte aligned:
// q_t [d, 256] (q transposed), feats [n, d], wk [d, d] (in, out), bk [d],
// pmask [256], valid [n] (> 0 means valid), scores [n], m_out / s_out [256],
// m_part / s_part [256, ceil(n / 32)]. Returns the first CUDA error (0 when
// every launch was accepted).
int b1_attention_scores_fwd(const float* q_t, const float* feats,
                            const float* wk, const float* bk,
                            const float* pmask, const float* valid,
                            float* scores, float* m_out, float* s_out,
                            float* m_part, float* s_part, int n, int d, int p,
                            int bf16, float sqrt_d, void* stream) {
  if (p != P || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d != 384) return (int)cudaErrorInvalidValue;  // DINOv2-S width only
  return (int)launch_mode<384>(bf16, q_t, feats, wk, bk, pmask, valid, scores,
                               m_out, s_out, m_part, s_part, n, sqrt_d, st);
}

}  // extern "C"
