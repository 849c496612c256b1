// Tile code of the attention-score forward (attention_scores.cu, B1): the
// CTA shape, the bf16 operand rounding, and the per-CTA recomputation of one
// ray block's K and logits, which its emit pass does instead of keeping a
// [P, N] logits buffer. The backward (attention_scores_bwd.cu, B2) forms no
// K and takes its tensor-core helpers from mma_pieces.cuh instead.
//
// Layouts: q_t [D, P] (q transposed), feats [n, D], Wk [D, D] (in, out),
// bk [D], valid [n] (> 0 means valid), all contiguous float32, 16-byte
// aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace attn {

constexpr int P = 256;        // image patches (16 x 16 DINOv2 grid)
constexpr int BN = 32;        // rays per block
constexpr int KT = 16;        // depth of one staged operand tile
constexpr int THREADS = 256;  // 8 warps
constexpr int KS = BN + 1;    // padded row stride of K^T in shared memory
constexpr float NEG = -9e15f; // the TPU kernel's mask value (not -inf)

static_assert(P == 64 * 4, "step B maps 64 patch groups of 4 patches");
static_assert(BN == 4 * 8, "step B maps 4 ray groups of 8 rays");
static_assert(THREADS == 256, "thread mappings assume 256 threads");

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int D>
__host__ __device__ constexpr int region1_floats() {
  // a row block [BN][D], then K^T [D][KS], then column partials [64][BN]
  return cmax(cmax(BN * D, D * KS), 64 * BN);
}

template <int D>
__host__ __device__ constexpr int region2_floats() {
  // one staged tile: [KT][D] rows of a [D, D] matrix or q^T rows [KT][P]
  return KT * cmax(D, P);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (region1_floats<D>() + region2_floats<D>());
}

// Stage rows [r0, r0 + BN) of a row-major [n, D] matrix into r1 [BN][D],
// rounded for the matmul; rows past n are zero.
template <int D, bool BF16>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int n,
                                           int r0, float* r1) {
  for (int idx = threadIdx.x; idx < BN * D / 4; idx += THREADS) {
    const int r = idx / (D / 4);
    const int c4 = idx % (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) {
      v = reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D)[c4];
    }
    v.x = rnd<BF16>(v.x);
    v.y = rnd<BF16>(v.y);
    v.z = rnd<BF16>(v.z);
    v.w = rnd<BF16>(v.w);
    reinterpret_cast<float4*>(r1)[idx] = v;
  }
}

// acc = r1 [BN][D] @ w [D][D] (w row-major, rounded as it is staged through
// r2). Thread (ty = tid / 32, tx = tid % 32) owns rows ty*4 + i and columns
// tx + 32c. Ends with a barrier, after which r1 and r2 may be overwritten.
template <int D, bool BF16>
__device__ __forceinline__ void project_rows(const float* r1,
                                             const float* __restrict__ w,
                                             float* r2, float (&acc)[4][D / 32]) {
  constexpr int CPT = D / 32;
  const int tid = threadIdx.x;
  const int ty = tid / 32;
  const int tx = tid % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < D; k0 += KT) {
    for (int idx = tid; idx < KT * D / 4; idx += THREADS) {
      float4 v = reinterpret_cast<const float4*>(w + (size_t)k0 * D)[idx];
      v.x = rnd<BF16>(v.x);
      v.y = rnd<BF16>(v.y);
      v.z = rnd<BF16>(v.z);
      v.w = rnd<BF16>(v.w);
      reinterpret_cast<float4*>(r2)[idx] = v;
    }
    __syncthreads();  // also orders the caller's r1 writes before the reads
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = r1[(ty * 4 + i) * D + k0 + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float wv = r2[kk * D + tx + 32 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(a[i], wv, acc[i][c]);
      }
    }
    __syncthreads();
  }
}

// Logits of the block's BN rays against all P patches, left in registers:
// thread (pg = tid / 4, rg = tid % 4) holds patches pg*4 + i (i < 4) and
// rays rg*8 + j (j < 8). Invalid in-range rays and rays past n are NEG. On
// return r1 holds the block's K^T [D][KS] (rounded in bf16 mode) and the
// last read of r2 has finished.
template <int D, bool BF16>
__device__ __forceinline__ void block_logits(
    const float* __restrict__ q_t, const float* __restrict__ feats,
    const float* __restrict__ wk, const float* __restrict__ bk,
    const float* __restrict__ valid, int n, int r0, float sqrt_d,
    float* r1, float* r2, float (&acc)[4][8]) {
  constexpr int CPT = D / 32;
  const int tid = threadIdx.x;

  // step A: K block [BN][D] = feats block @ Wk + bk
  stage_rows<D, BF16>(feats, n, r0, r1);
  float kacc[4][CPT];
  project_rows<D, BF16>(r1, wk, r2, kacc);
  // K^T [D][KS] over the feats block (every read of it finished above)
  const int ty = tid / 32;
  const int tx = tid % 32;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const float b = bk[tx + 32 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r1[(tx + 32 * c) * KS + ty * 4 + i] = rnd<BF16>(kacc[i][c] + b);
    }
  }

  // step B: logits [P][BN] = q K^T, q^T staged [KT][P] per tile
  const int pg = tid / 4;
  const int rg = tid % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < D; k0 += KT) {
    for (int idx = tid; idx < KT * P / 4; idx += THREADS) {
      float4 v = reinterpret_cast<const float4*>(q_t + (size_t)k0 * P)[idx];
      v.x = rnd<BF16>(v.x);
      v.y = rnd<BF16>(v.y);
      v.z = rnd<BF16>(v.z);
      v.w = rnd<BF16>(v.w);
      reinterpret_cast<float4*>(r2)[idx] = v;
    }
    __syncthreads();  // also orders the K^T writes before the first read
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const float4 qa = reinterpret_cast<const float4*>(r2 + kk * P)[pg];
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      float kb[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = r1[(k0 + kk) * KS + rg * 8 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qv[i], kb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = r0 + rg * 8 + j;
    const bool ok = r < n && valid[r] > 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][j] = ok ? acc[i][j] / sqrt_d : NEG;
  }
}

}  // namespace attn
