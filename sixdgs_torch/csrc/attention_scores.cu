// Fused patches x rays attention-score forward (B1) for Hopper, sm_90a.
//
// Replaces the TPU kernel sixdgs_tpu/ops/attention_kernel.py::_fwd_kernel_train
// (launched by _fused_fwd_call_train). For q [P, D], ray features [N, D],
// Wk [D, D] (in, out), bk [D], pmask [P] and valid [N] it computes
//
//     logits   = q K^T / sqrt(D) with K = feats Wk + bk, invalid rays -> NEG
//     m_p, s_p = max_j logits_pj, sum_j exp(logits_pj - m_p)
//     score_j  = sum_p pmask_p exp(logits_pj - m_p) / s_p
//
// reassociated so that K is never formed: q K^T = q'' feats^T + qb with
// q'' = q Wk^T and qb = q bk. The logits tile is the one B2 (the backward,
// attention_scores_bwd.cu) forms, from the same code (attention_tiles.cuh),
// and neither the [P, N] logits nor anything [N, D]-sized is written to
// device memory.
//
// The TPU kernel walks a sequential grid (2 passes, N/block) and carries the
// per-patch (m, s) in VMEM scratch. Here the ray axis is split across at
// most 132 CTAs, each a contiguous run of 64-ray blocks. CUDA kernels of one
// launch, in order:
//   1. b1_gemm_tile: q'' and qb in f32 FMA (qb as an extra column);
//   2. b1_pack_q:    q'' into its bf16 pieces in mma fragment order;
//   3. b1_stats:     per block, the feats pieces and the logits [256, 64] on
//                    mma.sync, then per patch an online (max, sum-exp) over
//                    the CTA's run, rescaling s when the max rises (the TPU
//                    kernel's pass 0); rays past N take no part. One
//                    [C][P] partial each for m and s;
//   4. b1_emit:      every CTA first combines the C partials in CTA order
//                    (m_p = max_c m_cp, s_p = sum_c s_cp exp(m_cp - m_p);
//                    CTA 0 writes them out), then recomputes each block's
//                    logits (the TPU kernel's pass 1) and writes the scores:
//                    the patch sum over a warp by shuffles, the 8 warps'
//                    partials in warp order through shared memory, one
//                    writer per ray.
// No float atomics: two launches agree bitwise. Shared memory: the block's
// feats pieces (50,176 bytes per piece) and, in b1_emit, 4 KB of combined
// stats and warp partials. Scratch (b1_scratch_floats): q'', qb, the A
// fragments of q'' (room for 3 pieces, 589,824 bytes) and the m, s
// partials: 1,246,208 bytes at N = 32,768 and at N = 131,072 (128 CTAs at
// both).
//
// Bound: the function needs 2 (P N D + P D^2) flops (the logits; q''),
// 6.52 GFLOP at N = 32,768: bound by operations at the bf16 tensor-core
// rate divided by the products of the mode (1, 3 or 6). This kernel
// executes 2 (2 P N D) on the tensor cores, times the products of the mode,
// because the emit pass recomputes the logits, and 2 P D (D + 1) in f32 FMA.
//
// Precision (NP pieces per operand, mma_pieces.cuh): "bf16" rounds q'' and
// feats to bf16 once (the TPU kernel rounds feats, Wk, q and K instead);
// "bf16_split3" (the default) the TPU kernel's hi/lo split, 3 products;
// "f32" three pieces, 6 products. q'', qb and the softmax are f32.

#include "attention_tiles.cuh"

namespace {

using namespace attn;

// s exp(m - m_new), where s = 0 stands for no ray yet (m = -inf).
__device__ __forceinline__ float rescale(float s, float m, float m_new) {
  return s == 0.f ? 0.f : s * expf(m - m_new);
}

// Per-CTA partial (max, sum-exp) of every patch over the CTA's run of ray
// blocks: m_part, s_part [C][P].
template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
b1_stats(const uint4* __restrict__ qa, const float* __restrict__ qb_in,
         const float* __restrict__ feats, const float* __restrict__ valid, int n,
         float sqrt_d, float* __restrict__ m_part, float* __restrict__ s_part) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* fp = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int t = threadIdx.x % 4;
  int b_begin, b_end;
  cta_blocks(n, b_begin, b_end);
  float qb[4], m[4], s[4];
  load_rows(qb_in, qb);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = -INFINITY;
    s[k] = 0.f;
  }

  for (int b = b_begin; b < b_end; ++b) {
    const int r0 = b * BN;
    __syncthreads();  // the last block's reads of fp are done
    stage_feats<NP>(feats, n, r0, fp);
    __syncthreads();
    float acc[2][8][4];
    block_logits<NP>(qa, fp, qb, valid, n, r0, sqrt_d, acc);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float mb = -INFINITY;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (r0 + 8 * nj + 2 * t + e < n) mb = fmaxf(mb, acc[k / 2][nj][e + 2 * (k % 2)]);
        }
      }
      if (mb > m[k]) {
        s[k] = rescale(s[k], m[k], mb);
        m[k] = mb;
      }
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (r0 + 8 * nj + 2 * t + e < n) s[k] += expf(acc[k / 2][nj][e + 2 * (k % 2)] - m[k]);
        }
      }
    }
  }
  // over the 4 lanes t of a row group, in a fixed order; lane t = 0 saw the
  // CTA's first ray, so every row ends with a finite m and s >= 1
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[k], off);
      const float so = __shfl_xor_sync(0xffffffffu, s[k], off);
      const float mn = fmaxf(m[k], mo);
      s[k] = rescale(s[k], m[k], mn) + rescale(so, mo, mn);
      m[k] = mn;
    }
    if (t == 0) {
      m_part[(size_t)blockIdx.x * P + my_patch(k)] = m[k];
      s_part[(size_t)blockIdx.x * P + my_patch(k)] = s[k];
    }
  }
}

// The combined stats, then the scores of the CTA's run of ray blocks.
template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
b1_emit(const uint4* __restrict__ qa, const float* __restrict__ qb_in,
        const float* __restrict__ feats, const float* __restrict__ pmask,
        const float* __restrict__ valid, const float* __restrict__ m_part,
        const float* __restrict__ s_part, int n, float sqrt_d, float* __restrict__ scores,
        float* __restrict__ m_out, float* __restrict__ s_out) {
  extern __shared__ float4 smem4[];
  __shared__ float stats[2][P];
  __shared__ float part[THREADS / 32][BN];
  __nv_bfloat16* fp = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  static_assert(THREADS == P, "one thread per patch combines the partials");
  {
    const int p = threadIdx.x;
    const int nc = gridDim.x;
    float mm = -INFINITY, ss = 0.f;
    for (int c = 0; c < nc; ++c) mm = fmaxf(mm, m_part[(size_t)c * P + p]);
    for (int c = 0; c < nc; ++c) {
      ss += rescale(s_part[(size_t)c * P + p], m_part[(size_t)c * P + p], mm);
    }
    stats[0][p] = mm;
    stats[1][p] = ss;
    if (blockIdx.x == 0) {
      m_out[p] = mm;
      s_out[p] = ss;
    }
  }
  __syncthreads();
  float qb[4], m[4], s[4], pm[4];
  load_rows(qb_in, qb);
  load_rows(pmask, pm);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = stats[0][my_patch(k)];
    s[k] = stats[1][my_patch(k)];
  }
  int b_begin, b_end;
  cta_blocks(n, b_begin, b_end);

  for (int b = b_begin; b < b_end; ++b) {
    const int r0 = b * BN;
    __syncthreads();  // the last block's reads of fp and part are done
    stage_feats<NP>(feats, n, r0, fp);
    __syncthreads();
    float acc[2][8][4];
    block_logits<NP>(qa, fp, qb, valid, n, r0, sqrt_d, acc);
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float col = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          col += expf(acc[k / 2][nj][e + 2 * (k % 2)] - m[k]) / s[k] * pm[k];
        }
        // over the 8 lanes g that share t (the warp's 32 patches)
        col += __shfl_xor_sync(0xffffffffu, col, 4);
        col += __shfl_xor_sync(0xffffffffu, col, 8);
        col += __shfl_xor_sync(0xffffffffu, col, 16);
        if (g == 0) part[warp][8 * nj + 2 * t + e] = col;
      }
    }
    __syncthreads();
    const int ray = threadIdx.x;
    if (ray < BN && r0 + ray < n) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) sum += part[w][ray];
      scores[r0 + ray] = sum;
    }
  }
}

// The shared prologue code (attention_tiles.cuh) under this kernel's names.
template <int NP>
__global__ void __launch_bounds__(THREADS)
b1_pack_q(const float* __restrict__ qpp, uint4* __restrict__ qa) {
  attn::pack_q<NP, false>(qpp, qa, nullptr);
}

__global__ void __launch_bounds__(GT)
b1_gemm_tile(const float* __restrict__ a, int a_sm, int a_sk, const float* __restrict__ b,
             int ldb, int M, int K, int ncols, const float* __restrict__ u,
             const float* __restrict__ v, float* __restrict__ out, const float* __restrict__ bx,
             float* __restrict__ out_x) {
  attn::gemm_tile(a, a_sm, a_sk, b, ldb, M, K, ncols, u, v, out, bx, out_x);
}

struct Args {
  const float *q, *feats, *wk_t, *bk, *pmask, *valid;
  float *scores, *m, *s;
  float *qpp, *qb, *frags, *m_part, *s_part;
  int n;
  float sqrt_d;
  cudaStream_t stream;
};

template <int NP>
cudaError_t launch(const Args& x) {
  const int n = x.n;
  const int nc = n_ctas(n);
  const size_t smem = smem_bytes<NP>();
  cudaError_t err = cudaFuncSetAttribute(
      b1_stats<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(b1_emit<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  uint4* qa = reinterpret_cast<uint4*>(x.frags);

  // prologue: q'' = q Wk^T (b = Wk^T row-major) with qb = q bk, the pieces
  b1_gemm_tile<<<gemm_grid(P, D, true), GT, 0, x.stream>>>(
      x.q, D, 1, x.wk_t, D, P, D, D, nullptr, nullptr, x.qpp, x.bk, x.qb);
  if ((err = cudaGetLastError())) return err;
  b1_pack_q<NP><<<PT * KT * 32 / THREADS, THREADS, 0, x.stream>>>(x.qpp, qa);
  if ((err = cudaGetLastError())) return err;

  b1_stats<NP><<<nc, THREADS, smem, x.stream>>>(qa, x.qb, x.feats, x.valid, n, x.sqrt_d,
                                                  x.m_part, x.s_part);
  if ((err = cudaGetLastError())) return err;
  b1_emit<NP><<<nc, THREADS, smem, x.stream>>>(qa, x.qb, x.feats, x.pmask, x.valid,
                                                 x.m_part, x.s_part, n, x.sqrt_d, x.scores,
                                                 x.m, x.s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch for n rays: b1_scratch_floats(n) floats in one buffer, carved by
// the launcher into 16-byte aligned pieces.
long long b1_scratch_floats(int n) {
  const long long nc = n_ctas(n);
  return (long long)P * D + P + 4 * qa_uint4s<3>() + 2 * nc * P;
}

// All pointers are device pointers to contiguous float32, 16-byte aligned:
// q [256, d], feats [n, d], wk_t [d, d] (Wk^T: (out, in)), bk [d],
// pmask [256], valid [n] (> 0 means valid); outputs scores [n], m / s
// [256]; scratch of b1_scratch_floats(n) floats. mode: 0 "bf16",
// 1 "bf16_split3", 2 "f32". Returns the first CUDA error (0 when every
// launch was accepted).
int b1_attention_scores_fwd(const float* q, const float* feats, const float* wk_t,
                            const float* bk, const float* pmask, const float* valid,
                            float* scores, float* m, float* s, float* scratch, int n, int d,
                            int p, int mode, float sqrt_d, void* stream) {
  if (p != P || d != D || n <= 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const long long nc = n_ctas(n);
  Args x{q, feats, wk_t, bk, pmask, valid, scores, m, s};
  float* at = scratch;
  auto take = [&at](long long count) {
    float* out = at;
    at += (count + 3) / 4 * 4;
    return out;
  };
  x.qpp = take((long long)P * D);
  x.qb = take(P);
  x.frags = take(4 * qa_uint4s<3>());
  x.m_part = take(nc * P);
  x.s_part = take(nc * P);
  x.n = n;
  x.sqrt_d = sqrt_d;
  x.stream = static_cast<cudaStream_t>(stream);
  if (mode == 0) return (int)launch<1>(x);
  if (mode == 1) return (int)launch<2>(x);
  return (int)launch<3>(x);
}

}  // extern "C"
