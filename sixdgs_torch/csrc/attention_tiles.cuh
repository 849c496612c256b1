// Tile code shared by the attention-score forward (attention_scores.cu, B1)
// and backward (attention_scores_bwd.cu, B2) on Hopper, sm_90a. Both form
// the logits reassociated, without K = feats Wk + bk:
//
//     q''    = q Wk^T [P, D],  qb = q bk [P]       (gemm_tile, one launch)
//     logits = (q'' feats^T + qb) / sqrt_d, invalid rays -> NEG
//
// with sqrt_d the launch's argument (sqrt of the true width, which the
// wrapper may have zero-padded to D), never a constant of D
//
// from the same code: q'' and qb by the same f32 FMA order, q'' split into
// the same bf16 pieces in mma fragment order (pack_q), the same feats
// pieces (stage_feats) and the same mma.sync products (block_logits). So
// the two kernels' logits are bitwise equal in every mode, and B2's
// probabilities exp(logits - m) / s sum to 1 against B1's m and s up to the
// rounding of the exponentials and sums.
//
// The ray passes of both kernels run at most NCTA CTAs (one per SM), each
// walking a contiguous run of BN-ray blocks (blocks_per_cta, n_ctas), and
// sum across CTAs through [C][...] partials in CTA order: no float atomics,
// so two launches agree bitwise.
//
// Precision (NP bf16 pieces per operand, mma_pieces.cuh): NP = 1 ("bf16")
// rounds q'' and feats to bf16 once; NP = 2 ("bf16_split3") the TPU
// kernel's hi/lo split, 3 products; NP = 3 ("f32") 6 products. q'' and qb
// are f32 FMA in every mode.
//
// Layouts: q [P, D], feats [n, D], Wk^T [D, D] row-major, bk [D], valid
// [n] (> 0 means valid), all contiguous float32, 16-byte aligned.

#pragma once

#include "mma_pieces.cuh"

#include <math.h>

namespace attn {

constexpr int P = 256;         // image patches (16 x 16 DINOv2 grid)
constexpr int D = 384;         // DINOv2-S width
constexpr int BN = 64;         // rays per block
constexpr int THREADS = 256;   // 8 warps; warp w owns patches 32w..32w+31
constexpr int NCTA = 132;      // most CTAs of the ray passes (one per SM)
constexpr int FS = D + 8;      // row stride (bf16) of a feats piece [BN][FS]
constexpr int KT = D / 16;     // k tiles of the logits (24)
constexpr int PT = P / 16;     // patch tiles (16)
constexpr int NT = D / 8;      // column tiles of a [P, D] B operand (48)
constexpr float NEG = -9e15f;  // the TPU kernel's mask value (not -inf)
static_assert(D % 64 == 0 && P == 32 * (THREADS / 32), "warp tiling");

// uint4 fragments of q'' as the logits' A operand: [NP][PT][KT][32]
template <int NP>
constexpr long long qa_uint4s() {
  return (long long)NP * PT * KT * 32;
}

// Shared memory of the ray passes: the block's feats pieces [NP][BN][FS].
template <int NP>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * NP * BN * FS;
}

__host__ __device__ inline int blocks_per_cta(int n) {
  const int nb = (n + BN - 1) / BN;
  return (nb + NCTA - 1) / NCTA;
}

__host__ __device__ inline int n_ctas(int n) {
  const int nb = (n + BN - 1) / BN;
  const int per = blocks_per_cta(n);
  return (nb + per - 1) / per;
}

// The run of ray blocks [b_begin, b_end) of this CTA.
__device__ __forceinline__ void cta_blocks(int n, int& b_begin, int& b_end) {
  const int per = blocks_per_cta(n);
  b_begin = blockIdx.x * per;
  b_end = min((n + BN - 1) / BN, b_begin + per);
}

// Rays [r0, r0 + BN) of feats [n, D] into their bf16 pieces fp [NP][BN][FS],
// each value split once per CTA; rays past n are zero. Six float4 loads per
// thread are in flight before the first is split.
template <int NP>
__device__ __forceinline__ void stage_feats(const float* __restrict__ feats, int n, int r0,
                                            __nv_bfloat16* fp) {
  constexpr int PER = BN * D / 4 / THREADS;  // float4 per thread (24)
  constexpr int BATCH = 6;
  static_assert(PER % BATCH == 0, "whole batches");
#pragma unroll
  for (int b0 = 0; b0 < PER; b0 += BATCH) {
    float4 v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int idx = threadIdx.x + THREADS * (b0 + j);
      const int r = idx / (D / 4), c4 = idx % (D / 4);
      v[j] = r0 + r < n ? reinterpret_cast<const float4*>(feats + (size_t)(r0 + r) * D)[c4]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int idx = threadIdx.x + THREADS * (b0 + j);
      const int r = idx / (D / 4), c4 = idx % (D / 4);
      uint32_t lo[NP], hi[NP];
      mma::split2<NP>(v[j].x, v[j].y, lo);
      mma::split2<NP>(v[j].z, v[j].w, hi);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        *reinterpret_cast<uint2*>(fp + (i * BN + r) * FS + 4 * c4) = make_uint2(lo[i], hi[i]);
      }
    }
  }
}

// The block's logits [32 patches of warp w][BN rays] in C-fragment order:
// acc[mi][nj] holds patches 32w + 16mi + g (+8) and rays 8nj + 2t (+1).
// q'' comes from its packed A fragments qa [NP][PT][KT][32] (uint4), feats
// from its pieces fp by ldmatrix. Invalid rays and rays past n are NEG.
template <int NP>
__device__ __forceinline__ void block_logits(const uint4* __restrict__ qa,
                                             const __nv_bfloat16* fp, const float (&qb)[4],
                                             const float* __restrict__ valid, int n, int r0,
                                             float sqrt_d, float (&acc)[2][8][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4, mat = lane / 8;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    }
  }
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t a[2][NP][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const uint4 v = qa[((size_t)(i * PT + 2 * warp + mi) * KT + kt) * 32 + lane];
        a[mi][i][0] = v.x;
        a[mi][i][1] = v.y;
        a[mi][i][2] = v.z;
        a[mi][i][3] = v.w;
      }
    }
#pragma unroll
    for (int nj = 0; nj < 8; nj += 2) {
      // B fragments of ray tiles nj and nj + 1: matrices (rays, k) (rays,
      // k + 8) (rays + 8, k) (rays + 8, k + 8) of the [ray][d] piece
      uint32_t b[2][NP][2];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        uint32_t r[4];
        mma::ldmatrix_x4(r, fp + (i * BN + 8 * nj + lane % 8 + 8 * (mat / 2)) * FS + 16 * kt +
                                8 * (mat % 2));
        b[0][i][0] = r[0];
        b[0][i][1] = r[1];
        b[1][i][0] = r[2];
        b[1][i][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // each k tile into a fresh accumulator, added to the running sum
        // in f32: the tensor core's adder truncates to the accumulator's
        // exponent, which over 24 k tiles of a running sum of ~100 drifted
        // the logits by ~2e-5 (50 ulp) from an f32 product
        float c[2][4] = {};
        mma::mma_pieces<NP>(c[0], a[mi], b[0]);
        mma::mma_pieces<NP>(c[1], a[mi], b[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mi][nj][e] += c[0][e];
          acc[mi][nj + 1][e] += c[1][e];
        }
      }
    }
  }
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + 8 * nj + 2 * t + e;
      const bool ok = r < n && valid[r] > 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        acc[mi][nj][e] = ok ? (acc[mi][nj][e] + qb[2 * mi]) / sqrt_d : NEG;
        acc[mi][nj][e + 2] = ok ? (acc[mi][nj][e + 2] + qb[2 * mi + 1]) / sqrt_d : NEG;
      }
    }
  }
}

// This thread's four patches: 32w + 16mi + g + 8h at index 2mi + h.
__device__ __forceinline__ int my_patch(int k) {
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4;
  return 32 * warp + 16 * (k / 2) + g + 8 * (k % 2);
}

__device__ __forceinline__ void load_rows(const float* __restrict__ src, float (&out)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = src[my_patch(k)];
}

// q'' [P][D] into its bf16 pieces in fragment order, one thread per lane of
// one fragment: qa [NP][PT][KT][32] (uint4, the logits' A operand: patches
// x d) and, WITH_B, qbf [NP][PT][NT][32] (uint2, a B operand: patches (k)
// x d (n), which B2's dfeats = dlog^T q'' takes). A grid of
// PT * KT (+ PT * NT with WITH_B) fragments of 32 lanes.
template <int NP, bool WITH_B>
__device__ __forceinline__ void pack_q(const float* __restrict__ qpp, uint4* __restrict__ qa,
                                       uint2* __restrict__ qbf) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = idx % 32, frag = idx / 32;
  const int g = lane / 4, t = lane % 4;
  if (frag < PT * KT) {
    const int mt = frag / KT, kt = frag % KT;
    const float* r0 = qpp + (size_t)(16 * mt + g) * D + 16 * kt + 2 * t;
    const float* r1 = r0 + 8 * D;
    uint32_t x0[NP], x1[NP], x2[NP], x3[NP];
    mma::split2<NP>(r0[0], r0[1], x0);
    mma::split2<NP>(r1[0], r1[1], x1);
    mma::split2<NP>(r0[8], r0[9], x2);
    mma::split2<NP>(r1[8], r1[9], x3);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      qa[((size_t)(i * PT + mt) * KT + kt) * 32 + lane] = make_uint4(x0[i], x1[i], x2[i], x3[i]);
    }
  } else if (WITH_B && frag < PT * KT + PT * NT) {
    const int f = frag - PT * KT;
    const int kt = f / NT, nt = f % NT;
    const float* col = qpp + (size_t)(16 * kt + 2 * t) * D + 8 * nt + g;
    uint32_t x0[NP], x1[NP];
    mma::split2<NP>(col[0], col[D], x0);
    mma::split2<NP>(col[8 * D], col[9 * D], x1);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      qbf[((size_t)(i * PT + kt) * NT + nt) * 32 + lane] = make_uint2(x0[i], x1[i]);
    }
  }
}

// out [M][ncols] = a b (+ u v^T), f32 FMA in k order: a is [M][K] read as
// a[m * a_sm + k * a_sk], b [K][ldb] row-major, u [M] and v [ncols]
// optional. With bx [K], out_x [M] = a bx as one more column of the same
// product (the same k order as a launch of its own). One 16 x 16 output
// tile per CTA of GT threads and one output per thread, k staged 16 at a
// time (384-600 CTAs for the [256 or 384, 384] products).
constexpr int GTILE = 16;
constexpr int GT = GTILE * GTILE;

__device__ __forceinline__ void gemm_tile(const float* __restrict__ a, int a_sm, int a_sk,
                                          const float* __restrict__ b, int ldb, int M, int K,
                                          int ncols, const float* __restrict__ u,
                                          const float* __restrict__ v, float* __restrict__ out,
                                          const float* __restrict__ bx,
                                          float* __restrict__ out_x) {
  __shared__ float as[GTILE][GTILE + 1];  // [k][m]
  __shared__ float bs[GTILE][GTILE];      // [k][n]
  const int ty = threadIdx.x / GTILE, tx = threadIdx.x % GTILE;
  const int m = blockIdx.y * GTILE + ty, n = blockIdx.x * GTILE + tx;
  // a is staged along its contiguous axis: k when a_sk = 1, else m
  const bool k_fast = a_sk == 1;
  const int am = blockIdx.y * GTILE + (k_fast ? ty : tx);
  const int ak = k_fast ? tx : ty;
  const bool extra = bx != nullptr && n == ncols;
  float acc = 0.f;
  for (int k0 = 0; k0 < K; k0 += GTILE) {
    const float av = am < M && k0 + ak < K ? a[(size_t)am * a_sm + (size_t)(k0 + ak) * a_sk] : 0.f;
    if (k_fast) {
      as[tx][ty] = av;
    } else {
      as[ty][tx] = av;
    }
    float bv = 0.f;
    if (k0 + ty < K) {
      if (n < ncols) {
        bv = b[(size_t)(k0 + ty) * ldb + n];
      } else if (extra) {
        bv = bx[k0 + ty];
      }
    }
    bs[ty][tx] = bv;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GTILE; ++k) acc = fmaf(as[k][ty], bs[k][tx], acc);
    __syncthreads();
  }
  if (m < M && n < ncols) out[(size_t)m * ncols + n] = acc + (u ? u[m] * v[n] : 0.f);
  if (m < M && extra) out_x[m] = acc + 0.f;
}

inline dim3 gemm_grid(int M, int ncols, bool extra) {
  return dim3((ncols + (extra ? 1 : 0) + GTILE - 1) / GTILE, (M + GTILE - 1) / GTILE);
}

// out[e] = sum_k part[k * e_count + e], k in order; one thread per e.
__device__ __forceinline__ void sum_parts(const float* __restrict__ part, int k_count,
                                          int e_count, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= e_count) return;
  float s = 0.f;
  for (int k = 0; k < k_count; ++k) s += part[(size_t)k * e_count + e];
  out[e] = s;
}

}  // namespace attn
