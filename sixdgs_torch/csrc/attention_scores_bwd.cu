// Fused patches x rays attention-score backward (B2) for Hopper, sm_90a.
//
// Replaces the TPU kernel sixdgs_tpu/ops/attention_kernel.py::_bwd_kernel
// (launched by _fused_scores_bwd), the custom-VJP backward of the forward in
// attention_scores.cu (B1). For q [P, D], ray features [N, D], Wk [D, D]
// (in, out), bk [D], the forward's per-patch residuals m, s [P] and the
// score cotangent g [N] it computes
//
//     K        = feats @ Wk + bk,  logits = q K^T / sqrt(D) (invalid -> NEG)
//     P_pj     = exp(logits_pj - m_p) / s_p
//     c_p      = sum_j P_pj g_j
//     dlog_pj  = pmask_p P_pj (g_j - c_p) / sqrt(D)
//     dk       = dlog^T q            dfeats = dk Wk^T
//     dq       = dlog K              dWk    = feats^T dk,  dbk = sum_j dk_j
//
// without ever writing a [P, N] logits, probability or dlog array to device
// memory. As in the TPU kernel, dlog is not masked by ray validity: with
// every ray invalid (m_p = NEG) each P_pj is 1/N and invalid rays get a
// nonzero dfeats.
//
// The TPU kernel walks a sequential grid and carries c_p and the dq / dWk /
// dbk sums in VMEM. Blocks on the card run in no order, so every reduction
// across rays goes through per-CTA partials and a fixed-order combine (no
// float atomics: the result is deterministic):
//   1. b2_c:        one CTA per 32-ray block recomputes K and the logits
//                   (attention_tiles.cuh) and writes partial c to [P, nb];
//   2. b2_row_sums: c_p, one CTA per patch;
//   3. b2_grad:     at most 132 CTAs, each walking a contiguous run of ray
//                   blocks: recompute K and the logits, form dlog [P, 32]
//                   in shared memory, write dk rows into the dfeats buffer,
//                   and add dlog K into the CTA's own [P, D] dq partial in
//                   device memory (it does not fit in shared memory);
//   4. b2_dwk:      dWk = feats^T dk as a split-K product: 128 x 128 output
//                   tiles x 16 ray splits, each writing its own partial;
//   5. b2_sum_parts: dq, dWk and dbk, summing the partials in order;
//   6. b2_dfeats:   dfeats = dk Wk^T, in place over the dk rows.
// Scratch (the wrapper allocates it): c partials P * ceil(N / 32) floats,
// dq partials C * P * D and dbk partials C * D for the C <= 132 b2_grad
// CTAs (128 at both sizes below), dWk partials 16 * D * D: 61.0 MB at
// N = 32,768 and 64.2 MB at N = 131,072 (D = 384).
//
// Bound: the function needs 2 (3 N D^2 + 3 P N D) flops (K, dfeats, dWk and
// the logits, dk, dq): 48.3 GFLOP at N = 32,768, 0.721 ms at the 67 TFLOP/s
// f32 peak, against ~0.1 GB of traffic, so it is bound by compute. This
// kernel executes 2 (4 N D^2 + 4 P N D), 64.4 GFLOP at N = 32,768, because
// b2_c and b2_grad each recompute K and the logits, as the TPU kernel's two
// passes do.
// This first version runs plain f32 FMA on the CUDA cores with shared-memory
// tiles; tensor cores (wgmma) and TMA are left for a later version.
//
// Precision: "f32" and "bf16_split3" run as plain f32 FMA. "bf16" rounds
// every matmul operand (feats, Wk, q, K, dlog, dk) to bf16 at the points
// where the TPU kernel's _dot does, and accumulates in f32. No TF32.

#include "attention_tiles.cuh"

namespace {

using namespace attn;

constexpr int NCH = 132;     // most b2_grad CTAs (one per H100 SM)
constexpr int DLS = BN + 1;  // padded row stride of dlog [P][DLS] in shared memory
constexpr int WT = 128;      // b2_dwk output tile (WT x WT per CTA)
constexpr int WSPLIT = 16;   // ray splits of the dWk reduction

template <int D>
constexpr size_t grad_smem_bytes() {
  return smem_bytes<D>() + sizeof(float) * P * DLS;
}

__host__ __device__ inline int grad_blocks_per_cta(int n) {
  const int nb = (n + BN - 1) / BN;
  return (nb + NCH - 1) / NCH;
}

__host__ __device__ inline int grad_ctas(int n) {
  const int nb = (n + BN - 1) / BN;
  const int per = grad_blocks_per_cta(n);
  return (nb + per - 1) / per;
}

// Partial c_p = sum_j P_pj g_j over the CTA's BN rays -> c_part [P, nb].
template <int D, bool BF16>
__global__ void __launch_bounds__(THREADS)
b2_c(const float* __restrict__ q_t, const float* __restrict__ feats,
     const float* __restrict__ wk, const float* __restrict__ bk,
     const float* __restrict__ valid, const float* __restrict__ m_in,
     const float* __restrict__ s_in, const float* __restrict__ g, int n,
     float sqrt_d, float* __restrict__ c_part) {
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
  float gv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = r0 + rg * 8 + j;
    gv[j] = r < n ? g[r] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = pg * 4 + i;
    const float m = m_in[p];
    const float s = s_in[p];
    float c = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (r0 + rg * 8 + j < n) c += expf(acc[i][j] - m) / s * gv[j];
    }
    c += __shfl_xor_sync(0xffffffffu, c, 1);
    c += __shfl_xor_sync(0xffffffffu, c, 2);
    if (rg == 0) c_part[(size_t)p * nb + b] = c;
  }
}

// out[row] = sum_b part[row * nb + b], a fixed-order tree, one CTA per row.
__global__ void __launch_bounds__(THREADS)
b2_row_sums(const float* __restrict__ part, int nb, float* __restrict__ out) {
  __shared__ float red[THREADS];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int b = tid; b < nb; b += THREADS) s += part[(size_t)row * nb + b];
  red[tid] = s;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w /= 2) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) out[row] = red[0];
}

// The gradient pass over a contiguous run of ray blocks: dk rows into
// dk_out [n, D], the CTA's dq partial [P, D] and dbk partial [D].
template <int D, bool BF16>
__global__ void __launch_bounds__(THREADS)
b2_grad(const float* __restrict__ q_t, const float* __restrict__ q,
        const float* __restrict__ feats, const float* __restrict__ wk,
        const float* __restrict__ bk, const float* __restrict__ pmask,
        const float* __restrict__ valid, const float* __restrict__ m_in,
        const float* __restrict__ s_in, const float* __restrict__ c_in,
        const float* __restrict__ g, int n, float sqrt_d,
        float* __restrict__ dk_out, float* __restrict__ dq_part,
        float* __restrict__ dbk_part) {
  constexpr int CPT = D / 32;
  constexpr int QC = 96;  // dq columns per sweep: 8 patches x 12 columns a thread
  static_assert(D % QC == 0, "dq sweeps cover D");
  extern __shared__ float4 smem4[];
  float* r1 = reinterpret_cast<float*>(smem4);
  float* r2 = r1 + region1_floats<D>();
  float* dl = r2 + region2_floats<D>();
  const int tid = threadIdx.x;
  const int nb = (n + BN - 1) / BN;
  const int per = grad_blocks_per_cta(n);
  const int b_begin = blockIdx.x * per;
  const int b_end = min(nb, b_begin + per);
  float* dq = dq_part + (size_t)blockIdx.x * P * D;
  const float inv_sqrt_d = 1.f / sqrt_d;
  const int pg = tid / 4, rg = tid % 4;   // logits: 4 patches x 8 rays
  const int ty = tid / 32, tx = tid % 32; // dk: 4 rays x 12 columns
  const int qg = tid / 8, cg = tid % 8;   // dq: 8 patches x 12 columns

  float dbk[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dbk[c] = 0.f;

  for (int b = b_begin; b < b_end; ++b) {
    const int r0 = b * BN;
    float acc[4][8];
    block_logits<D, BF16>(q_t, feats, wk, bk, valid, n, r0, sqrt_d, r1, r2, acc);

    // dlog [P][BN] into shared memory; rays past n are zero
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pg * 4 + i;
      const float m = m_in[p];
      const float s = s_in[p];
      const float c = c_in[p];
      const float pm = pmask[p];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = r0 + rg * 8 + j;
        float v = 0.f;
        if (r < n) v = pm * (expf(acc[i][j] - m) / s) * (g[r] - c) * inv_sqrt_d;
        dl[p * DLS + rg * 8 + j] = rnd<BF16>(v);
      }
    }

    // dk [BN][D] = dlog^T q, q rows staged [KT][D] per tile
    float dk[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) dk[i][c] = 0.f;
    }
    for (int p0 = 0; p0 < P; p0 += KT) {
      for (int idx = tid; idx < KT * D / 4; idx += THREADS) {
        float4 v = reinterpret_cast<const float4*>(q + (size_t)p0 * D)[idx];
        v.x = rnd<BF16>(v.x);
        v.y = rnd<BF16>(v.y);
        v.z = rnd<BF16>(v.z);
        v.w = rnd<BF16>(v.w);
        reinterpret_cast<float4*>(r2)[idx] = v;
      }
      __syncthreads();  // also orders the dlog writes before the first read
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = dl[(p0 + kk) * DLS + ty * 4 + i];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float w = r2[kk * D + tx + 32 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dk[i][c] = fmaf(a[i], w, dk[i][c]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
      if (r < n) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dk_out[(size_t)r * D + tx + 32 * c] = dk[i][c];
          dbk[c] += dk[i][c];
        }
      }
    }

    // dq partial [P][D] += dlog [P][BN] @ K [BN][D], K^T [D][KS] in r1
    for (int c0 = 0; c0 < D; c0 += QC) {
      float a2[8][12];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int k = 0; k < 12; ++k) a2[i][k] = 0.f;
      }
#pragma unroll 4
      for (int r = 0; r < BN; ++r) {
        float dv[8];
        float kv[12];
#pragma unroll
        for (int i = 0; i < 8; ++i) dv[i] = dl[(qg * 8 + i) * DLS + r];
#pragma unroll
        for (int k = 0; k < 12; ++k) kv[k] = r1[(c0 + cg + 8 * k) * KS + r];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int k = 0; k < 12; ++k) a2[i][k] = fmaf(dv[i], kv[k], a2[i][k]);
        }
      }
      // each thread owns the same elements in every block: no race
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int k = 0; k < 12; ++k) {
          const size_t o = (size_t)(qg * 8 + i) * D + c0 + cg + 8 * k;
          dq[o] = b == b_begin ? a2[i][k] : dq[o] + a2[i][k];
        }
      }
    }
    __syncthreads();  // r1 and dl are rewritten for the next block
  }

  // dbk over the CTA's rays: the 8 row groups summed in order through r2
#pragma unroll
  for (int c = 0; c < CPT; ++c) r2[ty * D + tx + 32 * c] = dbk[c];
  __syncthreads();
  for (int col = tid; col < D; col += THREADS) {
    float s = 0.f;
    for (int t = 0; t < THREADS / 32; ++t) s += r2[t * D + col];
    dbk_part[(size_t)blockIdx.x * D + col] = s;
  }
}

// dwk_part[split] [D][D] = feats^T dk over the split's rays, one WT x WT
// output tile per CTA. Thread (ta = tid / 16, tb = tid % 16) owns rows
// a0 + ta + 16i and columns b0 + tb + 16k (i, k < 8).
template <int D, bool BF16>
__global__ void __launch_bounds__(THREADS)
b2_dwk(const float* __restrict__ feats, const float* __restrict__ dk, int n,
       int rays_per_split, float* __restrict__ dwk_part) {
  static_assert(D % WT == 0, "dWk tiles cover D");
  __shared__ __align__(16) float fa[KT][WT];
  __shared__ __align__(16) float gb[KT][WT];
  constexpr int TILES = D / WT;
  const int a0 = (blockIdx.x / TILES) * WT;
  const int b0 = (blockIdx.x % TILES) * WT;
  const int split = blockIdx.y;
  const int j0 = split * rays_per_split;
  const int j1 = min(n, j0 + rays_per_split);
  const int tid = threadIdx.x;
  const int ta = tid / 16;
  const int tb = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
  }
  for (int jt = j0; jt < j1; jt += KT) {
    for (int idx = tid; idx < KT * WT / 4; idx += THREADS) {
      const int r = idx / (WT / 4);
      const int c4 = idx % (WT / 4);
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 h = f;
      if (jt + r < j1) {
        f = reinterpret_cast<const float4*>(feats + (size_t)(jt + r) * D + a0)[c4];
        h = reinterpret_cast<const float4*>(dk + (size_t)(jt + r) * D + b0)[c4];
      }
      f.x = rnd<BF16>(f.x);
      f.y = rnd<BF16>(f.y);
      f.z = rnd<BF16>(f.z);
      f.w = rnd<BF16>(f.w);
      h.x = rnd<BF16>(h.x);
      h.y = rnd<BF16>(h.y);
      h.z = rnd<BF16>(h.z);
      h.w = rnd<BF16>(h.w);
      reinterpret_cast<float4*>(&fa[r][0])[c4] = f;
      reinterpret_cast<float4*>(&gb[r][0])[c4] = h;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      float av[8];
      float bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = fa[kk][ta + 16 * i];
#pragma unroll
      for (int k = 0; k < 8; ++k) bv[k] = gb[kk][tb + 16 * k];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[i][k] = fmaf(av[i], bv[k], acc[i][k]);
      }
    }
    __syncthreads();
  }
  float* out = dwk_part + (size_t)split * D * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      out[(size_t)(a0 + ta + 16 * i) * D + b0 + tb + 16 * k] = acc[i][k];
    }
  }
}

// out[e] = sum_k part[k * e_count + e], k in order.
__global__ void __launch_bounds__(THREADS)
b2_sum_parts(const float* __restrict__ part, int k_count, int e_count,
             float* __restrict__ out) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= e_count) return;
  float s = 0.f;
  for (int k = 0; k < k_count; ++k) s += part[(size_t)k * e_count + e];
  out[e] = s;
}

// dfeats = dk Wk^T over one ray block, in place: every dk row of the block
// is staged in shared memory before the first write.
template <int D, bool BF16>
__global__ void __launch_bounds__(THREADS)
b2_dfeats(const float* __restrict__ wk_t, int n, float* dk_dfeats) {
  constexpr int CPT = D / 32;
  extern __shared__ float4 smem4[];
  float* r1 = reinterpret_cast<float*>(smem4);
  float* r2 = r1 + region1_floats<D>();
  const int r0 = blockIdx.x * BN;
  stage_rows<D, BF16>(dk_dfeats, n, r0, r1);
  float acc[4][CPT];
  project_rows<D, BF16>(r1, wk_t, r2, acc);
  const int ty = threadIdx.x / 32;
  const int tx = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r < n) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) dk_dfeats[(size_t)r * D + tx + 32 * c] = acc[i][c];
    }
  }
}

struct Args {
  const float *q_t, *q, *feats, *wk, *wk_t, *bk, *pmask, *valid, *m, *s, *g;
  float *dfeats, *dq, *dwk, *dbk, *c_part, *c, *dq_part, *dbk_part, *dwk_part;
  int n;
  float sqrt_d;
  cudaStream_t stream;
};

template <int D, bool BF16>
cudaError_t launch(const Args& a) {
  const int n = a.n;
  const int nb = (n + BN - 1) / BN;
  const int nch = grad_ctas(n);
  const size_t smem = smem_bytes<D>();
  const size_t gsmem = grad_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      b2_c<D, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      b2_grad<D, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gsmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      b2_dfeats<D, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  b2_c<D, BF16><<<nb, THREADS, smem, a.stream>>>(a.q_t, a.feats, a.wk, a.bk, a.valid,
                                                 a.m, a.s, a.g, n, a.sqrt_d, a.c_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  b2_row_sums<<<P, THREADS, 0, a.stream>>>(a.c_part, nb, a.c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  b2_grad<D, BF16><<<nch, THREADS, gsmem, a.stream>>>(
      a.q_t, a.q, a.feats, a.wk, a.bk, a.pmask, a.valid, a.m, a.s, a.c, a.g, n,
      a.sqrt_d, a.dfeats, a.dq_part, a.dbk_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int rays_per_split = (n + WSPLIT - 1) / WSPLIT;
  b2_dwk<D, BF16><<<dim3((D / WT) * (D / WT), WSPLIT), THREADS, 0, a.stream>>>(
      a.feats, a.dfeats, n, rays_per_split, a.dwk_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  b2_sum_parts<<<(P * D + THREADS - 1) / THREADS, THREADS, 0, a.stream>>>(
      a.dq_part, nch, P * D, a.dq);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  b2_sum_parts<<<(D * D + THREADS - 1) / THREADS, THREADS, 0, a.stream>>>(
      a.dwk_part, WSPLIT, D * D, a.dwk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  b2_sum_parts<<<(D + THREADS - 1) / THREADS, THREADS, 0, a.stream>>>(
      a.dbk_part, nch, D, a.dbk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  b2_dfeats<D, BF16><<<nb, THREADS, smem, a.stream>>>(a.wk_t, n, a.dfeats);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the scratch buffers for n rays: c partials [256, b2_c_blocks(n)],
// dq partials [b2_grad_ctas(n), 256, d], dbk partials [b2_grad_ctas(n), d],
// dWk partials [b2_dwk_splits(), d, d].
int b2_c_blocks(int n) { return (n + BN - 1) / BN; }
int b2_grad_ctas(int n) { return grad_ctas(n); }
int b2_dwk_splits() { return WSPLIT; }

// All pointers are device pointers to contiguous float32, 16-byte aligned:
// q_t [d, 256], q [256, d], feats [n, d], wk [d, d] (in, out), wk_t = wk^T,
// bk [d], pmask [256], valid [n], m / s [256] (the forward's residuals),
// g [n]; outputs dfeats [n, d], dq [256, d], dwk [d, d], dbk [d]; scratch
// c_part, c [256], dq_part, dbk_part, dwk_part as sized above. Returns the
// first CUDA error (0 when every launch was accepted).
int b2_attention_scores_bwd(const float* q_t, const float* q, const float* feats,
                            const float* wk, const float* wk_t, const float* bk,
                            const float* pmask, const float* valid,
                            const float* m, const float* s, const float* g,
                            float* dfeats, float* dq, float* dwk, float* dbk,
                            float* c_part, float* c, float* dq_part,
                            float* dbk_part, float* dwk_part, int n, int d,
                            int p, int bf16, float sqrt_d, void* stream) {
  if (p != P || n <= 0) return (int)cudaErrorInvalidValue;
  if (d != 384) return (int)cudaErrorInvalidValue;  // DINOv2-S width only
  const Args a{q_t, q, feats, wk, wk_t, bk, pmask, valid, m, s, g,
               dfeats, dq, dwk, dbk, c_part, c, dq_part, dbk_part, dwk_part,
               n, sqrt_d, static_cast<cudaStream_t>(stream)};
  return (int)(bf16 ? launch<384, true>(a) : launch<384, false>(a));
}

}  // extern "C"
