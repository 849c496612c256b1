// Fused patches x rays attention-score backward (B2) for Hopper, sm_90a.
//
// Replaces the TPU kernel sixdgs_tpu/ops/attention_kernel.py::_bwd_kernel
// (launched by _fused_scores_bwd), the custom-VJP backward of the forward in
// attention_scores.cu (B1). For q [P, D], ray features [N, D], Wk [D, D]
// (in, out), bk [D], the forward's per-patch residuals m, s [P] and the
// score cotangent g [N] it computes dq, dfeats, dWk and dbk, reassociated so
// that K = feats Wk + bk is never formed:
//
//     q''      = q Wk^T [P, D],  qb = q bk [P]                  (prologue)
//     logits   = (q'' feats^T + qb) / sqrt_d (invalid -> NEG)
//     P_pj     = exp(logits_pj - m_p) / s_p
//     c_p      = sum_j P_pj g_j                                 (c pass)
//     dlog_pj  = pmask_p P_pj (g_j - c_p) / sqrt_d
//     dfeats   = dlog^T q''     (= dk Wk^T with dk = dlog^T q)  (gradient pass)
//     A        = dlog feats,  r = rowsum(dlog)                  (gradient pass)
//     dq = A Wk + r bk^T,  dWk = A^T q,  dbk = q^T r            (epilogue)
//
// without ever writing a [P, N] logits, probability or dlog array to device
// memory. sqrt_d is the caller's argument, sqrt of the true width d: the
// wrapper zero-pads a narrower width to D and splits more patches into
// launches of P (ops/attention_kernel.py). As in the TPU kernel, dlog is not masked by ray validity: with
// every ray invalid (m_p = NEG) each P_pj is 1/N and invalid rays get a
// nonzero dfeats. The ray stream carries three P N D products (the logits,
// dfeats and A; the logits twice), no N D^2 product.
//
// The logits are B1's: q'', qb, the feats pieces and the mma.sync tile
// come from attention_tiles.cuh, which both kernels include, so B1's m and
// s are the residuals of these very logits.
//
// CUDA kernels of one launch, in order (no float atomics anywhere: every
// cross-CTA sum is taken in a fixed order, so two launches agree bitwise):
//   1. b2_gemm_tile: q'' and qb (gemm_tile with qb as an extra column);
//   2. b2_pack_q:    q'' into its bf16 pieces in mma fragment order, as the
//                    A operand of the logits and as the B operand of dfeats;
//   3. b2_c:         the ray-pass CTAs (at most 132, each a contiguous run
//                    of 64-ray blocks): stage_feats, block_logits, c
//                    partials;
//   4. b2_sum_parts: c, summing the CTA partials in order;
//   5. b2_grad:      the same CTAs and runs: logits again, dlog in
//                    registers, A += dlog feats (dlog's A fragments
//                    straight from the logits' accumulators, feats' B
//                    fragments by transposed ldmatrix) into the CTA's
//                    [P, D] partial in device memory, 32 columns at a
//                    time; then the dlog pieces over the feats pieces
//                    and dfeats = dlog^T q'' (transposed ldmatrix);
//   6. b2_sum_parts x2: A and r, summing the CTA partials in order;
//   7. b2_gemm_tile x3: dq, dWk and dbk, f32 FMA on the CUDA cores.
// The feats tile goes through registers into shared memory (split once per
// CTA) instead of cp.async: splitting the f32 tile inside every warp cost
// more than the copy's overlap saved (0.665-0.680 against 0.690-0.712 ms at
// N = 32,768 in split3 on an H100 SXM at 700 W). Shared memory: the block's
// feats pieces, 50,176 bytes per piece (the dlog pieces reuse it). Scratch
// (the wrapper allocates it): q'' and qb, fragment copies of q'' (1.18 MB),
// c, A and r partials for C <= 132 CTAs (128 at both sizes below), A, c
// and r: 52.6 MB at N = 32,768 and at N = 131,072 (D = 384).
//
// Bound: the function needs 2 (3 P N D + 3 P D^2) flops (the logits,
// dfeats, A; q'', dq, dWk): 19.56 GFLOP at N = 32,768. At the bf16
// tensor-core rate divided by the products its accuracy needs (1, 3 or 6
// per operand pair) it is bound by operations (its ~0.1 GB of traffic
// takes less). This kernel executes 2 (4 P N D) on the tensor cores, times
// the products of the mode, because the gradient pass recomputes the logits.
//
// Precision (NP pieces per operand, mma_pieces.cuh): "bf16" rounds q'',
// feats and dlog to bf16 once; "bf16_split3" (the default) runs the TPU
// kernel's hi/lo split, 3 products; "f32" three pieces, 6 products. The
// prologue and epilogue products are f32 FMA in every mode.

#include "attention_tiles.cuh"

namespace {

using namespace attn;

constexpr int LS = BN + 8;  // row stride (bf16) of a dlog piece [P][LS]
static_assert(P * LS <= BN * FS, "a dlog piece fits where a feats piece was");

// Sum of a per-thread row value over the 4 lanes t of its row group, in a
// fixed order, then one write per row.
__device__ __forceinline__ void write_rows(const float (&v)[4], float* __restrict__ out) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float x = v[k];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (threadIdx.x % 4 == 0) out[my_patch(k)] = x;
  }
}

// c partials: c_part [C][P], row p = sum_j P_pj g_j over the CTA's rays.
template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
b2_c(const uint4* __restrict__ qa, const float* __restrict__ qb_in,
     const float* __restrict__ feats, const float* __restrict__ valid,
     const float* __restrict__ m_in, const float* __restrict__ s_in,
     const float* __restrict__ g_in, int n, float sqrt_d, float* __restrict__ c_part) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* fp = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int t = threadIdx.x % 4;
  int b_begin, b_end;
  cta_blocks(n, b_begin, b_end);
  float qb[4], m[4], s[4], c[4] = {0.f, 0.f, 0.f, 0.f};
  load_rows(qb_in, qb);
  load_rows(m_in, m);
  load_rows(s_in, s);

  for (int b = b_begin; b < b_end; ++b) {
    const int r0 = b * BN;
    __syncthreads();  // the last block's reads of fp are done
    stage_feats<NP>(feats, n, r0, fp);
    __syncthreads();
    float acc[2][8][4];
    block_logits<NP>(qa, fp, qb, valid, n, r0, sqrt_d, acc);
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * nj + 2 * t + e;
        if (r < n) {
          const float gv = g_in[r];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            c[k] += expf(acc[k / 2][nj][e + 2 * (k % 2)] - m[k]) / s[k] * gv;
          }
        }
      }
    }
  }
  write_rows(c, c_part + (size_t)blockIdx.x * P);
}

// The gradient pass over the CTA's run of ray blocks: dfeats rows, the
// CTA's A partial a_part [C][P][D] and r partial r_part [C][P].
template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
b2_grad(const uint4* __restrict__ qa, const uint2* __restrict__ qbf,
        const float* __restrict__ qb_in, const float* __restrict__ feats,
        const float* __restrict__ pmask, const float* __restrict__ valid,
        const float* __restrict__ m_in, const float* __restrict__ s_in,
        const float* __restrict__ c_in, const float* __restrict__ g_in, int n,
        float sqrt_d, float* __restrict__ dfeats, float* __restrict__ a_part,
        float* __restrict__ r_part) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* fp = reinterpret_cast<__nv_bfloat16*>(smem4);  // [NP][BN][FS]
  __nv_bfloat16* dl = fp;                                        // [NP][P][LS], later
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, mat = lane / 8;
  int b_begin, b_end;
  cta_blocks(n, b_begin, b_end);
  float* ap = a_part + (size_t)blockIdx.x * P * D;
  const float inv_sqrt_d = 1.f / sqrt_d;
  float qb[4], m[4], s[4], c[4], pm[4], r[4] = {0.f, 0.f, 0.f, 0.f};
  load_rows(qb_in, qb);
  load_rows(m_in, m);
  load_rows(s_in, s);
  load_rows(c_in, c);
  load_rows(pmask, pm);

  for (int b = b_begin; b < b_end; ++b) {
    const int r0 = b * BN;
    __syncthreads();  // the last block's reads of dl are done
    stage_feats<NP>(feats, n, r0, fp);
    __syncthreads();
    float acc[2][8][4];
    block_logits<NP>(qa, fp, qb, valid, n, r0, sqrt_d, acc);

    // dlog in place of the logits (zero past n) and its row sums
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ray = r0 + 8 * nj + 2 * t + e;
        const bool in = ray < n;
        const float gv = in ? g_in[ray] : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float& v = acc[k / 2][nj][e + 2 * (k % 2)];
          v = in ? pm[k] * (expf(v - m[k]) / s[k]) * (gv - c[k]) * inv_sqrt_d : 0.f;
          r[k] += v;
        }
      }
    }
    // dlog's pieces as A fragments (patches x rays), straight from the
    // accumulators: da[mi][kk] covers rays 16kk .. 16kk + 15
    uint32_t da[2][4][NP][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t x0[NP], x1[NP], x2[NP], x3[NP];
        mma::split2<NP>(acc[mi][2 * kk][0], acc[mi][2 * kk][1], x0);
        mma::split2<NP>(acc[mi][2 * kk][2], acc[mi][2 * kk][3], x1);
        mma::split2<NP>(acc[mi][2 * kk + 1][0], acc[mi][2 * kk + 1][1], x2);
        mma::split2<NP>(acc[mi][2 * kk + 1][2], acc[mi][2 * kk + 1][3], x3);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          da[mi][kk][i][0] = x0[i];
          da[mi][kk][i][1] = x1[i];
          da[mi][kk][i][2] = x2[i];
          da[mi][kk][i][3] = x3[i];
        }
      }
    }

    // A partial [P][D] += dlog feats, 32 columns at a time; each thread owns
    // the same elements in every block, so the read-modify-write is race-free
    for (int c0 = 0; c0 < D; c0 += 32) {
      float aa[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) aa[mi][nt][e] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          // B fragments (rays x d) of column tiles nt, nt + 1: matrices
          // (rays, d) (rays + 8, d) (rays, d + 8) (rays + 8, d + 8), transposed
          uint32_t bb[2][NP][2];
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            uint32_t x[4];
            mma::ldmatrix_x4_trans(x, fp + (i * BN + 16 * kk + lane % 8 + 8 * (mat % 2)) * FS +
                                          c0 + 8 * nt + 8 * (mat / 2));
            bb[0][i][0] = x[0];
            bb[0][i][1] = x[1];
            bb[1][i][0] = x[2];
            bb[1][i][1] = x[3];
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma::mma_pieces<NP>(aa[mi][nt], da[mi][kk], bb[0]);
            mma::mma_pieces<NP>(aa[mi][nt + 1], da[mi][kk], bb[1]);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 32 * warp + 16 * mi + g + 8 * h;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float2* o = reinterpret_cast<float2*>(ap + (size_t)p * D + c0 + 8 * nt + 2 * t);
            float2 v = make_float2(aa[mi][nt][2 * h], aa[mi][nt][2 * h + 1]);
            if (b != b_begin) {
              const float2 old = *o;
              v.x += old.x;
              v.y += old.y;
            }
            *o = v;
          }
        }
      }
    }
    __syncthreads();  // every read of the feats pieces is done

    // the dlog pieces into dl [NP][patch][ray], two rays per 32-bit store
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < NP; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = my_patch(2 * mi + q % 2);
            const int ray = 16 * kk + 2 * t + 8 * (q / 2);
            *reinterpret_cast<uint32_t*>(dl + (i * P + p) * LS + ray) = da[mi][kk][i][q];
          }
        }
      }
    }
    __syncthreads();

    // dfeats [BN][D] = dlog^T q'': warp w owns columns 48w..48w+47 of all
    // BN rays; A (rays x patches) by transposed ldmatrix from dl, B from
    // qbf [NP][PT][NT][32] (uint2)
    float fa[4][6][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 6; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) fa[mt][nt][e] = 0.f;
      }
    }
    for (int kt = 0; kt < PT; ++kt) {
      uint32_t fa_a[4][NP][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          // matrices (patches, rays) (patches, rays + 8) (patches + 8, rays)
          // (patches + 8, rays + 8) of the [patch][ray] piece, transposed
          mma::ldmatrix_x4_trans(fa_a[mt][i], dl + (i * P + 16 * kt + lane % 8 + 8 * (mat / 2)) *
                                                       LS + 16 * mt + 8 * (mat % 2));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 6; ++nt) {
        uint32_t bb[NP][2];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const uint2 v = qbf[((size_t)(i * PT + kt) * NT + 6 * warp + nt) * 32 + lane];
          bb[i][0] = v.x;
          bb[i][1] = v.y;
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma::mma_pieces<NP>(fa[mt][nt], fa_a[mt], bb);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ray = r0 + 16 * mt + g + 8 * h;
        if (ray < n) {
#pragma unroll
          for (int nt = 0; nt < 6; ++nt) {
            *reinterpret_cast<float2*>(dfeats + (size_t)ray * D + 48 * warp + 8 * nt + 2 * t) =
                make_float2(fa[mt][nt][2 * h], fa[mt][nt][2 * h + 1]);
          }
        }
      }
    }
  }
  write_rows(r, r_part + (size_t)blockIdx.x * P);
}

// The shared prologue and partial-sum code (attention_tiles.cuh) under
// this kernel's names.
template <int NP>
__global__ void __launch_bounds__(THREADS)
b2_pack_q(const float* __restrict__ qpp, uint4* __restrict__ qa, uint2* __restrict__ qbf) {
  attn::pack_q<NP, true>(qpp, qa, qbf);
}

__global__ void __launch_bounds__(GT)
b2_gemm_tile(const float* __restrict__ a, int a_sm, int a_sk, const float* __restrict__ b,
             int ldb, int M, int K, int ncols, const float* __restrict__ u,
             const float* __restrict__ v, float* __restrict__ out, const float* __restrict__ bx,
             float* __restrict__ out_x) {
  attn::gemm_tile(a, a_sm, a_sk, b, ldb, M, K, ncols, u, v, out, bx, out_x);
}

__global__ void __launch_bounds__(THREADS)
b2_sum_parts(const float* __restrict__ part, int k_count, int e_count,
             float* __restrict__ out) {
  attn::sum_parts(part, k_count, e_count, out);
}

struct Args {
  const float *q, *feats, *wk, *wk_t, *bk, *pmask, *valid, *m, *s, *g;
  float *dfeats, *dq, *dwk, *dbk;
  float *qpp, *qb, *frags, *c_part, *c, *a_part, *a, *r_part, *r;
  int n;
  float sqrt_d;
  cudaStream_t stream;
};

cudaError_t gemm(const Args& x, const float* a, int a_sm, int a_sk, const float* b, int ldb,
                 int M, int K, int ncols, const float* u, const float* v, float* out,
                 const float* bx = nullptr, float* out_x = nullptr) {
  b2_gemm_tile<<<gemm_grid(M, ncols, bx != nullptr), GT, 0, x.stream>>>(
      a, a_sm, a_sk, b, ldb, M, K, ncols, u, v, out, bx, out_x);
  return cudaGetLastError();
}

cudaError_t sum_parts(const Args& x, const float* part, int k_count, int e_count,
                      float* out) {
  b2_sum_parts<<<(e_count + THREADS - 1) / THREADS, THREADS, 0, x.stream>>>(
      part, k_count, e_count, out);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch(const Args& x) {
  const int n = x.n;
  const int nc = n_ctas(n);
  const size_t smem = smem_bytes<NP>();
  cudaError_t err = cudaFuncSetAttribute(b2_c<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(b2_grad<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  uint4* qa = reinterpret_cast<uint4*>(x.frags);
  uint2* qbf = reinterpret_cast<uint2*>(qa + qa_uint4s<NP>());

  // prologue: q'' = q Wk^T (b = Wk^T row-major), qb = q bk, the pieces
  if ((err = gemm(x, x.q, D, 1, x.wk_t, D, P, D, D, nullptr, nullptr, x.qpp, x.bk, x.qb))) {
    return err;
  }
  b2_pack_q<NP><<<(PT * KT + PT * NT) * 32 / THREADS, THREADS, 0, x.stream>>>(x.qpp, qa, qbf);
  if ((err = cudaGetLastError())) return err;

  b2_c<NP><<<nc, THREADS, smem, x.stream>>>(qa, x.qb, x.feats, x.valid, x.m, x.s, x.g, n,
                                              x.sqrt_d, x.c_part);
  if ((err = cudaGetLastError())) return err;
  if ((err = sum_parts(x, x.c_part, nc, P, x.c))) return err;
  b2_grad<NP><<<nc, THREADS, smem, x.stream>>>(qa, qbf, x.qb, x.feats, x.pmask, x.valid,
                                                 x.m, x.s, x.c, x.g, n, x.sqrt_d, x.dfeats,
                                                 x.a_part, x.r_part);
  if ((err = cudaGetLastError())) return err;
  if ((err = sum_parts(x, x.a_part, nc, P * D, x.a))) return err;
  if ((err = sum_parts(x, x.r_part, nc, P, x.r))) return err;

  // epilogue: dq = A Wk + r bk^T, dWk = A^T q, dbk = q^T r
  if ((err = gemm(x, x.a, D, 1, x.wk, D, P, D, D, x.r, x.bk, x.dq))) return err;
  if ((err = gemm(x, x.a, 1, D, x.q, D, D, P, D, nullptr, nullptr, x.dwk))) return err;
  return gemm(x, x.r, 0, 1, x.q, D, 1, P, D, nullptr, nullptr, x.dbk);
}

}  // namespace

extern "C" {

// Scratch for n rays: b2_scratch_floats(n) floats in one buffer, carved by
// the launcher into 16-byte aligned pieces.
long long b2_scratch_floats(int n) {
  const long long nc = n_ctas(n);
  const long long frags = 3LL * (PT * KT * 32 * 4 + PT * NT * 32 * 2);  // bf16 pairs
  return (long long)P * D + P + frags + nc * P + P + nc * P * D + (long long)P * D + nc * P + P;
}

// All pointers are device pointers to contiguous float32, 16-byte aligned:
// q [256, d], feats [n, d], wk [d, d] (in, out), wk_t = wk^T, bk [d],
// pmask [256], valid [n], m / s [256] (the forward's residuals), g [n];
// outputs dfeats [n, d], dq [256, d], dwk [d, d], dbk [d]; scratch of
// b2_scratch_floats(n) floats. mode: 0 "bf16", 1 "bf16_split3", 2 "f32".
// Returns the first CUDA error (0 when every launch was accepted).
int b2_attention_scores_bwd(const float* q, const float* feats, const float* wk,
                            const float* wk_t, const float* bk, const float* pmask,
                            const float* valid, const float* m, const float* s,
                            const float* g, float* dfeats, float* dq, float* dwk,
                            float* dbk, float* scratch, int n, int d, int p, int mode,
                            float sqrt_d, void* stream) {
  if (p != P || d != D || n <= 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const long long nc = n_ctas(n);
  Args x{q, feats, wk, wk_t, bk, pmask, valid, m, s, g, dfeats, dq, dwk, dbk};
  float* at = scratch;
  auto take = [&at](long long count) {
    float* out = at;
    at += (count + 3) / 4 * 4;
    return out;
  };
  x.qpp = take((long long)P * D);
  x.qb = take(P);
  x.frags = take(3LL * (PT * KT * 32 * 4 + PT * NT * 32 * 2));
  x.c_part = take(nc * P);
  x.c = take(P);
  x.a_part = take(nc * P * D);
  x.a = take((long long)P * D);
  x.r_part = take(nc * P);
  x.r = take(P);
  x.n = n;
  x.sqrt_d = sqrt_d;
  x.stream = static_cast<cudaStream_t>(stream);
  if (mode == 0) return (int)launch<1>(x);
  if (mode == 1) return (int)launch<2>(x);
  return (int)launch<3>(x);
}

}  // extern "C"
