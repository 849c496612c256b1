// Tile compositor forward (B3) for Hopper, sm_90a.
//
// Replaces the TPU kernel sixdgs_tpu/ops/rasterizer/pallas_tiles.py::_fwd_kernel
// (launched by pallas_composite_fwd, both store_t variants). For every 16x16 tile t
// it composites the tile's depth-ordered pair segment
// [starts[t], starts[t] + counts[t]) of the plane-major records [16, nc]
// (rows x, y, conA, conB, conC, r, g, b, opacity; 7 padding rows never read)
// front to back, with the semantics of the golden model
// (ops/rasterizer/compositing.py):
//
//     power = -0.5 (A dx^2 + C dy^2) - B dx dy,  dx = px - (x - ox)
//     skip if power > 0;  alpha = min(0.99, opacity exp(power));
//     skip if alpha < 1/255;  stop (before contributing) if T (1 - alpha) < 1e-4
//     C += color alpha T;  T *= 1 - alpha
//     out[t, py * 16 + px, :] = C + T bg
//
// The TPU kernel replays this in parallel over pairs (a log-domain prefix
// scan on the matrix unit, pixels in sublanes, pairs in lanes). Here one CTA
// owns a tile and each thread PPT of its pixels (p = tid + k NT), walking
// the segment serially, so the sequential semantics hold as written. The
// segment goes through composite_tiles.cuh's PairStage in chunks of 128
// pairs: cp.async brings chunk k + 1 while chunk k is walked, and each pair
// is read pair-major with two broadcast loads (a third where it is live)
// that feed the thread's PPT evaluations, which are also PPT independent
// dependency chains. A pixel skips the exp of a pair whose exponent is
// below the staged pretest bound (alpha < 1/255 for certain). A thread
// whose pixels have all stopped idles; the CTA leaves the segment once
// every pixel has stopped (__syncthreads_count), as the TPU kernel's early
// tile exit does.
//
// With the store (a training step's forward, aligned layout only) the same
// kernel also writes each pixel's transmittance before each pair into
// texcl [nc / 128, 256, 128], which the backward (composite_bwd.cu) rereads
// instead of replaying. A pixel's row of a block is 512 bytes from the next
// pixel's, so the threads put 32 pairs' worth into a [256, 32] shared-memory
// tile and the warps then write it out one row (128 contiguous bytes) at a
// time (a thread writing its own pixel's lanes would touch 32 lines per
// warp store). A stopped pixel stores its frozen
// transmittance, and so do the lanes past the segment's end, up to a
// multiple of 32. Blocks after the tile's early exit stay unwritten: the
// backward takes the same exit. The per-pair arithmetic, with the exp
// pretest, is composite_tiles.cuh's, shared with the backward, and has no
// FMA that the compiler could contract differently in the two variants, so
// out is bitwise the same with and without the store.
//
// Bound: each (pixel, pair) evaluation up to the pixel's stop costs 14 f32
// operations (tile-local offsets, dx, dy and the quadratic), and each
// contributing pair another 14 (exp, opacity scale, clamp, the two tests, 1 - alpha,
// T (1 - alpha), alpha T and three colour FMAs); the bytes are the live
// record rows read once and the image written once. At the render path's
// shapes the operations bound it (chip_smoke.py computes both from the run's
// data). The walk is issue-bound: it runs ~20 instructions for an
// evaluation that the exp pretest ends and ~40 for one that reaches the
// exp, against the bound's 14 operations (compositor_probe.py times the
// parts). A box cull at alpha = 1/255 would rarely skip a whole warp, whose
// 32 pixels span the tile's width.

#include "composite_tiles.cuh"

// pixels per thread without and with the store, the fastest on the card of
// the builds chip_smoke.py times (-DB3_PPT=1, 2, 4, and B3_STORE_PPT alike)
#ifndef B3_PPT
#define B3_PPT 2
#endif
#ifndef B3_STORE_PPT
#define B3_STORE_PPT 1
#endif

namespace {

using namespace comp;

constexpr int CH = KB;  // pairs per staged chunk: one aligned block
static_assert(TEX_LANES == 32, "a warp writes one row of the store's tile");

// One pixel's step over pair j; leaves T, the colour and the stop latch
// updated.
__device__ __forceinline__ void fwd_step(const float4& pa, const float4& pb, const float2* pc,
                                         float px, float py, float& T, float& c0, float& c1,
                                         float& c2, int& done) {
  float dx, dy;
  const float power = pair_power(pa, pb.x, px, py, dx, dy);
  if (!(power <= 0.f) || power < pb.y) return;
  float g_raw;
  const float alpha = pair_alpha(pb.z, power, g_raw);
  if (!(alpha >= ALPHA_MIN)) return;
  const float test_t = next_transmittance(T, alpha);
  if (test_t < T_EPS) {
    done = 1;
    return;
  }
  const float2 gb = *pc;
  const float w = __fmul_rn(alpha, T);
  c0 = __fmaf_rn(pb.w, w, c0);
  c1 = __fmaf_rn(gb.x, w, c1);
  c2 = __fmaf_rn(gb.y, w, c2);
  T = test_t;
}

template <bool STORE_T, int PPT, int NT = NPIX / PPT>
__global__ void __launch_bounds__(NT)
b3_composite_fwd(const float* __restrict__ records, long long nc,
                 const int* __restrict__ starts, const int* __restrict__ counts,
                 int nx, const float* __restrict__ bg, float* __restrict__ out,
                 float* __restrict__ texcl) {
  static_assert(NPIX % PPT == 0 && NT % TILE == 0 && NT % 32 == 0,
                "a thread's pixels share a column and warps are whole");
  __shared__ PairStage<CH> st;
  __shared__ float tbuf[STORE_T ? NPIX : 1][TEX_LANES + 1];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)(tid % TILE);
  const float ox = (float)((t % nx) * TILE);
  const float oy = (float)((t / nx) * TILE);
  const long long start = starts[t];
  const int count = counts[t];

  float py[PPT], T[PPT], c0[PPT], c1[PPT], c2[PPT];
  int done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    py[k] = (float)(tid / TILE + k * (NT / TILE));
    T[k] = 1.f;
    c0[k] = c1[k] = c2[k] = 0.f;
    done[k] = 0;
  }

  const int nk = (count + CH - 1) / CH;
  if (nk > 0) {
    st.issue(records, nc, start, min(CH, count), tid, NT);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    st.pack(records, nc, start, min(CH, count), ox, oy, tid, NT);
    __syncthreads();  // chunk 0 packed, the landing zone free
    if (nk > 1) {
      st.issue(records, nc, start + CH, min(CH, count - CH), tid, NT);
      cp_async_commit();
    }
  }
  for (int k = 0; k < nk; ++k) {
    const int n = min(CH, count - k * CH);
    if constexpr (STORE_T) {
      // TEX_LANES pairs at a time; a stopped pixel, like the lanes past the
      // segment's end, goes on filling its row of the tile with its frozen
      // transmittance
      float* blk = texcl + ((start + k * CH) / KB * NPIX) * KB;
      for (int sub = 0; sub < n; sub += TEX_LANES) {
        for (int j = sub; j < sub + TEX_LANES; ++j) {
          const bool in = j < n;
          float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f), b4 = a4;
          if (in) {
            a4 = st.a[j];
            b4 = st.b[j];
          }
#pragma unroll
          for (int q = 0; q < PPT; ++q) {
            tbuf[tid + q * NT][j - sub] = T[q];
            if (in && !done[q]) fwd_step(a4, b4, &st.c[j], px, py[q], T[q], c0[q], c1[q],
                                         c2[q], done[q]);
          }
        }
        __syncthreads();
        // warp w writes rows w, w + NT / 32, ...: 32 lanes = 128 contiguous bytes
        for (int row = tid / 32; row < NPIX; row += NT / 32) {
          blk[(long long)row * KB + sub + tid % 32] = tbuf[row][tid % 32];
        }
        __syncthreads();
      }
    } else {
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        if (j % 4 == 0) {  // leave once the thread's pixels have all stopped
          int live = 0;
#pragma unroll
          for (int q = 0; q < PPT; ++q) live |= !done[q];
          if (!live) break;
        }
        const float4 a4 = st.a[j];
        const float4 b4 = st.b[j];
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          if (!done[q]) fwd_step(a4, b4, &st.c[j], px, py[q], T[q], c0[q], c1[q], c2[q],
                                 done[q]);
        }
      }
    }
    int all = 1;
#pragma unroll
    for (int q = 0; q < PPT; ++q) all &= done[q];
    cp_async_wait_all();  // chunk k + 1 has landed (this thread's copies)
    // every pixel has stopped, or the segment is walked
    if (__syncthreads_count(all) == NT || k + 1 == nk) break;
    st.pack(records, nc, start + (k + 1) * CH, min(CH, count - (k + 1) * CH), ox, oy, tid, NT);
    __syncthreads();  // chunk k + 1 packed, the landing zone free
    if (k + 2 < nk) {
      st.issue(records, nc, start + (k + 2) * CH, min(CH, count - (k + 2) * CH), tid, NT);
      cp_async_commit();
    }
  }
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    float* o = out + ((long long)t * NPIX + tid + q * NT) * 3;
    o[0] = __fmaf_rn(T[q], bg[0], c0[q]);
    o[1] = __fmaf_rn(T[q], bg[1], c1[q]);
    o[2] = __fmaf_rn(T[q], bg[2], c2[q]);
  }
}

}  // namespace

extern "C" {

// records: [16, nc] float32 (plane-major); starts [n_tiles (+1)] and counts
// [n_tiles] int32 with starts[t] + counts[t] <= nc; bg [3] float32; out
// [n_tiles, 256, 3] float32; texcl null, or [nc / 128, 256, 128] float32,
// 16-byte aligned, with every starts[t] a multiple of 128 (the aligned
// layout). All device
// pointers. Returns the launch's CUDA error (0 when accepted).
int b3_composite_fwd_launch(const float* records, long long nc, const int* starts,
                            const int* counts, int n_tiles, int nx, const float* bg,
                            float* out, float* texcl, void* stream) {
  if (n_tiles <= 0 || nx <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (texcl != nullptr) {
    if (reinterpret_cast<uintptr_t>(texcl) % 16) return (int)cudaErrorMisalignedAddress;
    b3_composite_fwd<true, B3_STORE_PPT><<<n_tiles, NPIX / B3_STORE_PPT, 0, s>>>(
        records, nc, starts, counts, nx, bg, out, texcl);
  } else {
    b3_composite_fwd<false, B3_PPT><<<n_tiles, NPIX / B3_PPT, 0, s>>>(
        records, nc, starts, counts, nx, bg, out, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
