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
// scan on the matrix unit, pixels in sublanes, pairs in lanes). Here it is
// the classic 3DGS shape: one CTA per tile and one thread per pixel, each
// thread walking the segment serially, so the sequential semantics hold as
// written. The 9 live record rows are staged in shared memory 128 pairs at
// a time, with coalesced loads from the plane-major layout, and every
// thread then reads the same pair (a shared-memory broadcast). A thread
// whose pixel has stopped idles; the CTA leaves the segment as soon as all
// 256 pixels have stopped (__syncthreads_count), as the TPU kernel's early
// tile exit does.
//
// With the store (a training step's forward, aligned layout only) the same
// kernel also writes each pixel's transmittance before each pair into
// texcl [nc / 128, 256, 128], which the backward (composite_bwd.cu) rereads
// instead of replaying. A thread owns a pixel, and a pixel's row of a block
// is 512 bytes from the next pixel's, so the threads put 32 pairs' worth
// into a [256, 32] shared-memory tile and the warps then write it out one
// row (128 contiguous bytes) at a time. A stopped pixel stores its frozen
// transmittance. Blocks after the tile's early exit stay unwritten: the
// backward takes the same exit. The per-pair arithmetic is
// composite_tiles.cuh's, shared with the backward, and has no FMA that the
// compiler could contract differently in the two variants, so out is bitwise
// the same with and without the store.
//
// Bound: each (pixel, pair) evaluation up to the pixel's stop costs 14 f32
// operations (tile-local offsets, dx, dy and the quadratic), and each
// contributing pair another 14 (exp, opacity scale, clamp, the two tests, 1 - alpha,
// T (1 - alpha), alpha T and three colour FMAs); the bytes are the live
// record rows read once and the image written once. At the render path's
// shapes the operations bound it (chip_smoke.py computes both from the run's
// data). This first version spends no effort on the per-pair serial latency:
// each thread's loop is a chain of dependent f32 operations.

#include "composite_tiles.cuh"

namespace {

using namespace comp;

template <bool STORE_T>
__global__ void __launch_bounds__(NPIX)
b3_composite_fwd(const float* __restrict__ records, long long nc,
                 const int* __restrict__ starts, const int* __restrict__ counts,
                 int nx, const float* __restrict__ bg, float* __restrict__ out,
                 float* __restrict__ texcl) {
  __shared__ float rec[LIVE_ROWS][KB];
  __shared__ float tbuf[STORE_T ? NPIX : 1][TS];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)(tid % TILE);
  const float py = (float)(tid / TILE);
  const float ox = (float)((t % nx) * TILE);
  const float oy = (float)((t / nx) * TILE);
  const long long start = starts[t];
  const int count = counts[t];

  float T = 1.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
  int done = 0;
  for (int base = 0; base < count; base += KB) {
    const int n = min(KB, count - base);
    __syncthreads();  // every thread has finished reading the previous round
    stage_records<KB>(rec, records, nc, start + base, n);
    __syncthreads();
    float* blk = STORE_T ? texcl + ((start + base) / KB * NPIX) * KB : nullptr;
    for (int sub = 0; sub < (STORE_T ? n : 1); sub += SB) {
      // without the store: one walk over the chunk, and a stopped pixel
      // idles. With it: 32 pairs at a time, and a stopped pixel, like the
      // lanes past the segment's end, goes on filling its row of the tile
      // with the frozen transmittance
      const int hi = STORE_T ? sub + SB : (done ? 0 : n);
      for (int j = sub; j < hi; ++j) {
        if constexpr (STORE_T) {
          tbuf[tid][j - sub] = T;
          if (done || j >= n) continue;
        }
        float dx, dy, g_raw;
        const float power = pair_power<KB>(rec, j, px, py, ox, oy, dx, dy);
        if (!(power <= 0.f)) continue;
        const float alpha = pair_alpha(rec[8][j], power, g_raw);
        if (!(alpha >= ALPHA_MIN)) continue;
        const float test_t = next_transmittance(T, alpha);
        if (test_t < T_EPS) {
          done = 1;
          if constexpr (STORE_T) continue; else break;
        }
        const float w = __fmul_rn(alpha, T);
        c0 = __fmaf_rn(rec[5][j], w, c0);
        c1 = __fmaf_rn(rec[6][j], w, c1);
        c2 = __fmaf_rn(rec[7][j], w, c2);
        T = test_t;
      }
      if constexpr (STORE_T) {
        __syncthreads();
        // warp w writes rows w, w + 8, ...: 32 lanes = 128 contiguous bytes
        for (int row = tid / 32; row < NPIX; row += WARPS) {
          blk[(long long)row * KB + sub + tid % 32] = tbuf[row][tid % 32];
        }
        __syncthreads();
      }
    }
    if (__syncthreads_count(done) == NPIX) break;  // every pixel has stopped
  }
  float* o = out + ((long long)t * NPIX + tid) * 3;
  o[0] = __fmaf_rn(T, bg[0], c0);
  o[1] = __fmaf_rn(T, bg[1], c1);
  o[2] = __fmaf_rn(T, bg[2], c2);
}

}  // namespace

extern "C" {

// records: [16, nc] float32 (plane-major); starts [n_tiles (+1)] and counts
// [n_tiles] int32 with starts[t] + counts[t] <= nc; bg [3] float32; out
// [n_tiles, 256, 3] float32; texcl null, or [nc / 128, 256, 128] float32
// with every starts[t] a multiple of 128 (the aligned layout). All device
// pointers. Returns the launch's CUDA error (0 when accepted).
int b3_composite_fwd_launch(const float* records, long long nc, const int* starts,
                            const int* counts, int n_tiles, int nx, const float* bg,
                            float* out, float* texcl, void* stream) {
  if (n_tiles <= 0 || nx <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (texcl != nullptr) {
    b3_composite_fwd<true><<<n_tiles, NPIX, 0, s>>>(records, nc, starts, counts, nx, bg,
                                                    out, texcl);
  } else {
    b3_composite_fwd<false><<<n_tiles, NPIX, 0, s>>>(records, nc, starts, counts, nx, bg,
                                                     out, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
