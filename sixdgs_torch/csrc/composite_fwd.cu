// Tile compositor forward (B3) for Hopper, sm_90a.
//
// Replaces the TPU kernel sixdgs_tpu/ops/rasterizer/pallas_tiles.py::_fwd_kernel
// (launched by pallas_composite_fwd, store_t=False). For every 16x16 tile t
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
// Bound: each (pixel, pair) evaluation up to the pixel's stop costs 14 f32
// operations (tile-local offsets, dx, dy and the quadratic), and each
// contributing pair another 14 (exp, opacity scale, clamp, the two tests, 1 - alpha,
// T (1 - alpha), alpha T and three colour FMAs); the bytes are the live
// record rows read once and the image written once. At the render path's
// shapes the operations bound it (chip_smoke.py computes both from the run's
// data). This first version spends no effort on the per-pair serial latency:
// each thread's loop is a chain of dependent f32 operations.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;  // one thread per pixel
constexpr int KB = 128;            // pairs staged per round
constexpr int LIVE_ROWS = 9;       // x, y, conA, conB, conC, r, g, b, opacity
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

__global__ void __launch_bounds__(NPIX)
b3_composite_fwd(const float* __restrict__ records, long long nc,
                 const int* __restrict__ starts, const int* __restrict__ counts,
                 int nx, const float* __restrict__ bg, float* __restrict__ out) {
  __shared__ float rec[LIVE_ROWS][KB];
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
    for (int i = tid; i < LIVE_ROWS * KB; i += NPIX) {
      const int r = i / KB;
      const int l = i % KB;
      rec[r][l] = l < n ? records[r * nc + start + base + l] : 0.f;
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < n; ++j) {
        const float dx = px - (rec[0][j] - ox);
        const float dy = py - (rec[1][j] - oy);
        const float power =
            -0.5f * (rec[2][j] * dx * dx + rec[4][j] * dy * dy) - rec[3][j] * dx * dy;
        if (!(power <= 0.f)) continue;  // NaN-safe, as the live test
        const float alpha = fminf(ALPHA_MAX, rec[8][j] * expf(power));
        if (!(alpha >= ALPHA_MIN)) continue;
        const float test_t = T * (1.f - alpha);
        if (test_t < T_EPS) {
          done = 1;
          break;
        }
        const float w = alpha * T;
        c0 += rec[5][j] * w;
        c1 += rec[6][j] * w;
        c2 += rec[7][j] * w;
        T = test_t;
      }
    }
    if (__syncthreads_count(done) == NPIX) break;  // every pixel has stopped
  }
  float* o = out + ((long long)t * NPIX + tid) * 3;
  o[0] = c0 + T * bg[0];
  o[1] = c1 + T * bg[1];
  o[2] = c2 + T * bg[2];
}

}  // namespace

extern "C" {

// records: [16, nc] float32 (plane-major); starts [n_tiles (+1)] and counts
// [n_tiles] int32 with starts[t] + counts[t] <= nc; bg [3] float32; out
// [n_tiles, 256, 3] float32. All device pointers. Returns the launch's CUDA
// error (0 when accepted).
int b3_composite_fwd_launch(const float* records, long long nc, const int* starts,
                            const int* counts, int n_tiles, int nx, const float* bg,
                            float* out, void* stream) {
  if (n_tiles <= 0 || nx <= 0) return (int)cudaErrorInvalidValue;
  b3_composite_fwd<<<n_tiles, NPIX, 0, static_cast<cudaStream_t>(stream)>>>(
      records, nc, starts, counts, nx, bg, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
