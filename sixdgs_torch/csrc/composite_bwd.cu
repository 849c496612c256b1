// Tile compositor backward (B4) for Hopper, sm_90a.
//
// Replaces the TPU kernel sixdgs_tpu/ops/rasterizer/pallas_tiles.py::_bwd_kernel
// (launched by pallas_composite_bwd). Given the forward's inputs, its output
// out [n_tiles, 256, 3] and the cotangent dout of the same shape, it writes
// the gradient of every pair's record into dpairs [16, nc], in the record
// rows: 0 dmx, 1 dmy, 2 dconA, 3 dconB, 4 dconC, 5-7 dcolor, 8 dopacity. The
// caller zeroes dpairs first; the kernel writes the lanes of each segment
// that it walks, so padding lanes, lanes after a tile's early exit and rows
// 9-15 stay zero.
//
// The math is the front-to-back form of 3DGS. With the background
// composited in the forward, S = <dout, out> per pixel holds both
// suppression terms. Walking a pixel's pairs in the forward's order, with
// T the transmittance before the pair:
//
//     dbuf = <dout, color>          w = alpha T (a contributing pair, else 0)
//     acc += dbuf w                 (inclusive prefix)
//     da   = dbuf T - (S - acc) / max(1 - alpha, 1e-6)
//     s    = da g_raw,  0 where opacity g_raw > 0.99 (the clamp is flat)
//
// and per pair, summed over the tile's 256 pixels:
//
//     dopacity = sum s                      dcolor = sum dout w
//     dmx   = opacity (conA sum s dx + conB sum s dy)
//     dmy   = opacity (conC sum s dy + conB sum s dx)
//     dconA = -0.5 opacity sum s dx^2       dconB = -opacity sum s dx dy
//     dconC = -0.5 opacity sum s dy^2
//
// The TPU kernel replays the compositing in parallel over pairs (log-domain
// scans and pixel-moment products on the matrix unit, in split bf16). Here
// one CTA owns a tile and one thread a pixel, and each thread walks the
// segment serially as the forward does, so acc and the stop latch come
// directly, in f32. Alpha, the live test and the transmittance update are
// composite_tiles.cuh's, the forward's own code.
//
// T comes one of two ways. Replay (texcl null, any layout): the thread
// carries T as the forward did. Stored (texcl given, aligned layout): it
// rereads the forward's texcl block, 32 pairs at a time through a [256, 32]
// shared-memory tile (a warp reads one pixel's 128 contiguous bytes), and
// takes the forward's early exit, so it never reads a block the forward left
// unwritten. Both use the same values in the same operations, written with
// the rounding intrinsics so that neither instance of the template can be
// contracted differently: the two modes' gradients are bitwise equal.
//
// The nine per-pair sums are taken in a fixed order: a shuffle tree within
// each warp, the 8 warp partials to shared memory, and one thread per pair
// adding them in warp order. No float atomics: a pair belongs to one tile in
// either layout, so its lane has one writer and two launches give the same
// bits. A warp none of whose pixels the pair contributes to skips the tree.
//
// Bound: per (pixel, pair) evaluation up to the pixel's stop 14 f32
// operations, as the forward; per contributing pair 50 more: the forward's
// 14, dbuf 5, acc 2, da 6, s 3, the five moment terms 8, the colour terms 3
// and 9 adds of the sums. Bytes: the live record rows, out and dout read
// once, dpairs written once, and in the stored mode the texcl blocks up to
// each tile's exit read once. chip_smoke.py computes both from the run's
// data.

#include "composite_tiles.cuh"

namespace {

using namespace comp;

constexpr int NSUM = 9;  // s dx, s dy, s dx^2, s dx dy, s dy^2, dout w (3), s

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;  // lane 0 holds the sum
}

template <bool STORED>
__global__ void __launch_bounds__(NPIX)
b4_composite_bwd(const float* __restrict__ records, long long nc,
                 const int* __restrict__ starts, const int* __restrict__ counts, int nx,
                 const float* __restrict__ out, const float* __restrict__ dout,
                 const float* __restrict__ texcl, float* __restrict__ dpairs) {
  __shared__ float rec[LIVE_ROWS][SB];
  __shared__ float part[WARPS][NSUM][SB];
  __shared__ float tbuf[STORED ? NPIX : 1][TS];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float px = (float)(tid % TILE);
  const float py = (float)(tid / TILE);
  const float ox = (float)((t % nx) * TILE);
  const float oy = (float)((t / nx) * TILE);
  const long long start = starts[t];
  const int count = counts[t];

  const float* o = out + ((long long)t * NPIX + tid) * 3;
  const float* d = dout + ((long long)t * NPIX + tid) * 3;
  const float d0 = d[0], d1 = d[1], d2 = d[2];
  const float S = __fmaf_rn(d2, o[2], __fmaf_rn(d1, o[1], __fmul_rn(d0, o[0])));

  float T = 1.f, acc = 0.f;
  int done = 0;
  for (int base = 0; base < count; base += SB) {
    const int n = min(SB, count - base);
    __syncthreads();  // the previous round's rec, part and tbuf have been read
    stage_records<SB>(rec, records, nc, start + base, n);
    if constexpr (STORED) {
      const long long first = start + base;
      const float* blk = texcl + (first / KB * NPIX) * KB + first % KB;
      for (int row = warp; row < NPIX; row += WARPS) {
        tbuf[row][lane] = blk[(long long)row * KB + lane];
      }
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float v[NSUM];
      bool contrib = false;  // first "live", then "live and before the stop"
      float dx, dy, g_raw, alpha;
      if (!done) {
        const float power = pair_power<SB>(rec, j, px, py, ox, oy, dx, dy);
        if (power <= 0.f) {
          alpha = pair_alpha(rec[8][j], power, g_raw);
          contrib = alpha >= ALPHA_MIN;
        }
      }
      if (contrib) {
        if constexpr (STORED) T = tbuf[tid][j];
        const float test_t = next_transmittance(T, alpha);
        if (test_t < T_EPS) {
          done = 1;
          contrib = false;
        } else {
          const float w = __fmul_rn(alpha, T);
          const float dbuf = __fmaf_rn(d2, rec[7][j], __fmaf_rn(d1, rec[6][j],
                                                                __fmul_rn(d0, rec[5][j])));
          acc = __fmaf_rn(dbuf, w, acc);
          const float one_minus = fmaxf(__fsub_rn(1.f, alpha), 1e-6f);
          const float da = __fsub_rn(__fmul_rn(dbuf, T),
                                     __fdiv_rn(__fsub_rn(S, acc), one_minus));
          const float s = __fmul_rn(rec[8][j], g_raw) > ALPHA_MAX
                              ? 0.f : __fmul_rn(da, g_raw);
          v[0] = __fmul_rn(s, dx);
          v[1] = __fmul_rn(s, dy);
          v[2] = __fmul_rn(v[0], dx);
          v[3] = __fmul_rn(v[0], dy);
          v[4] = __fmul_rn(v[1], dy);
          v[5] = __fmul_rn(d0, w);
          v[6] = __fmul_rn(d1, w);
          v[7] = __fmul_rn(d2, w);
          v[8] = s;
          T = test_t;
        }
      }
      if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
        for (int r = 0; r < NSUM; ++r) {
          const float sum = warp_sum(contrib ? v[r] : 0.f);
          if (lane == 0) part[warp][r][j] = sum;
        }
      } else if (lane < NSUM) {
        part[warp][lane][j] = 0.f;
      }
    }
    __syncthreads();
    if (tid < n) {
      float m[NSUM];
#pragma unroll
      for (int r = 0; r < NSUM; ++r) {
        float sum = part[0][r][tid];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) sum = __fadd_rn(sum, part[w][r][tid]);
        m[r] = sum;
      }
      const float conA = rec[2][tid], conB = rec[3][tid], conC = rec[4][tid];
      const float opac = rec[8][tid];
      float* g = dpairs + start + base + tid;
      g[0 * nc] = __fmul_rn(opac, __fmaf_rn(conA, m[0], __fmul_rn(conB, m[1])));
      g[1 * nc] = __fmul_rn(opac, __fmaf_rn(conC, m[1], __fmul_rn(conB, m[0])));
      g[2 * nc] = __fmul_rn(__fmul_rn(-0.5f, opac), m[2]);
      g[3 * nc] = __fmul_rn(-opac, m[3]);
      g[4 * nc] = __fmul_rn(__fmul_rn(-0.5f, opac), m[4]);
      g[5 * nc] = m[5];
      g[6 * nc] = m[6];
      g[7 * nc] = m[7];
      g[8 * nc] = m[8];
    }
    if (__syncthreads_count(done) == NPIX) break;  // every pixel has stopped
  }
}

}  // namespace

extern "C" {

// records [16, nc] float32 (plane-major); starts [n_tiles (+1)] and counts
// [n_tiles] int32 with starts[t] + counts[t] <= nc; out and dout
// [n_tiles, 256, 3] float32; texcl null (replay) or the forward's
// [nc / 128, 256, 128] float32 store, with every starts[t] a multiple of
// 128; dpairs [16, nc] float32, zeroed by the caller. All device pointers.
// Returns the launch's CUDA error (0 when accepted).
int b4_composite_bwd_launch(const float* records, long long nc, const int* starts,
                            const int* counts, int n_tiles, int nx, const float* out,
                            const float* dout, const float* texcl, float* dpairs,
                            void* stream) {
  if (n_tiles <= 0 || nx <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (texcl != nullptr) {
    b4_composite_bwd<true><<<n_tiles, NPIX, 0, s>>>(records, nc, starts, counts, nx, out,
                                                    dout, texcl, dpairs);
  } else {
    b4_composite_bwd<false><<<n_tiles, NPIX, 0, s>>>(records, nc, starts, counts, nx, out,
                                                     dout, nullptr, dpairs);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
