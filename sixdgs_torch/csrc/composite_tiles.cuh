// Tile code shared by the tile compositor's forward (composite_fwd.cu, B3)
// and backward (composite_bwd.cu, B4): the CTA shape, the staging of pair
// records, and the per-(pixel, pair) evaluation.
//
// Arithmetic. The stored-transmittance backward, the replaying backward and
// the forward (with or without the store) must walk every pixel through
// bitwise the same alpha, live test and transmittance update, so that
// arithmetic lives here once, written with the rounding intrinsics
// (__fmul_rn, __fadd_rn, __fsub_rn): nvcc never contracts them into FMAs,
// so the same source line cannot compile to other roundings in the two
// files. The operations and their order are those of the plain PyTorch
// version (pallas_tiles._SegmentWalk), so the kernels and the plain
// versions round alike up to exp, and a pair on the edge of the
// alpha >= 1/255 test falls the same way in both (with FMAs one pair in
// ~1e8 did not, which moves a pixel's transmittance by 0.4% from there on).
//
// Staging. Both kernels walk a tile's segment in chunks of CH pairs through
// one PairStage:
//   * cp.async copies the 9 live record rows of the next chunk into a
//     plane-major landing zone (raw) while the current chunk is walked.
//     A row's chunk may start at any float offset (the unaligned layout,
//     nc not a multiple of 4), so each row lands at the same offset modulo
//     16 bytes as its source: the 16-byte groups that lie wholly inside the
//     chunk go as 16-byte copies, a ragged head or tail as 4-byte copies.
//   * pack() turns the landed chunk pair-major: per pair two float4s
//     {x - ox, y - oy, -conA / 2, -conC / 2} and {conB, L, opacity, r} and
//     a float2 {g, b}, so that a pixel thread reads a pair with two
//     broadcast loads (a third where the pair contributes). The tile-local
//     means are the same __fsub_rn of the same operands as the plain
//     version's x - ox, so every dx and dy keeps its bits; a power-of-two
//     scale commutes with rounding, so -0.5 (A dx dx + C dy dy) taken as
//     (-A/2) dx dx + (-C/2) dy dy keeps its bits too (down to subnormal
//     terms, where exp gives 1 either way). The landing zone and the
//     packed chunk are the two buffers: chunk k + 1 lands while chunk k is
//     walked.
//
// The exp pretest. L (pretest_bound) lets a pixel skip the exp of a pair
// whose power shows that alpha < 1/255: power < L. L lies below every
// power that the full evaluation could find live, by a margin that covers
// the roundings of expf, of the opacity product and of L itself, so a
// skipped pair is one that the full evaluation would have found not live:
// the results keep their bits, and the forward and both backward modes
// skip the same pairs.
//
// Layouts: records [16, nc] float32 plane-major (rows x, y, conA, conB,
// conC, r, g, b, opacity; 7 padding rows never read); the stored exclusive
// transmittance texcl [nc / KB, NPIX, KB] float32: block b, row p, lane k
// is pixel p's transmittance before pair b * KB + k.

#pragma once

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace comp {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int KB = 128;            // pairs per aligned block of the layout
constexpr int TEX_LANES = 32;      // B3's store fills a block's lanes to a multiple of this
constexpr int LIVE_ROWS = 9;       // x, y, conA, conB, conC, r, g, b, opacity
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

static_assert(KB % TEX_LANES == 0, "the filled lanes never pass a block's end");

// ------------------------------------------------------------- cp.async

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies have landed; a __syncthreads makes everyone's visible
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------------------- staging

// offset of a float address modulo 16 bytes, in floats
__device__ __forceinline__ int quad_offset(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// L of a pair with this opacity. Live needs fl(opacity expf(p)) >= ALPHA_MIN
// at the evaluated power p; with round-to-nearest and expf within 2 ulp
// that needs p >= ln(ALPHA_MIN / opacity) - 4e-7. logf is within 1 ulp
// (2e-6 for |L| < 20) and the quotient within 1/2 ulp (6e-8 in the log),
// so L = logf(ALPHA_MIN / opacity) - 1e-4 lies below that.
// Opacities below ALPHA_MIN are never live (alpha <= opacity when
// power <= 0): L = +inf skips every pixel. A NaN opacity gives L = NaN,
// which skips nothing.
__device__ __forceinline__ float pretest_bound(float opac) {
  if (opac < ALPHA_MIN) return __int_as_float(0x7f800000);
  return __fsub_rn(logf(__fdiv_rn(ALPHA_MIN, opac)), 1e-4f);
}

// CH pairs per chunk
template <int CH>
struct __align__(16) PairStage {
  static_assert(CH % 4 == 0, "the landing rows are whole 16-byte groups");
  static constexpr int RAW = CH + 4;     // a row lands at offset 0-3
  static constexpr int GROUPS = CH / 4 + 1;  // 16-byte groups a row can touch

  float raw[LIVE_ROWS][RAW];
  float4 a[CH];  // x - ox, y - oy, -conA / 2, -conC / 2
  float4 b[CH];  // conB, L, opacity, r
  float2 c[CH];  // g, b

  // Start copying lanes [first, first + n) of the live rows into raw; the
  // caller commits. Threads tid of nt share the copies.
  __device__ __forceinline__ void issue(const float* __restrict__ records, long long nc,
                                        long long first, int n, int tid, int nt) {
    for (int i = tid; i < LIVE_ROWS * GROUPS; i += nt) {
      const int r = i / GROUPS;
      const int g = i % GROUPS;
      const float* src = records + r * nc + first;
      const int sh = quad_offset(src);  // lane l lands at raw[r][sh + l]
      const int lo = max(4 * g, sh), hi = min(4 * g + 4, sh + n);
      if (lo >= hi) continue;
      if (hi - lo == 4) {
        cp_async16(&raw[r][lo], src + (lo - sh));
      } else {
        for (int d = lo; d < hi; ++d) cp_async4(&raw[r][d], src + (d - sh));
      }
    }
  }

  // The landed chunk (lanes [first, first + n)) pair-major.
  __device__ __forceinline__ void pack(const float* __restrict__ records, long long nc,
                                       long long first, int n, float ox, float oy, int tid,
                                       int nt) {
    int sh[LIVE_ROWS];
#pragma unroll
    for (int r = 0; r < LIVE_ROWS; ++r) sh[r] = quad_offset(records + r * nc + first);
    for (int l = tid; l < n; l += nt) {
      const float opac = raw[8][sh[8] + l];
      a[l] = make_float4(__fsub_rn(raw[0][sh[0] + l], ox), __fsub_rn(raw[1][sh[1] + l], oy),
                         __fmul_rn(-0.5f, raw[2][sh[2] + l]), __fmul_rn(-0.5f, raw[4][sh[4] + l]));
      b[l] = make_float4(raw[3][sh[3] + l], pretest_bound(opac), opac, raw[5][sh[5] + l]);
      c[l] = make_float2(raw[6][sh[6] + l], raw[7][sh[7] + l]);
    }
  }
};

// ------------------------------------------------- per-(pixel, pair) math

// Pair j at one pixel, in steps so that a kernel can leave between them.
// pair_power: the offsets from the tile-local mean and the exponent; a pair
// with !(power <= 0) is not live (NaN-safe), nor one with power < L.
// pair_alpha: g_raw = exp(power) and alpha = min(ALPHA_MAX, opacity g_raw);
// a pair with !(alpha >= ALPHA_MIN) is not live.
__device__ __forceinline__ float pair_power(const float4& pa, float conB, float px, float py,
                                            float& dx, float& dy) {
  dx = __fsub_rn(px, pa.x);
  dy = __fsub_rn(py, pa.y);
  const float hq = __fadd_rn(__fmul_rn(__fmul_rn(pa.z, dx), dx),
                             __fmul_rn(__fmul_rn(pa.w, dy), dy));
  return __fsub_rn(hq, __fmul_rn(__fmul_rn(conB, dx), dy));
}

__device__ __forceinline__ float pair_alpha(float opac, float power, float& g_raw) {
  g_raw = expf(power);
  return fminf(ALPHA_MAX, __fmul_rn(opac, g_raw));
}

// The transmittance after a live pair; the pixel stops (before the pair
// contributes) when it falls below T_EPS.
__device__ __forceinline__ float next_transmittance(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.f, alpha));
}

}  // namespace comp
