// Tile code shared by the tile compositor's forward (composite_fwd.cu, B3)
// and backward (composite_bwd.cu, B4): the CTA shape, the staging of record
// rows, and the per-(pixel, pair) evaluation. The stored-transmittance
// backward, the replaying backward and the forward (with or without the
// store) must walk every pixel through bitwise the same alpha, live test and
// transmittance update, so that arithmetic lives here once, written with the
// rounding intrinsics (__fmul_rn, __fadd_rn, __fsub_rn): nvcc never
// contracts them into FMAs, so the same source line cannot compile to other
// roundings in the two files. The operations and their order are those of
// the plain PyTorch version (pallas_tiles._SegmentWalk), so the kernels and
// the plain versions round alike up to exp, and a pair on the edge of the
// alpha >= 1/255 test falls the same way in both (with FMAs one pair in
// ~1e8 did not, which moves a pixel's transmittance by 0.4% from there on;
// the unfused form measured no slower).
//
// Layouts: records [16, nc] float32 plane-major (rows x, y, conA, conB,
// conC, r, g, b, opacity; 7 padding rows never read); the stored exclusive
// transmittance texcl [nc / KB, NPIX, KB] float32: block b, row p, lane k
// is pixel p's transmittance before pair b * KB + k.

#pragma once

#include <cuda_runtime.h>

#include <math.h>

namespace comp {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;  // one thread per pixel
constexpr int WARPS = NPIX / 32;
constexpr int KB = 128;            // pairs per aligned block of the layout
constexpr int SB = 32;             // pairs walked between two CTA-wide steps
constexpr int TS = SB + 1;         // padded row stride of a [NPIX, SB] tile
constexpr int LIVE_ROWS = 9;       // x, y, conA, conB, conC, r, g, b, opacity
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

static_assert(KB % SB == 0, "a sub-block never straddles two aligned blocks");
static_assert(SB == 32, "a warp moves one row of a [NPIX, SB] tile at a time");

// Stage lanes [first, first + width) of the 9 live record rows of a segment
// into rec (coalesced along the lanes); lanes >= n get zeros.
template <int WIDTH>
__device__ __forceinline__ void stage_records(float (*rec)[WIDTH],
                                              const float* __restrict__ records,
                                              long long nc, long long first, int n) {
  for (int i = threadIdx.x; i < LIVE_ROWS * WIDTH; i += NPIX) {
    const int r = i / WIDTH;
    const int l = i % WIDTH;
    rec[r][l] = l < n ? records[r * nc + first + l] : 0.f;
  }
}

// Pair j of the staged rows at one pixel, in two steps so that a kernel can
// leave between them. pair_power: the offsets from the mean and the
// exponent; a pair with !(power <= 0) is not live (NaN-safe). pair_alpha:
// g_raw = exp(power) and alpha = min(ALPHA_MAX, opacity g_raw); a pair with
// !(alpha >= ALPHA_MIN) is not live.
template <int WIDTH>
__device__ __forceinline__ float pair_power(const float (*rec)[WIDTH], int j, float px,
                                            float py, float ox, float oy, float& dx,
                                            float& dy) {
  dx = __fsub_rn(px, __fsub_rn(rec[0][j], ox));
  dy = __fsub_rn(py, __fsub_rn(rec[1][j], oy));
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(rec[2][j], dx), dx),
                            __fmul_rn(__fmul_rn(rec[4][j], dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(rec[3][j], dx), dy));
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
