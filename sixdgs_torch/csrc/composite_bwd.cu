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
// one CTA owns a tile and each thread PPT of its pixels, walking the
// segment serially as the forward does, so acc and the stop latch come
// directly, in f32. Alpha, the live test with its exp pretest and the
// transmittance update are composite_tiles.cuh's, the forward's own code,
// and so is the staging: cp.async brings the next chunk of 64 pairs while
// the current one is walked.
//
// Each round of SB pairs has two phases, so that no per-pair sum runs on
// warp shuffles:
//   * walk: each pixel takes the round's pairs and writes s and w for each
//     into two shared tiles [SB][256 + 1], 0 where the pair does not
//     contribute; a warp none of whose 32 pixels contributes to a pair
//     writes nothing and leaves that pair's flag for its pixels unset;
//   * reduce: thread (j, slice) sums pair j over a fixed slice of pixels
//     (whole rows, or a stretch of one row), serially and in a fixed order,
//     skipping the unflagged 32-pixel groups (adding their zeros would
//     change no sum) and recomputing dx and dy from the pixel index and the
//     staged tile-local mean (the walk's operations, so the walk's bits).
//     Within a row dy is one value, so the row's sums of s and s dx carry
//     the dy terms (sum s dy = sum_rows dy sum_row s, and so on), and a
//     (pixel, pair) costs 3 shared loads and 8 f32 operations. The slices'
//     partials then go through shared memory and thread j adds them in
//     slice order.
// Two CTA-wide barriers per round (after the walk, after the reduce), two
// more per chunk (the pack).
// No float atomics: a pair belongs to one tile in either layout, so its
// lane has one writer, and every sum has one order: two launches give the
// same bits. The direct f32 sums keep the accuracy that the TPU kernel's
// moment expansion (sum s dx^2 = m20 - 2 x m10 + x^2 m00 in bf16 pieces)
// loses to cancellation when the means lie far from the tile origin.
//
// T comes one of two ways, and nothing else differs. Replay (texcl null,
// any layout): the thread carries T as the forward did. Stored (texcl
// given, aligned layout): round r's [256, SB] slice of the forward's texcl
// block rides the staging into a shared tile (cp.async, 16-byte copies of
// each pixel's contiguous lanes), and each pixel reads 4 pairs' worth at a
// time. Round r + 1's slice is requested once round r has shown a live
// pixel, so the kernel never reads a block that the forward left unwritten,
// and it lands while round r is reduced. (Each thread loading its own
// pixel's lanes from global memory instead would touch 32 cache lines per
// warp load.) The tile costs occupancy: 3 CTAs per SM against replay's 4.
// Both modes use the same values in the same operations, written with the
// rounding intrinsics so that neither instance of the template can be
// contracted differently: the two modes' gradients are bitwise equal.
//
// Bound: per (pixel, pair) evaluation up to the pixel's stop 14 f32
// operations, as the forward; per contributing pair 50 more: the forward's
// 14, dbuf 5, acc 2, da 6, s 3, the five moment terms 8, the colour terms 3
// and 9 adds of the sums. Bytes: the live record rows, out and dout read
// once, dpairs written once, and in the stored mode the texcl blocks up to
// each tile's exit read once. chip_smoke.py computes both from the run's
// data.

#include "composite_tiles.cuh"

#include <stddef.h>

// pixels per thread and pairs per round, the fastest on the card of the
// builds chip_smoke.py times (-DB4_PPT=1, 2, 4 with -DB4_SB=16, 32)
#ifndef B4_PPT
#define B4_PPT 1
#endif
#ifndef B4_SB
#define B4_SB 16
#endif

namespace {

using namespace comp;

constexpr int PPT = B4_PPT;
constexpr int NT = NPIX / PPT;      // threads per tile
constexpr int SB = B4_SB;           // pairs per round
constexpr int CH = 64;              // pairs per staged chunk
constexpr int NSUM = 9;             // s dx, s dy, s dx^2, s dx dy, s dy^2, dout w (3), s
constexpr int NSL = NT / SB;        // pixel slices of the reduce
constexpr int SLICE = NPIX / NSL;   // pixels per slice
constexpr int SEG = SLICE < TILE ? SLICE : TILE;  // pixels per segment: one row or less
constexpr int NSEG = SLICE / SEG;   // segments per slice
constexpr int SWS = NPIX + 1;       // padded row of the s and w tiles
static_assert(NPIX % PPT == 0 && NT % TILE == 0 && NT % 32 == 0,
              "a thread's pixels share a column and warps are whole");
static_assert(SB % 4 == 0 && CH % SB == 0 && KB % CH == 0 && TEX_LANES % SB == 0,
              "rounds nest in chunks, chunks in blocks, and rounds lie in the store's lanes");
static_assert(NT % SB == 0 && NSEG * SEG * NSL == NPIX && TILE % SEG == 0,
              "every thread has a reduce slice of whole segments of a row");
static_assert(NT % 32 == 0 && 32 % TILE == 0, "a warp's pixels are whole rows of one group");

struct Smem {
  PairStage<CH> st;
  float s[SB][SWS];
  float w[SB][SWS];
  float part[NSL][NSUM][SB];
  float4 dout[NPIX];
  // by round parity: some pixel of 32-pixel group q contributed to pair j
  // (only such groups' s and w are written)
  int hit[2][SB][NPIX / 32];
  __align__(16) float tt[NPIX][SB + 4];  // stored mode only: round r's texcl
};

constexpr size_t SMEM_STORED = sizeof(Smem);
constexpr size_t SMEM_REPLAY = offsetof(Smem, tt);

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Round r's [NPIX, SB] slice of the texcl block into tt, 16-byte copies
// (a warp reads 8 pixels' 64 contiguous bytes each), asking L2 to fetch the
// 256 bytes around each: a pixel's next rounds follow in the same row
__device__ __forceinline__ void issue_texcl(float (*tt)[SB + 4], const float* __restrict__ texcl,
                                            long long first, int tid) {
  const float* blk = texcl + (first / KB * NPIX) * KB + first % KB;
  for (int i = tid; i < NPIX * (SB / 4); i += NT) {
    const int p = i / (SB / 4);
    const int q = i % (SB / 4);
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n"
                 ::"r"(smem_addr(&tt[p][4 * q])), "l"(blk + (long long)p * KB + 4 * q)
                 : "memory");
  }
}

// One pixel's step over pair j with the transmittance Tb before it: s and
// w of the pair (0 unless it contributes); acc, T and the stop latch
// updated.
__device__ __forceinline__ void bwd_step(const float4& pa, const float4& pb, const float2* pc,
                                         float px, float py, float d0, float d1, float d2,
                                         float S, float Tb, float& T, float& acc, int& done,
                                         float& s, float& w) {
  float dx, dy;
  const float power = pair_power(pa, pb.x, px, py, dx, dy);
  if (!(power <= 0.f) || power < pb.y) return;
  float g_raw;
  const float alpha = pair_alpha(pb.z, power, g_raw);
  if (!(alpha >= ALPHA_MIN)) return;
  const float test_t = next_transmittance(Tb, alpha);
  if (test_t < T_EPS) {
    done = 1;
    return;
  }
  const float2 gb = *pc;
  w = __fmul_rn(alpha, Tb);
  const float dbuf = __fmaf_rn(d2, gb.y, __fmaf_rn(d1, gb.x, __fmul_rn(d0, pb.w)));
  acc = __fmaf_rn(dbuf, w, acc);
  const float one_minus = fmaxf(__fsub_rn(1.f, alpha), 1e-6f);
  const float da = __fsub_rn(__fmul_rn(dbuf, Tb), __fdiv_rn(__fsub_rn(S, acc), one_minus));
  s = __fmul_rn(pb.z, g_raw) > ALPHA_MAX ? 0.f : __fmul_rn(da, g_raw);
  T = test_t;
}

template <bool STORED>
__global__ void __launch_bounds__(NT)
b4_composite_bwd(const float* __restrict__ records, long long nc,
                 const int* __restrict__ starts, const int* __restrict__ counts, int nx,
                 const float* __restrict__ out, const float* __restrict__ dout,
                 const float* __restrict__ texcl, float* __restrict__ dpairs) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_bytes);
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)(tid % TILE);
  const float ox = (float)((t % nx) * TILE);
  const float oy = (float)((t / nx) * TILE);
  const long long start = starts[t];
  const int count = counts[t];

  float py[PPT], d0[PPT], d1[PPT], d2[PPT], S[PPT], T[PPT], acc[PPT];
  int done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + k * NT;
    const float* o = out + ((long long)t * NPIX + p) * 3;
    const float* d = dout + ((long long)t * NPIX + p) * 3;
    py[k] = (float)(p / TILE);
    d0[k] = d[0];
    d1[k] = d[1];
    d2[k] = d[2];
    sm.dout[p] = make_float4(d0[k], d1[k], d2[k], 0.f);
    S[k] = __fmaf_rn(d2[k], o[2], __fmaf_rn(d1[k], o[1], __fmul_rn(d0[k], o[0])));
    T[k] = 1.f;
    acc[k] = 0.f;
    done[k] = 0;
  }

  const int nr = (count + SB - 1) / SB;
  if (nr == 0) return;
  sm.st.issue(records, nc, start, min(CH, count), tid, NT);
  if constexpr (STORED) issue_texcl(sm.tt, texcl, start, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  sm.st.pack(records, nc, start, min(CH, count), ox, oy, tid, NT);
  for (int i = tid; i < SB * (NPIX / 32); i += NT) sm.hit[0][i / (NPIX / 32)][i % (NPIX / 32)] = 0;
  __syncthreads();  // chunk 0 packed, the landing zone free
  if (count > CH) {
    sm.st.issue(records, nc, start + CH, min(CH, count - CH), tid, NT);
    cp_async_commit();
  }

  // the reduce's fixed assignment: pair rj, pixels [rsl SLICE, (rsl + 1)
  // SLICE) in segments of SEG within a row, taken from a start rotated by
  // one segment in odd slices (no bank conflict when two slices share a
  // warp)
  const int rj = tid % SB;
  const int rsl = tid / SB;
  const int rot = NSEG > 1 ? (rsl & 1) : 0;

  for (int r = 0; r < nr; ++r) {
    const long long first = start + (long long)r * SB;
    const int n = min(SB, count - r * SB);
    const int j0 = (r * SB) % CH;  // the round's first pair in the staged chunk
    const float4* pa = sm.st.a + j0;
    const float4* pb = sm.st.b + j0;
    const float2* pc = sm.st.c + j0;
    int (*hit)[NPIX / 32] = sm.hit[r & 1];

    // walk: s and w of every (pair, pixel) of the round
#pragma unroll
    for (int g = 0; g < SB / 4; ++g) {
      if (4 * g >= n) break;
      float4 tc[PPT];
      if constexpr (STORED) {
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          tc[k] = *reinterpret_cast<const float4*>(&sm.tt[tid + k * NT][4 * g]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * g + jj;
        if (j >= n) break;
        const float4 a4 = pa[j];
        const float4 b4 = pb[j];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          float s = 0.f, w = 0.f;
          if (!done[k]) {
            float Tb = T[k];
            if constexpr (STORED) Tb = lane_of(tc[k], jj);
            bwd_step(a4, b4, pc + j, px, py[k], d0[k], d1[k], d2[k], S[k], Tb, T[k], acc[k],
                     done[k], s, w);
          }
          // a warp's 32 pixels are one group: it writes their s and w only
          // where one of them contributes
          if (__any_sync(0xffffffffu, w != 0.f)) {
            sm.s[j][tid + k * NT] = s;
            sm.w[j][tid + k * NT] = w;
            if (tid % 32 == 0) hit[j][(tid + k * NT) / 32] = 1;
          }
        }
      }
    }
    int mine = 1;
#pragma unroll
    for (int k = 0; k < PPT; ++k) mine &= done[k];
    // the tiles are written; every pixel has stopped?
    const bool all_done = __syncthreads_count(mine) == NT;
    // tt is read: bring the next round's, now that a pixel is known live
    if constexpr (STORED) {
      if (!all_done && r + 1 < nr) {
        issue_texcl(sm.tt, texcl, first + SB, tid);
        cp_async_commit();
      }
    }
    // round r + 1's flags, read by round r - 1's reduce, before now
    for (int i = tid; i < SB * (NPIX / 32); i += NT) {
      sm.hit[(r + 1) & 1][i / (NPIX / 32)][i % (NPIX / 32)] = 0;
    }

    // reduce: pair rj over the segments of its slice
    float m[NSUM];
#pragma unroll
    for (int q = 0; q < NSUM; ++q) m[q] = 0.f;
    if (rj < n) {
      const float xl = pa[rj].x, yl = pa[rj].y;
      const float* srow = sm.s[rj];
      const float* wrow = sm.w[rj];
      for (int sg = 0; sg < NSEG; ++sg) {
        const int p0 = rsl * SLICE + (sg + rot) % NSEG * SEG;
        if (!hit[rj][p0 / 32]) continue;  // s = w = 0 there: nothing to add
        const float dy = __fsub_rn((float)(p0 / TILE), yl);
        float row_s = 0.f, row_sdx = 0.f;
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
          const int p = p0 + i;
          const float dx = __fsub_rn((float)(p0 % TILE + i), xl);
          const float s = srow[p];
          const float w = wrow[p];
          const float4 d = sm.dout[p];
          const float sdx = __fmul_rn(s, dx);
          row_s = __fadd_rn(row_s, s);
          row_sdx = __fadd_rn(row_sdx, sdx);
          m[2] = __fmaf_rn(sdx, dx, m[2]);
          m[5] = __fmaf_rn(d.x, w, m[5]);
          m[6] = __fmaf_rn(d.y, w, m[6]);
          m[7] = __fmaf_rn(d.z, w, m[7]);
        }
        m[0] = __fadd_rn(m[0], row_sdx);
        m[1] = __fmaf_rn(row_s, dy, m[1]);
        m[3] = __fmaf_rn(row_sdx, dy, m[3]);
        m[4] = __fmaf_rn(__fmul_rn(row_s, dy), dy, m[4]);
        m[8] = __fadd_rn(m[8], row_s);
      }
    }
#pragma unroll
    for (int q = 0; q < NSUM; ++q) sm.part[rsl][q][rj] = m[q];
    const bool chunk_end = (r + 1) * SB % CH == 0 && r + 1 < nr && !all_done;
    if (chunk_end || STORED) cp_async_wait_all();  // the next chunk (and tt) landed
    __syncthreads();  // the partials are in, the tiles free (and the copies visible)

    // epilogue: pair tid, the slices added in order
    if (tid < n) {
      float g[NSUM];
#pragma unroll
      for (int q = 0; q < NSUM; ++q) {
        float sum = sm.part[0][q][tid];
#pragma unroll
        for (int sl = 1; sl < NSL; ++sl) sum = __fadd_rn(sum, sm.part[sl][q][tid]);
        g[q] = sum;
      }
      // the staged -conA / 2 and -conC / 2, scaled back exactly
      const float conA = __fmul_rn(-2.f, pa[tid].z), conC = __fmul_rn(-2.f, pa[tid].w);
      const float conB = pb[tid].x, opac = pb[tid].z;
      float* gp = dpairs + first + tid;
      gp[0 * nc] = __fmul_rn(opac, __fmaf_rn(conA, g[0], __fmul_rn(conB, g[1])));
      gp[1 * nc] = __fmul_rn(opac, __fmaf_rn(conC, g[1], __fmul_rn(conB, g[0])));
      gp[2 * nc] = __fmul_rn(__fmul_rn(-0.5f, opac), g[2]);
      gp[3 * nc] = __fmul_rn(-opac, g[3]);
      gp[4 * nc] = __fmul_rn(__fmul_rn(-0.5f, opac), g[4]);
      gp[5 * nc] = g[5];
      gp[6 * nc] = g[6];
      gp[7 * nc] = g[7];
      gp[8 * nc] = g[8];
    }
    if (all_done) break;
    if (chunk_end) {
      const long long next = start + (long long)(r + 1) * SB;
      __syncthreads();  // the chunk's pairs are read
      sm.st.pack(records, nc, next, min(CH, count - (r + 1) * SB), ox, oy, tid, NT);
      __syncthreads();  // the next chunk packed, the landing zone free
      if (count - (r + 1) * SB > CH) {
        sm.st.issue(records, nc, next + CH, min(CH, count - (r + 1) * SB - CH), tid, NT);
        cp_async_commit();
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the CTA
}

template <bool STORED>
cudaError_t launch(int n_tiles, cudaStream_t s, const float* records, long long nc,
                   const int* starts, const int* counts, int nx, const float* out,
                   const float* dout, const float* texcl, float* dpairs) {
  constexpr size_t bytes = STORED ? SMEM_STORED : SMEM_REPLAY;
  static const cudaError_t attr = cudaFuncSetAttribute(
      b4_composite_bwd<STORED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  b4_composite_bwd<STORED><<<n_tiles, NT, bytes, s>>>(records, nc, starts, counts, nx, out,
                                                      dout, texcl, dpairs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// records [16, nc] float32 (plane-major); starts [n_tiles (+1)] and counts
// [n_tiles] int32 with starts[t] + counts[t] <= nc; out and dout
// [n_tiles, 256, 3] float32; texcl null (replay) or the forward's
// [nc / 128, 256, 128] float32 store, 16-byte aligned, with every starts[t]
// a multiple of 128; dpairs [16, nc] float32, zeroed by the caller. All
// device pointers. Returns the launch's CUDA error (0 when accepted).
int b4_composite_bwd_launch(const float* records, long long nc, const int* starts,
                            const int* counts, int n_tiles, int nx, const float* out,
                            const float* dout, const float* texcl, float* dpairs,
                            void* stream) {
  if (n_tiles <= 0 || nx <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (texcl != nullptr) {
    if (reinterpret_cast<uintptr_t>(texcl) % 16) return (int)cudaErrorMisalignedAddress;
    return (int)launch<true>(n_tiles, s, records, nc, starts, counts, nx, out, dout, texcl,
                             dpairs);
  }
  return (int)launch<false>(n_tiles, s, records, nc, starts, counts, nx, out, dout, nullptr,
                            dpairs);
}

}  // extern "C"
