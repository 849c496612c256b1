// Aligned-layout gather (B5) for Hopper, sm_90a.
//
// Replaces the TPU kernel sixdgs_tpu/ops/rasterizer/pallas_tiles.py::_align_kernel
// (launched by _align_compact). It moves the tile-sorted compact gaussian
// indices gidx [nc] into the layout where tile t's segment starts at
// starts_al[t], a multiple of 128 (clamped to nc):
//
//     out[c] = gidx[starts[t] + k]   if t < n_tiles and k < starts[t+1] - starts[t]
//            = sentinel              otherwise
//
// with t the tile that owns the 128-slot chunk of c (the first tile whose
// aligned end starts_al[t+1] lies past the chunk's first slot; n_tiles for
// chunks past the aligned total) and k = c - starts_al[t].
//
// The TPU kernel builds the chunk -> tile map with a 0/1 matmul, reads an
// aligned 2x128 window per chunk and rotates lanes by the residue, because
// Mosaic slices lanes at 128 only. Here the map is turned around: the work
// is tile-major, so no slot searches for its tile.
//
//   * One warp per tile, 8 tiles per CTA. Since starts_al is non-decreasing,
//     tile t owns exactly the slots [starts_al[t], starts_al[t+1]); an empty
//     tile, or one the clamp to nc emptied, owns none. Each warp reads its
//     tile's four bounds once and writes its range 128 slots per step, each
//     lane storing 4 consecutive int32 as one 16-byte store.
//   * Every range starts and ends at a multiple of 128: starts_al holds
//     multiples of 128 clamped to nc, and nc is a multiple of 128 (the
//     wrapper checks it; the rasterizer's nc is a multiple of 1024). So a
//     clamped range never ends short of a chunk, and every step's 128 slots
//     lie inside the range and inside out.
//   * Reads: the tile's run starts at starts[t], at any residue r modulo 4.
//     Each lane loads the aligned 16 bytes at starts[t] - r + k and takes the
//     next lane's 16 bytes with warp shuffles (lane 31 loads the next step's
//     first 16 bytes itself), then picks its 4 values by r: coalesced
//     16-byte loads, no unaligned access. Loads wholly past the tile's run
//     are skipped; values past count_t are the sentinel.
//   * The tail [starts_al[n_tiles], nc) is the sentinel: the grid's last
//     tail_ctas CTAs fill it with grid-stride 16-byte stores.
//
// Every slot is written exactly once: no atomics, and a second launch is
// bitwise equal. Pure data movement, bound by bytes: the real indices read
// once and nc indices written.

#include <cuda_runtime.h>

namespace {

constexpr int KB = 128;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TAIL_CTAS_MAX = 264;  // two per SM on an H100

__device__ __forceinline__ int4 shfl_down4(int4 v) {
  return make_int4(__shfl_down_sync(0xffffffffu, v.x, 1), __shfl_down_sync(0xffffffffu, v.y, 1),
                   __shfl_down_sync(0xffffffffu, v.z, 1), __shfl_down_sync(0xffffffffu, v.w, 1));
}

__device__ __forceinline__ int4 load4(const int* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__global__ void __launch_bounds__(THREADS)
b5_align_compact(const int* __restrict__ gidx, const int* __restrict__ starts,
                 const int* __restrict__ starts_al, int n_tiles, int tile_ctas, int sentinel,
                 int nc, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  if (blockIdx.x >= tile_ctas) {  // the tail past the aligned total
    const int step = (gridDim.x - tile_ctas) * THREADS * 4;
    const int4 s4 = make_int4(sentinel, sentinel, sentinel, sentinel);
    for (int c = starts_al[n_tiles] + ((blockIdx.x - tile_ctas) * THREADS + threadIdx.x) * 4;
         c < nc; c += step) {
      *reinterpret_cast<int4*>(out + c) = s4;
    }
    return;
  }
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= n_tiles) return;
  const int a0 = starts_al[t], width = starts_al[t + 1] - a0;
  const int s = starts[t], count = starts[t + 1] - s;
  const int r = s & 3;
  const int run_end = s + count;  // <= nc
  for (int k0 = 0; k0 < width; k0 += KB) {  // warp-uniform: width is a multiple of 128
    const int k = k0 + 4 * lane;
    const int i = s - r + k;  // aligned source of this lane's first value
    int4 a = make_int4(sentinel, sentinel, sentinel, sentinel);
    if (i < run_end) a = load4(gidx + i);
    int4 b = shfl_down4(a);
    if (lane == 31 && r != 0 && i + 4 < run_end) b = load4(gidx + i + 4);
    int4 v;
    switch (r) {  // warp-uniform
      case 0: v = a; break;
      case 1: v = make_int4(a.y, a.z, a.w, b.x); break;
      case 2: v = make_int4(a.z, a.w, b.x, b.y); break;
      default: v = make_int4(a.w, b.x, b.y, b.z); break;
    }
    if (k + 0 >= count) v.x = sentinel;
    if (k + 1 >= count) v.y = sentinel;
    if (k + 2 >= count) v.z = sentinel;
    if (k + 3 >= count) v.w = sentinel;
    *reinterpret_cast<int4*>(out + a0 + k) = v;
  }
}

}  // namespace

extern "C" {

// gidx [nc], starts / starts_al [n_tiles + 1], out [nc]: int32 device
// pointers, gidx and out 16-byte aligned; nc a multiple of 128; starts
// non-decreasing from 0 with starts[n_tiles] <= nc; starts_al
// non-decreasing multiples of 128 from 0, clamped to nc. Returns the
// launch's CUDA error (0 when accepted).
int b5_align_compact_launch(const int* gidx, const int* starts, const int* starts_al,
                            int n_tiles, int sentinel, int nc, int* out, void* stream) {
  if (nc <= 0 || nc % KB != 0 || n_tiles < 0) return (int)cudaErrorInvalidValue;
  const int tile_ctas = (n_tiles + WARPS - 1) / WARPS;
  int tail_ctas = nc / (THREADS * 4);
  tail_ctas = tail_ctas < 1 ? 1 : (tail_ctas > TAIL_CTAS_MAX ? TAIL_CTAS_MAX : tail_ctas);
  b5_align_compact<<<tile_ctas + tail_ctas, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      gidx, starts, starts_al, n_tiles, tile_ctas, sentinel, nc, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
