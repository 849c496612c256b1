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
// Mosaic slices lanes at 128 only. On the card none of that is needed: one
// thread per output slot binary-searches starts_al for its owning tile and
// does one gather. Pure data movement, bound by bytes: the real indices
// read once and nc indices written.

#include <cuda_runtime.h>

namespace {

constexpr int KB = 128;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
b5_align_compact(const int* __restrict__ gidx, const int* __restrict__ starts,
                 const int* __restrict__ starts_al, int n_tiles, int sentinel, int nc,
                 int* __restrict__ out) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= nc) return;
  const int chunk_pos = c / KB * KB;
  // owning tile: the first t with starts_al[t + 1] > chunk_pos
  int lo = 0, hi = n_tiles;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (starts_al[mid + 1] <= chunk_pos) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int v = sentinel;
  if (lo < n_tiles) {
    const int k = c - starts_al[lo];
    if (k < starts[lo + 1] - starts[lo]) v = gidx[starts[lo] + k];
  }
  out[c] = v;
}

}  // namespace

extern "C" {

// gidx [nc], starts / starts_al [n_tiles + 1], out [nc]: int32 device
// pointers; starts_al non-decreasing multiples of 128 (clamped to nc).
// Returns the launch's CUDA error (0 when accepted).
int b5_align_compact_launch(const int* gidx, const int* starts, const int* starts_al,
                            int n_tiles, int sentinel, int nc, int* out, void* stream) {
  if (nc <= 0 || n_tiles < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (nc + THREADS - 1) / THREADS;
  b5_align_compact<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      gidx, starts, starts_al, n_tiles, sentinel, nc, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
