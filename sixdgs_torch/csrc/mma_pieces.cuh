// Tensor-core building blocks for the attention-score kernels on Hopper,
// sm_90a: f32 values split into bf16 pieces, warp-level mma.sync.m16n8k16
// (bf16 operands, f32 accumulation) over products of pieces, and ldmatrix.
//
// Precision by the number of pieces NP of each operand:
//   NP = 1 ("bf16"):        x ~ hi                        1 product
//   NP = 2 ("bf16_split3"): x ~ hi + lo (rel. 2^-18)      3: hi.hi, hi.lo, lo.hi
//   NP = 3 ("f32"):         x ~ p0 + p1 + p2 (2^-27)      6: pieces i.j, i + j < 3
// The split of NP = 2 is the TPU kernel's _split_bf16; NP = 3 is the split
// a TPU's Precision.HIGHEST takes.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
//   A (16 x 16, row-major): reg0 (row g, k 2t..2t+1), reg1 (row g+8, k 2t..),
//                           reg2 (row g, k 2t+8..),   reg3 (row g+8, k 2t+8..)
//   B (16 x 8, k by n):     reg0 (k 2t..2t+1, col g), reg1 (k 2t+8..2t+9, col g)
//   C (16 x 8, f32):        c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// The lower k (or column) index sits in the low 16 bits of a register.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

// out[i] = piece i of (a, b), a in the low half: a = sum_i piece_i(a) up to
// the precision in the header.
template <int NP>
__device__ __forceinline__ void split2(float a, float b, uint32_t (&out)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // one cvt for the pair
    out[i] = *reinterpret_cast<const uint32_t*>(&h);
    if (i + 1 < NP) {
      const float2 back = __bfloat1622float2(h);
      a -= back.x;  // exact: a and its bf16 rounding are within one bf16 ulp
      b -= back.y;
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A B over the products of pieces i . j with i + j < NP.
template <int NP>
__device__ __forceinline__ void mma_pieces(float (&c)[4], const uint32_t (&a)[NP][4],
                                           const uint32_t (&b)[NP][2]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int j = 0; i + j < NP; ++j) mma_bf16(c, a[i], b[j]);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: lane l gives the address of row l % 8
// of matrix l / 8, and a thread receives two elements of one column.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

}  // namespace mma
