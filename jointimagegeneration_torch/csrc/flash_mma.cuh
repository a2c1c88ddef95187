// bf16 tensor-core helpers shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu).
//
// mma.sync.m16n8k16 fragment layout, with g = lane / 4 and t4 = lane % 4:
//   A (16x16, row):  a0 = A[g][2t4..+1]   a1 = A[g+8][2t4..+1]
//                    a2 = A[g][2t4+8..+9] a3 = A[g+8][2t4+8..+9]
//   B (16x8, col):   b0 = B[2t4..+1][g]   b1 = B[2t4+8..+9][g]
//   C (16x8, fp32):  c0 = C[g][2t4]  c1 = C[g][2t4+1]  c2 = C[g+8][2t4]  c3 = C[g+8][2t4+1]
// Two C tiles side by side (n-tiles 2kk and 2kk+1) hold exactly the values of
// one A fragment over k-step kk, so an accumulator is re-packed as the next
// product's A operand without leaving registers (`pack_bf16`).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of k-step ks from a row-major shared tile whose 16 rows start at
// `base` with row stride `stride` (elements).
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const __nv_bfloat16* base,
                                            int stride, int ks, int g, int t4) {
  a[0] = lds32(base + g * stride + ks * 16 + t4 * 2);
  a[1] = lds32(base + (g + 8) * stride + ks * 16 + t4 * 2);
  a[2] = lds32(base + g * stride + ks * 16 + 8 + t4 * 2);
  a[3] = lds32(base + (g + 8) * stride + ks * 16 + 8 + t4 * 2);
}

// A fragment of k-step kk from four accumulator tiles: c[2kk] and c[2kk+1],
// rounded to bf16.
__device__ __forceinline__ void pack_a_frag(uint32_t (&a)[4], const float (&lo)[4],
                                            const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}
