// Hopper (sm_90a) primitives shared by the port's kernels (conv3d.cu,
// flash_fwd.cu, flash_bwd.cu): asynchronous copies (cp.async, and TMA tensor copies that
// complete on an mbarrier), proxy fences, named barriers, ldmatrix, the MUFU
// exponential, and warpgroup matrix multiplies (wgmma) with their
// shared-memory matrix descriptors.
//
// Swizzled tiles.  A tile whose rows are RB = 32, 64 or 128 bytes lives in
// shared memory with the 16-byte chunk c of row r at chunk position
// c ^ ((r * RB >> 7) & (RB / 16 - 1)) (`swizzle_off`): the XOR of address bits
// [4, 4 + log2(RB / 16)) with bits [7, ...) that the hardware's 32-, 64- and
// 128-byte swizzles undo when wgmma reads the tile, so the tile must start on
// a 1024-byte boundary.  The same bytes serve two operand layouts:
//   * K-major (`kmajor_desc`): rows are M (or N) and the RB bytes of a row are
//     K.  One k16 step reads 32 bytes of every row, at start + 32 * step
//     inside the row; 8-row groups are 8 * RB bytes apart (the stride byte
//     offset); the leading offset is unused.
//   * MN-major (`mnmajor_desc`, the instruction's transpose bit): rows are K
//     and the RB bytes of a row are N.  One k16 step reads 16 rows from
//     start; 8-row groups along K are 8 * RB bytes apart (the stride byte
//     offset), and the leading byte offset is the distance between atoms of
//     RB bytes along N (unused while N fits one atom).
//
// wgmma register layouts (warp w of the warpgroup owns rows 16w ... 16w + 15;
// g = lane / 4, t4 = lane % 4): accumulator element i of an m64nN product is
// row g + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2 * t4 + (i & 1), the
// mma.sync C layout per 8-column tile; the RS form's A fragment (16 x 16 per
// warp) is mma.sync's A layout, so two accumulator tiles re-pack into one A
// fragment in registers (flash_common.cuh `pack_frags`).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  // copies `bytes` (0 or 16) and zero-fills the rest of the 16
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's generic-proxy writes to shared memory become visible to wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier ID (1 ... 15; 0 is __syncthreads') over THREADS threads, a multiple of 32
template <int ID, int THREADS>
__device__ __forceinline__ void named_barrier_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(THREADS) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// mbarriers (8 bytes of shared memory each)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA); then __syncthreads
__device__ __forceinline__ void fence_mbar_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
// this thread's arrival, announcing `bytes` that TMA copies will complete on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// waits until the barrier's phase `parity` (0, 1, 0, ... per completion) has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// TMA tiled copies of a box at element coordinates (c0 innermost) of the
// tensor `map` (a CUtensorMap in kernel-parameter or global memory) to shared
// memory at dst, completing its bytes on barrier bar; out-of-bounds elements
// are written as zeros
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const void* map, int c0, uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2}], [%3];\n"
               ::"r"(dst), "l"(map), "r"(c0), "r"(bar) : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(bar) : "memory");
}
// brings a tensor map into the cache ahead of its first copy
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}
// 2^x by one MUFU.EX2 (denormal results flush to 0; 2^-inf = 0)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte chunk c of row r in a swizzled tile of RB-byte rows
template <int RB>
__host__ __device__ constexpr int swizzle_off(int r, int c) {
  return r * RB + ((c ^ ((r * RB >> 7) & (RB / 16 - 1))) << 4);
}

// wgmma matrix descriptor: start address >> 4 (14 bits), leading and stride
// byte offsets >> 4, layout 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
template <int RB>
__device__ __forceinline__ uint64_t swizzle_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  static_assert(RB == 32 || RB == 64 || RB == 128, "32-, 64- or 128-byte swizzle");
  constexpr uint64_t layout = RB == 128 ? 1 : (RB == 64 ? 2 : 3);
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}
template <int RB>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t saddr) {
  return swizzle_desc<RB>(saddr, 16, 8 * RB);
}
template <int RB>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t saddr, uint32_t atom_stride) {
  return swizzle_desc<RB>(saddr, atom_stride, 8 * RB);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the async wgmma
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define JIG_ACC4(i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define JIG_ACC8(i) JIG_ACC4(i), JIG_ACC4((i) + 4)
#define JIG_ACC16(i) JIG_ACC8(i), JIG_ACC8((i) + 8)
#define JIG_ACC32(i) JIG_ACC16(i), JIG_ACC16((i) + 16)
#define JIG_REGS8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define JIG_REGS16 JIG_REGS8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define JIG_REGS32 JIG_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define JIG_REGS64                                                                                          \
  JIG_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
             "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// RS form: D (64 x N, fp32) = A (64 x 16, bf16, registers) * B (16 x N, bf16,
// descriptor; K-major, or MN-major with TRANS_B), plus D where accumulate != 0
template <int N, bool TRANS_B = false>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate = 1) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma_rs: N of 16, 32, 64 or 128");
  constexpr int kTrans = TRANS_B ? 1 : 0;
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" JIG_REGS8 "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : JIG_ACC8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(kTrans));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" JIG_REGS16 "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : JIG_ACC16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(kTrans));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" JIG_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : JIG_ACC32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(kTrans));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" JIG_REGS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : JIG_ACC32(0), JIG_ACC32(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(kTrans));
  }
}

// SS form: D (64 x 64, fp32) = A (64 x 16, bf16) * B (16 x 64, bf16), both
// K-major descriptors, plus D where accumulate != 0
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" JIG_REGS32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : JIG_ACC32(0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef JIG_ACC4
#undef JIG_ACC8
#undef JIG_ACC16
#undef JIG_ACC32
#undef JIG_REGS8
#undef JIG_REGS16
#undef JIG_REGS32
#undef JIG_REGS64
