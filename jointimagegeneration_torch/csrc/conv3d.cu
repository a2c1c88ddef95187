// SAME 3x3x3 convolution as an implicit GEMM for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces three TPU kernels, which compute one function:
//   * jointimagegeneration_tpu/ops/pallas/fused_resblock.py:51 `_kernel`
//     (entered through `fused_affine_silu_conv3d` and `fused_conv3d`): the
//     conv with an optional GroupNorm-affine + SiLU prologue, a +bias
//     (fp32) / +residual epilogue and per-channel [sum, sum of squares] of the
//     fp32 result;
//   * jointimagegeneration_tpu/ops/pallas/conv3d.py:52 `_kernel`
//     (`conv3d_3x3`) and :163 `_kernel_v2` (`conv3d_3x3_v2`): the bare conv
//     with an optional SiLU epilogue, any batch.
//
//   out[b, z, y, x, n] = cast( act( sum_{dz,dy,dx,c} t(x)[b, z+dz-1, y+dy-1, x+dx-1, c]
//                                   * W[dz, dy, dx, c, n] + bias[n] + res[b, z, y, x, n] ) )
//
// on channels-last (B, D, H, W, C) tensors, zero padding, fp32 accumulation.
// With the prologue, t(x) = round_to_input_dtype(silu(x * scale[c] + shift[c]))
// on in-bounds elements and 0 on the padding taps (silu(shift) != 0, so the
// pad must be re-zeroed after the affine, as the TPU kernel does at :86-95);
// without it t(x) = x.  Stats are taken on the fp32 value after bias and
// residual and before the cast, as at fused_resblock.py:104-117.
//
// GEMM view: M = B*D*H*W output voxels, N = Cout, K = 27*Cin in (dz, dy, dx, c)
// order, i.e. JAX's `kernel.reshape(27 * cin, cout)`.  The weight arrives as
// its transpose, wt (Cout, 27*Cin), so each output channel's K row is
// contiguous.  Ragged D, H, W, Cout and Cin are masked with zeros.
//
// Bound on an H100 SXM.  2*M*27*Cin*Cout flops against one read of x, the
// weight and the residual and one write of the output: at stage 1's level 0
// (64x128x128, 64 -> 64, bf16) 2.32e11 flops are 0.235 ms at 989 TFLOP/s,
// while the ~0.27 GB of traffic is 0.08 ms at 3.35 TB/s, so the conv is bound
// by the tensor cores' operations at every level of the UNet.  At levels 3-4
// (2,048 and 256 voxels) one output tile per block gives 10-64 blocks for 132
// SMs, each walking all of K alone, so there the time is latency, not work,
// unless K is split.  The time that stays, at level 0: each block's halo load
// and prologue (hidden only behind other blocks on its SM) and each block
// streaming the whole weight from L2 for its 128-256 voxels.
//
// bf16 design (`conv3d_wgmma_kernel`), against the three limits of the
// first, mma.sync version of this kernel:
//   1. The prologue ran once per tap (27 times per element) on A chunks
//      reloaded from L2 for every tap.  Now a block owns a 3D output tile of
//      TZ x 8 x 8 voxels (TZ = 2, or 4 on large grids) and, for each chunk
//      of 64 input channels, loads the (TZ + 2) x 10 x 10 input window
//      ("halo") into shared memory once, with cp.async zero-fill for the
//      out-of-bounds taps (no padded copy in device memory).  Mode A applies
//      silu(x*scale+shift) once per in-bounds window element, rounds it to
//      bf16 and stores it back; the padding stays 0.  The 27 taps then read
//      shifted windows of that tile.  Rows are 128 bytes with their 16-byte
//      chunks XOR-swizzled by the row index, so ldmatrix reads of 8
//      neighbouring voxels are free of bank conflicts.
//   2. mma.sync on 64x64 tiles with a register pipeline.  Now TZ consumer
//      warpgroups (one output plane, 64 rows, each) issue wgmma m64nBNk16
//      (BN = 64, or 128 where Cout is a multiple of 128) in its RS form: A
//      (voxels x 16 channels)
//      comes from the halo by ldmatrix, which takes any row addresses, so any
//      shifted window works; B, the taps' (BN x 64) slabs of wt, is staged in
//      a ring of 128-byte-swizzled shared-memory stages filled by cp.async
//      (2 stages of 3 taps at BN 64, of 9 in 4-plane blocks, 3 of one at
//      BN 128), read by wgmma
//      through a matrix descriptor; within a stage the next tap's fragments
//      load while the current tap's products run.  Two 2-plane blocks fit on
//      an SM, so one block's halo load and prologue hide behind the other's
//      products (one 2-plane block per SM, with a deeper ring, ran 1.5x
//      slower); a 4-plane block fills an SM alone and halves the weight
//      traffic per voxel, 9-11% faster at level 0 only.
//   3. No split-K.  Now, where the output tiles are fewer than the SMs
//      (132), the K walk (chunk-major over (chunk, tap) iterations) is cut
//      into `splits` contiguous ranges; each writes fp32 partials and
//      `splitk_reduce_kernel` sums them in a fixed order and runs the
//      epilogue.  The split count, tile and buffers come from the host-side
//      planner (`ops/conv3d.py` `plan_conv3d`), which this file checks.
// Epilogue: bias, residual, SiLU and the cast through a shared-memory tile
// with coalesced stores; with stats, each block (or reduce block) writes its
// per-channel partial [sum, sumsq] to its own row of a (rows, 2, Cout)
// buffer and `stats_reduce_kernel` sums the rows in a fixed order.  No float
// atomics anywhere: results are the same run to run and the launches can be
// captured in a CUDA graph.
//
// fp32 (`conv3d_ffma_kernel`) stays on plain FFMA (not TF32), so fp32
// results hold tightly against an fp32 reference: one block of 4 warps per
// 64-voxel x 64-channel tile (M flattened), Cin in chunks of 16, a two-stage
// register pipeline, each thread owning 8 voxels x 4 channels.  No main path
// runs it; the card-vs-CPU fp32 checks do.
//
// Launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum : int { kAffine = 1, kBias = 2, kResidual = 4, kStats = 8, kActivate = 16 };

struct Params {
  const void* x;       // (M, cin) in T
  const void* wt;      // (cout, 27 * cin) in T
  const float* scale;  // (cin,) prologue
  const float* shift;  // (cin,)
  const float* bias;   // (cout,)
  const void* res;     // (M, cout) in T
  void* out;           // (M, cout) in T
  float* partial;      // (stats rows, 2, cout)
  int d, h, w, cin, cout, m;
  bool vec;            // 16-byte loads of x and wt are aligned
  // (the fields above keep their offsets of the fp32 kernel's first version, so its code is unchanged)
  bool vec_out;        // 16-byte loads and stores of res and out are aligned
  float* split;        // (splits, M, cout) fp32 partial sums (bf16 split-K only)
  int b, splits, flags;
};

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// ---------------------------------------------------------------------------
// fp32: FFMA implicit GEMM over flattened 64-voxel x 64-channel tiles.

constexpr int kBM = 64;        // output voxels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kThreads = 128;  // 4 warps
constexpr int kPadF = 4;       // fp32 elements of row padding
constexpr int kSC = kBN + 1;   // row stride of the fp32 epilogue tile
constexpr int kSmemBytes = kBM * kSC * 4;  // the epilogue tile; the A/B tiles alias it

// 4 consecutive floats (16 bytes) from src, zeros where !ok or past `left`.
__device__ __forceinline__ uint4 load_chunk(const float* src, bool ok, int left, bool vec) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (ok && left > 0) {
    if (vec && left >= 4) {
      r = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      float* v = reinterpret_cast<float*>(&r);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < left) v[i] = src[i];
    }
  }
  return r;
}

template <bool AFF, bool BIAS, bool RES, bool STATS, bool ACT>
__global__ void __launch_bounds__(kThreads) conv3d_ffma_kernel(const Params p) {
  constexpr int E = 4;             // elements per 16-byte chunk
  constexpr int BK = 4 * E;        // K chunk: four chunks per tile row
  constexpr int SF = kBM + kPadF;  // tile row stride ([k][row])
  static_assert(kBM == kBN, "the A and B tiles share one row mapping");

  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const float* __restrict__ wt = static_cast<const float*>(p.wt);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int cin = p.cin, cout = p.cout, D = p.d, H = p.h, W = p.w;
  const int K = 27 * cin;
  const int cc = (tid & 3) * E;  // this thread's column in the A and B tiles

  // the two tile rows this thread loads: voxel m0 + row of A, channel n0 + row of B
  int vm[2], vz[2], vy[2], vx[2];
  bool vok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid >> 2) + 32 * i;
    vok[i] = m < p.m;
    vm[i] = m;
    vx[i] = m % W;
    const int r = m / W;
    vy[i] = r % H;
    vz[i] = (r / H) % D;
  }
  const int n_cchunks = (cin + BK - 1) / BK;
  const int n_iters = 27 * n_cchunks;

  uint4 ra[2], rb[2];
  bool aok[2];
  auto load = [&](int it) -> int {
    const int tap = it / n_cchunks;
    const int c = (it - tap * n_cchunks) * BK + cc;
    const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
    const int delta = ((dz - 1) * H + (dy - 1)) * W + (dx - 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int zi = vz[i] + dz - 1, yi = vy[i] + dy - 1, xi = vx[i] + dx - 1;
      const bool ok = vok[i] && zi >= 0 && zi < D && yi >= 0 && yi < H && xi >= 0 && xi < W;
      aok[i] = ok;
      ra[i] = load_chunk(ok ? x + (size_t)(vm[i] + delta) * cin + c : x, ok, cin - c, p.vec);
      const int n = n0 + (tid >> 2) + 32 * i;
      rb[i] = load_chunk(n < cout ? wt + (size_t)n * K + tap * cin + c : wt, n < cout, cin - c, p.vec);
    }
    return c;
  };

  float acc[8][4];  // [voxel][channel] of the micro-tile
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int tx = tid % 16, ty = tid / 16;  // micro-tile coordinates

  int cur_c = load(0);
  for (int it = 0; it < n_iters; ++it) {
    // registers -> shared memory, with the prologue on in-bounds elements
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + 32 * i;
      uint4 a = ra[i];
      if constexpr (AFF) {
        float* v = reinterpret_cast<float*>(&a);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int ch = cur_c + j;
          float f = 0.f;  // the padding taps and channels past cin stay 0
          if (aok[i] && ch < cin) f = silu(v[j] * __ldg(p.scale + ch) + __ldg(p.shift + ch));
          v[j] = f;
        }
      }
      float* sA = reinterpret_cast<float*>(smem);
      float* sB = sA + BK * SF;
      const float* va = reinterpret_cast<const float*>(&a);
      const float* vb = reinterpret_cast<const float*>(&rb[i]);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        sA[(cc + j) * SF + row] = va[j];
        sB[(cc + j) * SF + row] = vb[j];
      }
    }
    __syncthreads();
    int next_c = 0;
    if (it + 1 < n_iters) next_c = load(it + 1);  // in flight during the product below

    const float* sA = reinterpret_cast<const float*>(smem);
    const float* sB = sA + BK * SF;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(sA + k * SF + 8 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(sA + k * SF + 8 * ty + 4);
      const float4 b = *reinterpret_cast<const float4*>(sB + k * SF + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    cur_c = next_c;
  }

  // accumulators -> the fp32 epilogue tile (aliases the A/B tiles, now consumed)
  float* sC = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sC[(8 * ty + i) * kSC + 4 * tx + j] = acc[i][j];
  __syncthreads();

  const float* __restrict__ res = static_cast<const float*>(p.res);
  float* __restrict__ out = static_cast<float*>(p.out);
  for (int e = tid; e < kBM * kBN; e += kThreads) {
    const int row = e / kBN, col = e % kBN;
    const int m = m0 + row, n = n0 + col;
    float v = 0.f;
    if (m < p.m && n < cout) {
      v = sC[row * kSC + col];
      if constexpr (BIAS) v += __ldg(p.bias + n);
      if constexpr (RES) v += res[(size_t)m * cout + n];
      out[(size_t)m * cout + n] = ACT ? silu(v) : v;
    }
    sC[row * kSC + col] = v;  // masked entries add nothing to the stats
  }
  if constexpr (STATS) {
    __syncthreads();
    if (tid < kBN && n0 + tid < cout) {
      float s = 0.f, s2 = 0.f;
      for (int r = 0; r < kBM; ++r) {
        const float v = sC[r * kSC + tid];
        s += v;
        s2 += v * v;
      }
      p.partial[((size_t)blockIdx.x * 2) * cout + n0 + tid] = s;
      p.partial[((size_t)blockIdx.x * 2 + 1) * cout + n0 + tid] = s2;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma over a shared-memory halo tile.

// A block of TZ consumer warpgroups owns a TZ x 8 x 8 output tile: warpgroup
// w computes plane w, 64 rows.
constexpr int kChunk = 64;       // input channels per halo chunk: one 128-byte row per voxel

constexpr int kTY = 8, kTX = 8;
constexpr int kHX = kTX + 2, kHY = kTY + 2;  // the halo window is (TZ + 2) x 10 x 10 voxels

// the B ring of STAGES stages of TPS taps (1024-byte aligned for the 128-byte
// swizzle), then the halo; the 1024 leading bytes pay for aligning the
// dynamic shared memory base
template <int BN, int TPS, int STAGES, int TZ>
__host__ __device__ constexpr int wgmma_smem_bytes() {
  return 1024 + STAGES * TPS * BN * 128 + (TZ + 2) * kHY * kHX * 128;
}

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
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// keeps the compiler from moving accumulator reads or writes across the async wgmma
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma matrix descriptor of a K-major operand in 128-byte-swizzled rows:
// start address >> 4, leading offset 1 (unused when swizzled), stride 1024
// bytes between 8-row groups, layout 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// D (64 x BN, fp32) += A (64 x 16, bf16, registers) * B (16 x BN, bf16, descriptor)
template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc);

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Grid: (M-tiles, Cout / BN, splits); M-tile index = ((b * nz + iz) * ny + iy) * nx + ix.
// The K walk: iteration it = (chunk, tap group), chunk-major, 27 / TPS groups per chunk,
// through a ring of STAGES stages of TPS taps.
template <int BN, int TPS, int STAGES, int TZ, bool AFF>
__global__ void __launch_bounds__(128 * TZ, TZ == 2 ? 2 : 1) conv3d_wgmma_kernel(const Params p) {
  constexpr int TX = kTX, TY = kTY, HX = kHX, HY = kHY, HV = (TZ + 2) * kHY * kHX;
  constexpr int kWgThreads = 128 * TZ, kTileM = 64 * TZ, kTZ = TZ;
  constexpr int GROUPS = 27 / TPS;      // tap groups per chunk
  constexpr int kTapSlab = BN * 128;    // bytes of one tap's B: BN rows of 64 channels
  constexpr int kSlab = TPS * kTapSlab;  // bytes of one ring stage
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t sB = base;                   // STAGES slabs
  const uint32_t sH = base + STAGES * kSlab;  // the halo window, HV rows of 128 bytes
  unsigned char* const halo = sm + STAGES * kSlab;

  const __nv_bfloat16* __restrict__ x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* __restrict__ wt = static_cast<const __nv_bfloat16*>(p.wt);
  const int tid = threadIdx.x, D = p.d, H = p.h, W = p.w, cin = p.cin, cout = p.cout;
  const int nx = (W + TX - 1) / TX, ny = (H + TY - 1) / TY, nz = (D + kTZ - 1) / kTZ;
  int t = blockIdx.x;
  const int x0 = (t % nx) * TX;
  t /= nx;
  const int y0 = (t % ny) * TY;
  t /= ny;
  const int z0 = (t % nz) * kTZ;
  const int bb = t / nz;
  const int n0 = blockIdx.y * BN;
  const int n_it = GROUPS * ((cin + kChunk - 1) / kChunk);
  const int it0 = static_cast<int>((long long)blockIdx.z * n_it / p.splits);
  const int it1 = static_cast<int>((long long)(blockIdx.z + 1) * n_it / p.splits);
  const int n_local = it1 - it0;

  // halo row hv <-> input voxel (z0 + iz - 1, y0 + iy - 1, x0 + ix - 1); 16-byte chunk c
  // of row hv lives at chunk position c ^ (hv & 7)
  auto halo_voxel = [&](int hv, int& z, int& y, int& xx) -> bool {
    const int ix = hv % HX, iy = (hv / HX) % HY, iz = hv / (HX * HY);
    z = z0 + iz - 1;
    y = y0 + iy - 1;
    xx = x0 + ix - 1;
    return z >= 0 && z < D && y >= 0 && y < H && xx >= 0 && xx < W;
  };
  auto load_halo = [&](int chunk) {
    for (int e = tid; e < HV * 8; e += kWgThreads) {
      const int hv = e >> 3, c = e & 7, ch = chunk * kChunk + c * 8;
      int z, y, xx;
      const bool ok = halo_voxel(hv, z, y, xx) && ch < cin;
      const __nv_bfloat16* src = ok ? x + ((((size_t)bb * D + z) * H + y) * W + xx) * cin + ch : x;
      const int off = hv * 128 + ((c ^ (hv & 7)) << 4);
      if (p.vec) {
        cp_async16(sH + off, src, ok ? 16 : 0);
      } else {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        __nv_bfloat16* vv = reinterpret_cast<__nv_bfloat16*>(&v);
        for (int j = 0; j < 8; ++j)
          if (ok && ch + j < cin) vv[j] = src[j];
        *reinterpret_cast<uint4*>(halo + off) = v;
      }
    }
  };
  // mode A's prologue, once per in-bounds window element; the thread works on
  // the chunks it loaded itself (its column c is fixed: the stride is a
  // multiple of 8), so its own cp.async.wait suffices before it.
  auto transform = [&](int chunk) {
    const int c = tid & 7, ch0 = chunk * kChunk + c * 8;
    float sc[8], sf[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j] = ch0 + j < cin ? __ldg(p.scale + ch0 + j) : 0.f;
      sf[j] = ch0 + j < cin ? __ldg(p.shift + ch0 + j) : 0.f;
    }
    for (int e = tid; e < HV * 8; e += kWgThreads) {
      const int hv = e >> 3;
      int z, y, xx;
      if (!halo_voxel(hv, z, y, xx)) continue;  // the padding stays 0
      uint4* ptr = reinterpret_cast<uint4*>(halo + hv * 128 + ((c ^ (hv & 7)) << 4));
      uint4 v = *ptr;
      __nv_bfloat16* vv = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // channels past cin stay 0
        const float u = __bfloat162float(vv[j]) * sc[j] + sf[j];
        const float f = ch0 + j < cin ? __fdividef(u, 1.f + __expf(-u)) : 0.f;  // silu
        vv[j] = __float2bfloat16(f);  // t enters the product in bf16
      }
      *ptr = v;
    }
  };
  // local iteration j -> TPS (BN x 64) slabs of wt, one per tap of its (chunk, tap group), into
  // ring stage j % STAGES
  auto load_b = [&](int j) {
    const int it = it0 + j, chunk = it / GROUPS, tap0 = (it - chunk * GROUPS) * TPS;
    const int stage = (j % STAGES) * kSlab;
    for (int e = tid; e < TPS * BN * 8; e += kWgThreads) {
      const int tp = e / (BN * 8), n = (e >> 3) % BN, c = e & 7, ch = chunk * kChunk + c * 8;
      const bool ok = n0 + n < cout && ch < cin;
      const __nv_bfloat16* src = ok ? wt + (size_t)(n0 + n) * (27 * cin) + (tap0 + tp) * cin + ch : wt;
      const int off = stage + tp * kTapSlab + n * 128 + ((c ^ (n & 7)) << 4);
      if (p.vec) {
        cp_async16(sB + off, src, ok ? 16 : 0);
      } else {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        __nv_bfloat16* vv = reinterpret_cast<__nv_bfloat16*>(&v);
        for (int q = 0; q < 8; ++q)
          if (ok && ch + q < cin) vv[q] = src[q];
        *reinterpret_cast<uint4*>(sm + off) = v;
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // this lane's ldmatrix row of the tile, and its halo row at tap (0, 0, 0)
  const int lr = wg * 64 + warp * 16 + (lane & 15);
  const int h_lane = ((lr / (TX * TY)) * HY + (lr / TX) % TY) * HX + lr % TX;
  const int col8 = lane >> 4;

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_local) load_b(j);
    cp_async_commit();  // one group per stage, empty or not, so the wait counts hold
  }
  // A fragments of one tap: rows of its shifted window of the halo, 4 steps of 16 channels
  auto load_a = [&](uint32_t(&a)[4][4], int tap) {
    const int hrow = h_lane + ((tap / 9) * HY + (tap / 3) % 3) * HX + tap % 3;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) ldmatrix_x4(a[ks], sH + hrow * 128 + (((ks * 2 + col8) ^ (hrow & 7)) << 4));
  };
  int chunk_loaded = -1;
  for (int j = 0; j < n_local; ++j) {
    const int it = it0 + j, chunk = it / GROUPS, tap0 = (it - chunk * GROUPS) * TPS;
    if (chunk != chunk_loaded) {
      __syncthreads();  // every warp is done with the previous chunk's halo
      load_halo(chunk);
      cp_async_commit();
      cp_async_wait<0>();
      if constexpr (AFF) transform(chunk);
      chunk_loaded = chunk;
    }
    cp_async_wait<STAGES - 2>();  // this thread's part of stage j has landed
    fence_async_shared();
    __syncthreads();  // all of stage j (and the halo) is visible; stage j - 1 is consumed
    if (j + STAGES - 1 < n_local) load_b(j + STAGES - 1);
    cp_async_commit();

    // the next tap's A fragments load while the current tap's products run
    const uint32_t slab = sB + (j % STAGES) * kSlab;
    uint32_t a[2][4][4];
    load_a(a[0], tap0);
    fence_operands(acc);
#pragma unroll
    for (int tp = 0; tp < TPS; ++tp) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_rs<BN>(acc, a[tp & 1][ks], sw128_desc(slab + tp * kTapSlab + ks * 32));
      wgmma_commit();
      if (tp + 1 < TPS) {
        wgmma_wait<1>();  // tap tp - 1's products are done with the other fragment buffer
        load_a(a[(tp + 1) & 1], tap0 + tp + 1);
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
  }

  // accumulator element i of this thread: row (g, or g + 8) of its warp's 16,
  // column 8 * (i / 4) + 2 * t4 + (i & 1)
  const int g = lane >> 2, t4 = lane & 3;
  auto voxel_of = [&](int row, int& m) -> bool {
    const int z = z0 + row / (TX * TY), y = y0 + (row / TX) % TY, xx = x0 + row % TX;
    m = ((bb * D + z) * H + y) * W + xx;
    return z < D && y < H && xx < W;
  };
  if (p.splits > 1) {  // fp32 partial sums; splitk_reduce_kernel runs the epilogue
    float* __restrict__ split = p.split + (size_t)blockIdx.z * p.m * cout;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int row = wg * 64 + warp * 16 + g + 8 * ((i >> 1) & 1);
      const int n = n0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      int m;
      if (voxel_of(row, m) && n < cout) split[(size_t)m * cout + n] = acc[i];
    }
    return;
  }

  constexpr int SC = BN + 4;  // row stride of the fp32 epilogue tile
  static_assert(kTileM * SC * 4 <= STAGES * kSlab + HV * 128, "the epilogue tile fits in the ring and halo");
  __syncthreads();  // the ring and the halo are consumed: the epilogue tile aliases them
  float* sC = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int row = wg * 64 + warp * 16 + g + 8 * ((i >> 1) & 1);
    sC[row * SC + 8 * (i >> 2) + 2 * t4 + (i & 1)] = acc[i];
  }
  __syncthreads();
  const __nv_bfloat16* __restrict__ res = static_cast<const __nv_bfloat16*>(p.res);
  __nv_bfloat16* __restrict__ out = static_cast<__nv_bfloat16*>(p.out);
  const int flags = p.flags;
  const bool vec_out = p.vec_out;
  for (int e = tid; e < kTileM * BN / 8; e += kWgThreads) {  // 8 consecutive channels of one voxel
    const int row = e / (BN / 8), col = (e % (BN / 8)) * 8, n = n0 + col;
    float* v = sC + row * SC + col;
    int m;
    const bool ok = voxel_of(row, m);
    if (ok && vec_out && n + 8 <= cout) {
      uint4 r = make_uint4(0u, 0u, 0u, 0u), o;
      if (flags & kResidual) r = *reinterpret_cast<const uint4*>(res + (size_t)m * cout + n);
      const __nv_bfloat16* rv = reinterpret_cast<const __nv_bfloat16*>(&r);
      __nv_bfloat16* ov = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (flags & kBias) v[q] += __ldg(p.bias + n + q);
        if (flags & kResidual) v[q] += __bfloat162float(rv[q]);
        ov[q] = __float2bfloat16((flags & kActivate) ? silu(v[q]) : v[q]);
      }
      *reinterpret_cast<uint4*>(out + (size_t)m * cout + n) = o;
    } else {
      for (int q = 0; q < 8; ++q) {
        if (ok && n + q < cout) {
          if (flags & kBias) v[q] += __ldg(p.bias + n + q);
          if (flags & kResidual) v[q] += __bfloat162float(res[(size_t)m * cout + n + q]);
          out[(size_t)m * cout + n + q] = __float2bfloat16((flags & kActivate) ? silu(v[q]) : v[q]);
        } else {
          v[q] = 0.f;  // masked entries add nothing to the stats
        }
      }
    }
  }
  if (flags & kStats) {  // thread (part, col) sums rows part * R ... part * R + R - 1 in order, then
    constexpr int P = kWgThreads / BN, R = kTileM / P;  // thread row 0 sums the P partials in order
    static_assert(kTileM * SC * 4 + 2 * kWgThreads * 4 <= STAGES * kSlab + HV * 128, "the stats scratch fits");
    float* red = sC + kTileM * SC;
    __syncthreads();
    const int col = tid % BN, part = tid / BN;
    float s = 0.f, s2 = 0.f;
    for (int r = part * R; r < part * R + R; ++r) {
      const float v = sC[r * SC + col];
      s += v;
      s2 += v * v;
    }
    red[part * BN + col] = s;
    red[kWgThreads + part * BN + col] = s2;
    __syncthreads();
    if (tid < BN && n0 + tid < cout) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        a += red[q * BN + tid];
        b += red[kWgThreads + q * BN + tid];
      }
      p.partial[((size_t)blockIdx.x * 2) * cout + n0 + tid] = a;
      p.partial[((size_t)blockIdx.x * 2 + 1) * cout + n0 + tid] = b;
    }
  }
}

// The split-K epilogue: v = sum over s of split[s, m, n], in order s = 0, 1,
// ...; then bias, residual, stats, SiLU and the bf16 cast.  Block (32, 8) owns
// 64 rows x 32 channels; with stats it writes its per-channel [sum, sumsq]
// to row blockIdx.x of partial (ceil(m / 64), 2, cout), each thread summing
// its 8 rows in order, then thread row 0 summing the 8 partials in order.
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ split, const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ partial, int m, int cout, int splits, int flags) {
  __shared__ float red[2][8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n = blockIdx.y * 32 + tx;
  float s1 = 0.f, s2 = 0.f;
  if (n < cout) {
    for (int i = 0; i < 8; ++i) {
      const int r = blockIdx.x * 64 + ty + 8 * i;
      if (r >= m) break;
      float v = 0.f;
      for (int s = 0; s < splits; ++s) v += split[((size_t)s * m + r) * cout + n];
      if (flags & kBias) v += __ldg(bias + n);
      if (flags & kResidual) v += __bfloat162float(res[(size_t)r * cout + n]);
      s1 += v;
      s2 += v * v;
      out[(size_t)r * cout + n] = __float2bfloat16((flags & kActivate) ? silu(v) : v);
    }
  }
  if (flags & kStats) {
    red[0][ty][tx] = s1;
    red[1][ty][tx] = s2;
    __syncthreads();
    if (ty == 0 && n < cout) {
      float a = 0.f, b = 0.f;
      for (int i = 0; i < 8; ++i) {
        a += red[0][i][tx];
        b += red[1][i][tx];
      }
      partial[((size_t)blockIdx.x * 2) * cout + n] = a;
      partial[((size_t)blockIdx.x * 2 + 1) * cout + n] = b;
    }
  }
}

// stats[c] = sum over r of partial[r, c], for a (rows, cols) fp32 buffer, in a
// fixed order: thread (tx, ty) of a 32x32 block sums rows ty, ty + 32, ... of
// column blockIdx.x * 32 + tx, then row 0 of the block sums the 32 partials.
__global__ void __launch_bounds__(1024)
stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ stats, int rows, int cols) {
  __shared__ float red[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < cols) {
#pragma unroll 8
    for (int r = threadIdx.y; r < rows; r += 32) s += partial[(size_t)r * cols + col];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float t = 0.f;
    for (int i = 0; i < 32; ++i) t += red[i][threadIdx.x];
    stats[col] = t;
  }
}

#define JIG_FFMA_CASE(F)                                                                          \
  case F:                                                                                         \
    conv3d_ffma_kernel<((F)&kAffine) != 0, ((F)&kBias) != 0, ((F)&kResidual) != 0,              \
                       ((F)&kStats) != 0, ((F)&kActivate) != 0><<<grid, kThreads, 0, stream>>>(p); \
    break;

cudaError_t launch_ffma(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.m + kBM - 1) / kBM, (p.cout + kBN - 1) / kBN);
  switch (p.flags) {  // the fused ResBlock's 16 combinations, and conv3d's SiLU epilogue alone
    JIG_FFMA_CASE(0) JIG_FFMA_CASE(1) JIG_FFMA_CASE(2) JIG_FFMA_CASE(3)
    JIG_FFMA_CASE(4) JIG_FFMA_CASE(5) JIG_FFMA_CASE(6) JIG_FFMA_CASE(7)
    JIG_FFMA_CASE(8) JIG_FFMA_CASE(9) JIG_FFMA_CASE(10) JIG_FFMA_CASE(11)
    JIG_FFMA_CASE(12) JIG_FFMA_CASE(13) JIG_FFMA_CASE(14) JIG_FFMA_CASE(15)
    JIG_FFMA_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

#undef JIG_FFMA_CASE

template <int BN, int TPS, int STAGES, int TZ, bool AFF>
cudaError_t launch_wgmma_as(const Params& p, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes != wgmma_smem_bytes<BN, TPS, STAGES, TZ>()) return cudaErrorInvalidValue;  // the planner disagrees
  auto kernel = conv3d_wgmma_kernel<BN, TPS, STAGES, TZ, AFF>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  const long long mt = (long long)p.b * ((p.d + TZ - 1) / TZ) * ((p.h + kTY - 1) / kTY) * ((p.w + kTX - 1) / kTX);
  if (mt >= 0x7fffffffLL || p.splits > (27 / TPS) * ((p.cin + kChunk - 1) / kChunk))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(mt), (p.cout + BN - 1) / BN, p.splits);
  kernel<<<grid, 128 * TZ, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int BN, int TPS, int STAGES, int TZ>
cudaError_t launch_wgmma_aff(const Params& p, int smem_bytes, cudaStream_t s) {
  return (p.flags & kAffine) ? launch_wgmma_as<BN, TPS, STAGES, TZ, true>(p, smem_bytes, s)
                             : launch_wgmma_as<BN, TPS, STAGES, TZ, false>(p, smem_bytes, s);
}

// the (block width, taps per stage, stages, tile depth) the planner chooses from
cudaError_t launch_wgmma(const Params& p, int bn, int tps, int stages, int tz, int smem_bytes, cudaStream_t s) {
  if (bn == 64 && tps == 3 && stages == 2 && tz == 2) return launch_wgmma_aff<64, 3, 2, 2>(p, smem_bytes, s);
  if (bn == 128 && tps == 1 && stages == 3 && tz == 2) return launch_wgmma_aff<128, 1, 3, 2>(p, smem_bytes, s);
  if (bn == 64 && tps == 9 && stages == 2 && tz == 4) return launch_wgmma_aff<64, 9, 2, 4>(p, smem_bytes, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (b, d, h, w, cin); wt: (cout, 27 * cin), both in the dtype (0 = bf16,
// 1 = fp32); scale, shift: (cin,) fp32; bias: (cout,) fp32; residual, out:
// (b, d, h, w, cout) in the dtype.  flags: 1 prologue, 2 bias, 4 residual,
// 8 stats, 16 SiLU epilogue (alone).  The launch plan comes from
// `ops/conv3d.py` `plan_conv3d`: tile_z (bf16: output planes of a
// tile_z x 8 x 8 block tile; fp32: 1, with 64 flattened voxels a block), bn
// (output channels per block), tps and stages (bf16: taps per pipeline stage
// and stages in the ring; fp32: 27 and 1), splits (bf16: K ranges, each
// writing fp32 partials to split (splits, b*d*h*w, cout) when > 1, which
// jig_conv3d_splitk_reduce then sums; fp32: 1) and smem_bytes (checked
// against the kernel's own).  The combinations launch_wgmma lists are the
// ones built.  With stats and splits == 1 the kernel writes partial
// (M-tiles, 2, cout) fp32.  Pointers a flag does not ask for may be null.
// All contiguous.  Returns a cudaError_t (0 = launched).
extern "C" int jig_conv3d(const void* x, const void* wt, const void* scale, const void* shift,
                          const void* bias, const void* residual, void* out, void* partial, void* split,
                          int b, int d, int h, int w, int cin, int cout, int dtype, int flags, int tile_z, int bn, int tps, int stages, int splits, int smem_bytes,
                          void* stream) {
  if (b < 1 || d < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || (dtype != 0 && dtype != 1) || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m = (long long)b * d * h * w;
  if (m >= 0x7fffffffLL - (long long)h * w - w - 1 || 27LL * cin * cout >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (((flags & kAffine) && (!scale || !shift)) || ((flags & kBias) && !bias) ||
      ((flags & kResidual) && !residual) || ((flags & kStats) && splits == 1 && !partial) || !x || !wt ||
      !out || (splits > 1 && !split) || (flags & ~31))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.wt = wt;
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.bias = static_cast<const float*>(bias);
  p.res = residual;
  p.out = out;
  p.partial = static_cast<float*>(partial);
  p.split = static_cast<float*>(split);
  p.b = b;
  p.d = d;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cout = cout;
  p.m = static_cast<int>(m);
  p.splits = splits;
  p.flags = flags;
  const int e = dtype == 0 ? 8 : 4;
  p.vec = cin % e == 0 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt)) % 16 == 0;
  p.vec_out = cout % e == 0 && (reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(residual)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (tile_z != 1 || bn != kBN || tps != 27 || stages != 1 || splits != 1 || smem_bytes != kSmemBytes)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_ffma(p, s));
  }
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_wgmma(p, bn, tps, stages, tile_z, smem_bytes, s));
}

// out (m, cout) bf16 = epilogue(sum over s of split (splits, m, cout) fp32):
// + bias, + residual (bf16), SiLU (flags as jig_conv3d's; the prologue flag
// is ignored); with stats, partial (ceil(m / 64), 2, cout) fp32 per-row-block
// sums.  Returns a cudaError_t.
extern "C" int jig_conv3d_splitk_reduce(const void* split, const void* bias, const void* residual, void* out,
                                        void* partial, int m, int cout, int splits, int flags, void* stream) {
  if (m < 1 || cout < 1 || splits < 1 || !split || !out || ((flags & kBias) && !bias) ||
      ((flags & kResidual) && !residual) || ((flags & kStats) && !partial))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + 63) / 64, (cout + 31) / 32);
  splitk_reduce_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(split), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(residual), static_cast<__nv_bfloat16*>(out), static_cast<float*>(partial),
      m, cout, splits, flags);
  return static_cast<int>(cudaGetLastError());
}

// stats (cols,) = the sum over rows of partial (rows, cols), fp32, in a fixed
// order.  Returns a cudaError_t.
extern "C" int jig_conv3d_stats_reduce(const void* partial, void* stats, int rows, int cols,
                                       void* stream) {
  if (rows < 1 || cols < 1 || !partial || !stats) return static_cast<int>(cudaErrorInvalidValue);
  stats_reduce_kernel<<<(cols + 31) / 32, dim3(32, 32), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(stats), rows, cols);
  return static_cast<int>(cudaGetLastError());
}
