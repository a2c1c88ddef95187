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
// GEMM view: M = B*D*H*W output voxels (flattened, so one tile may span rows,
// planes and batch items: any W, D or batch), N = Cout, K = 27*Cin in
// (dz, dy, dx, c) order, i.e. JAX's `kernel.reshape(27 * cin, cout)`.  The
// weight arrives as its transpose, wt (Cout, 27*Cin), so each output channel's
// K row is contiguous.  Ragged M, N and Cin are masked with zeros.
//
// Bound on an H100 SXM.  2*M*27*Cin*Cout flops against one read of x, the
// weight and the residual and one write of the output: at stage 1's level 0
// (64x128x128, 64 -> 64, bf16) 2.32e11 flops are 0.235 ms at 989 TFLOP/s,
// while the ~0.27 GB of traffic is 0.08 ms at 3.35 TB/s, so the conv is
// bound by the tensor cores' operations, at every level of the UNet.
//
// Design (simple and right first):
//   * one block of 4 warps per 64-voxel x 64-channel output tile; the K loop
//     walks the 27 taps and, within each, Cin in chunks of 32 (bf16) or 16
//     (fp32).  The halo is bounds-checked loads that write zeros: no padded
//     copy of the input in device memory;
//   * the next chunk's A (voxels x channels) and B (channels x Cout) tiles are
//     loaded from global memory into registers while the current chunk's
//     product runs from shared memory (a two-stage register pipeline);
//   * bf16: mma.sync.m16n8k16 with fp32 accumulators (flash_mma.cuh), each
//     warp owning 16 voxels x 64 channels; fp32: plain FFMA (not TF32), each
//     thread owning 8 voxels x 4 channels, so fp32 results hold tightly
//     against an fp32 reference;
//   * epilogue through shared memory: bias, residual, SiLU and the cast, with
//     coalesced stores; with stats, each block writes its per-channel partial
//     [sum, sumsq] to row blockIdx.x of a (num_m_blocks, 2, Cout) buffer, and
//     `stats_reduce_kernel` sums the rows in a fixed order.  No float atomics:
//     results are the same run to run and the launches can be captured in a
//     CUDA graph.
// Why it sits well below the bound: mma.sync instead of wgmma, no cp.async or
// TMA pipeline (the register stage hides only part of the load latency),
// per-element halo checks, and 64-wide tiles whose A and B are re-read from
// global memory (L2) by every block.  Those are later work.
//
// Launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_mma.cuh"

namespace {

constexpr int kBM = 64;        // output voxels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kThreads = 128;  // 4 warps
constexpr int kPadH = 8;       // bf16 elements of row padding in the A/B tiles
constexpr int kPadF = 4;       // fp32 elements of row padding
constexpr int kSC = kBN + 1;   // row stride of the fp32 epilogue tile
constexpr int kSmemBytes = kBM * kSC * 4;  // the epilogue tile; the A/B tiles alias it

enum : int { kAffine = 1, kBias = 2, kResidual = 4, kStats = 8, kActivate = 16 };

struct Params {
  const void* x;       // (M, cin) in T
  const void* wt;      // (cout, 27 * cin) in T
  const float* scale;  // (cin,) prologue
  const float* shift;  // (cin,)
  const float* bias;   // (cout,)
  const void* res;     // (M, cout) in T
  void* out;           // (M, cout) in T
  float* partial;      // (gridDim.x, 2, cout)
  int d, h, w, cin, cout, m;
  bool vec;            // 16-byte loads of x and wt are aligned
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype / .to do
}
__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// E consecutive elements (16 bytes) from src, zeros where !ok or past `left`.
template <typename T, int E>
__device__ __forceinline__ uint4 load_chunk(const T* src, bool ok, int left, bool vec) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (ok && left > 0) {
    if (vec && left >= E) {
      r = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      T* v = reinterpret_cast<T*>(&r);
#pragma unroll
      for (int i = 0; i < E; ++i)
        if (i < left) v[i] = src[i];
    }
  }
  return r;
}

template <typename T, bool AFF, bool BIAS, bool RES, bool STATS, bool ACT>
__global__ void __launch_bounds__(kThreads) conv3d_kernel(const Params p) {
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int BK = 4 * E;          // K chunk: four chunks per tile row
  constexpr int SH = BK + kPadH;     // bf16 tile row stride ([row][k])
  constexpr int SF = kBM + kPadF;    // fp32 tile row stride ([k][row])
  static_assert(kBM == kBN, "the A and B tiles share one row mapping");

  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ wt = static_cast<const T*>(p.wt);
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
      ra[i] = load_chunk<T, E>(ok ? x + (size_t)(vm[i] + delta) * cin + c : x, ok, cin - c, p.vec);
      const int n = n0 + (tid >> 2) + 32 * i;
      rb[i] = load_chunk<T, E>(n < cout ? wt + (size_t)n * K + tap * cin + c : wt, n < cout, cin - c,
                               p.vec);
    }
    return c;
  };

  float acc[8][4];  // bf16: [n-tile][fragment]; fp32: [voxel][channel] of the micro-tile
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates (bf16)
  const int tx = tid % 16, ty = tid / 16;  // FFMA micro-tile coordinates (fp32)

  int cur_c = load(0);
  for (int it = 0; it < n_iters; ++it) {
    // registers -> shared memory, with the prologue on in-bounds elements
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + 32 * i;
      uint4 a = ra[i];
      if constexpr (AFF) {
        T* v = reinterpret_cast<T*>(&a);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int ch = cur_c + j;
          float f = 0.f;  // the padding taps and channels past cin stay 0
          if (aok[i] && ch < cin) f = silu(to_f(v[j]) * __ldg(p.scale + ch) + __ldg(p.shift + ch));
          v[j] = from_f<T>(f);  // t enters the product in the input dtype
        }
      }
      if constexpr (kBF16) {
        __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
        __nv_bfloat16* sB = sA + kBM * SH;
        *reinterpret_cast<uint4*>(sA + row * SH + cc) = a;
        *reinterpret_cast<uint4*>(sB + row * SH + cc) = rb[i];
      } else {
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
    }
    __syncthreads();
    int next_c = 0;
    if (it + 1 < n_iters) next_c = load(it + 1);  // in flight during the product below

    if constexpr (kBF16) {
      const __nv_bfloat16* sA = reinterpret_cast<const __nv_bfloat16*>(smem);
      const __nv_bfloat16* sB = sA + kBM * SH;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[4];
        load_a_frag(af, sA + warp * 16 * SH, SH, ks, g, t4);
#pragma unroll
        for (int nt = 0; nt < kBN / 8; ++nt) {
          const __nv_bfloat16* br = sB + (nt * 8 + g) * SH + ks * 16 + t4 * 2;
          mma_16816(acc[nt], af, lds32(br), lds32(br + 8));
        }
      }
    } else {
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
    }
    __syncthreads();
    cur_c = next_c;
  }

  // accumulators -> the fp32 epilogue tile (aliases the A/B tiles, now consumed)
  float* sC = reinterpret_cast<float*>(smem);
  if constexpr (kBF16) {
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      const int col = nt * 8 + 2 * t4, r0 = warp * 16 + g;
      sC[r0 * kSC + col] = acc[nt][0];
      sC[r0 * kSC + col + 1] = acc[nt][1];
      sC[(r0 + 8) * kSC + col] = acc[nt][2];
      sC[(r0 + 8) * kSC + col + 1] = acc[nt][3];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sC[(8 * ty + i) * kSC + 4 * tx + j] = acc[i][j];
  }
  __syncthreads();

  const T* __restrict__ res = static_cast<const T*>(p.res);
  T* __restrict__ out = static_cast<T*>(p.out);
  for (int e = tid; e < kBM * kBN; e += kThreads) {
    const int row = e / kBN, col = e % kBN;
    const int m = m0 + row, n = n0 + col;
    float v = 0.f;
    if (m < p.m && n < cout) {
      v = sC[row * kSC + col];
      if constexpr (BIAS) v += __ldg(p.bias + n);
      if constexpr (RES) v += to_f(res[(size_t)m * cout + n]);
      out[(size_t)m * cout + n] = from_f<T>(ACT ? silu(v) : v);
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

#define JIG_CONV_CASE(F)                                                                          \
  case F:                                                                                        \
    conv3d_kernel<T, ((F)&kAffine) != 0, ((F)&kBias) != 0, ((F)&kResidual) != 0,                \
                  ((F)&kStats) != 0, ((F)&kActivate) != 0><<<grid, kThreads, 0, stream>>>(p); \
    break;

template <typename T>
cudaError_t launch_conv(const Params& p, int flags, cudaStream_t stream) {
  const dim3 grid((p.m + kBM - 1) / kBM, (p.cout + kBN - 1) / kBN);
  switch (flags) {  // the fused ResBlock's 16 combinations, and conv3d's SiLU epilogue alone
    JIG_CONV_CASE(0) JIG_CONV_CASE(1) JIG_CONV_CASE(2) JIG_CONV_CASE(3)
    JIG_CONV_CASE(4) JIG_CONV_CASE(5) JIG_CONV_CASE(6) JIG_CONV_CASE(7)
    JIG_CONV_CASE(8) JIG_CONV_CASE(9) JIG_CONV_CASE(10) JIG_CONV_CASE(11)
    JIG_CONV_CASE(12) JIG_CONV_CASE(13) JIG_CONV_CASE(14) JIG_CONV_CASE(15)
    JIG_CONV_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

#undef JIG_CONV_CASE

}  // namespace

// x: (b, d, h, w, cin); wt: (cout, 27 * cin), both in the dtype (0 = bf16,
// 1 = fp32); scale, shift: (cin,) fp32; bias: (cout,) fp32; residual, out:
// (b, d, h, w, cout) in the dtype; partial: (ceil(b*d*h*w / 64), 2, cout)
// fp32.  flags: 1 prologue, 2 bias, 4 residual, 8 stats, 16 SiLU epilogue
// (alone).  Pointers a flag does not ask for may be null.  All contiguous.
// Returns a cudaError_t (0 = launched).
extern "C" int jig_conv3d(const void* x, const void* wt, const void* scale, const void* shift,
                          const void* bias, const void* residual, void* out, void* partial, int b,
                          int d, int h, int w, int cin, int cout, int dtype, int flags,
                          void* stream) {
  if (b < 1 || d < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m = (long long)b * d * h * w;
  if (m >= 0x7fffffffLL - (long long)h * w - w - 1 || 27LL * cin * cout >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (((flags & kAffine) && (!scale || !shift)) || ((flags & kBias) && !bias) ||
      ((flags & kResidual) && !residual) || ((flags & kStats) && !partial) || !x || !wt || !out)
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
  p.d = d;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cout = cout;
  p.m = static_cast<int>(m);
  const int e = dtype == 0 ? 8 : 4;
  p.vec = cin % e == 0 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? launch_conv<__nv_bfloat16>(p, flags, s)
                                     : launch_conv<float>(p, flags, s));
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
