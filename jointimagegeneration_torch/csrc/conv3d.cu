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
// fp32 design (`conv3d_ffma_kernel`): plain FFMA (not TF32, which keeps a
// 10-bit mantissa), so fp32 results hold tightly against an fp32 reference
// and the bound is 2*M*27*Cin*Cout flops at 67 TFLOP/s (at level 1,
// 32x64x64, 128 -> 128: 1.73 ms).  The bf16 design carried over to FFMA:
//   * A block of 256 threads owns a 4 x 8 x 8 output tile x 64 channels.
//     For each chunk of 16 input channels, the (4 + 2) x 10 x 10 halo is
//     loaded once by cp.async (zero-filled past the volume and Cin) into a
//     voxel-major staging buffer while the previous chunk is computed, then
//     transposed once into channel-major halo planes, rows of 12 floats per
//     (z, y): mode A's silu(x * scale + shift) is applied there, once per
//     in-bounds element (the padding stays 0).  The 27 taps read that halo.
//   * The weight arrives as the DHWIO kernel reshaped, (27 * Cin, Cout), so
//     a tap's (16, 64) slab is 16 rows of 64 contiguous floats; slabs of the
//     three taps dx = 0, 1, 2 of one (dz, dy) stream through a two-stage
//     cp.async ring: K iteration = (chunk, (dz, dy)), chunk-major.
//   * Each thread owns 8 voxels (x = 0 ... 7 of one (z, y) row of the tile) x
//     8 channels (4 tx ... 4 tx + 3 and 32 + 4 tx ...): per input channel it
//     reads its halo row as three float4 (x 0 ... 11, shared by the three dx
//     taps) and per tap two float4 of weights, 9 shared loads for 192 FMAs;
//     the 8 threads of a quarter-warp read one halo row (broadcast) and 32
//     consecutive weights (conflict-free).
//   * Split-K where the blocks are fewer than the SMs, as in bf16: ranges of
//     K iterations write fp32 partials and `splitk_reduce_kernel<float>` sums
//     them in order and runs the epilogue.
// Epilogue: bias, residual, SiLU from registers, float4 stores; with stats,
// each thread sums its 8 voxels per channel, the 32 row threads of a
// channel are summed in order through shared memory, and the block's
// [sum, sumsq] row goes to the (rows, 2, Cout) buffer `stats_reduce_kernel`
// sums.  Two blocks on an SM (at most 128 registers a thread).
//
// Launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

enum : int { kAffine = 1, kBias = 2, kResidual = 4, kStats = 8, kActivate = 16 };

struct Params {
  const void* x;       // (M, cin) in T
  const void* wt;      // in T: bf16 (cout, 27 * cin); fp32 (27 * cin, cout), the DHWIO kernel reshaped
  const float* scale;  // (cin,) prologue
  const float* shift;  // (cin,)
  const float* bias;   // (cout,)
  const void* res;     // (M, cout) in T
  void* out;           // (M, cout) in T
  float* partial;      // (stats rows, 2, cout)
  int d, h, w, cin, cout, m;
  bool vec;            // 16-byte loads of x and wt are aligned
  bool vec_out;        // 16-byte loads and stores of res and out are aligned
  float* split;        // (splits, M, cout) fp32 partial sums (split-K)
  int b, splits, flags;
};

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// ---------------------------------------------------------------------------
// fp32: FFMA over a shared-memory halo tile.

constexpr int kFTZ = 4;                          // output planes of a block tile (4 x 8 x 8 voxels)
constexpr int kFBN = 64;                         // output channels per block
constexpr int kFKC = 16;                         // input channels per halo chunk
constexpr int kFThreads = 256;                   // 32 tile rows (z, y) x 8 channel groups
constexpr int kFStages = 2;                      // ring stages, each the 3 taps of one (dz, dy)
constexpr int kFHV = (kFTZ + 2) * 10 * 10;       // halo voxels
constexpr int kFRow = 12;                        // floats of a halo row: x 0 ... 9 and 2 unused
constexpr int kFPlane = (kFTZ + 2) * 10 * kFRow + 4;  // floats of one channel's halo plane (+4: fewer bank conflicts)
constexpr int kFSlab = 3 * kFKC * kFBN;          // floats of one ring stage: [dx][channel][n]
constexpr int kFSmemBytes = 4 * (kFStages * kFSlab + kFKC * kFPlane + kFHV * kFKC);
static_assert(2 * 32 * kFBN <= kFStages * kFSlab, "the stats scratch fits in the ring");

template <bool AFF>
__global__ void __launch_bounds__(kFThreads, 2) conv3d_ffma_kernel(const Params p) {
  extern __shared__ __align__(16) float smf[];
  float* const ring = smf;                          // kFStages slabs
  float* const halo = ring + kFStages * kFSlab;     // [channel][(z, y)][x], planes of kFPlane
  float* const stg = halo + kFKC * kFPlane;         // [halo voxel][channel], the next chunk's copies

  const float* __restrict__ x = static_cast<const float*>(p.x);
  const float* __restrict__ wk = static_cast<const float*>(p.wt);
  const int tid = threadIdx.x, D = p.d, H = p.h, W = p.w, cin = p.cin, cout = p.cout;
  const int nx = (W + 7) / 8, ny = (H + 7) / 8, nz = (D + kFTZ - 1) / kFTZ;
  int t = blockIdx.x;
  const int x0 = (t % nx) * 8;
  t /= nx;
  const int y0 = (t % ny) * 8;
  t /= ny;
  const int z0 = (t % nz) * kFTZ;
  const int bb = t / nz;
  const int n0 = blockIdx.y * kFBN;
  const int n_it = 9 * ((cin + kFKC - 1) / kFKC);
  const int it0 = static_cast<int>((long long)blockIdx.z * n_it / p.splits);
  const int it1 = static_cast<int>((long long)(blockIdx.z + 1) * n_it / p.splits);
  const int n_local = it1 - it0;
  const int tx = tid & 7, ty = tid >> 3, oz = ty >> 3, oy = ty & 7;

  // halo voxel hv <-> input voxel (z0 + iz - 1, y0 + iy - 1, x0 + ix - 1)
  auto halo_voxel = [&](int hv, int& ix, int& iy, int& iz) -> bool {
    ix = hv % 10;
    iy = (hv / 10) % 10;
    iz = hv / 100;
    const int z = z0 + iz - 1, y = y0 + iy - 1, xx = x0 + ix - 1;
    return z >= 0 && z < D && y >= 0 && y < H && xx >= 0 && xx < W;
  };
  // chunk c's halo, voxel-major, into the staging buffer: zeros past the volume and cin
  auto load_staging = [&](int c) {
    for (int e = tid; e < kFHV * (kFKC / 4); e += kFThreads) {
      const int hv = e >> 2, ch = c * kFKC + (e & 3) * 4;
      int ix, iy, iz;
      const bool in = halo_voxel(hv, ix, iy, iz);
      const float* src = in ? x + ((((size_t)bb * D + z0 + iz - 1) * H + y0 + iy - 1) * W + x0 + ix - 1) * cin + ch : x;
      float* dst = stg + hv * kFKC + (e & 3) * 4;
      if (p.vec) {
        const bool ok = in && ch < cin;
        cp_async16(smem_u32(dst), src, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) dst[q] = in && ch + q < cin ? src[q] : 0.f;
      }
    }
  };
  // staging -> the channel-major halo planes, with mode A's prologue on in-bounds elements; a
  // thread's channel is fixed (the stride is a multiple of kFKC)
  auto transpose = [&](int c) {
    const int cl = tid & (kFKC - 1), ch = c * kFKC + cl;
    float sc = 0.f, sf = 0.f;
    if (AFF && ch < cin) {
      sc = __ldg(p.scale + ch);
      sf = __ldg(p.shift + ch);
    }
    for (int e = tid; e < kFHV * kFKC; e += kFThreads) {
      const int hv = e / kFKC;
      int ix, iy, iz;
      const bool in = halo_voxel(hv, ix, iy, iz);
      float v = stg[e];
      if (AFF) v = in && ch < cin ? silu(fmaf(v, sc, sf)) : 0.f;  // the padding and channels past cin stay 0
      halo[cl * kFPlane + (iz * 10 + iy) * kFRow + ix] = v;
    }
  };
  // local iteration j = (chunk, (dz, dy)) -> the (16, 64) slabs of its taps dx = 0, 1, 2 into stage j % 2
  auto load_b = [&](int j) {
    const int it = it0 + j, c = it / 9, r9 = it - c * 9;
    float* const slab = ring + (j & 1) * kFSlab;
    for (int e = tid; e < 3 * kFKC * (kFBN / 4); e += kFThreads) {
      const int dx = e / (kFKC * kFBN / 4), k = (e / (kFBN / 4)) % kFKC, n = (e % (kFBN / 4)) * 4;
      const int ch = c * kFKC + k, tap = r9 * 3 + dx;
      const bool in = ch < cin;
      const float* src = in ? wk + ((size_t)tap * cin + ch) * cout + n0 + n : wk;
      float* dst = slab + (dx * kFKC + k) * kFBN + n;
      if (p.vec) {
        const bool ok = in && n0 + n < cout;
        cp_async16(smem_u32(dst), ok ? src : wk, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) dst[q] = in && n0 + n + q < cout ? src[q] : 0.f;
      }
    }
  };

  float acc[8][8];  // [x][channel: 4 tx + j for j < 4, 32 + 4 tx + j - 4 above]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (n_local > 0) {
    load_staging(it0 / 9);
    load_b(0);
  }
  cp_async_commit();
  int chunk_loaded = -1;
  for (int j = 0; j < n_local; ++j) {
    const int it = it0 + j, c = it / 9, r9 = it - c * 9;
    if (c != chunk_loaded) {
      cp_async_wait<0>();
      __syncthreads();  // the staging copies (and stage j) have landed, from every thread
      transpose(c);
      __syncthreads();  // the halo is complete and the staging free
      if ((c + 1) * 9 < it1) load_staging(c + 1);  // joins stage j + 1's group, under this chunk's products
      chunk_loaded = c;
    }
    if (j + 1 < n_local) load_b(j + 1);  // into the stage iteration j - 1 consumed
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage j is visible

    const float* slab = ring + (j & 1) * kFSlab;
    const float* arow = halo + ((oz + r9 / 3) * 10 + oy + r9 % 3) * kFRow;
#pragma unroll
    for (int k = 0; k < kFKC; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(arow + k * kFPlane);
      const float4 a1 = *reinterpret_cast<const float4*>(arow + k * kFPlane + 4);
      const float4 a2 = *reinterpret_cast<const float4*>(arow + k * kFPlane + 8);
      const float a[12] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x, a2.y, a2.z, a2.w};
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* b = slab + (dx * kFKC + k) * kFBN + 4 * tx;
        const float4 b0 = *reinterpret_cast<const float4*>(b);
        const float4 b1 = *reinterpret_cast<const float4*>(b + 32);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jn = 0; jn < 8; ++jn) acc[i][jn] = fmaf(a[i + dx], bv[jn], acc[i][jn]);
      }
    }
    __syncthreads();  // stage j (and, at a chunk's end, the halo) is consumed
  }
  cp_async_wait<0>();

  const int z = z0 + oz, y = y0 + oy;
  const bool row_ok = z < D && y < H;
  const size_t mrow = (((size_t)bb * D + z) * H + y) * W;  // voxel index of (z, y, x = 0)
  if (p.splits > 1) {  // fp32 partial sums; splitk_reduce_kernel runs the epilogue
    float* __restrict__ split = p.split + (size_t)blockIdx.z * p.m * cout;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!row_ok || x0 + i >= W) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + 32 * h + 4 * tx;
        float* o = split + (mrow + x0 + i) * cout + n;
        if (p.vec_out && n < cout) {
          *reinterpret_cast<float4*>(o) = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                                      acc[i][4 * h + 3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (n + q < cout) o[q] = acc[i][4 * h + q];
        }
      }
    }
    return;
  }

  const float* __restrict__ res = static_cast<const float*>(p.res);
  float* __restrict__ out = static_cast<float*>(p.out);
  const int flags = p.flags;
  float s1[8] = {}, s2[8] = {};  // this thread's per-channel sums over its voxels
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + 32 * h + 4 * tx;
    float bias[4] = {};
    if (flags & kBias) {
#pragma unroll
      for (int q = 0; q < 4; ++q) bias[q] = n + q < cout ? __ldg(p.bias + n + q) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!row_ok || x0 + i >= W) continue;
      const size_t off = (mrow + x0 + i) * cout + n;
      float v[4], r[4] = {};
      if (flags & kResidual) {
        if (p.vec_out && n < cout) {
          const float4 rv = *reinterpret_cast<const float4*>(res + off);
          r[0] = rv.x, r[1] = rv.y, r[2] = rv.z, r[3] = rv.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) r[q] = n + q < cout ? res[off + q] : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = n + q < cout ? acc[i][4 * h + q] + bias[q] + r[q] : 0.f;  // masked entries add nothing to the stats
        s1[4 * h + q] += v[q];
        s2[4 * h + q] += v[q] * v[q];
        if (flags & kActivate) v[q] = silu(v[q]);
      }
      if (p.vec_out && n < cout) {
        *reinterpret_cast<float4*>(out + off) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < cout) out[off + q] = v[q];
      }
    }
  }
  if (flags & kStats) {  // the 32 row threads of each channel, summed in order of ty
    float* const red = ring;  // (2, 32, 64): the ring is consumed
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        red[ty * kFBN + 32 * h + 4 * tx + q] = s1[4 * h + q];
        red[32 * kFBN + ty * kFBN + 32 * h + 4 * tx + q] = s2[4 * h + q];
      }
    __syncthreads();
    if (tid < kFBN && n0 + tid < cout) {
      float a = 0.f, b = 0.f;
      for (int r = 0; r < 32; ++r) {
        a += red[r * kFBN + tid];
        b += red[32 * kFBN + r * kFBN + tid];
      }
      p.partial[((size_t)blockIdx.x * 2) * cout + n0 + tid] = a;
      p.partial[((size_t)blockIdx.x * 2 + 1) * cout + n0 + tid] = b;
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
      for (int ks = 0; ks < 4; ++ks) wgmma_rs<BN>(acc, a[tp & 1][ks], kmajor_desc<128>(slab + tp * kTapSlab + ks * 32));
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

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The split-K epilogue: v = sum over s of split[s, m, n], in order s = 0, 1,
// ...; then bias, residual, stats, SiLU and the cast to T (bf16 or fp32).
// Block (32, 8) owns 64 rows x 32 channels; with stats it writes its
// per-channel [sum, sumsq] to row blockIdx.x of partial (ceil(m / 64), 2,
// cout), each thread summing its 8 rows in order, then thread row 0 summing
// the 8 partials in order.
template <typename T>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ split, const float* __restrict__ bias, const T* __restrict__ res,
                     T* __restrict__ out, float* __restrict__ partial, int m, int cout, int splits, int flags) {
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
      if (flags & kResidual) v += load_f(res + (size_t)r * cout + n);
      s1 += v;
      s2 += v * v;
      store_f(out + (size_t)r * cout + n, (flags & kActivate) ? silu(v) : v);
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

cudaError_t launch_ffma(const Params& p, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes != kFSmemBytes) return cudaErrorInvalidValue;  // the planner disagrees
  const long long mt = (long long)p.b * ((p.d + kFTZ - 1) / kFTZ) * ((p.h + 7) / 8) * ((p.w + 7) / 8);
  if (mt >= 0x7fffffffLL || p.splits > 9 * ((p.cin + kFKC - 1) / kFKC)) return cudaErrorInvalidValue;
  auto kernel = (p.flags & kAffine) ? conv3d_ffma_kernel<true> : conv3d_ffma_kernel<false>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(mt), (p.cout + kFBN - 1) / kFBN, p.splits);
  kernel<<<grid, kFThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

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

// x: (b, d, h, w, cin); wt: bf16 (cout, 27 * cin), fp32 (27 * cin, cout)
// (the DHWIO kernel reshaped), both in the dtype (0 = bf16, 1 = fp32);
// scale, shift: (cin,) fp32; bias: (cout,) fp32; residual, out: (b, d, h, w,
// cout) in the dtype.  flags: 1 prologue, 2 bias, 4 residual, 8 stats, 16
// SiLU epilogue (alone).  The launch plan comes from `ops/conv3d.py`
// `plan_conv3d`: tile_z (output planes of a tile_z x 8 x 8 block tile), bn
// (output channels per block), tps and stages (taps per pipeline stage and
// stages in the ring; fp32: 3 and 2), splits (K ranges, each writing fp32
// partials to split (splits, b*d*h*w, cout) when > 1, which
// jig_conv3d_splitk_reduce then sums) and smem_bytes (checked against the
// kernel's own).  The combinations launch_wgmma lists are the bf16 ones
// built; fp32 has one (4, 64, 3, 2).  With stats and splits == 1 the kernel writes partial
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
  p.vec = cin % e == 0 && (dtype == 0 || cout % 4 == 0) &&
          (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt)) % 16 == 0;
  p.vec_out = cout % e == 0 && (reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(residual) |
                                reinterpret_cast<uintptr_t>(split)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (tile_z != kFTZ || bn != kFBN || tps != 3 || stages != kFStages) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_ffma(p, smem_bytes, s));
  }
  return static_cast<int>(launch_wgmma(p, bn, tps, stages, tile_z, smem_bytes, s));
}

// out (m, cout) in the dtype (0 = bf16, 1 = fp32) = epilogue(sum over s of
// split (splits, m, cout) fp32): + bias, + residual (in the dtype), SiLU
// (flags as jig_conv3d's; the prologue flag is ignored); with stats, partial
// (ceil(m / 64), 2, cout) fp32 per-row-block sums.  Returns a cudaError_t.
extern "C" int jig_conv3d_splitk_reduce(const void* split, const void* bias, const void* residual, void* out,
                                        void* partial, int m, int cout, int splits, int flags, int dtype,
                                        void* stream) {
  if (m < 1 || cout < 1 || splits < 1 || !split || !out || ((flags & kBias) && !bias) ||
      ((flags & kResidual) && !residual) || ((flags & kStats) && !partial) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + 63) / 64, (cout + 31) / 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* part = static_cast<float*>(partial);
  if (dtype == 0) {
    splitk_reduce_kernel<__nv_bfloat16><<<grid, dim3(32, 8), 0, s>>>(
        static_cast<const float*>(split), b, static_cast<const __nv_bfloat16*>(residual),
        static_cast<__nv_bfloat16*>(out), part, m, cout, splits, flags);
  } else {
    splitk_reduce_kernel<float><<<grid, dim3(32, 8), 0, s>>>(static_cast<const float*>(split), b,
                                                             static_cast<const float*>(residual),
                                                             static_cast<float*>(out), part, m, cout, splits, flags);
  }
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
