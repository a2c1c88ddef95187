// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel family in jointimagegeneration_tpu/ops/pallas/
// flash_attention.py: `_flash_kernel_unrolled` (the default forward),
// `_flash_kernel` (grid k-loop) and `_flash_kernel_pipelined`, all three
// entered through `_flash_forward`.  They compute one function, so one kernel
// covers them:
//
//   O[bh, i, :] = softmax_j(q[bh, i, :] . k[bh, j, :]) @ v[bh, j, :]
//   LSE[bh, i]  = log sum_j exp(q[bh, i, :] . k[bh, j, :])
//
// on (BH, T, D) row-major tensors, q already scaled by 1/sqrt(D).  The running
// max, the denominator and the output accumulator are fp32; O is written in the
// input dtype and LSE in fp32.
//
// Bound on an H100 SXM.  Per (q row, key) pair the kernel does 4*D flops on the
// tensor cores and one exp on the MUFU unit.  At the main path's D = 32 the
// tensor-core bound is 4*BH*Tq*Tk*32 / 989 TFLOP/s (e.g. 35 us at
// (16, 4096, 32)), the HBM bound (q, k, v, o read/written once) is several
// times smaller, and the BH*Tq*Tk exps at 16/clk/SM are of the same order as
// the tensor-core bound: the exp count, not the bytes, is what holds a
// D = 32 attention back.
//
// Design (simple and correct first; no wgmma, TMA or warp specialisation):
//   * bf16: one block of 4 warps per (bh, 64-row q tile); each warp owns 16 q
//     rows.  K/V tiles of 64 keys are staged in shared memory (V transposed),
//     both products run on mma.sync.m16n8k16 (bf16 in, fp32 accumulate), and
//     the score tile never leaves registers: the S accumulator fragments are
//     re-packed as the A operand of P.V (the FlashAttention-2 register reuse).
//     P is rounded to bf16 for P.V, as the TPU kernel does (p.astype(v.dtype)),
//     while the denominator sums the fp32 P.
//   * fp32: one thread per q row, plain FMA over fp32 K/V tiles in shared
//     memory (broadcast reads), an online softmax key by key with expf.  Used
//     where the model runs in fp32.
//   * Any Tq, Tk >= 1 and D <= 256: D is padded with zeros to the kernel's head
//     width (16/32/64/128/256), ragged q rows are not written, and keys past Tk
//     get a score of -inf.
//
// Launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int kBlockM = 64;    // q rows per block
constexpr int kBlockN = 64;    // keys per shared-memory tile (bf16 kernel)
constexpr int kThreads = 128;  // 4 warps x 16 q rows
constexpr int kPad = 8;        // bf16 elements of row padding (bank spread)
constexpr int kF32BlockN = 32; // keys per shared-memory tile (fp32 kernel)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInit = -1e30f;  // running-max start, as the TPU kernel's _NEG_INF

// Copy rows [row0, row0 + rows) x [0, d) of a (n_rows, d) bf16 matrix into a
// (rows, HD + kPad) shared tile, zero-filling rows past n_rows and columns past
// d.  With `transpose`, element (r, c) lands at dst[c * (rows + kPad) + r].
template <int HD, bool kTranspose>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int row0, int rows, int n_rows, int d, bool vec_ok) {
  constexpr int kChunk = 8;
  const int chunks_per_row = HD / kChunk;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int c = threadIdx.x; c < rows * chunks_per_row; c += kThreads) {
    const int r = c / chunks_per_row;
    const int c0 = (c % chunks_per_row) * kChunk;
    __nv_bfloat16 vals[kChunk];
    const int gr = row0 + r;
    if (gr < n_rows && vec_ok && c0 + kChunk <= d) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + c0);
      const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) vals[i] = pv[i];
    } else {
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        vals[i] = (gr < n_rows && c0 + i < d) ? src[(size_t)gr * d + c0 + i] : zero;
    }
    if (kTranspose) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) dst[(c0 + i) * (rows + kPad) + r] = vals[i];
    } else {
      uint4 u;
      __nv_bfloat16* pu = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) pu[i] = vals[i];
      *reinterpret_cast<uint4*>(dst + r * (HD + kPad) + c0) = u;
    }
  }
}

template <int HD>
constexpr int bf16_smem_bytes() {
  return (kBlockM * (HD + kPad) + kBlockN * (HD + kPad) + HD * (kBlockN + kPad)) * 2;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int tq, int tk, int d) {
  static_assert(HD % 16 == 0, "head width must be a multiple of 16");
  constexpr int QS = HD + kPad;        // sQ / sK row stride (elements)
  constexpr int VS = kBlockN + kPad;   // sVt row stride (elements)
  constexpr int NT = kBlockN / 8;      // n-tiles of 8 keys in S
  constexpr int KS = HD / 16;          // k-steps over the head dim in Q.K^T
  constexpr int DT = HD / 8;           // n-tiles of 8 head dims in P.V

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * QS;
  __nv_bfloat16* sVt = sK + kBlockN * QS;

  const int n_mtiles = (tq + kBlockM - 1) / kBlockM;
  const int bh = blockIdx.x / n_mtiles;
  const int m0 = (blockIdx.x % n_mtiles) * kBlockM;
  const __nv_bfloat16* qb = q + (size_t)bh * tq * d;
  const __nv_bfloat16* kb = k + (size_t)bh * tk * d;
  const __nv_bfloat16* vb = v + (size_t)bh * tk * d;
  // uint4 loads need every row start 16-byte aligned
  const bool vec_ok = (d % 8 == 0) &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) % 16 == 0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread in group

  stage_tile<HD, false>(sQ, qb, m0, kBlockM, tq, d, vec_ok);
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a_frag(qf[ks], sQ + (warp * 16) * QS, QS, ks, g, t4);

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_r[2] = {kNegInit, kNegInit};  // rows g and g + 8 of this warp
  float l_r[2] = {0.f, 0.f};            // per-thread partial denominators

  for (int n0 = 0; n0 < tk; n0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<HD, false>(sK, kb, n0, kBlockN, tk, d, vec_ok);
    stage_tile<HD, true>(sVt, vb, n0, kBlockN, tk, d, vec_ok);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* kr = sK + (nt * 8 + g) * QS + ks * 16 + t4 * 2;
        mma_16816(s[nt], qf[ks], lds32(kr), lds32(kr + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int key = n0 + nt * 8 + t4 * 2;
      if (key >= tk) { s[nt][0] = -INFINITY; s[nt][2] = -INFINITY; }
      if (key + 1 >= tk) { s[nt][1] = -INFINITY; s[nt][3] = -INFINITY; }
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = exp2f((m_r[r] - m_new) * kLog2e);
      m_r[r] = m_new;
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[nt][e] = exp2f((s[nt][e] - m_r[r]) * kLog2e);
        l_r[r] += s[nt][e];
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= corr[0]; acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1]; acc[dt][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pack_a_frag(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* vr = sVt + (dt * 8 + g) * VS + kk * 16 + t4 * 2;
        mma_16816(acc[dt], pa, lds32(vr), lds32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const float inv[2] = {1.f / l_r[0], 1.f / l_r[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    if (row >= tq) continue;
    __nv_bfloat16* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = dt * 8 + t4 * 2;
      const float v0 = acc[dt][2 * r] * inv[r];
      const float v1 = acc[dt][2 * r + 1] * inv[r];
      if (col + 1 < d) {
        if (d % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
        } else {
          orow[col] = __float2bfloat16(v0);
          orow[col + 1] = __float2bfloat16(v1);
        }
      } else if (col < d) {
        orow[col] = __float2bfloat16(v0);
      }
    }
    if (t4 == 0) lse[(size_t)bh * tq + row] = m_r[r] + logf(l_r[r]);
  }
}

template <int HD>
constexpr int f32_smem_bytes() {
  return 2 * kF32BlockN * HD * 4;
}

template <int HD>
__global__ void __launch_bounds__(kBlockM)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // (kF32BlockN, HD)
  float* sV = sK + kF32BlockN * HD;

  const int n_mtiles = (tq + kBlockM - 1) / kBlockM;
  const int bh = blockIdx.x / n_mtiles;
  const int row = (blockIdx.x % n_mtiles) * kBlockM + threadIdx.x;
  const bool active = row < tq;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;

  float qr[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    qr[c] = (active && c < d) ? q[((size_t)bh * tq + row) * d + c] : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInit, l = 0.f;

  for (int n0 = 0; n0 < tk; n0 += kF32BlockN) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32BlockN * HD; i += kBlockM) {
      const int r = i / HD, c = i % HD;
      const bool ok = (n0 + r < tk) && (c < d);
      sK[i] = ok ? kb[(size_t)(n0 + r) * d + c] : 0.f;
      sV[i] = ok ? vb[(size_t)(n0 + r) * d + c] : 0.f;
    }
    __syncthreads();
    const int n_keys = min(kF32BlockN, tk - n0);
#pragma unroll 1
    for (int j = 0; j < n_keys; ++j) {  // online softmax, one key at a time
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) s = fmaf(qr[c], sK[j * HD + c], s);
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int c = 0; c < HD; ++c) acc[c] = fmaf(p, sV[j * HD + c], acc[c] * corr);
      m = m_new;
    }
  }

  if (!active) return;
  const float inv = 1.f / l;
  float* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
  for (int c = 0; c < HD; ++c)
    if (c < d) orow[c] = acc[c] * inv;
  lse[(size_t)bh * tq + row] = m + logf(l);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int tq, int tk, int d, int is_f32, cudaStream_t stream) {
  const int blocks = ((tq + kBlockM - 1) / kBlockM) * bh;
  cudaError_t err;
  if (is_f32) {
    constexpr int smem = f32_smem_bytes<HD>();
    if ((err = allow_smem(flash_fwd_f32_kernel<HD>, smem)) != cudaSuccess) return err;
    flash_fwd_f32_kernel<HD><<<blocks, kBlockM, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), tq, tk,
        d);
  } else {
    constexpr int smem = bf16_smem_bytes<HD>();
    if ((err = allow_smem(flash_fwd_bf16_kernel<HD>, smem)) != cudaSuccess) return err;
    flash_fwd_bf16_kernel<HD><<<blocks, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(lse), tq, tk, d);
  }
  return cudaGetLastError();
}

}  // namespace

// q: (bh, tq, d); k, v: (bh, tk, d); o: (bh, tq, d) in the input dtype; lse:
// (bh, tq) fp32.  All contiguous.  dtype: 0 = bf16, 1 = fp32.  Returns a
// cudaError_t (0 = launched).
extern "C" int jig_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int bh, int tq, int tk, int d, int dtype, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 1 || d > 256 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)((tq + kBlockM - 1) / kBlockM) * bh > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 16) err = launch<16>(q, k, v, o, lse, bh, tq, tk, d, dtype, s);
  else if (d <= 32) err = launch<32>(q, k, v, o, lse, bh, tq, tk, d, dtype, s);
  else if (d <= 64) err = launch<64>(q, k, v, o, lse, bh, tq, tk, d, dtype, s);
  else if (d <= 128) err = launch<128>(q, k, v, o, lse, bh, tq, tk, d, dtype, s);
  else err = launch<256>(q, k, v, o, lse, bh, tq, tk, d, dtype, s);
  return static_cast<int>(err);
}
