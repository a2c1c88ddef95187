// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the two TPU kernels of jointimagegeneration_tpu/ops/pallas/
// flash_attention.py's `_flash_backward`: `_bwd_dkv_kernel` (dK, dV) and
// `_bwd_dq_kernel` (dQ).  Over (BH, T, D) row-major tensors, q already scaled
// by 1/sqrt(D), with the forward's fp32 LSE and delta = rowsum(dO * O) (fp32,
// computed by the caller):
//
//   P  = exp(q k^T - LSE)            dP = dO v^T        dS = P * (dP - delta)
//   dV = P^T dO      dK = dS^T q      dQ = dS k
//
// As the TPU kernels do, P is rounded to dO's dtype before P^T dO and dS to
// q's (k's) dtype before dS^T q (dS k); P, dP, dS and every accumulator are
// fp32; dQ, dK, dV are written in the input dtype.
//
// Bound on an H100 SXM.  The function does five products of 2*BH*Tq*Tk*D
// flops each (S, dP, dV, dK, dQ) on the tensor cores and one exp per (q, key)
// pair; at the training shapes' D = 32 that is 10*BH*T^2*32 / 989 TFLOP/s
// (e.g. 0.17 ms at (16, 4096, 32)), several times the HBM time.  The split
// into two kernels recomputes S and dP in each (7 products instead of 5),
// the price of writing every gradient once with no atomics.
//
// Design (simple and correct first; no wgmma, TMA or warp specialisation):
//   * dkv (bf16): one block of 4 warps per (bh, 64-key tile, head-column
//     chunk); each warp owns 16 keys and loops over 64-row q tiles staged in
//     shared memory.  S^T = K Q^T and dP^T = V dO^T run on mma.sync.m16n8k16
//     with K/V rows as the A operand, so the fp32 accumulators hold P^T and
//     dS^T with keys as rows and are re-packed in registers as the A operand
//     of dV += P^T dO and dK += dS^T Q (Q and dO are staged a second time,
//     transposed, for those B operands).  LSE and delta broadcast along the
//     accumulator columns, from shared memory.
//   * dq (bf16): one block per (bh, 64-row q tile, chunk); each warp owns 16
//     q rows and loops over 64-key tiles.  S = Q K^T and dP = dO V^T, then
//     dQ += dS K with K staged transposed.  LSE and delta are per-row
//     registers.
//   * Head columns: the output accumulators cover at most 64 head columns;
//     for D > 64 the grid gets one block per 64-column chunk, each of which
//     recomputes S and dP over the full D.  That keeps registers bounded at
//     every head width the forward takes (D <= 256).
//   * fp32: one thread per key (dkv) or q row (dq), plain FMA over fp32 tiles
//     in shared memory (broadcast reads) with expf; tensor cores would round
//     through TF32.
//   * Ragged shapes: q rows past Tq get P = 0 (LSE = +inf in the dkv tile),
//     keys past Tk get P = 0 in dq and are never written in dkv, D is padded
//     with zeros to the kernel's head width (16/32/64/128/256).
//
// Launches on the caller's stream, allocates nothing, writes every output
// element exactly once (deterministic), and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int kTile = 64;      // rows a block owns, and rows per inner tile
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kPad = 8;        // bf16 elements of row padding (bank spread)
constexpr int kMaxChunk = 64;  // head columns of output per block
constexpr int kF32Tile = 32;   // rows per shared-memory tile (fp32 kernels)
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
__host__ __device__ constexpr int chunk_cols() {
  return HD < kMaxChunk ? HD : kMaxChunk;
}

// Copy rows [row0, row0 + kTile) x columns [col0, col0 + COLS) of an
// (n_rows, d) bf16 matrix into shared memory, zero-filling outside it.
// Row-major: element (r, c) at dst[r * (COLS + kPad) + c]; transposed: at
// dst[c * (kTile + kPad) + r].
template <int COLS, bool kTranspose>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                      int n_rows, int col0, int d, bool vec_ok) {
  constexpr int kChunk = 8;
  constexpr int kPerRow = COLS / kChunk;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int c = threadIdx.x; c < kTile * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int cc = (c % kPerRow) * kChunk;
    const int gr = row0 + r;
    const int gc = col0 + cc;
    __nv_bfloat16 vals[kChunk];
    if (gr < n_rows && vec_ok && gc + kChunk <= d) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + gc);
      const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) vals[i] = pv[i];
    } else {
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        vals[i] = (gr < n_rows && gc + i < d) ? src[(size_t)gr * d + gc + i] : zero;
    }
    if (kTranspose) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) dst[(cc + i) * (kTile + kPad) + r] = vals[i];
    } else {
      uint4 u;
      __nv_bfloat16* pu = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) pu[i] = vals[i];
      *reinterpret_cast<uint4*>(dst + r * (COLS + kPad) + cc) = u;
    }
  }
}

// Write rows g and g + 8 of a warp's (16, DC) fp32 accumulator to out[row0 +
// ...][col0 + ...] in bf16, skipping rows past n_rows and columns past d.
template <int DT>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[DT][4],
                                           int row0, int n_rows, int col0, int d, int g, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
    __nv_bfloat16* orow = out + (size_t)row * d;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = col0 + dt * 8 + t4 * 2;
      const float v0 = acc[dt][2 * r], v1 = acc[dt][2 * r + 1];
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
  }
}

template <int HD>
constexpr int dkv_smem_bytes() {
  return (4 * kTile * (HD + kPad) + 2 * chunk_cols<HD>() * (kTile + kPad)) * 2 + 2 * kTile * 4;
}

template <int HD>
constexpr int dq_smem_bytes() {
  return (4 * kTile * (HD + kPad) + chunk_cols<HD>() * (kTile + kPad)) * 2;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int tq,
                          int tk, int d) {
  static_assert(HD % 16 == 0, "head width must be a multiple of 16");
  constexpr int DC = chunk_cols<HD>();  // output head columns of this block
  constexpr int NCH = HD / DC;
  constexpr int RS = HD + kPad;        // row stride of row-major tiles
  constexpr int TS = kTile + kPad;     // row stride of transposed tiles
  constexpr int NT = kTile / 8;        // n-tiles of 8 q rows in S^T
  constexpr int KS = HD / 16;          // k-steps over the head dim in K Q^T, V dO^T
  constexpr int DT = DC / 8;           // n-tiles of 8 head columns in dK, dV

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTile * RS;
  __nv_bfloat16* sQ = sV + kTile * RS;
  __nv_bfloat16* sdO = sQ + kTile * RS;
  __nv_bfloat16* sQt = sdO + kTile * RS;
  __nv_bfloat16* sdOt = sQt + DC * TS;
  float* sLse = reinterpret_cast<float*>(sdOt + DC * TS);
  float* sDelta = sLse + kTile;

  const int n_tiles = (tk + kTile - 1) / kTile;
  const int chunk = blockIdx.x % NCH;
  const int n0 = ((blockIdx.x / NCH) % n_tiles) * kTile;
  const int bh = blockIdx.x / NCH / n_tiles;
  const int dc0 = chunk * DC;
  const __nv_bfloat16* qb = q + (size_t)bh * tq * d;
  const __nv_bfloat16* dob = dout + (size_t)bh * tq * d;
  const __nv_bfloat16* kb = k + (size_t)bh * tk * d;
  const __nv_bfloat16* vb = v + (size_t)bh * tk * d;
  const float* lseb = lse + (size_t)bh * tq;
  const float* deltab = delta + (size_t)bh * tq;
  const bool vec_ok = (d % 8 == 0) &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  stage<HD, false>(sK, kb, n0, tk, 0, d, vec_ok);
  stage<HD, false>(sV, vb, n0, tk, 0, d, vec_ok);
  const __nv_bfloat16* kw = sK + warp * 16 * RS;  // this warp's 16 keys
  const __nv_bfloat16* vw = sV + warp * 16 * RS;

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  for (int m0 = 0; m0 < tq; m0 += kTile) {
    __syncthreads();  // the previous q tile is consumed
    stage<HD, false>(sQ, qb, m0, tq, 0, d, vec_ok);
    stage<HD, false>(sdO, dob, m0, tq, 0, d, vec_ok);
    stage<DC, true>(sQt, qb, m0, tq, dc0, d, vec_ok);
    stage<DC, true>(sdOt, dob, m0, tq, dc0, d, vec_ok);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool ok = m0 + i < tq;
      sLse[i] = ok ? lseb[m0 + i] : INFINITY;  // padded q rows: P = exp(-inf) = 0
      sDelta[i] = ok ? deltab[m0 + i] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T: this warp's 16 keys x 64 q rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      load_a_frag(ka, kw, RS, ks, g, t4);
      load_a_frag(va, vw, RS, ks, g, t4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* qr = sQ + (nt * 8 + g) * RS + ks * 16 + t4 * 2;
        mma_16816(s[nt], ka, lds32(qr), lds32(qr + 8));
        const __nv_bfloat16* orow = sdO + (nt * 8 + g) * RS + ks * 16 + t4 * 2;
        mma_16816(dp[nt], va, lds32(orow), lds32(orow + 8));
      }
    }
    // P^T in s, dS^T in dp; LSE and delta vary along the columns (q rows)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + t4 * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col + (e & 1);
        const float p = exp2f((s[nt][e] - sLse[c]) * kLog2e);
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sDelta[c]);
      }
    }
    // dV += P^T dO, dK += dS^T Q over the tile's 64 q rows
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4], da[4];
      pack_a_frag(pa, s[2 * kk], s[2 * kk + 1]);
      pack_a_frag(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* ot = sdOt + (dt * 8 + g) * TS + kk * 16 + t4 * 2;
        mma_16816(dv_acc[dt], pa, lds32(ot), lds32(ot + 8));
        const __nv_bfloat16* qt = sQt + (dt * 8 + g) * TS + kk * 16 + t4 * 2;
        mma_16816(dk_acc[dt], da, lds32(qt), lds32(qt + 8));
      }
    }
  }

  const int row0 = n0 + warp * 16;
  store_rows<DT>(dk + (size_t)bh * tk * d, dk_acc, row0, tk, dc0, d, g, t4);
  store_rows<DT>(dv + (size_t)bh * tk * d, dv_acc, row0, tk, dc0, d, g, t4);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int tq, int tk, int d) {
  static_assert(HD % 16 == 0, "head width must be a multiple of 16");
  constexpr int DC = chunk_cols<HD>();
  constexpr int NCH = HD / DC;
  constexpr int RS = HD + kPad;
  constexpr int TS = kTile + kPad;
  constexpr int NT = kTile / 8;        // n-tiles of 8 keys in S
  constexpr int KS = HD / 16;
  constexpr int DT = DC / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kTile * RS;
  __nv_bfloat16* sK = sdO + kTile * RS;
  __nv_bfloat16* sV = sK + kTile * RS;
  __nv_bfloat16* sKt = sV + kTile * RS;

  const int n_tiles = (tq + kTile - 1) / kTile;
  const int chunk = blockIdx.x % NCH;
  const int m0 = ((blockIdx.x / NCH) % n_tiles) * kTile;
  const int bh = blockIdx.x / NCH / n_tiles;
  const int dc0 = chunk * DC;
  const __nv_bfloat16* qb = q + (size_t)bh * tq * d;
  const __nv_bfloat16* dob = dout + (size_t)bh * tq * d;
  const __nv_bfloat16* kb = k + (size_t)bh * tk * d;
  const __nv_bfloat16* vb = v + (size_t)bh * tk * d;
  const bool vec_ok = (d % 8 == 0) &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  stage<HD, false>(sQ, qb, m0, tq, 0, d, vec_ok);
  stage<HD, false>(sdO, dob, m0, tq, 0, d, vec_ok);
  const __nv_bfloat16* qw = sQ + warp * 16 * RS;  // this warp's 16 q rows
  const __nv_bfloat16* ow = sdO + warp * 16 * RS;
  float lse_r[2], delta_r[2];  // rows g and g + 8; padded rows are never written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    lse_r[r] = row < tq ? lse[(size_t)bh * tq + row] : 0.f;
    delta_r[r] = row < tq ? delta[(size_t)bh * tq + row] : 0.f;
  }

  float dq_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[dt][e] = 0.f;

  for (int n0 = 0; n0 < tk; n0 += kTile) {
    __syncthreads();  // the previous key tile is consumed (and Q/dO staged on the first pass)
    stage<HD, false>(sK, kb, n0, tk, 0, d, vec_ok);
    stage<HD, false>(sV, vb, n0, tk, 0, d, vec_ok);
    stage<DC, true>(sKt, kb, n0, tk, dc0, d, vec_ok);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], oa[4];
      load_a_frag(qa, qw, RS, ks, g, t4);
      load_a_frag(oa, ow, RS, ks, g, t4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kr = sK + (nt * 8 + g) * RS + ks * 16 + t4 * 2;
        mma_16816(s[nt], qa, lds32(kr), lds32(kr + 8));
        const __nv_bfloat16* vr = sV + (nt * 8 + g) * RS + ks * 16 + t4 * 2;
        mma_16816(dp[nt], oa, lds32(vr), lds32(vr + 8));
      }
    }
    // dS in dp; LSE and delta vary along the rows; keys past tk get P = 0
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int key = n0 + nt * 8 + t4 * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = (key + (e & 1) < tk) ? exp2f((s[nt][e] - lse_r[r]) * kLog2e) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - delta_r[r]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t da[4];
      pack_a_frag(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* kt = sKt + (dt * 8 + g) * TS + kk * 16 + t4 * 2;
        mma_16816(dq_acc[dt], da, lds32(kt), lds32(kt + 8));
      }
    }
  }

  store_rows<DT>(dq + (size_t)bh * tq * d, dq_acc, m0 + warp * 16, tq, dc0, d, g, t4);
}

template <int HD>
constexpr int f32_smem_bytes() {
  return 2 * kF32Tile * HD * 4 + 2 * kF32Tile * 4;
}

// fp32 dK, dV: one thread per key; q / dO rows staged kF32Tile at a time.
template <int HD>
__global__ void __launch_bounds__(kTile)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int tq, int tk, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // (kF32Tile, HD)
  float* sdO = sQ + kF32Tile * HD;
  float* sLse = sdO + kF32Tile * HD;
  float* sDelta = sLse + kF32Tile;

  const int n_tiles = (tk + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_tiles;
  const int key = (blockIdx.x % n_tiles) * kTile + threadIdx.x;
  const bool active = key < tk;
  const float* qb = q + (size_t)bh * tq * d;
  const float* dob = dout + (size_t)bh * tq * d;

  float kr[HD], vr[HD], dkr[HD], dvr[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    const bool ok = active && c < d;
    kr[c] = ok ? k[((size_t)bh * tk + key) * d + c] : 0.f;
    vr[c] = ok ? v[((size_t)bh * tk + key) * d + c] : 0.f;
    dkr[c] = dvr[c] = 0.f;
  }

  for (int m0 = 0; m0 < tq; m0 += kF32Tile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Tile * HD; i += kTile) {
      const int r = i / HD, c = i % HD;
      const bool ok = (m0 + r < tq) && (c < d);
      sQ[i] = ok ? qb[(size_t)(m0 + r) * d + c] : 0.f;
      sdO[i] = ok ? dob[(size_t)(m0 + r) * d + c] : 0.f;
    }
    for (int i = threadIdx.x; i < kF32Tile; i += kTile) {
      const bool ok = m0 + i < tq;
      sLse[i] = ok ? lse[(size_t)bh * tq + m0 + i] : 0.f;
      sDelta[i] = ok ? delta[(size_t)bh * tq + m0 + i] : 0.f;
    }
    __syncthreads();
    const int n_rows = min(kF32Tile, tq - m0);
#pragma unroll 1
    for (int j = 0; j < n_rows; ++j) {
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        s = fmaf(kr[c], sQ[j * HD + c], s);
        dpv = fmaf(vr[c], sdO[j * HD + c], dpv);
      }
      const float p = expf(s - sLse[j]);
      const float ds = p * (dpv - sDelta[j]);
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        dvr[c] = fmaf(p, sdO[j * HD + c], dvr[c]);
        dkr[c] = fmaf(ds, sQ[j * HD + c], dkr[c]);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    if (c < d) {
      dk[((size_t)bh * tk + key) * d + c] = dkr[c];
      dv[((size_t)bh * tk + key) * d + c] = dvr[c];
    }
  }
}

// fp32 dQ: one thread per q row; k / v rows staged kF32Tile at a time.
template <int HD>
__global__ void __launch_bounds__(kTile)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int tq, int tk, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // (kF32Tile, HD)
  float* sV = sK + kF32Tile * HD;

  const int n_tiles = (tq + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_tiles;
  const int row = (blockIdx.x % n_tiles) * kTile + threadIdx.x;
  const bool active = row < tq;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;

  float qr[HD], dor[HD], dqr[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    const bool ok = active && c < d;
    qr[c] = ok ? q[((size_t)bh * tq + row) * d + c] : 0.f;
    dor[c] = ok ? dout[((size_t)bh * tq + row) * d + c] : 0.f;
    dqr[c] = 0.f;
  }
  const float lse_i = active ? lse[(size_t)bh * tq + row] : 0.f;
  const float delta_i = active ? delta[(size_t)bh * tq + row] : 0.f;

  for (int n0 = 0; n0 < tk; n0 += kF32Tile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Tile * HD; i += kTile) {
      const int r = i / HD, c = i % HD;
      const bool ok = (n0 + r < tk) && (c < d);
      sK[i] = ok ? kb[(size_t)(n0 + r) * d + c] : 0.f;
      sV[i] = ok ? vb[(size_t)(n0 + r) * d + c] : 0.f;
    }
    __syncthreads();
    const int n_keys = min(kF32Tile, tk - n0);
#pragma unroll 1
    for (int j = 0; j < n_keys; ++j) {
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        s = fmaf(qr[c], sK[j * HD + c], s);
        dpv = fmaf(dor[c], sV[j * HD + c], dpv);
      }
      const float ds = expf(s - lse_i) * (dpv - delta_i);
#pragma unroll
      for (int c = 0; c < HD; ++c) dqr[c] = fmaf(ds, sK[j * HD + c], dqr[c]);
    }
  }

  if (!active) return;
#pragma unroll
  for (int c = 0; c < HD; ++c)
    if (c < d) dq[((size_t)bh * tq + row) * d + c] = dqr[c];
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dkv: dk, dv; dq: dq
  int bh, tq, tk, d;
  cudaStream_t stream;
};

template <int HD>
cudaError_t launch_dkv(const Args& a, bool is_f32) {
  cudaError_t err;
  const int tiles = (a.tk + kTile - 1) / kTile;
  if (is_f32) {
    constexpr int smem = f32_smem_bytes<HD>();
    if ((err = allow_smem(flash_bwd_dkv_f32_kernel<HD>, smem)) != cudaSuccess) return err;
    flash_bwd_dkv_f32_kernel<HD><<<tiles * a.bh, kTile, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.tq, a.tk, a.d);
  } else {
    constexpr int smem = dkv_smem_bytes<HD>();
    constexpr int nch = HD / chunk_cols<HD>();
    if ((err = allow_smem(flash_bwd_dkv_bf16_kernel<HD>, smem)) != cudaSuccess) return err;
    flash_bwd_dkv_bf16_kernel<HD><<<tiles * a.bh * nch, kThreads, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<__nv_bfloat16*>(a.out0), static_cast<__nv_bfloat16*>(a.out1), a.tq, a.tk, a.d);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const Args& a, bool is_f32) {
  cudaError_t err;
  const int tiles = (a.tq + kTile - 1) / kTile;
  if (is_f32) {
    constexpr int smem = 2 * kF32Tile * HD * 4;
    if ((err = allow_smem(flash_bwd_dq_f32_kernel<HD>, smem)) != cudaSuccess) return err;
    flash_bwd_dq_f32_kernel<HD><<<tiles * a.bh, kTile, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.out0), a.tq, a.tk, a.d);
  } else {
    constexpr int smem = dq_smem_bytes<HD>();
    constexpr int nch = HD / chunk_cols<HD>();
    if ((err = allow_smem(flash_bwd_dq_bf16_kernel<HD>, smem)) != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<HD><<<tiles * a.bh * nch, kThreads, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<__nv_bfloat16*>(a.out0), a.tq, a.tk, a.d);
  }
  return cudaGetLastError();
}

// Dispatch on the padded head width; `rows` is the dimension the kernel
// tiles its grid over (tk for dkv, tq for dq).
template <bool kDkv>
int dispatch(const Args& a, int dtype, int rows) {
  if (a.bh < 1 || a.tq < 1 || a.tk < 1 || a.d < 1 || a.d > 256 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)((rows + kTile - 1) / kTile) * a.bh * 4 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool f32 = dtype == 1;
  cudaError_t err;
  if (a.d <= 16) err = kDkv ? launch_dkv<16>(a, f32) : launch_dq<16>(a, f32);
  else if (a.d <= 32) err = kDkv ? launch_dkv<32>(a, f32) : launch_dq<32>(a, f32);
  else if (a.d <= 64) err = kDkv ? launch_dkv<64>(a, f32) : launch_dq<64>(a, f32);
  else if (a.d <= 128) err = kDkv ? launch_dkv<128>(a, f32) : launch_dq<128>(a, f32);
  else err = kDkv ? launch_dkv<256>(a, f32) : launch_dq<256>(a, f32);
  return static_cast<int>(err);
}

}  // namespace

// q, dout: (bh, tq, d); k, v: (bh, tk, d); lse, delta: (bh, tq) fp32; dk, dv:
// (bh, tk, d) in the input dtype.  All contiguous.  dtype: 0 = bf16, 1 = fp32.
// Returns a cudaError_t (0 = launched).
extern "C" int jig_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int bh,
                                 int tq, int tk, int d, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, dtype, tk);
}

// As jig_flash_bwd_dkv; dq: (bh, tq, d) in the input dtype.
extern "C" int jig_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int bh, int tq,
                                int tk, int d, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, bh, tq, tk, d,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, dtype, tq);
}
