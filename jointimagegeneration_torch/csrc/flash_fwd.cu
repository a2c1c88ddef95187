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
// max (starting at -1e30, the TPU kernel's _NEG_INF), the denominator and the
// output accumulator are fp32; P is rounded to v's dtype before P.V while the
// denominator sums the fp32 P; O is written in the input dtype and LSE in fp32.
//
// Bound on an H100 SXM.  Per (q row, key) pair the kernel does 4*D flops on the
// tensor cores and one exponential on the MUFU (16 per clock per SM).  At the
// main paths' D = 32 that is 128 flops per exponential, and the exponentials
// bound it: at (8, 2048, 32) 3.4e7 of them take 8.0 us at 1.98 GHz, the
// products 4.3 us at 989 TFLOP/s, the bytes (q, k, v, O once) 1.3 us.
//
// bf16 design (`flash_fwd_wgmma_kernel`):
//   * A block owns 64 q rows and one output chunk of 64 head columns (one
//     block per chunk above D = 64, each recomputing S over all of D).  Its Q
//     tile arrives once by TMA; up to D = 32 it is held as register A
//     fragments, so S = Q K^T is wgmma's RS form (above, the SS form).
//   * K tiles (all of D) and V tiles (the block's chunk) of 64 keys stream by
//     TMA through a ring of two stages per warpgroup on mbarriers, in the
//     hardware's swizzle (rows of 32, 64 or 128 bytes): after the
//     warpgroup's barrier says stage j - 1 is consumed, its thread 0 refills
//     it with tile j + 1, outside every wgmma commit-wait window.
//   * O += P V is wgmma's RS form: P is the S accumulator re-packed to bf16
//     A fragments in registers, and V is read MN-major through the
//     transpose-B bit from the same tile TMA wrote, so nothing is staged
//     transposed.
//   * Online softmax in the accumulator layout (hopper.cuh): each thread holds
//     rows g and g + 8 of its warp's 16; the row max is two shuffles within
//     the quad; keys past Tk get S = -inf before the max.  The max is kept in
//     natural units, each element costs one FFMA (s * log2e - m * log2e) and
//     one MUFU.EX2, and O and l are rescaled once per tile.
//   * Warpgroups: where blocks are few, two warpgroups split the block's key
//     tiles, each with its own (m, l, O), merged once at the end through
//     shared memory in a fixed order (m = max(m0, m1), O = O0 2^(m0 - m) +
//     O1 2^(m1 - m), l likewise); a warpgroup that saw no key leaves the other's
//     state exact.  The host planner (`ops/flash_attention.py`
//     `plan_flash_fwd`) chooses; the kernel checks its shared-memory size
//     against the plan's.
//   * TMA wants d % 8 == 0 and 16-byte aligned tensors (the wrapper pads with
//     zero columns otherwise); any Tq, Tk >= 1 (rows past T arrive as zeros,
//     q rows past Tq are not written).
//
// fp32 (`flash_fwd_f32_kernel`): one thread per q row, plain FMA over fp32
// K / V tiles of 32 keys in shared memory (broadcast reads; the next tile
// loads by cp.async into a second buffer meanwhile), free of TF32 rounding.  Each tile is one step of the online softmax: its 32 scores (8 at
// a time, 8 independent FMA chains, kept per thread in shared memory), one max,
// one rescale of the accumulator, one expf per key.
//
// Launches on the caller's stream, allocates nothing, uses no float atomics,
// writes every output element once (results are the same call to call), and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kF32Tile = 32;         // keys per shared-memory tile (fp32 kernel)
constexpr int kF32Group = 8;         // scores computed together (fp32 kernel)
constexpr float kNegInit = -1e30f;  // running-max start, as the TPU kernel's _NEG_INF

struct FwdParams {
  CUtensorMap q_map, k_map, v_map;  // (d, T, bh) with boxes (AC, 64, 1)
  __nv_bfloat16* o;
  float* lse;  // (bh, tq)
  int tq, tk, d;
};

// Shared memory of a block: 1024 bytes of slack for aligning the base, the
// 1024-byte control slot (flash_common.cuh), the Q tile, then per warpgroup a
// ring of kStages stages of (K tile, the V tile's atom of the block's chunk).
template <int HD, int NWG>
struct FwdSmem {
  static constexpr int kStage = Tile<HD>::BYTES + Tile<HD>::ATOM;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kRings = 1024 + Tile<HD>::BYTES;  // the first warpgroup's ring
  static constexpr int kBytes = 1024 + kRings + NWG * kRing;
  static_assert((Tile<HD>::AC / 2 + 4) * 128 * 4 <= kRing, "the merge scratch fits in a ring");
  static_assert(kStage % 1024 == 0, "every tile on a 1024-byte boundary");
};

// One online-softmax step on the scores s of the 64 keys from n0 (this
// thread's rows g and g + 8, hopper.cuh's layout): keys past tk to -inf, the
// rows' new max m (two shuffles in the quad), s to P = 2^(s log2e - m log2e),
// l rescaled and summed; `scale` is the factor O takes, 2^((m_old - m) log2e).
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&m_r)[2], float (&l_r)[2], float (&scale)[2],
                                             int n0, int tk, int t4) {
  if (n0 + kTile > tk) {  // keys past tk: S = -inf, so the max ignores them and P = 0
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (n0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= tk) s[i] = -INFINITY;
  }
  float mx[2] = {s[0], s[2]};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r]);
    scale[r] = ex2_approx((m_r[r] - m_new) * kLog2e);
    m_r[r] = m_new;
    ml[r] = m_new * kLog2e;
    l_r[r] *= scale[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ex2_approx(fmaf(s[i], kLog2e, -ml[(i >> 1) & 1]));
    l_r[(i >> 1) & 1] += s[i];
  }
}

// Warpgroup 1's (O, m, l) into warpgroup 0's through the shared scratch `red`
// (warpgroup 1's consumed ring), row by row: m = max(m0, m1), O = O0 a0 +
// O1 a1 and l = l0 a0 + l1 a1 with a_w = 2^((m_w - m) log2e).  Where
// warpgroup 1 saw no key (m1 = -1e30, l1 = 0, O1 = 0) a0 = 1 and a1 = 0, so
// warpgroup 0's state passes exactly.  Returns false for warpgroup 1, which
// then has nothing to store.
template <int N>
__device__ __forceinline__ bool merge_warpgroups(float (&o)[N], float (&m)[2], float (&l)[2], float* red, int wg,
                                                 int t) {
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * 128 + t] = o[i];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      red[(N + r) * 128 + t] = m[r];
      red[(N + 2 + r) * 128 + t] = l[r];
    }
  }
  __syncthreads();
  if (wg == 1) return false;
  float a0[2], a1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = red[(N + r) * 128 + t], l1 = red[(N + 2 + r) * 128 + t];
    const float mm = fmaxf(m[r], m1);
    a0[r] = ex2_approx((m[r] - mm) * kLog2e);
    a1[r] = ex2_approx((m1 - mm) * kLog2e);
    m[r] = mm;
    l[r] = l[r] * a0[r] + l1 * a1[r];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = o[i] * a0[(i >> 1) & 1] + red[i * 128 + t] * a1[(i >> 1) & 1];
  return true;
}

// Blocks of one warpgroup: four on an SM up to D = 32, two above (one at
// D = 256, by its shared memory); blocks of two: two on an SM up to D = 32,
// one above (at most 128 registers a thread where four warpgroups share an SM).
template <int HD, int NWG>
__global__ void __launch_bounds__(128 * NWG, (HD <= 32 ? 4 : 2) / NWG)
flash_fwd_wgmma_kernel(const __grid_constant__ FwdParams p) {
  using T = Tile<HD>;
  using S = FwdSmem<HD, NWG>;
  constexpr int DC = T::AC, NCH = HD / DC;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t raw = smem_u32(smem_tiles);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base + 1024;

  const int tq = p.tq, tk = p.tk, d = p.d;
  const int n_tiles = (tq + kTile - 1) / kTile;
  const int chunk = blockIdx.x % NCH;
  const int m0 = ((blockIdx.x / NCH) % n_tiles) * kTile;
  const int bh = blockIdx.x / NCH / n_tiles;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // this warpgroup's key tiles wg, wg + NWG, ..., through its ring
  const int n_local = ((tk + kTile - 1) / kTile - wg + NWG - 1) / NWG;
  const int ring_off = S::kRings + wg * S::kRing;
  auto stage_k = [&](int j) { return base + ring_off + (j % kStages) * S::kStage; };
  auto stage_bar = [&](int j) { return bar_addr(base, 1 + wg * kStages + j % kStages); };
  auto load_stage = [&](int j) {
    const int n0 = (wg + j * NWG) * kTile;
    const uint32_t bar = stage_bar(j);
    mbar_expect_tx(bar, T::BYTES + T::ATOM);
    tma_tile<HD>(stage_k(j), p.k_map, n0, bh, bar);
    tma_load_3d(stage_k(j) + T::BYTES, &p.v_map, chunk * DC, n0, bh, bar);
  };
  if (tid == 0) start_block<HD, NWG>(base, &p.q_map, nullptr, m0, bh);
  if (t == 0) {
    prefetch_tensormap(&p.k_map);
    prefetch_tensormap(&p.v_map);
  }
  __syncthreads();  // the barriers are initialised
  if (t == 0) {
    for (int j = 0; j < kStages - 1 && j < n_local; ++j) load_stage(j);
  }
  mbar_wait(bar_addr(base, 0), 0);  // Q has landed
  uint32_t qf[kFrags<HD>][4];
  if constexpr (kFragA<HD>) load_frags<HD>(qf, sQ, warp, lane);

  float o_acc[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) o_acc[i] = 0.f;
  float m_r[2] = {kNegInit, kNegInit};  // rows g and g + 8 of this warp's 16
  float l_r[2] = {0.f, 0.f};            // this thread's share of their denominators
  float s[32], scale[2];
  uint32_t pa[4][4];

  Phases ph;  // 0 stage wait, 1 barrier and refill issue, 2 S, 3 max, rescale and P, 4 O += P V and the wait
  ph.mark(-1);
  for (int j = 0; j < n_local; ++j) {
    if (wg == 0) named_barrier_sync<1, 128>();
    else named_barrier_sync<2, 128>();
    if (t == 0 && j + 1 < n_local) load_stage(j + 1);  // into tile j - 1's stage
    ph.mark(1);
    mbar_wait(stage_bar(j), (j / kStages) & 1);
    ph.mark(0);
    const uint32_t sK = stage_k(j), sV = sK + T::BYTES;

    // S = Q K^T: 64 q rows (this warp's 16) x 64 keys
    wgmma_fence();
    product_over_d<HD>(s, qf, sQ, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    ph.mark(2);
    softmax_step(s, m_r, l_r, scale, (wg + j * NWG) * kTile, tk, t4);
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) o_acc[i] *= scale[(i >> 1) & 1];
    ph.mark(3);
    // O += P V over the tile's 64 keys, V read MN-major
    pack_frags(pa, s);
    fence_operands(o_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DC, true>(o_acc, pa[kk], mndesc<HD>(sV, 0, kk));
    wgmma_commit();
    wgmma_wait<0>();  // the stage is free once the whole warpgroup passes the next barrier
    fence_operands(o_acc);
    ph.mark(4);
  }
  ph.store(blockIdx.x * NWG + wg, t == 0);

#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the quad's shares: the rows' whole denominators
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  if constexpr (NWG == 2) {
    float* const red = reinterpret_cast<float*>(smem_tiles + (base - raw) + S::kRings + S::kRing);
    if (!merge_warpgroups(o_acc, m_r, l_r, red, wg, t)) return;
  }
  const float inv[2] = {1.f / l_r[0], 1.f / l_r[1]};
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) o_acc[i] *= inv[(i >> 1) & 1];
  const int row0 = m0 + warp * 16;
  store_acc<DC>(p.o + (size_t)bh * tq * d, o_acc, row0, tq, chunk * DC, d, g, t4);
  if (chunk == 0 && t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row < tq) p.lse[(size_t)bh * tq + row] = m_r[r] + logf(l_r[r]);
    }
  }
}

template <int HD>
constexpr int f32_smem_bytes() {
  return 2 * 2 * kF32Tile * HD * 4 + kF32Tile * kTile * 4;
}

// fp32: one thread per q row (64 a block).  Shared memory: two buffers of
// (K tile, V tile) of kF32Tile keys, (kF32Tile, HD) each, the next tile
// loading by cp.async while this one is used, then each thread's scores of
// the tile (sS[key][thread]).
template <int HD>
__global__ void __launch_bounds__(kTile)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, float* __restrict__ lse, int tq, int tk, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const tiles = reinterpret_cast<float*>(smem_raw);
  float* const sS = tiles + 4 * kF32Tile * HD;  // (kF32Tile, kTile)

  const int n_mtiles = (tq + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_mtiles;
  const int t = threadIdx.x;
  const int row = (blockIdx.x % n_mtiles) * kTile + t;
  const bool active = row < tq;
  const float* kb = k + (size_t)bh * tk * d;
  const float* vb = v + (size_t)bh * tk * d;
  // float4 loads need d % 4 == 0 and 16-byte aligned tensors
  const bool vec = d % 4 == 0 && ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0);

  float qr[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    qr[c] = (active && c < d) ? q[((size_t)bh * tq + row) * d + c] : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInit, l = 0.f;

  // keys n0 ... n0 + kF32Tile - 1 into buffer b, zeros past tk and d: by
  // cp.async where vec (one commit group per tile), else by plain stores
  auto load_tile = [&](int n0, int b) {
    float* const dk0 = tiles + b * 2 * kF32Tile * HD;
    for (int i = t; i < kF32Tile * HD / 4; i += kTile) {
      const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
      float* dk = dk0 + r * HD + c;
      float* dv = dk + kF32Tile * HD;
      if (vec) {
        const bool in = n0 + r < tk && c < d;
        const size_t off = in ? (size_t)(n0 + r) * d + c : 0;
        cp_async16(smem_u32(dk), kb + off, in ? 16 : 0);
        cp_async16(smem_u32(dv), vb + off, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = n0 + r < tk && c + e < d;
          dk[e] = ok ? kb[(size_t)(n0 + r) * d + c + e] : 0.f;
          dv[e] = ok ? vb[(size_t)(n0 + r) * d + c + e] : 0.f;
        }
      }
    }
    cp_async_commit();
  };

  const int n_kt = (tk + kF32Tile - 1) / kF32Tile;
  load_tile(0, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int n0 = it * kF32Tile;
    if (it + 1 < n_kt) load_tile(n0 + kF32Tile, (it + 1) & 1);  // its buffer was consumed in it - 1
    else cp_async_commit();                                      // an empty group: the wait below is for tile it
    cp_async_wait<1>();
    __syncthreads();  // tile it has landed, from every thread's copies
    const float* sK = tiles + (it & 1) * 2 * kF32Tile * HD;
    const float* sV = sK + kF32Tile * HD;

    // the tile's scores, kF32Group keys at a time; keys past tk get -inf
    float mx = -INFINITY;
#pragma unroll 1
    for (int j0 = 0; j0 < kF32Tile; j0 += kF32Group) {
      float s[kF32Group];
#pragma unroll
      for (int jj = 0; jj < kF32Group; ++jj) s[jj] = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
#pragma unroll
        for (int jj = 0; jj < kF32Group; ++jj) s[jj] = fmaf(qr[c], sK[(j0 + jj) * HD + c], s[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < kF32Group; ++jj) {
        const float sj = n0 + j0 + jj < tk ? s[jj] : -INFINITY;
        sS[(j0 + jj) * kTile + t] = sj;
        mx = fmaxf(mx, sj);
      }
    }
    // one step of the online softmax for the whole tile
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int c = 0; c < HD; ++c) acc[c] *= corr;
#pragma unroll 1
    for (int j0 = 0; j0 < kF32Tile; j0 += kF32Group) {
      float pj[kF32Group];
#pragma unroll
      for (int jj = 0; jj < kF32Group; ++jj) {
        pj[jj] = expf(sS[(j0 + jj) * kTile + t] - m);  // 0 past tk
        l += pj[jj];
      }
#pragma unroll
      for (int c = 0; c < HD; ++c) {
#pragma unroll
        for (int jj = 0; jj < kF32Group; ++jj) acc[c] = fmaf(pj[jj], sV[(j0 + jj) * HD + c], acc[c]);
      }
    }
    __syncthreads();  // buffer it & 1 is consumed: iteration it + 1 refills it
  }

  if (!active) return;
  const float inv = 1.f / l;
  float* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
  for (int c = 0; c < HD; ++c)
    if (c < d) orow[c] = acc[c] * inv;
  lse[(size_t)bh * tq + row] = m + logf(l);
}

// The launch as the plan gives it: warpgroups (0 for fp32) and the shared
// memory size, checked against the kernel's own.
struct Launch {
  int bh, nwg, smem_bytes;
  cudaStream_t stream;
};

template <int HD, int NWG>
cudaError_t launch_wgmma_as(const FwdParams& p, const Launch& l) {
  constexpr int smem = FwdSmem<HD, NWG>::kBytes;
  if (l.smem_bytes != smem) return cudaErrorInvalidValue;  // the planner disagrees
  const cudaError_t e = allow_smem(flash_fwd_wgmma_kernel<HD, NWG>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (p.tq + kTile - 1) / kTile;
  flash_fwd_wgmma_kernel<HD, NWG><<<tiles * l.bh * (HD / chunk_cols<HD>()), 128 * NWG, smem, l.stream>>>(p);
  return cudaGetLastError();
}

// the (head width, warpgroups) combinations the planner chooses from: one or
// two warpgroups per block, two only below D = 256
cudaError_t launch_wgmma(const FwdParams& p, const Launch& l, int hd) {
  switch (hd * 10 + l.nwg) {
    case 161: return launch_wgmma_as<16, 1>(p, l);
    case 162: return launch_wgmma_as<16, 2>(p, l);
    case 321: return launch_wgmma_as<32, 1>(p, l);
    case 322: return launch_wgmma_as<32, 2>(p, l);
    case 641: return launch_wgmma_as<64, 1>(p, l);
    case 642: return launch_wgmma_as<64, 2>(p, l);
    case 1281: return launch_wgmma_as<128, 1>(p, l);
    case 1282: return launch_wgmma_as<128, 2>(p, l);
    case 2561: return launch_wgmma_as<256, 1>(p, l);
    default: return cudaErrorInvalidValue;
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int tq, int tk, int d,
                       const Launch& l) {
  constexpr int smem = f32_smem_bytes<HD>();
  if (l.smem_bytes != smem) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(flash_fwd_f32_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_kernel<HD><<<((tq + kTile - 1) / kTile) * l.bh, kTile, smem, l.stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), tq, tk, d);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, tq, d); k, v: (bh, tk, d); o: (bh, tq, d) in the input dtype; lse:
// (bh, tq) fp32.  All contiguous; bf16 wants d % 8 == 0 and 16-byte aligned
// tensors.  dtype: 0 = bf16, 1 = fp32.  nwg, smem_bytes: the launch plan
// (`ops/flash_attention.py` `plan_flash_fwd`: warpgroups per block, 0 for
// fp32; shared memory bytes), checked against the kernel's.  Returns a
// cudaError_t (0 = launched).
extern "C" int jig_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int tq,
                             int tk, int d, int dtype, int nwg, int smem_bytes, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 1 || d > 256 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)((tq + kTile - 1) / kTile) * bh * 4 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int hd = head_width(d);
  const Launch l{bh, nwg, smem_bytes, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == 0) {
    const int ac = hd < kMaxChunk ? hd : kMaxChunk;
    const uintptr_t a = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v);
    FwdParams p{};
    p.o = static_cast<__nv_bfloat16*>(o);
    p.lse = static_cast<float*>(lse);
    p.tq = tq;
    p.tk = tk;
    p.d = d;
    if (d % 8 != 0 || a % 16 != 0 || !cached_map(&p.q_map, q, bh, tq, d, ac) ||
        !cached_map(&p.k_map, k, bh, tk, d, ac) || !cached_map(&p.v_map, v, bh, tk, d, ac))
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch_wgmma(p, l, hd);
  } else if (nwg != 0) {
    err = cudaErrorInvalidValue;
  } else if (hd == 16) {
    err = launch_f32<16>(q, k, v, o, lse, tq, tk, d, l);
  } else if (hd == 32) {
    err = launch_f32<32>(q, k, v, o, lse, tq, tk, d, l);
  } else if (hd == 64) {
    err = launch_f32<64>(q, k, v, o, lse, tq, tk, d, l);
  } else if (hd == 128) {
    err = launch_f32<128>(q, k, v, o, lse, tq, tk, d, l);
  } else {
    err = launch_f32<256>(q, k, v, o, lse, tq, tk, d, l);
  }
  return static_cast<int>(err);
}

#if JIG_FLASH_TRACE
// Profiling builds: the (blocks * warpgroups, 7) int64 device buffer the next
// launches write their phase clocks to.  Returns a cudaError_t.
extern "C" int jig_flash_fwd_trace(void* buf) {
  long long* p = static_cast<long long*>(buf);
  return static_cast<int>(cudaMemcpyToSymbol(g_trace, &p, sizeof(p)));
}
#endif
