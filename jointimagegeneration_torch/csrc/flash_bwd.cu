// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the two TPU kernels of jointimagegeneration_tpu/ops/pallas/
// flash_attention.py's `_flash_backward`: `_bwd_dkv_kernel` (dK, dV) and
// `_bwd_dq_kernel` (dQ), and the rowsum that function leaves to XLA.  Over
// (BH, T, D) row-major tensors, q already scaled by 1/sqrt(D), with the
// forward's O and fp32 LSE:
//
//   delta = rowsum(dO * O)   P = exp(q k^T - LSE)   dP = dO v^T   dS = P * (dP - delta)
//   dV = P^T dO      dK = dS^T q      dQ = dS k
//
// As the TPU kernels do, P is rounded to dO's dtype before P^T dO and dS to
// q's (k's) dtype before dS^T q (dS k); delta, P, dP, dS and every
// accumulator are fp32; dQ, dK, dV are written in the input dtype.  The dq
// kernel runs first and writes delta (fp32) for the dkv kernel.
//
// Bound on an H100 SXM.  The function does five products of 2*BH*Tq*Tk*D
// flops each (S, dP, dV, dK, dQ) on the tensor cores and one exponential per
// (q, key) pair on the MUFU (16 per clock per SM).  At the training shapes'
// D = 32 the two are of one size: at (8, 2048, 32) dkv's four products take
// 8.7 us at 989 TFLOP/s and its 3.4e7 exponentials 8.0 us at 1.98 GHz, and
// dq (three products) is bound by its exponentials; HBM traffic is several
// times smaller.  The split into two kernels recomputes S, dP and P in each (7
// products, 2 exponential passes, instead of 5 and 1), the price of writing
// every gradient once with no float atomics.
//
// bf16 design (`flash_bwd_dkv_wgmma_kernel`, `flash_bwd_dq_wgmma_kernel`):
//   * Every product is a wgmma (hopper.cuh).  dkv: a block owns 64 keys of
//     one head-column chunk; per streamed 64-row q tile a warpgroup computes
//     S^T = K Q^T and dP^T = V dO^T (A = the block's K or V, B = the Q or dO
//     tile, K-major), turns them into P^T and dS^T in registers, re-packs
//     those as bf16 A fragments and adds dV += P^T dO and dK += dS^T Q in the
//     RS form, reading the same dO and Q tiles MN-major through the
//     transpose-B bit.  dq: a block owns 64 q rows; per streamed 64-key tile
//     S = Q K^T and dP = dO V^T, then dQ += dS K (RS, K read MN-major).  No
//     tile is stored twice or transposed.  Up to D = 32 the block's own tiles
//     enter S and dP as register fragments loaded once (RS form); above, by
//     descriptor (SS form).  The tile layout, its TMA copies and descriptors
//     and the host's tensor maps are in flash_common.cuh, shared with the
//     forward.
//   * Tiles live in shared memory in the hardware's swizzle: rows of 32, 64
//     or 128 bytes at D = 16, 32 and >= 64 (64-column atoms), 1024-byte
//     aligned.  TMA copies them (and dkv's LSE and delta rows), one thread
//     issuing a tile's copies, which complete on an mbarrier and zero-fill
//     past T and D.  Each warpgroup streams its tiles (Q, dO, LSE, delta in
//     dkv; K, V in dq) through its own ring of two stages: after the
//     warpgroup's barrier says stage j - 1 is consumed, its thread 0 refills
//     it, so tile j + 1 loads under tile j's products.  (Copies issued
//     by all 128 threads with cp.async cost 45% of each iteration in issue
//     stalls alone; `scripts/bench_flash_bwd.py --trace` reads the phases.)
//   * Warpgroups: one per block (dkv: three blocks on an SM up to D = 32, two
//     above; dq: up to four), so that one warpgroup's exponentials overlap
//     another's wgmma.  Where dq blocks are few, two warpgroups split the
//     block's key loop, each with its own accumulator, summed once at the
//     end through shared memory, warpgroup 0's plus warpgroup 1's: the same
//     order every call.  The host-side planner (`ops/flash_attention.py`
//     `plan_flash_bwd`) chooses; the kernel checks its shared-memory size
//     against the plan's.
//   * Exponentials: P = 2^(S * log2e - LSE * log2e), one FFMA and one
//     MUFU.EX2 per element, LSE and delta read per tile as float2 pairs of
//     the columns (dkv) or held per row in registers (dq).
//   * Ragged shapes: q rows past Tq get LSE = +inf (P = 0) in dkv and are not
//     written by dq; keys past Tk get P = 0 in dq and are not written by dkv;
//     D is padded with zeros to the head width (16/32/64/128/256).  Output
//     head columns are chunked at 64 (one block per chunk, each recomputing
//     S and dP over all of D), which bounds the accumulators at D = 256.
//     TMA wants d % 8 == 0, tq % 4 == 0 and 16-byte aligned tensors; the
//     wrapper pads with zero columns and rows where they are not.
//   * delta: each dq block sums dO * O over its 64 rows in fp32 from device
//     memory while its first tiles load, and block (row tile, chunk 0) writes
//     them to the (BH, Tq) buffer dkv reads.

// fp32 (`flash_bwd_dkv_f32_kernel`, `flash_bwd_dq_f32_kernel`): one thread per
// key (dkv) or q row (dq), plain FMA over fp32 tiles in shared memory
// (broadcast reads) with expf; tensor cores would round through TF32.  The fp32
// dq entry computes delta with `delta_f32_kernel` first.
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

constexpr int kF32Tile = 32;  // rows per shared-memory tile (fp32 kernels)

// Warpgroup 1's accumulator to warpgroup 0's through the shared scratch `red`
// (warpgroup 1's consumed ring): warpgroup 0 adds it to its own, in that
// order; returns false for warpgroup 1, which then has nothing to store.
template <int N>
__device__ __forceinline__ bool sum_warpgroups(float (&a)[N], float* red, int wg, int t) {
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * 128 + t] = a[i];
  }
  __syncthreads();
  if (wg == 1) return false;
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] += red[i * 128 + t];
  return true;
}

struct BwdParams {
  // bf16 kernels: TMA maps of q, k, v, dO as (d, T, bh) with boxes (AC, 64, 1),
  // and of LSE and delta as (bh * tq) fp32 with boxes of 64 (dkv only)
  CUtensorMap q_map, k_map, v_map, do_map, lse_map, delta_map;
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // (bh, tq)
  float* delta;      // (bh, tq): written by dq, read by dkv
  void *out0, *out1; // dkv: dk, dv; dq: dq
  int tq, tk, d;
};

// Shared memory of a block: 1024 bytes of slack for aligning the base, then a
// 1024-byte control slot (the mbarriers; dq also keeps its 64 rows' delta
// there, at byte 512), the block's own two tiles (K and V in dkv, Q and dO in
// dq), then per warpgroup a ring of kStages stages: dkv (Q tile, dO tile, 64
// LSE and 64 delta in a 1024-byte slot); dq (K tile, V tile).
template <bool kDkv, int HD, int NWG>
struct Smem {
  static constexpr int kStage = 2 * Tile<HD>::BYTES + (kDkv ? 1024 : 0);
  static constexpr int kRing = kStages * kStage;
  static constexpr int kOwn = 1024;                          // the block's own tiles, after the control slot
  static constexpr int kRings = kOwn + 2 * Tile<HD>::BYTES;  // the first warpgroup's ring
  static constexpr int kBytes = 1024 + kRings + NWG * kRing;
  static_assert((kDkv ? 2 : 1) * 64 * Tile<HD>::AC * 4 <= kRing, "the reduction scratch fits in a ring");
  static_assert(8 * (1 + NWG * kStages) <= 512, "the barriers fit in the control slot");
};
// One warpgroup per block, three blocks on an SM up to D = 32 (at most 170
// registers, which the D = 64 instance could only meet by spilling), else two.
// (Two warpgroups splitting the q loop measured slower at every training shape.)
template <int HD>
__global__ void __launch_bounds__(128, HD <= 32 ? 3 : 2)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ BwdParams p) {
  using T = Tile<HD>;
  using S = Smem<true, HD, 1>;
  constexpr int DC = T::AC, NCH = HD / DC;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t raw = smem_u32(smem_tiles);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_tiles + (base - raw);
  const uint32_t sK = base + S::kOwn, sV = sK + T::BYTES;

  const int tq = p.tq, tk = p.tk, d = p.d;
  const int n_tiles = (tk + kTile - 1) / kTile;
  const int chunk = blockIdx.x % NCH;
  const int n0 = ((blockIdx.x / NCH) % n_tiles) * kTile;
  const int bh = blockIdx.x / NCH / n_tiles;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // the q tiles, through the ring, each stage filled by TMA (issued by thread 0) on the stage's barrier
  const int n_q = (tq + kTile - 1) / kTile;
  auto load_stage = [&](int j) {
    const int m0 = j * kTile, off = S::kRings + (j % kStages) * S::kStage;
    const uint32_t bar = bar_addr(base, 1 + j % kStages);
    mbar_expect_tx(bar, 2 * T::BYTES + 2 * 256);
    tma_tile<HD>(base + off, p.q_map, m0, bh, bar);
    tma_tile<HD>(base + off + T::BYTES, p.do_map, m0, bh, bar);
    tma_load_1d(base + off + 2 * T::BYTES, &p.lse_map, bh * tq + m0, bar);  // rows past tq: masked below
    tma_load_1d(base + off + 2 * T::BYTES + 256, &p.delta_map, bh * tq + m0, bar);
  };
  if (t == 0) {
    start_block<HD, 1>(base, &p.k_map, &p.v_map, n0, bh);
    prefetch_tensormap(&p.q_map);
    prefetch_tensormap(&p.do_map);
    prefetch_tensormap(&p.lse_map);
    prefetch_tensormap(&p.delta_map);
  }
  __syncthreads();  // the barriers are initialised
  if (t == 0) {
    for (int j = 0; j < kStages - 1 && j < n_q; ++j) load_stage(j);
  }
  mbar_wait(bar_addr(base, 0), 0);  // K and V have landed
  uint32_t kf[kFrags<HD>][4], vf[kFrags<HD>][4];
  if constexpr (kFragA<HD>) {
    load_frags<HD>(kf, sK, warp, lane);
    load_frags<HD>(vf, sV, warp, lane);
  }

  float dk_acc[DC / 2], dv_acc[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  Phases ph;  // 0 stage wait, 1 barrier and refill issue, 2 S, 3 P, 4 dV issue and dP, 5 dS, 6 dK and the wait
  ph.mark(-1);
  for (int j = 0; j < n_q; ++j) {
    __syncthreads();  // the warpgroup is done with stage j - 1: it may be refilled
    if (t == 0 && j + kStages - 1 < n_q) load_stage(j + kStages - 1);
    ph.mark(1);
    mbar_wait(bar_addr(base, 1 + j % kStages), (j / kStages) & 1);
    ph.mark(0);

    const int m0 = j * kTile, off = S::kRings + (j % kStages) * S::kStage;
    const uint32_t sQ = base + off, sdO = sQ + T::BYTES;
    const float2* sL = reinterpret_cast<const float2*>(sm + off + 2 * T::BYTES);  // (LSE, delta) pairs
    const float2* sD = sL + 32;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys (this warp's 16) x 64 q rows
    float s[32], dp[32];
    wgmma_fence();
    product_over_d<HD>(s, kf, sK, sQ);
    wgmma_commit();
    product_over_d<HD>(dp, vf, sV, sdO);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(s);
    ph.mark(2);
    // P^T: the columns are q rows; rows past tq get LSE = +inf, so P = 0
    const int valid = tq - m0;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int c = 8 * jn + 2 * t4;
      const float2 l = sL[4 * jn + t4];
      const float l0 = c < valid ? l.x * kLog2e : INFINITY;
      const float l1 = c + 1 < valid ? l.y * kLog2e : INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * jn + e] = ex2_approx(fmaf(s[4 * jn + e], kLog2e, -((e & 1) ? l1 : l0)));
    }
    ph.mark(3);
    // dV += P^T dO (dO read MN-major) runs while dS is computed
    uint32_t pa[4][4], da[4][4];
    pack_frags(pa, s);
    fence_operands(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DC, true>(dv_acc, pa[kk], mndesc<HD>(sdO, chunk, kk));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is done
    fence_operands(dp);
    ph.mark(4);
    // dS^T; delta of rows past tq is finite (the next head's, or 0) and meets P = 0
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float2 dl = sD[4 * jn + t4];
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * jn + e] = s[4 * jn + e] * (dp[4 * jn + e] - ((e & 1) ? dl.y : dl.x));
    }
    // dK += dS^T Q over the tile's 64 q rows, Q read MN-major
    pack_frags(da, dp);
    ph.mark(5);
    fence_operands(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DC, true>(dk_acc, da[kk], mndesc<HD>(sQ, chunk, kk));
    wgmma_commit();
    wgmma_wait<0>();  // the stage is free once the whole warpgroup passes the next barrier
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    ph.mark(6);
  }
  ph.store(blockIdx.x, t == 0);

  const int row0 = n0 + warp * 16;
  store_acc<DC>(static_cast<__nv_bfloat16*>(p.out0) + (size_t)bh * tk * d, dk_acc, row0, tk, chunk * DC, d, g, t4);
  store_acc<DC>(static_cast<__nv_bfloat16*>(p.out1) + (size_t)bh * tk * d, dv_acc, row0, tk, chunk * DC, d, g, t4);
}

template <int HD, int NWG>
__global__ void __launch_bounds__(128 * NWG, NWG == 1 ? 2 : 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ BwdParams p) {
  using T = Tile<HD>;
  using S = Smem<false, HD, NWG>;
  constexpr int DC = T::AC, NCH = HD / DC;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t raw = smem_u32(smem_tiles);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_tiles + (base - raw);
  float* const sDelta = reinterpret_cast<float*>(sm + 512);
  const uint32_t sQ = base + S::kOwn, sdO = sQ + T::BYTES;

  const int tq = p.tq, tk = p.tk, d = p.d;
  const int n_tiles = (tq + kTile - 1) / kTile;
  const int chunk = blockIdx.x % NCH;
  const int m0 = ((blockIdx.x / NCH) % n_tiles) * kTile;
  const int bh = blockIdx.x / NCH / n_tiles;
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(p.dout) + (size_t)bh * tq * d;
  const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(p.o) + (size_t)bh * tq * d;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // this warpgroup's key tiles wg, wg + NWG, ..., through its ring
  const int n_local = ((tk + kTile - 1) / kTile - wg + NWG - 1) / NWG;
  const int ring_off = S::kRings + wg * S::kRing;
  auto load_stage = [&](int j) {
    const int n0 = (wg + j * NWG) * kTile, off = ring_off + (j % kStages) * S::kStage;
    const uint32_t bar = bar_addr(base, 1 + wg * kStages + j % kStages);
    mbar_expect_tx(bar, 2 * T::BYTES);
    tma_tile<HD>(base + off, p.k_map, n0, bh, bar);
    tma_tile<HD>(base + off + T::BYTES, p.v_map, n0, bh, bar);
  };
  if (tid == 0) start_block<HD, NWG>(base, &p.q_map, &p.do_map, m0, bh);
  if (t == 0) {
    prefetch_tensormap(&p.k_map);
    prefetch_tensormap(&p.v_map);
  }
  __syncthreads();  // the barriers are initialised
  if (t == 0) {
    for (int j = 0; j < kStages - 1 && j < n_local; ++j) load_stage(j);
  }

  // delta = rowsum(dO * O) in fp32 for the block's 64 rows, TPR adjacent lanes per row, while the tiles load
  {
    constexpr int TPR = 2 * NWG;
    const int r = tid / TPR, part = tid % TPR, row = m0 + r;
    float acc = 0.f;
    if (row < tq) {
      const __nv_bfloat16* orow = ob + (size_t)row * d;
      const __nv_bfloat16* drow = dob + (size_t)row * d;
      for (int c = part * 8; c < d; c += TPR * 8) {  // d % 8 == 0, rows 16-byte aligned
        const uint4 uo = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 ud = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat16* po = reinterpret_cast<const __nv_bfloat16*>(&uo);
        const __nv_bfloat16* pd = reinterpret_cast<const __nv_bfloat16*>(&ud);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc += __bfloat162float(pd[i]) * __bfloat162float(po[i]);
      }
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (part == 0) {
      sDelta[r] = acc;
      if (chunk == 0 && row < tq) p.delta[(size_t)bh * tq + row] = acc;
    }
  }
  mbar_wait(bar_addr(base, 0), 0);  // Q and dO have landed
  __syncthreads();                  // and delta is in shared memory
  uint32_t qf[kFrags<HD>][4], of[kFrags<HD>][4];
  if constexpr (kFragA<HD>) {
    load_frags<HD>(qf, sQ, warp, lane);
    load_frags<HD>(of, sdO, warp, lane);
  }

  // this thread's rows warp * 16 + g and + 8: scaled LSE and delta; padded rows are never written
  float lse_s[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = warp * 16 + g + 8 * r;
    lse_s[r] = m0 + rr < tq ? p.lse[(size_t)bh * tq + m0 + rr] * kLog2e : 0.f;
    delta_r[r] = sDelta[rr];
  }
  float dq_acc[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dq_acc[i] = 0.f;

  Phases ph;  // 0 stage wait, 1 barrier and refill issue, 2 S, 3 P, 4 dP, 5 dS, 6 dQ and the wait
  ph.mark(-1);
  for (int j = 0; j < n_local; ++j) {
    if (wg == 0) named_barrier_sync<1, 128>();
    else named_barrier_sync<2, 128>();
    if (t == 0 && j + kStages - 1 < n_local) load_stage(j + kStages - 1);
    ph.mark(1);
    mbar_wait(bar_addr(base, 1 + wg * kStages + j % kStages), (j / kStages) & 1);
    ph.mark(0);

    const int n0 = (wg + j * NWG) * kTile, off = ring_off + (j % kStages) * S::kStage;
    const uint32_t sK = base + off, sV = sK + T::BYTES;

    // S = Q K^T and dP = dO V^T: 64 q rows (this warp's 16) x 64 keys
    float s[32], dp[32];
    wgmma_fence();
    product_over_d<HD>(s, qf, sQ, sK);
    wgmma_commit();
    product_over_d<HD>(dp, of, sdO, sV);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(s);
    ph.mark(2);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = ex2_approx(fmaf(s[i], kLog2e, -lse_s[(i >> 1) & 1]));
    if (n0 + kTile > tk) {  // keys past tk: P = 0
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (n0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= tk) s[i] = 0.f;
    }
    ph.mark(3);
    wgmma_wait<0>();
    fence_operands(dp);
    ph.mark(4);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - delta_r[(i >> 1) & 1]);
    // dQ += dS K over the tile's 64 keys, K read MN-major
    uint32_t da[4][4];
    pack_frags(da, dp);
    ph.mark(5);
    fence_operands(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DC, true>(dq_acc, da[kk], mndesc<HD>(sK, chunk, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dq_acc);
    ph.mark(6);
  }
  ph.store(blockIdx.x * NWG + wg, t == 0);

  if constexpr (NWG == 2) {
    if (!sum_warpgroups(dq_acc, reinterpret_cast<float*>(sm + S::kRings + S::kRing), wg, t)) return;
  }
  store_acc<DC>(static_cast<__nv_bfloat16*>(p.out0) + (size_t)bh * tq * d, dq_acc, m0 + warp * 16, tq, chunk * DC,
                d, g, t4);
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

// fp32 delta = rowsum(dO * O): one warp per row, lanes over the columns, then
// a butterfly sum (a fixed order)
__global__ void __launch_bounds__(256) delta_f32_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                                                        float* __restrict__ delta, int rows, int d) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += dout[(size_t)row * d + c] * o[(size_t)row * d + c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// The launch as the plan gives it: warpgroups and the shared memory
// size, checked against the kernel's own.
struct Launch {
  int bh, nwg, smem_bytes;
  cudaStream_t stream;
};

template <bool kDkv, int HD, int NWG>
cudaError_t launch_wgmma_as(const BwdParams& p, const Launch& l) {
  constexpr int smem = Smem<kDkv, HD, NWG>::kBytes;
  if (l.smem_bytes != smem) return cudaErrorInvalidValue;  // the planner disagrees
  auto kernel = kDkv ? flash_bwd_dkv_wgmma_kernel<HD> : flash_bwd_dq_wgmma_kernel<HD, NWG>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int tiles = ((kDkv ? p.tk : p.tq) + kTile - 1) / kTile;
  kernel<<<tiles * l.bh * (HD / chunk_cols<HD>()), 128 * NWG, smem, l.stream>>>(p);
  return cudaGetLastError();
}

// the (head width, warpgroups) combinations the planner chooses from: dkv one
// warpgroup per block, dq one or two (two only below D = 256)
template <bool kDkv>
cudaError_t launch_wgmma(const BwdParams& p, const Launch& l, int hd) {
  if (l.nwg != 1 && (kDkv || l.nwg != 2 || hd == 256)) return cudaErrorInvalidValue;
  switch (hd * 10 + l.nwg) {
    case 161: return launch_wgmma_as<kDkv, 16, 1>(p, l);
    case 162: return launch_wgmma_as<kDkv, 16, 2>(p, l);
    case 321: return launch_wgmma_as<kDkv, 32, 1>(p, l);
    case 322: return launch_wgmma_as<kDkv, 32, 2>(p, l);
    case 641: return launch_wgmma_as<kDkv, 64, 1>(p, l);
    case 642: return launch_wgmma_as<kDkv, 64, 2>(p, l);
    case 1281: return launch_wgmma_as<kDkv, 128, 1>(p, l);
    case 1282: return launch_wgmma_as<kDkv, 128, 2>(p, l);
    case 2561: return launch_wgmma_as<kDkv, 256, 1>(p, l);
    default: return cudaErrorInvalidValue;
  }
}

template <int HD>
cudaError_t launch_f32(const BwdParams& p, const Launch& l, bool dkv) {
  cudaError_t err;
  const int tiles = ((dkv ? p.tk : p.tq) + kTile - 1) / kTile;
  const float *q = static_cast<const float*>(p.q), *k = static_cast<const float*>(p.k),
              *v = static_cast<const float*>(p.v), *dout = static_cast<const float*>(p.dout);
  if (dkv) {
    constexpr int smem = f32_smem_bytes<HD>();
    if (l.smem_bytes != smem) return cudaErrorInvalidValue;
    if ((err = allow_smem(flash_bwd_dkv_f32_kernel<HD>, smem)) != cudaSuccess) return err;
    flash_bwd_dkv_f32_kernel<HD><<<tiles * l.bh, kTile, smem, l.stream>>>(
        q, k, v, dout, p.lse, p.delta, static_cast<float*>(p.out0), static_cast<float*>(p.out1), p.tq, p.tk, p.d);
  } else {
    constexpr int smem = 2 * kF32Tile * HD * 4;
    if (l.smem_bytes != smem) return cudaErrorInvalidValue;
    if ((err = allow_smem(flash_bwd_dq_f32_kernel<HD>, smem)) != cudaSuccess) return err;
    const int rows = l.bh * p.tq;
    delta_f32_kernel<<<(rows + 7) / 8, 256, 0, l.stream>>>(static_cast<const float*>(p.o), dout, p.delta, rows,
                                                           p.d);
    flash_bwd_dq_f32_kernel<HD><<<tiles * l.bh, kTile, smem, l.stream>>>(
        q, k, v, dout, p.lse, p.delta, static_cast<float*>(p.out0), p.tq, p.tk, p.d);
  }
  return cudaGetLastError();
}

// Dispatch on the padded head width.  bf16 wants d % 8 == 0, tq % 4 == 0 (the
// LSE and delta rows dkv copies start on 16 bytes) and 16-byte aligned
// tensors: what TMA takes (the wrapper pads otherwise).
template <bool kDkv>
int dispatch(BwdParams& p, const Launch& l, int dtype) {
  if (l.bh < 1 || p.tq < 1 || p.tk < 1 || p.d < 1 || p.d > 256 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)(((kDkv ? p.tk : p.tq) + kTile - 1) / kTile) * l.bh * 4 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int hd = head_width(p.d);
  if (dtype == 0) {
    const int ac = hd < kMaxChunk ? hd : kMaxChunk;
    const uintptr_t a = reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
                        reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.o) |
                        reinterpret_cast<uintptr_t>(p.dout) | reinterpret_cast<uintptr_t>(p.lse) |
                        reinterpret_cast<uintptr_t>(p.delta);
    if (p.d % 8 != 0 || (kDkv && p.tq % 4 != 0) || a % 16 != 0 || !cached_map(&p.q_map, p.q, l.bh, p.tq, p.d, ac) ||
        !cached_map(&p.k_map, p.k, l.bh, p.tk, p.d, ac) || !cached_map(&p.v_map, p.v, l.bh, p.tk, p.d, ac) ||
        !cached_map(&p.do_map, p.dout, l.bh, p.tq, p.d, ac) ||
        (kDkv && (!cached_map(&p.lse_map, p.lse, l.bh, p.tq, 1, 0) ||
                  !cached_map(&p.delta_map, p.delta, l.bh, p.tq, 1, 0))))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_wgmma<kDkv>(p, l, hd));
  }
  if (l.nwg != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (hd == 16) err = launch_f32<16>(p, l, kDkv);
  else if (hd == 32) err = launch_f32<32>(p, l, kDkv);
  else if (hd == 64) err = launch_f32<64>(p, l, kDkv);
  else if (hd == 128) err = launch_f32<128>(p, l, kDkv);
  else err = launch_f32<256>(p, l, kDkv);
  return static_cast<int>(err);
}

BwdParams params(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
                 void* delta, void* out0, void* out1, int tq, int tk, int d) {
  BwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.out0 = out0;
  p.out1 = out1;
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  return p;
}

}  // namespace

// q, dout: (bh, tq, d); k, v: (bh, tk, d); lse, delta: (bh, tq) fp32 (delta as
// written by jig_flash_bwd_dq); dk, dv: (bh, tk, d) in the input dtype.  All
// contiguous; bf16 wants d % 8 == 0, tq % 4 == 0 and 16-byte aligned
// tensors.  dtype: 0 =
// bf16, 1 = fp32.  nwg, smem_bytes: the launch plan (`ops/flash_attention.py`
// `plan_flash_bwd`: warpgroups per block, 0 for the fp32 kernels; shared
// memory bytes), checked against the kernels'.  Returns a cudaError_t (0 =
// launched).
extern "C" int jig_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int bh, int tq, int tk, int d, int dtype,
                                 int nwg, int smem_bytes, void* stream) {
  BwdParams p = params(q, k, v, q, dout, lse, const_cast<void*>(delta), dk, dv, tq, tk, d);
  return dispatch<true>(p, Launch{bh, nwg, smem_bytes, static_cast<cudaStream_t>(stream)}, dtype);
}

// As jig_flash_bwd_dkv, plus o: (bh, tq, d) in the input dtype; writes delta
// (bh, tq) fp32 and dq: (bh, tq, d) in the input dtype.
extern "C" int jig_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                const void* lse, void* delta, void* dq, int bh, int tq, int tk, int d, int dtype,
                                int nwg, int smem_bytes, void* stream) {
  BwdParams p = params(q, k, v, o, dout, lse, delta, dq, nullptr, tq, tk, d);
  return dispatch<false>(p, Launch{bh, nwg, smem_bytes, static_cast<cudaStream_t>(stream)}, dtype);
}

#if JIG_FLASH_TRACE
// Profiling builds: the (blocks * warpgroups, 7) int64 device buffer the next
// launches write their phase clocks to.  Returns a cudaError_t.
extern "C" int jig_flash_bwd_trace(void* buf) {
  long long* p = static_cast<long long*>(buf);
  return static_cast<int>(cudaMemcpyToSymbol(g_trace, &p, sizeof(p)));
}
#endif
