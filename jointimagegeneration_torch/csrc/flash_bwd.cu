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

// fp32 design (`flash_bwd_dkv_f32_kernel`, `flash_bwd_dq_f32_kernel`; the
// dq entry runs `delta_f32_kernel` first).  Every product in full fp32 on the
// FMA pipes (one TF32 pass keeps a 10-bit mantissa, too coarse for fp32
// gradients), so the bound is the FMAs: dkv 8*BH*Tq*Tk*D flops, dq 6*, at 67
// TFLOP/s.  To get near it:
//   * The card is filled: a block of 256 threads owns 64 keys (dkv) or 64 q
//     rows (dq) and one output chunk of min(D, 64) head columns, and the
//     planner (`plan_flash_bwd`) splits its streamed loop (q tiles in dkv,
//     key tiles in dq) over `splits` blocks, so that the grid reaches about
//     two blocks per SM where the work allows.  A split writes its partial
//     dK/dV (dQ) to an fp32 workspace and `splits_reduce_f32_kernel` sums the
//     partials in split order (no float atomics; two calls are bitwise
//     equal); with one split the block writes the gradient itself.
//   * Register tiles: the 16 x 16 threads of a block each compute a micro-tile
//     of S and dP (4 of the block's rows x RT / 16 streamed rows) from float4
//     shared-memory reads, each feeding 4 x RT / 16 FMAs; P and dS go through a
//     transposed shared tile, and each thread then adds its 4 x CW (CW = chunk
//     / 16) micro-tile of dV, dK (dQ), reading one float4 of P / dS and the
//     chunk's CW columns per streamed row.  Shared rows are padded by 4
//     floats, so the lanes of a warp read distinct banks or broadcast.
//   * The streamed tiles (RT rows of Q and dO in dkv, of K and V in dq; RT =
//     64 up to D = 32, 32 up to D = 128, 16 at 256) are double-buffered by
//     cp.async, zero-filled past T and D; the LSE (scaled by log2 e, +inf past
//     Tq so that P = 0 there) and delta of the next tile are read into
//     registers while this one is computed.  Keys past Tk get P = 0 in dq
//     and are not written by dkv.  P = 2^(S log2e - LSE log2e): one FFMA and
//     one MUFU.EX2.
//   * The kernels take d % 4 == 0 and 16-byte aligned q, k, v, dO (the
//     wrapper pads with zero columns where they are not); any T >= 1.
//
// Launches on the caller's stream, allocates nothing (the wrapper passes the
// workspace), uses no float atomics, writes every output element once
// (results are the same call to call), and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

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

// ---- fp32 kernels ----

// rows of a streamed tile (Q / dO in dkv, K / V in dq)
template <int HD>
__host__ __device__ constexpr int f32_rows() {
  return HD <= 32 ? 64 : (HD <= 128 ? 32 : 16);
}

// Shared memory of an fp32 block, in floats: the block's own two tiles (K, V
// in dkv; Q, dO in dq; 64 rows of HD + kPad), two stages of the streamed pair
// (RT rows each), the row data (dkv: per stage RT scaled LSE and RT delta; dq:
// the block's 64 rows' scaled LSE and delta), then the transposed tiles (dkv:
// P and dS as (RT, 64 + kPad); dq: dS as (RT, 64 + kPad)).
template <bool kDkv, int HD>
struct F32Smem {
  static constexpr int RT = f32_rows<HD>(), LD = HD + kPad, LDT = kTile + kPad;
  static constexpr int kOwn = 2 * kTile * LD;
  static constexpr int kStage = 2 * RT * LD;
  static constexpr int kRows = kDkv ? 2 * 2 * RT : 2 * kTile;
  static constexpr int kTrans = (kDkv ? 2 : 1) * RT * LDT;
  static constexpr int kBytes = 4 * (kOwn + 2 * kStage + kRows + kTrans);
  static_assert(RT % 16 == 0 && kBytes <= 232448, "an fp32 block fits its shared memory");
};

struct F32Params {
  const float *q, *k, *v, *dout, *lse;
  const float* delta;  // (bh, tq), written by delta_f32_kernel
  float *out0, *out1;  // dkv: dk, dv; dq: dq (splits == 1)
  float* ws;           // splits > 1: (splits, n_out) partials, dkv's dk then dv
  long long n_out;     // floats of one split's partials: dkv 2 * bh * tk * d, dq bh * tq * d
  int tq, tk, d, splits;
};

// fp32 dK, dV.  Block (bh, 64-key tile, chunk, split); thread (ty, tx):
// S^T and dP^T for keys ty + 16 i and q rows tx + 16 j of each streamed tile,
// then dK, dV for keys 4 ty + i and the chunk's columns tx CW + e.
template <int HD>
__global__ void __launch_bounds__(kF32Threads, HD <= 64 ? 2 : 1)
flash_bwd_dkv_f32_kernel(const __grid_constant__ F32Params p) {
  using S = F32Smem<true, HD>;
  constexpr int RT = S::RT, LD = S::LD, LDT = S::LDT, TR = RT / 16;
  constexpr int DC = chunk_cols<HD>(), NCH = HD / DC, CW = DC / 16;
  extern __shared__ __align__(16) float smf[];
  float* const sK = smf;
  float* const sV = sK + kTile * LD;
  float* const stages = sV + kTile * LD;
  float* const sRows = stages + 2 * S::kStage;  // per stage: scaled LSE [RT], delta [RT]
  float* const sP = sRows + 4 * RT;             // (RT, LDT): P[row][key]
  float* const sDS = sP + RT * LDT;             // dS[row][key]

  const int tq = p.tq, tk = p.tk, d = p.d, splits = p.splits;
  const int n_kt = (tk + kTile - 1) / kTile;
  int blk = blockIdx.x;
  const int s = blk % splits;
  blk /= splits;
  const int chunk = blk % NCH;
  blk /= NCH;
  const int n0 = (blk % n_kt) * kTile;
  const int bh = blk / n_kt;
  const int n_qt = (tq + RT - 1) / RT;
  const int j0 = split_start(s, n_qt, splits), j1 = split_start(s + 1, n_qt, splits);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int ty = 4 * (warp >> 1) + (lane >> 3), tx = 8 * (warp & 1) + (lane & 7);
  const float* qb = p.q + (size_t)bh * tq * d;
  const float* dob = p.dout + (size_t)bh * tq * d;
  const float* lseb = p.lse + (size_t)bh * tq;
  const float* deltab = p.delta + (size_t)bh * tq;

  // the next tile's row data passes through registers (thread t < RT: row t)
  float next_l = 0.f, next_d = 0.f;
  auto fetch_rows = [&](int j) {
    if (t < RT) {
      const int row = j * RT + t;
      next_l = row < tq ? lseb[row] * kLog2e : INFINITY;  // P = 0 past tq
      next_d = row < tq ? deltab[row] : 0.f;
    }
  };
  auto put_rows = [&](int j) {
    if (t < RT) {
      sRows[(j & 1) * 2 * RT + t] = next_l;
      sRows[(j & 1) * 2 * RT + RT + t] = next_d;
    }
  };
  auto load_stage = [&](int j) {
    float* st = stages + (j & 1) * S::kStage;
    load_rows<HD, RT>(st, qb, j * RT, tq, d, t);
    load_rows<HD, RT>(st + RT * LD, dob, j * RT, tq, d, t);
  };

  load_rows<HD, kTile>(sK, p.k + (size_t)bh * tk * d, n0, tk, d, t);
  load_rows<HD, kTile>(sV, p.v + (size_t)bh * tk * d, n0, tk, d, t);
  if (j0 < j1) {
    load_stage(j0);
    fetch_rows(j0);
    put_rows(j0);
  }
  cp_async_commit();

  float dk[4][CW] = {}, dv[4][CW] = {};
  for (int j = j0; j < j1; ++j) {
    if (j + 1 < j1) {  // its buffer was consumed in iteration j - 1
      load_stage(j + 1);
      fetch_rows(j + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage j (and the own tiles) have landed, from every thread's copies
    const float* sQ = stages + (j & 1) * S::kStage;
    const float* sdO = sQ + RT * LD;
    const float* rl = sRows + (j & 1) * 2 * RT;

    // S^T = K Q^T and dP^T = V dO^T: keys ty + 16 i, rows tx + 16 jj
    float st[4][TR] = {}, dpt[4][TR] = {};
    dot_tile<HD, TR>(st, sK, ty, sQ, tx);
    dot_tile<HD, TR>(dpt, sV, ty, sdO, tx);
#pragma unroll
    for (int jj = 0; jj < TR; ++jj) {
      const int r = tx + 16 * jj;
      const float l2 = rl[r], dl = rl[RT + r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = ex2_approx(fmaf(st[i][jj], kLog2e, -l2));
        sP[r * LDT + ty + 16 * i] = pv;
        sDS[r * LDT + ty + 16 * i] = pv * (dpt[i][jj] - dl);
      }
    }
    __syncthreads();  // P and dS are complete

    // dV += P^T dO and dK += dS^T Q over the tile's rows: keys 4 ty + i, columns tx CW + e
    const int col = chunk * DC + tx * CW;
#pragma unroll 4
    for (int r = 0; r < RT; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(sP + r * LDT + 4 * ty);
      const float4 sv = *reinterpret_cast<const float4*>(sDS + r * LDT + 4 * ty);
      float ov[CW], qv[CW];
      load_cols<CW>(ov, sdO + r * LD + col);
      load_cols<CW>(qv, sQ + r * LD + col);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w}, sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < CW; ++e) {
          dv[i][e] = fmaf(pa[i], ov[e], dv[i][e]);
          dk[i][e] = fmaf(sa[i], qv[e], dk[i][e]);
        }
    }
    if (j + 1 < j1) put_rows(j + 1);  // its slot was read in iteration j - 1
    __syncthreads();                  // stage j and the transposed tiles are consumed
  }
  cp_async_wait<0>();  // a split with no tile still waits for its own tiles' copies

  float *dkp = p.out0, *dvp = p.out1;
  if (splits > 1) {
    dkp = p.ws + (size_t)s * p.n_out;
    dvp = dkp + p.n_out / 2;
  }
  const size_t off = (size_t)bh * tk * d;
  store_tile<CW>(dkp + off, dk, n0 + 4 * ty, tk, chunk * DC + tx * CW, d);
  store_tile<CW>(dvp + off, dv, n0 + 4 * ty, tk, chunk * DC + tx * CW, d);
}

// fp32 dQ.  Block (bh, 64-row tile, chunk, split); thread (ty, tx): S and dP
// for q rows ty + 16 i and keys tx + 16 j of each streamed tile, then dQ for
// rows 4 ty + i and the chunk's columns tx CW + e.
template <int HD>
__global__ void __launch_bounds__(kF32Threads, HD <= 64 ? 2 : 1)
flash_bwd_dq_f32_kernel(const __grid_constant__ F32Params p) {
  using S = F32Smem<false, HD>;
  constexpr int RT = S::RT, LD = S::LD, LDT = S::LDT, TR = RT / 16;
  constexpr int DC = chunk_cols<HD>(), NCH = HD / DC, CW = DC / 16;
  extern __shared__ __align__(16) float smf[];
  float* const sQ = smf;
  float* const sdO = sQ + kTile * LD;
  float* const stages = sdO + kTile * LD;
  float* const sL = stages + 2 * S::kStage;  // the block's rows: scaled LSE [64], delta [64]
  float* const sDS = sL + 2 * kTile;         // (RT, LDT): dS[key][row]

  const int tq = p.tq, tk = p.tk, d = p.d, splits = p.splits;
  const int n_mt = (tq + kTile - 1) / kTile;
  int blk = blockIdx.x;
  const int s = blk % splits;
  blk /= splits;
  const int chunk = blk % NCH;
  blk /= NCH;
  const int m0 = (blk % n_mt) * kTile;
  const int bh = blk / n_mt;
  const int n_kt = (tk + RT - 1) / RT;
  const int j0 = split_start(s, n_kt, splits), j1 = split_start(s + 1, n_kt, splits);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int ty = 4 * (warp >> 1) + (lane >> 3), tx = 8 * (warp & 1) + (lane & 7);
  const float* kb = p.k + (size_t)bh * tk * d;
  const float* vb = p.v + (size_t)bh * tk * d;
  auto load_stage = [&](int j) {
    float* st = stages + (j & 1) * S::kStage;
    load_rows<HD, RT>(st, kb, j * RT, tk, d, t);
    load_rows<HD, RT>(st + RT * LD, vb, j * RT, tk, d, t);
  };

  load_rows<HD, kTile>(sQ, p.q + (size_t)bh * tq * d, m0, tq, d, t);
  load_rows<HD, kTile>(sdO, p.dout + (size_t)bh * tq * d, m0, tq, d, t);
  if (j0 < j1) load_stage(j0);
  cp_async_commit();
  if (t < kTile) {  // rows past tq are never written: any finite values
    const int row = m0 + t;
    sL[t] = row < tq ? p.lse[(size_t)bh * tq + row] * kLog2e : 0.f;
    sL[kTile + t] = row < tq ? p.delta[(size_t)bh * tq + row] : 0.f;
  }

  float dq[4][CW] = {};
  for (int j = j0; j < j1; ++j) {
    if (j + 1 < j1) load_stage(j + 1);  // its buffer was consumed in iteration j - 1
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage j (and the own tiles and row data) have landed
    const float* sK = stages + (j & 1) * S::kStage;
    const float* sV = sK + RT * LD;

    // S = Q K^T and dP = dO V^T: rows ty + 16 i, keys tx + 16 jj
    float sc[4][TR] = {}, dp[4][TR] = {};
    dot_tile<HD, TR>(sc, sQ, ty, sK, tx);
    dot_tile<HD, TR>(dp, sdO, ty, sV, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float l2 = sL[r], dl = sL[kTile + r];
#pragma unroll
      for (int jj = 0; jj < TR; ++jj) {
        const int key = tx + 16 * jj;
        const float pv = j * RT + key < tk ? ex2_approx(fmaf(sc[i][jj], kLog2e, -l2)) : 0.f;  // P = 0 past tk
        sDS[key * LDT + r] = pv * (dp[i][jj] - dl);
      }
    }
    __syncthreads();  // dS is complete

    // dQ += dS K over the tile's keys: rows 4 ty + i, columns tx CW + e
    const int col = chunk * DC + tx * CW;
#pragma unroll 4
    for (int r = 0; r < RT; ++r) {
      const float4 sv = *reinterpret_cast<const float4*>(sDS + r * LDT + 4 * ty);
      float kv[CW];
      load_cols<CW>(kv, sK + r * LD + col);
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < CW; ++e) dq[i][e] = fmaf(sa[i], kv[e], dq[i][e]);
    }
    __syncthreads();  // stage j and dS are consumed
  }
  cp_async_wait<0>();

  float* dqp = splits > 1 ? p.ws + (size_t)s * p.n_out : p.out0;
  store_tile<CW>(dqp + (size_t)bh * tq * d, dq, m0 + 4 * ty, tq, chunk * DC + tx * CW, d);
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

// out[i] = sum over s = 0 ... splits - 1, in that order, of ws[s][i]: the
// fp32 kernels' split partials, float4 at a time (n4 float4s a split)
__global__ void __launch_bounds__(256) splits_reduce_f32_kernel(const float4* __restrict__ ws,
                                                                float4* __restrict__ out, long long n4, int splits) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  float4 a = ws[i];
  for (int s = 1; s < splits; ++s) {
    const float4 b = ws[s * n4 + i];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  out[i] = a;
}

// The launch as the plan gives it: warpgroups (0 for fp32), the splits of
// the streamed loop (1 for bf16) and the shared memory size, checked against
// the kernel's own; the fp32 kernels' workspace of split partials.
struct Launch {
  int bh, nwg, splits, smem_bytes;
  void* ws;
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

template <bool kDkv, int HD>
cudaError_t launch_f32(const BwdParams& b, const Launch& l) {
  constexpr int smem = F32Smem<kDkv, HD>::kBytes;
  if (l.smem_bytes != smem) return cudaErrorInvalidValue;  // the planner disagrees
  auto kernel = kDkv ? flash_bwd_dkv_f32_kernel<HD> : flash_bwd_dq_f32_kernel<HD>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  F32Params p{};
  p.q = static_cast<const float*>(b.q);
  p.k = static_cast<const float*>(b.k);
  p.v = static_cast<const float*>(b.v);
  p.dout = static_cast<const float*>(b.dout);
  p.lse = b.lse;
  p.delta = b.delta;
  p.out0 = static_cast<float*>(b.out0);
  p.out1 = static_cast<float*>(b.out1);
  p.ws = static_cast<float*>(l.ws);
  p.n_out = (long long)(kDkv ? 2 : 1) * l.bh * (kDkv ? b.tk : b.tq) * b.d;
  p.tq = b.tq;
  p.tk = b.tk;
  p.d = b.d;
  p.splits = l.splits;
  if (!kDkv) {
    const int rows = l.bh * b.tq;
    delta_f32_kernel<<<(rows + 7) / 8, 256, 0, l.stream>>>(static_cast<const float*>(b.o), p.dout, b.delta, rows,
                                                           b.d);
  }
  const int tiles = ((kDkv ? b.tk : b.tq) + kTile - 1) / kTile;
  kernel<<<tiles * l.bh * (HD / chunk_cols<HD>()) * l.splits, kF32Threads, smem, l.stream>>>(p);
  return cudaGetLastError();
}

// Dispatch on the padded head width.  bf16 wants d % 8 == 0, tq % 4 == 0 (the
// LSE and delta rows dkv copies start on 16 bytes) and 16-byte aligned
// tensors: what TMA takes (the wrapper pads otherwise).  fp32 wants d % 4 ==
// 0 and 16-byte aligned q, k, v, dO (cp.async), a workspace where splits > 1,
// and fp32 outputs 16-byte aligned.
template <bool kDkv>
int dispatch(BwdParams& p, const Launch& l, int dtype) {
  if (l.bh < 1 || p.tq < 1 || p.tk < 1 || p.d < 1 || p.d > 256 || (dtype != 0 && dtype != 1) || l.splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)(((kDkv ? p.tk : p.tq) + kTile - 1) / kTile) * l.bh * 4 * l.splits > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int hd = head_width(p.d);
  if (dtype == 0) {
    const int ac = hd < kMaxChunk ? hd : kMaxChunk;
    const uintptr_t a = reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
                        reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.o) |
                        reinterpret_cast<uintptr_t>(p.dout) | reinterpret_cast<uintptr_t>(p.lse) |
                        reinterpret_cast<uintptr_t>(p.delta);
    if (l.splits != 1 || p.d % 8 != 0 || (kDkv && p.tq % 4 != 0) || a % 16 != 0 ||
        !cached_map(&p.q_map, p.q, l.bh, p.tq, p.d, ac) || !cached_map(&p.k_map, p.k, l.bh, p.tk, p.d, ac) ||
        !cached_map(&p.v_map, p.v, l.bh, p.tk, p.d, ac) || !cached_map(&p.do_map, p.dout, l.bh, p.tq, p.d, ac) ||
        (kDkv && (!cached_map(&p.lse_map, p.lse, l.bh, p.tq, 1, 0) ||
                  !cached_map(&p.delta_map, p.delta, l.bh, p.tq, 1, 0))))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_wgmma<kDkv>(p, l, hd));
  }
  const uintptr_t a = reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
                      reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.dout) |
                      reinterpret_cast<uintptr_t>(p.out0) | reinterpret_cast<uintptr_t>(p.out1) |
                      reinterpret_cast<uintptr_t>(l.ws);
  if (l.nwg != 0 || p.d % 4 != 0 || a % 16 != 0 || (l.splits > 1) != (l.ws != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (hd == 16) err = launch_f32<kDkv, 16>(p, l);
  else if (hd == 32) err = launch_f32<kDkv, 32>(p, l);
  else if (hd == 64) err = launch_f32<kDkv, 64>(p, l);
  else if (hd == 128) err = launch_f32<kDkv, 128>(p, l);
  else err = launch_f32<kDkv, 256>(p, l);
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
// tensors, fp32 d % 4 == 0 and 16-byte aligned tensors.  dtype: 0 = bf16, 1 =
// fp32.  nwg, splits, smem_bytes: the launch plan (`ops/flash_attention.py`
// `plan_flash_bwd`: warpgroups per block, 0 for the fp32 kernels; the splits
// of the q loop, 1 for bf16; shared memory bytes), checked against the
// kernels'.  ws: with splits > 1, the (splits, 2, bh, tk, d) fp32 workspace of
// the split partials, dk's then dv's, which jig_flash_bwd_reduce then sums
// into dk (dv must follow dk in memory); else null.  Returns a cudaError_t (0
// = launched).
extern "C" int jig_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, void* ws, int bh, int tq, int tk, int d,
                                 int dtype, int nwg, int splits, int smem_bytes, void* stream) {
  BwdParams p = params(q, k, v, q, dout, lse, const_cast<void*>(delta), dk, dv, tq, tk, d);
  return dispatch<true>(p, Launch{bh, nwg, splits, smem_bytes, ws, static_cast<cudaStream_t>(stream)}, dtype);
}

// As jig_flash_bwd_dkv, plus o: (bh, tq, d) in the input dtype; writes delta
// (bh, tq) fp32 and dq: (bh, tq, d) in the input dtype (with splits > 1, the
// (splits, bh, tq, d) partials to ws, for jig_flash_bwd_reduce).
extern "C" int jig_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                const void* lse, void* delta, void* dq, void* ws, int bh, int tq, int tk, int d,
                                int dtype, int nwg, int splits, int smem_bytes, void* stream) {
  BwdParams p = params(q, k, v, o, dout, lse, delta, dq, nullptr, tq, tk, d);
  return dispatch<false>(p, Launch{bh, nwg, splits, smem_bytes, ws, static_cast<cudaStream_t>(stream)}, dtype);
}

// out[i] = ws[0][i] + ws[1][i] + ... + ws[splits - 1][i], summed in that order,
// for i < n (n % 4 == 0; ws (splits, n) and out (n) fp32, 16-byte aligned):
// the fp32 kernels' split partials.  Returns a cudaError_t.
extern "C" int jig_flash_bwd_reduce(const void* ws, void* out, long long n, int splits, void* stream) {
  if (n < 4 || n % 4 != 0 || splits < 2 ||
      (reinterpret_cast<uintptr_t>(ws) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  splits_reduce_f32_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(ws), static_cast<float4*>(out), n4, splits);
  return static_cast<int>(cudaGetLastError());
}

#if JIG_FLASH_TRACE
// Profiling builds: the (blocks * warpgroups, 7) int64 device buffer the next
// launches write their phase clocks to.  Returns a cudaError_t.
extern "C" int jig_flash_bwd_trace(void* buf) {
  long long* p = static_cast<long long*>(buf);
  return static_cast<int>(cudaMemcpyToSymbol(g_trace, &p, sizeof(p)));
}
#endif
