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
// fp32 (`flash_fwd_f32_kernel`, `flash_fwd_merge_f32_kernel`): both
// products in full fp32 on the FMA pipes (one TF32 pass keeps a 10-bit
// mantissa, too coarse for an fp32 O), so the bound is 4*BH*Tq*Tk*D flops at
// 67 TFLOP/s.  The design is the fp32 backward's (flash_bwd.cu):
//   * The card is filled: a block of 256 threads owns 64 q rows and one
//     output chunk of min(D, 64) head columns, and the planner
//     (`plan_flash_fwd`) splits its key loop over `splits` blocks where the
//     grid is small (the refiner's (8, 512, 64) has 64 blocks for 132 SMs).
//     A split writes its (m, l, unnormalised O) to an fp32 workspace, and
//     `flash_fwd_merge_f32_kernel` combines the splits in split order: m =
//     max m_s, l = sum l_s 2^((m_s - m) log2e), O = sum O_s 2^(...) / l,
//     LSE = m + log l; a split that saw no key (m = -1e30, l = 0, O = 0)
//     adds nothing.  No float atomics: two calls are bitwise equal.  With one
//     split the block writes O and LSE itself.
//   * Register tiles: thread (ty, tx) of the 16 x 16 computes S for q rows
//     ty + 16 i (i < 4) and keys tx + 16 j of each streamed tile from float4
//     shared-memory reads (rows padded by 4 floats: conflict-free or
//     broadcast).  The 16 threads of a row are one half-warp, so its max and
//     sum are four shuffles.  P goes through a shared (keys, 64 + 4) tile,
//     its rows permuted so that a thread's four q rows are one float4, and
//     each thread adds its 4 x CW (CW = chunk / 16) micro-tile of O for the
//     same four rows, so the per-row rescale stays in registers.
//   * K and V tiles of `f32_fwd_rows` keys (64 up to D = 64, 32 at 128, 16
//     at 256) are double-buffered by cp.async, zero-filled past Tk and D;
//     keys past Tk get S = -inf.  P = 2^(S log2e - m log2e): one FFMA and one
//     MUFU.EX2.  The kernel takes d % 4 == 0 and 16-byte aligned q, k, v, O
//     and workspace (the wrapper pads with zero columns where they are not).
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

// ---- fp32 ----

// keys of a streamed K / V tile
template <int HD>
__host__ __device__ constexpr int f32_fwd_rows() {
  return HD <= 64 ? 64 : (HD <= 128 ? 32 : 16);
}

// Shared memory of an fp32 block, in floats: the block's Q tile (64 rows of
// HD + kPad), two stages of (K tile, V tile) of RT rows each, then P as
// (RT, 64 + kPad) with q row r at column 4 (r % 16) + r / 16.
template <int HD>
struct F32FwdSmem {
  static constexpr int RT = f32_fwd_rows<HD>(), LD = HD + kPad, LDT = kTile + kPad;
  static constexpr int kStage = 2 * RT * LD;
  static constexpr int kBytes = 4 * (kTile * LD + 2 * kStage + RT * LDT);
  static_assert(RT % 16 == 0 && kBytes <= 232448, "an fp32 block fits its shared memory");
};

struct F32FwdParams {
  const float *q, *k, *v;
  float *o, *lse;       // splits == 1: (bh, tq, d), (bh, tq)
  float *ws_o, *ws_ml;  // splits > 1: (splits, bh, tq, d) unnormalised O, (splits, bh, tq, 2) (m, l)
  long long rows;       // bh * tq
  int tq, tk, d, splits;
};

// fp32 forward.  Block (bh, 64-row q tile, chunk, split); thread (ty, tx):
// S for q rows ty + 16 i and keys tx + 16 j of each streamed tile, then O
// for rows ty + 16 i and the chunk's columns tx CW + e.  Two blocks on an SM
// up to D = 64 (at most 128 registers a thread), one above.
template <int HD>
__global__ void __launch_bounds__(kF32Threads, HD <= 64 ? 2 : 1)
flash_fwd_f32_kernel(const __grid_constant__ F32FwdParams p) {
  using S = F32FwdSmem<HD>;
  constexpr int RT = S::RT, LD = S::LD, LDT = S::LDT, TR = RT / 16;
  constexpr int DC = chunk_cols<HD>(), NCH = HD / DC, CW = DC / 16;
  extern __shared__ __align__(16) float smf[];
  float* const sQ = smf;
  float* const stages = sQ + kTile * LD;
  float* const sP = stages + 2 * S::kStage;  // (RT, LDT): P[key][4 (row % 16) + row / 16]

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
  const int ty = 2 * warp + (lane >> 4), tx = lane & 15;  // a row's 16 threads: one half-warp
  const float* kb = p.k + (size_t)bh * tk * d;
  const float* vb = p.v + (size_t)bh * tk * d;
  auto load_stage = [&](int j) {
    float* st = stages + (j & 1) * S::kStage;
    load_rows<HD, RT>(st, kb, j * RT, tk, d, t);
    load_rows<HD, RT>(st + RT * LD, vb, j * RT, tk, d, t);
  };

  load_rows<HD, kTile>(sQ, p.q + (size_t)bh * tq * d, m0, tq, d, t);
  if (j0 < j1) load_stage(j0);
  cp_async_commit();

  float o[4][CW] = {};
  float m_r[4] = {kNegInit, kNegInit, kNegInit, kNegInit};  // rows ty + 16 i, in natural units
  float l_r[4] = {};                                        // this thread's share of their denominators
  for (int j = j0; j < j1; ++j) {
    if (j + 1 < j1) load_stage(j + 1);  // its buffer was consumed in iteration j - 1
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage j (and Q) have landed, from every thread's copies
    const float* sK = stages + (j & 1) * S::kStage;
    const float* sV = sK + RT * LD;

    // S = Q K^T: rows ty + 16 i, keys tx + 16 jj; keys past tk to -inf
    float sc[4][TR] = {};
    dot_tile<HD, TR>(sc, sQ, ty, sK, tx);
#pragma unroll
    for (int jj = 0; jj < TR; ++jj)
      if (j * RT + tx + 16 * jj >= tk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i][jj] = -INFINITY;
      }
    // one online-softmax step per row: the tile's max over the half-warp,
    // then P = 2^(S log2e - m log2e), the rescale of l and O
    float scale[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = sc[i][0];
#pragma unroll
      for (int jj = 1; jj < TR; ++jj) mx = fmaxf(mx, sc[i][jj]);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      scale[i] = ex2_approx((m_r[i] - m_new) * kLog2e);
      m_r[i] = m_new;
      const float ml = m_new * kLog2e;
      l_r[i] *= scale[i];
#pragma unroll
      for (int jj = 0; jj < TR; ++jj) {
        sc[i][jj] = ex2_approx(fmaf(sc[i][jj], kLog2e, -ml));  // 0 past tk
        l_r[i] += sc[i][jj];
      }
#pragma unroll
      for (int e = 0; e < CW; ++e) o[i][e] *= scale[i];
    }
#pragma unroll
    for (int jj = 0; jj < TR; ++jj)
      *reinterpret_cast<float4*>(sP + (tx + 16 * jj) * LDT + 4 * ty) =
          make_float4(sc[0][jj], sc[1][jj], sc[2][jj], sc[3][jj]);
    __syncthreads();  // P is complete

    // O += P V over the tile's keys: rows ty + 16 i, columns tx CW + e
    const int col = chunk * DC + tx * CW;
#pragma unroll 4
    for (int r = 0; r < RT; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(sP + r * LDT + 4 * ty);
      float vv[CW];
      load_cols<CW>(vv, sV + r * LD + col);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < CW; ++e) o[i][e] = fmaf(pa[i], vv[e], o[i][e]);
    }
    __syncthreads();  // stage j and P are consumed
  }
  cp_async_wait<0>();  // a split with no tile still waits for its Q copies

#pragma unroll
  for (int i = 0; i < 4; ++i)  // the half-warp's shares: the rows' whole denominators, in a fixed order
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], off);
  const int col0 = chunk * DC + tx * CW;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row >= tq) continue;
      const float inv = 1.f / l_r[i];
      float* orow = p.o + ((size_t)bh * tq + row) * d + col0;
#pragma unroll
      for (int e = 0; e < CW; ++e) o[i][e] *= inv;
      if constexpr (CW == 4) {
        if (col0 < d) *reinterpret_cast<float4*>(orow) = make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
      } else {
#pragma unroll
        for (int e = 0; e < CW; ++e)
          if (col0 + e < d) orow[e] = o[i][e];
      }
      if (chunk == 0 && tx == 0) p.lse[(size_t)bh * tq + row] = m_r[i] + logf(l_r[i]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= tq) continue;
    const size_t r = (size_t)bh * tq + row;
    float* orow = p.ws_o + ((size_t)s * p.rows + r) * d + col0;
    if constexpr (CW == 4) {
      if (col0 < d) *reinterpret_cast<float4*>(orow) = make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
    } else {
#pragma unroll
      for (int e = 0; e < CW; ++e)
        if (col0 + e < d) orow[e] = o[i][e];
    }
    if (chunk == 0 && tx == 0)
      *reinterpret_cast<float2*>(p.ws_ml + ((size_t)s * p.rows + r) * 2) = make_float2(m_r[i], l_r[i]);
  }
}

// The fp32 splits' merge: thread (row, 4 columns) reads the splits' (m, l)
// of its row and their unnormalised O columns, and writes O = sum_s O_s a_s /
// l and (column group 0) LSE = m + log l, with m = max_s m_s, a_s =
// 2^((m_s - m) log2e), l = sum_s l_s a_s, every sum in split order.
__global__ void __launch_bounds__(256)
flash_fwd_merge_f32_kernel(const float4* __restrict__ ws_o, const float2* __restrict__ ws_ml,
                           float4* __restrict__ o, float* __restrict__ lse, long long rows, int d4, int splits) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= rows * d4) return;
  const long long r = i / d4;
  float m = kNegInit;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ws_ml[s * rows + r].x);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float2 ml = ws_ml[s * rows + r];
    const float a = ex2_approx((ml.x - m) * kLog2e);  // 0 for a split that saw no key
    const float4 v = ws_o[s * rows * d4 + i];
    l = fmaf(ml.y, a, l);
    acc.x = fmaf(v.x, a, acc.x);
    acc.y = fmaf(v.y, a, acc.y);
    acc.z = fmaf(v.z, a, acc.z);
    acc.w = fmaf(v.w, a, acc.w);
  }
  const float inv = 1.f / l;
  o[i] = make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  if (i % d4 == 0) lse[r] = m + logf(l);
}

// The launch as the plan gives it: warpgroups (0 for fp32), the splits of
// the key loop (1 for bf16) and the shared memory size, checked against the
// kernel's own.
struct Launch {
  int bh, nwg, splits, smem_bytes;
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
cudaError_t launch_f32(const F32FwdParams& p, const Launch& l) {
  constexpr int smem = F32FwdSmem<HD>::kBytes, rt = F32FwdSmem<HD>::RT;
  // the planner disagrees, or a split would get no key tile
  if (l.smem_bytes != smem || p.splits > (p.tk + rt - 1) / rt) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(flash_fwd_f32_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (p.tq + kTile - 1) / kTile;
  flash_fwd_f32_kernel<HD><<<tiles * l.bh * (HD / chunk_cols<HD>()) * l.splits, kF32Threads, smem, l.stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, tq, d); k, v: (bh, tk, d); o: (bh, tq, d) in the input dtype; lse:
// (bh, tq) fp32.  All contiguous; bf16 wants d % 8 == 0 and 16-byte aligned
// tensors, fp32 d % 4 == 0 and 16-byte aligned tensors.  dtype: 0 = bf16,
// 1 = fp32.  nwg, splits, smem_bytes: the launch plan (`ops/flash_attention.py`
// `plan_flash_fwd`: warpgroups per block, 0 for fp32; the splits of the fp32
// key loop, 1 for bf16, at most one per key tile; shared memory bytes),
// checked against the kernel's.  ws_o, ws_ml: with splits > 1, the fp32
// workspace of the splits' unnormalised O (splits, bh, tq, d) and (m, l)
// (splits, bh, tq, 2), which jig_flash_fwd_merge then combines into o and
// lse; else null.  Returns a cudaError_t (0 = launched).
extern "C" int jig_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* ws_o,
                             void* ws_ml, int bh, int tq, int tk, int d, int dtype, int nwg, int splits,
                             int smem_bytes, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 1 || d > 256 || (dtype != 0 && dtype != 1) || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)((tq + kTile - 1) / kTile) * bh * 4 * splits > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int hd = head_width(d);
  const Launch l{bh, nwg, splits, smem_bytes, static_cast<cudaStream_t>(stream)};
  const uintptr_t a = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v);
  if (dtype == 0) {
    const int ac = hd < kMaxChunk ? hd : kMaxChunk;
    FwdParams p{};
    p.o = static_cast<__nv_bfloat16*>(o);
    p.lse = static_cast<float*>(lse);
    p.tq = tq;
    p.tk = tk;
    p.d = d;
    if (splits != 1 || ws_o || ws_ml || d % 8 != 0 || a % 16 != 0 || !cached_map(&p.q_map, q, bh, tq, d, ac) ||
        !cached_map(&p.k_map, k, bh, tk, d, ac) || !cached_map(&p.v_map, v, bh, tk, d, ac))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_wgmma(p, l, hd));
  }
  const uintptr_t w = reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(ws_o) |
                      reinterpret_cast<uintptr_t>(ws_ml);
  if (nwg != 0 || d % 4 != 0 || (a | w) % 16 != 0 || (splits > 1) != (ws_o != nullptr) ||
      (splits > 1) != (ws_ml != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  F32FwdParams p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.ws_o = static_cast<float*>(ws_o);
  p.ws_ml = static_cast<float*>(ws_ml);
  p.rows = (long long)bh * tq;
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.splits = splits;
  cudaError_t err;
  if (hd == 16) err = launch_f32<16>(p, l);
  else if (hd == 32) err = launch_f32<32>(p, l);
  else if (hd == 64) err = launch_f32<64>(p, l);
  else if (hd == 128) err = launch_f32<128>(p, l);
  else err = launch_f32<256>(p, l);
  return static_cast<int>(err);
}

// o (rows, d), lse (rows,) fp32 from the fp32 forward's split workspace:
// ws_o (splits, rows, d), ws_ml (splits, rows, 2), combined in split order
// (rows = bh * tq; d % 4 == 0; all 16-byte aligned).  Returns a cudaError_t.
extern "C" int jig_flash_fwd_merge(const void* ws_o, const void* ws_ml, void* o, void* lse, long long rows, int d,
                                   int splits, void* stream) {
  if (rows < 1 || d < 4 || d % 4 != 0 || splits < 2 ||
      (reinterpret_cast<uintptr_t>(ws_o) | reinterpret_cast<uintptr_t>(ws_ml) | reinterpret_cast<uintptr_t>(o)) %
              16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = rows * (d / 4);
  flash_fwd_merge_f32_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(ws_o), static_cast<const float2*>(ws_ml), static_cast<float4*>(o),
      static_cast<float*>(lse), rows, d / 4, splits);
  return static_cast<int>(cudaGetLastError());
}

#if JIG_FLASH_TRACE
// Profiling builds: the (blocks * warpgroups, 7) int64 device buffer the next
// launches write their phase clocks to.  Returns a cudaError_t.
extern "C" int jig_flash_fwd_trace(void* buf) {
  long long* p = static_cast<long long*>(buf);
  return static_cast<int>(cudaMemcpyToSymbol(g_trace, &p, sizeof(p)));
}
#endif
