// What the flash-attention kernels (flash_fwd.cu, flash_bwd.cu) share on top
// of hopper.cuh: the swizzled (64, HD) bf16 tile and its descriptors, its TMA
// copies, the block's start (barriers and its own tiles), A fragments from a
// tile or from an accumulator, the product over the head dim, the bf16 store
// of an accumulator, the phase clock of profiling builds, and on the host the
// tensor maps, encoded once per (address, shape) and cached.
//
// Everything here has internal linkage (one copy in each library).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;      // rows of a block's own tile and of every streamed tile
constexpr int kMaxChunk = 64;  // head columns of output per block
constexpr int kStages = 2;     // stages in each warpgroup's ring of streamed tiles
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
__host__ __device__ constexpr int chunk_cols() {
  return HD < kMaxChunk ? HD : kMaxChunk;
}

// A (64, HD) bf16 tile in shared memory: HD / AC atoms of 64 rows x RB bytes,
// each swizzled (hopper.cuh); an atom holds one output chunk's AC columns.
template <int HD>
struct Tile {
  static constexpr int AC = chunk_cols<HD>();  // columns per atom
  static constexpr int RB = 2 * AC;            // bytes per atom row: the swizzle, 32, 64 or 128
  static constexpr int ATOM = kTile * RB;      // bytes per atom
  static constexpr int BYTES = kTile * HD * 2;
  static_assert(HD % 16 == 0 && HD % AC == 0, "head width of 16, 32, 64, 128 or 256");
};

// K-major descriptor of k-step ks (head columns 16ks ... 16ks + 15) of a tile
template <int HD>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int ks) {
  using T = Tile<HD>;
  return kmajor_desc<T::RB>(tile + (ks * 16 / T::AC) * T::ATOM + (ks * 16 % T::AC) * 2);
}
// MN-major descriptor of rows 16kk ... 16kk + 15 (K) and the columns of chunk ch (N) of a tile
template <int HD>
__device__ __forceinline__ uint64_t mndesc(uint32_t tile, int ch, int kk) {
  using T = Tile<HD>;
  return mnmajor_desc<T::RB>(tile + ch * T::ATOM + kk * 16 * T::RB, T::ATOM);
}

// Rows [row0, row0 + 64) of head bh of a (bh, T, d) bf16 tensor into the tile
// at dst: one TMA copy per atom (the tensor map's boxes are AC columns x 64
// rows, swizzled as the atoms are), completing on barrier bar; rows past T and
// columns past d arrive as zeros.  Issued by one thread.
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap& map, int row0, int bh, uint32_t bar) {
  using T = Tile<HD>;
#pragma unroll
  for (int a = 0; a < HD / T::AC; ++a) tma_load_3d(dst + a * T::ATOM, &map, a * T::AC, row0, bh, bar);
}

// Rows g and g + 8 of each warp's 16 of a (64, DC) wgmma accumulator, in bf16,
// to out[row0 + ...][col0 + ...], skipping rows past n_rows and columns past d.
template <int DC>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, const float (&acc)[DC / 2], int row0, int n_rows,
                                          int col0, int d, int g, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
    __nv_bfloat16* orow = out + (size_t)row * d;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      const int col = col0 + j * 8 + t4 * 2;
      const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
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

// Two 8-column accumulator tiles (fp32, rows g and g + 8, columns 2t4 and
// 2t4 + 1 of each) hold exactly the values of one 16 x 16 A fragment, rounded
// to bf16 (hopper.cuh's register layouts)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void pack_a_frag(uint32_t (&a)[4], const float (&lo)[4], const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}
// bf16 A fragments of the four k16 steps of a (64, 64) fp32 accumulator: its
// 8-column tiles 2kk and 2kk + 1
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4], const float (&acc)[32]) {
  const auto& tiles = reinterpret_cast<const float(&)[8][4]>(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) pack_a_frag(a[kk], tiles[2 * kk], tiles[2 * kk + 1]);
}

// A fragments of this warp's 16 rows of a tile, every k16 step of the head
// dim, by ldmatrix from the swizzled layout
template <int HD>
__device__ __forceinline__ void load_frags(uint32_t (&f)[HD / 16][4], uint32_t tile, int warp, int lane) {
  using T = Tile<HD>;
  const int r = warp * 16 + (lane & 15);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int c = 2 * ks + (lane >> 4);
    ldmatrix_x4(f[ks], tile + (c / (T::AC / 8)) * T::ATOM + swizzle_off<T::RB>(r, c % (T::AC / 8)));
  }
}

// Up to D = 32 a block's own tiles (K, V in dkv; Q, dO in dq; Q in the
// forward) enter the products over D as register fragments, loaded once (the
// RS form: wgmma reads only the streamed tile from shared memory); above,
// both operands come by descriptor (the SS form).  (At D = 64 the RS form
// with fragments of the 128-byte swizzle gave a wrong S from the second
// streamed tile on, in the forward and in dq, on an H100; the SS form is
// right there.)
template <int HD>
constexpr bool kFragA = HD <= 32;
template <int HD>
constexpr int kFrags = kFragA<HD> ? HD / 16 : 1;

// D (64 x 64, fp32) = A B^T over the head dim: A the block's tile (fragments
// `af`, or the tile at a_tile), B the streamed tile at b_tile, both K-major
template <int HD>
__device__ __forceinline__ void product_over_d(float (&d)[32], const uint32_t (&af)[kFrags<HD>][4], uint32_t a_tile,
                                               uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    if constexpr (kFragA<HD>) {
      wgmma_rs<64>(d, af[ks], kdesc<HD>(b_tile, ks), ks);
    } else {
      wgmma_ss64(d, kdesc<HD>(a_tile, ks), kdesc<HD>(b_tile, ks), ks);
    }
  }
}

// A block's shared memory starts (after up to 1024 bytes of slack for aligning
// the base) with a 1024-byte control slot: barrier 0 is the block's own
// tiles', barrier 1 + w * kStages + s warpgroup w's stage s's.  The block's own
// tiles follow at base + 1024.
__device__ __forceinline__ uint32_t bar_addr(uint32_t base, int i) { return base + 8 * i; }

// One thread's share of a block's start: initialises the barriers and has TMA
// bring the block's own tiles (rows row0 ... row0 + 63 of head bh of a, and of
// b unless it is null) to base + 1024 and on
template <int HD, int NWG>
__device__ __forceinline__ void start_block(uint32_t base, const CUtensorMap* a, const CUtensorMap* b, int row0,
                                            int bh) {
  for (int i = 0; i < 1 + NWG * kStages; ++i) mbar_init(bar_addr(base, i), 1);
  fence_mbar_init();
  prefetch_tensormap(a);
  if (b) prefetch_tensormap(b);
  mbar_expect_tx(bar_addr(base, 0), (b ? 2 : 1) * Tile<HD>::BYTES);
  tma_tile<HD>(base + 1024, *a, row0, bh, bar_addr(base, 0));
  if (b) tma_tile<HD>(base + 1024 + Tile<HD>::BYTES, *b, row0, bh, bar_addr(base, 0));
}

// ---- the fp32 kernels' register-tiled products (flash_fwd.cu, flash_bwd.cu) ----

constexpr int kF32Threads = 256;  // a block: 16 x 16 threads
constexpr int kPad = 4;           // floats of padding per shared row

// rows [row0, row0 + R) of a (T, d) fp32 matrix into a shared (R, HD + kPad)
// tile by cp.async, 16 bytes a copy, zeros past T and d (d % 4 == 0)
template <int HD, int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int t_rows, int d, int t) {
  constexpr int Q4 = HD / 4;
#pragma unroll
  for (int i = t; i < R * Q4; i += kF32Threads) {
    const int r = i / Q4, c = (i % Q4) * 4;
    const bool in = row0 + r < t_rows && c < d;
    cp_async16(smem_u32(dst + r * (HD + kPad) + c), in ? src + (size_t)(row0 + r) * d + c : src, in ? 16 : 0);
  }
}

// The streamed tiles of split s of n: [s n / splits, (s + 1) n / splits)
__device__ __forceinline__ int split_start(int s, int n, int splits) {
  return (int)((long long)s * n / splits);
}

// acc[i][jj] += a_row(i) . b_row(jj) over the head dim: a rows at a + (a0 +
// 16 i) * LD (i < 4), b rows at b + (b0 + 16 jj) * LD (jj < TR), float4 reads
template <int HD, int TR>
__device__ __forceinline__ void dot_tile(float (&acc)[4][TR], const float* a, int a0, const float* b, int b0) {
  constexpr int LD = HD + kPad;
#pragma unroll 4
  for (int c = 0; c < HD; c += 4) {
    float4 av[4], bv[TR];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + (a0 + 16 * i) * LD + c);
#pragma unroll
    for (int j = 0; j < TR; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (b0 + 16 * j) * LD + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// CW consecutive floats from shared memory (16-, 8- or 4-byte aligned)
template <int CW>
__device__ __forceinline__ void load_cols(float (&x)[CW], const float* p) {
  if constexpr (CW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (CW == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}

// A thread's 4 x CW micro-tile (rows row0 + i, columns col0 + e) of a (rows,
// d) fp32 output; rows past n_rows and columns past d are not written
template <int CW>
__device__ __forceinline__ void store_tile(float* out, float (&acc)[4][CW], int row0, int n_rows, int col0,
                                           int d) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row0 + i >= n_rows) continue;
    float* o = out + (size_t)(row0 + i) * d + col0;
    if constexpr (CW == 4) {
      if (col0 < d) *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int e = 0; e < CW; ++e)
        if (col0 + e < d) o[e] = acc[i][e];
    }
  }
}

// Profiling builds only (JIG_FLASH_TRACE = 1; `scripts/bench_flash_bwd.py
// --trace`, `scripts/bench_flash_fwd.py --trace`): thread 0 of each warpgroup
// sums the SM clocks of its k loop's phases (`Phases::mark`) and stores them
// to the (blocks * warpgroups, kPhases) buffer the library's
// jig_flash_{fwd,bwd}_trace names.  A no-op in every build the port loads.
#ifndef JIG_FLASH_TRACE
#define JIG_FLASH_TRACE 0
#endif
constexpr int kPhases = 7;
#if JIG_FLASH_TRACE
__device__ long long* g_trace;
#endif
struct Phases {
  long long last = 0, sum[kPhases] = {};
  __device__ __forceinline__ void mark(int i) {
#if JIG_FLASH_TRACE
    const long long now = clock64();
    if (i >= 0) sum[i] += now - last;
    last = now;
#endif
  }
  __device__ __forceinline__ void store(int slot, bool leader) {
#if JIG_FLASH_TRACE
    if (leader)
      for (int i = 0; i < kPhases; ++i) g_trace[(long long)slot * kPhases + i] = sum[i];
#endif
  }
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A (bh, t, d) bf16 tensor as TMA sees it, (d, t, bh) with boxes of (ac, 64, 1)
// in the swizzle of ac-column rows; a (n,) fp32 vector with boxes of 64
bool tile_map(CUtensorMap* m, const void* ptr, int bh, int t, int d, int ac) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)ac, (cuuint32_t)kTile, 1u}, step[3] = {1u, 1u, 1u};
  const CUtensorMapSwizzle sw =
      ac == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : (ac == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  const EncodeTiled encode = encode_tiled();
  return encode && encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, step,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
bool row_map(CUtensorMap* m, const void* ptr, long long n) {
  const cuuint64_t dims[1] = {(cuuint64_t)n}, strides[1] = {4};
  const cuuint32_t box[1] = {(cuuint32_t)kTile}, step[1] = {1u};
  const EncodeTiled encode = encode_tiled();
  return encode && encode(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, strides, box, step,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map is a pure function of (address, shape, box), so the last 64
// encoded are kept: a call on tensors PyTorch's allocator has handed out
// before skips encoding it again.  ac > 0: tile_map's; ac == 0: row_map's of
// bh * t elements.
bool cached_map(CUtensorMap* m, const void* ptr, int bh, int t, int d, int ac) {
  struct Entry {
    const void* ptr;
    int bh, t, d, ac;
    CUtensorMap map;
  };
  static Entry cache[64];
  static int used = 0, next = 0;
  static std::mutex mu;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.ptr == ptr && e.bh == bh && e.t == t && e.d == d && e.ac == ac) {
      *m = e.map;
      return true;
    }
  }
  if (!(ac > 0 ? tile_map(m, ptr, bh, t, d, ac) : row_map(m, ptr, (long long)bh * t))) return false;
  cache[next] = Entry{ptr, bh, t, d, ac, *m};
  next = (next + 1) % 64;
  used = used < 64 ? used + 1 : 64;
  return true;
}

// The head width a kernel instance is built for: D padded to 16, 32, 64, 128 or 256
inline int head_width(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256; }

}  // namespace
