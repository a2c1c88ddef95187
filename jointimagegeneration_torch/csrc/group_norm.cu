// GroupNorm with its neighbours fused, for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which fuses
// it with the ops around it.  The port ran it as separate fp32 passes of
// plain PyTorch (x.float(), var_mean, sub, rsqrt, mul, mul, add, the cast
// back, SiLU, and the timestep embedding's add before it): about nine launches
// and ~52 bytes of device-memory traffic per element at every GroupNorm site
// of the UNets.  This pair computes, on a channels-last (B, S, C) tensor,
//
//   y[b, s, c] = act( ((x + add[b, c]) - mu[b, g]) * rstd[b, g] * gamma[c] + beta[c] )
//                [* (1 + film_scale[b, c]) + film_shift[b, c]]
//
// with g = c / (C / G), mu and rstd = 1 / sqrt(var + eps) the (biased)
// statistics of x + add over the S * C / G elements of (b, g), act SiLU or
// none, and the FiLM factor optional.  x and y are bf16 or fp32 (y in x's
// dtype); add, gamma, beta and FiLM are fp32; statistics, affine and
// activation are computed in fp32 and each output element is rounded once.
//
// Bound on an H100 SXM: bytes.  Two reads of x and one write of y (6 bytes an
// element in bf16) at 3.35 TB/s; the arithmetic is ~15 operations an element.
// Design, two launches and nothing else (no cast, no memset):
//   1. `gn_welford_reduce_kernel`: a grid of (row tile, sample), the tiles
//      sized by the host planner (`ops/group_norm.py` `plan_group_norm`) so
//      that a large launch makes four blocks per SM and a small one at least
//      one.  A block reads its tile with
//      16-byte vector loads along C (the contiguous axis; one element a load
//      where C is not a multiple of the vector), each thread keeping fp32
//      Welford (mean, M2) for the channels of its vector; the block merges
//      its threads' partials per channel and then per group with Chan's
//      parallel formula (never sum x^2: a near-constant field keeps its
//      digits) and writes the tile's per-group (mean, M2) to a workspace.
//      The last block of a sample to finish (a per-sample counter, which that
//      block resets to 0 itself, so nothing is cleared between calls) folds
//      the tiles in a fixed order into mu and rstd, and folds add, gamma, beta
//      and FiLM into a per-(b, c) centre, scale and shift:
//        y = act((x - centre) * scale + shift),  centre = mu - add,
//        scale = rstd * gamma [* (1 + film_scale)],
//        shift = beta [* (1 + film_scale) + film_shift].
//      Subtracting the centre before the scale keeps the two-pass accuracy
//      where |mu| is large against the spread.
//   2. `gn_affine_silu_elementwise_kernel`: one read of x and one write of
//      y, vectorised, each thread holding its channels' three coefficients in
//      registers.  It walks each tile's rows from the end back to the start:
//      the statistics pass ended on the tiles' last rows, so the first rows
//      it reads are the ones most likely still in the 50 MB L2.
// No float atomics: results are the same run to run, and the pair can be
// captured in a CUDA graph (the counters are left at 0 by every call).
// The kernel names keep the benchmark's classification of device time by
// name: the first is a norm reduction, the second an elementwise pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// A call's shape and the planner's numbers, as `ops/group_norm.py` `_Shape`
// lays them out (made once per shape on the host and passed by pointer).
// Outside the unnamed namespace: an entry point that takes a type with
// internal linkage is not exported.
struct GnShape {
  int b, s, c, groups, dtype, vec, tiles, rows, tpr, rpp, threads, smem_bytes, add_stride, scale_stride, shift_stride;
  int silu;
  float eps;
};

namespace {

constexpr int kStatsUnroll = 4;  // vectors a thread of the statistics kernel loads before it uses the first
constexpr int kApplyUnroll = 2;  // of the apply kernel (whose coefficients take 24 registers)
constexpr int kFold = 8;         // tile partials a lane of the last block loads at once

struct GnArgs {
  const void* x;
  void* y;
  const float* add;         // (B, C) rows `add_stride` apart, or null
  const float* gamma;       // (C,)
  const float* beta;        // (C,)
  const float* film_scale;  // (B, C) rows `scale_stride` apart, or null (then film_shift is null too)
  const float* film_shift;  // (B, C) rows `shift_stride` apart
  float* partial;           // (B, tiles, G, 2) per-tile group (mean, M2)
  float* coef;              // (3, B, C): centre, scale, shift
  unsigned int* counter;    // (B,) tiles finished, 0 between calls
  int b, s, c, groups, tiles, rows, tpr, rpp, add_stride, scale_stride, shift_stride, silu;
  float eps;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// Chan's merge of (nb, mb, qb) into (n, m, q): counts, means, sums of squared
// deviations.
__device__ __forceinline__ void chan(float& n, float& m, float& q, float nb, float mb, float qb) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - m;
  const float w = nb / nn;
  m = fmaf(d, w, m);
  q = q + qb + d * d * n * w;
  n = nn;
}

// Rows of tile `tile` that the thread in row slot `ty` visits.
__device__ __forceinline__ int rows_of(int nrows, int ty, int rpp) {
  return ty < nrows ? (nrows - ty + rpp - 1) / rpp : 0;
}

template <typename T, int V>
__global__ void __launch_bounds__(256, 4) gn_welford_reduce_kernel(const GnArgs a) {
  extern __shared__ float smem[];
  float* s_mean = smem;            // [C] the tile's per-channel means
  float* s_m2 = smem + a.c;        // [C] and sums of squared deviations
  float* s_part = smem + 2 * a.c;  // [rpp][tpr][V][2] one column pass's thread partials
  __shared__ int s_last;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x % a.tpr, ty = threadIdx.x / a.tpr;
  const int r0 = tile * a.rows, nrows = min(a.s - r0, a.rows);
  const int nvec = a.c / V;
  const T* __restrict__ x = static_cast<const T*>(a.x) + ((size_t)b * a.s + r0) * a.c;
  const float* add = a.add ? a.add + (size_t)b * a.add_stride : nullptr;
  const int mine = ty < a.rpp ? rows_of(nrows, ty, a.rpp) : 0;

  for (int col0 = 0; col0 < nvec; col0 += a.tpr) {
    const int v = col0 + lane;
    float mean[V], m2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) mean[k] = m2[k] = 0.f;
    if (v < nvec) {
      const T* p = x + (size_t)ty * a.c + v * V;
      const size_t step = (size_t)a.rpp * a.c;
      float n = 0.f;
      for (int j = 0; j < mine; j += kStatsUnroll) {
        Vec<T, V> buf[kStatsUnroll];
#pragma unroll
        for (int u = 0; u < kStatsUnroll; ++u)
          if (j + u < mine) buf[u] = *reinterpret_cast<const Vec<T, V>*>(p + (j + u) * step);
#pragma unroll
        for (int u = 0; u < kStatsUnroll; ++u) {
          if (j + u < mine) {
            n += 1.f;
            const float inv = 1.f / n;
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const float xf = to_f32(buf[u].v[k]);
              const float d = xf - mean[k];
              mean[k] = fmaf(d, inv, mean[k]);
              m2[k] = fmaf(d, xf - mean[k], m2[k]);
            }
          }
        }
      }
      if (ty < a.rpp) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          s_part[((ty * a.tpr + lane) * V + k) * 2] = mean[k];
          s_part[((ty * a.tpr + lane) * V + k) * 2 + 1] = m2[k];
        }
      }
    }
    __syncthreads();
    // merge the row slots' partials of each channel of this pass, in slot order;
    // the mean is that of x + add
    for (int j = threadIdx.x; j < a.tpr * V; j += blockDim.x) {
      const int lv = j / V, k = j % V, ch = (col0 + lv) * V + k;
      if (col0 + lv >= nvec) continue;
      float n = 0.f, m = 0.f, q = 0.f;
      for (int t = 0; t < a.rpp; ++t) {
        const float nt = (float)rows_of(nrows, t, a.rpp);
        if (nt == 0.f) break;
        chan(n, m, q, nt, s_part[((t * a.tpr + lv) * V + k) * 2], s_part[((t * a.tpr + lv) * V + k) * 2 + 1]);
      }
      s_mean[ch] = m + (add ? add[ch] : 0.f);
      s_m2[ch] = q;
    }
    __syncthreads();
  }

  // the tile's groups: channels of a group have equal counts, so Chan's
  // formula over them is the plain mean and the within-plus-between sum
  const int cg = a.c / a.groups;
  for (int g = threadIdx.x; g < a.groups; g += blockDim.x) {
    float sum = 0.f;
    for (int i = 0; i < cg; ++i) sum += s_mean[g * cg + i];
    const float mg = sum / cg;
    float q = 0.f;
    for (int i = 0; i < cg; ++i) {
      const float d = s_mean[g * cg + i] - mg;
      q += s_m2[g * cg + i] + nrows * d * d;
    }
    float* out = a.partial + (((size_t)b * a.tiles + tile) * a.groups + g) * 2;
    out[0] = mg;
    out[1] = q;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(a.counter + b, 1u) == (unsigned)(a.tiles - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block of sample b: fold its tiles, a warp per group, each lane
  // over every 32nd tile, then the lanes in a fixed tree
  float* s_stat = smem;  // [G][2] (mu, rstd); s_mean is no longer read
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int g = warp; g < a.groups; g += nwarps) {
    float n = 0.f, m = 0.f, q = 0.f;
    for (int t0 = wl; t0 < a.tiles; t0 += 32 * kFold) {
      float2 part[kFold];  // loaded together: one trip to L2 for kFold tiles
#pragma unroll
      for (int u = 0; u < kFold; ++u) {
        const int t = t0 + 32 * u;
        part[u] = t < a.tiles ? __ldcg(reinterpret_cast<const float2*>(
                                    a.partial + (((size_t)b * a.tiles + t) * a.groups + g) * 2))
                              : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kFold; ++u) {
        const int t = t0 + 32 * u;
        if (t < a.tiles) chan(n, m, q, (float)min(a.rows, a.s - t * a.rows) * cg, part[u].x, part[u].y);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float nb = __shfl_down_sync(0xffffffffu, n, off);
      const float mb = __shfl_down_sync(0xffffffffu, m, off);
      const float qb = __shfl_down_sync(0xffffffffu, q, off);
      chan(n, m, q, nb, mb, qb);
    }
    if (wl == 0) {
      s_stat[2 * g] = m;
      s_stat[2 * g + 1] = rsqrtf(q / n + a.eps);
    }
  }
  __syncthreads();
  float* centre = a.coef + (size_t)b * a.c;
  float* scale = a.coef + ((size_t)a.b + b) * a.c;
  float* shift = a.coef + ((size_t)2 * a.b + b) * a.c;
  for (int ch = threadIdx.x; ch < a.c; ch += blockDim.x) {
    const int g = ch / cg;
    float sc = s_stat[2 * g + 1] * a.gamma[ch], sh = a.beta[ch];
    if (a.film_scale) {
      const float f = 1.f + a.film_scale[(size_t)b * a.scale_stride + ch];
      sc *= f;
      sh = fmaf(sh, f, a.film_shift[(size_t)b * a.shift_stride + ch]);
    }
    centre[ch] = s_stat[2 * g] - (add ? add[ch] : 0.f);
    scale[ch] = sc;
    shift[ch] = sh;
  }
  if (threadIdx.x == 0) a.counter[b] = 0u;
}

template <typename T, int V>
__global__ void __launch_bounds__(256, 4) gn_affine_silu_elementwise_kernel(const GnArgs a) {
  const int tile = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x % a.tpr, ty = threadIdx.x / a.tpr;
  if (ty >= a.rpp) return;
  const int r0 = tile * a.rows, nrows = min(a.s - r0, a.rows);
  const int nvec = a.c / V, mine = rows_of(nrows, ty, a.rpp);
  const size_t base = ((size_t)b * a.s + r0) * a.c, step = (size_t)a.rpp * a.c;
  const T* __restrict__ x = static_cast<const T*>(a.x) + base;
  T* __restrict__ y = static_cast<T*>(a.y) + base;
  const float* centre = a.coef + (size_t)b * a.c;
  const float* scale = a.coef + ((size_t)a.b + b) * a.c;
  const float* shift = a.coef + ((size_t)2 * a.b + b) * a.c;
  for (int v = lane; v < nvec; v += a.tpr) {
    float cen[V], sc[V], sh[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      cen[k] = centre[v * V + k];
      sc[k] = scale[v * V + k];
      sh[k] = shift[v * V + k];
    }
    const size_t off = (size_t)ty * a.c + v * V;
    for (int j = mine - 1; j >= 0; j -= kApplyUnroll) {  // the tile's last rows first
      Vec<T, V> buf[kApplyUnroll];
#pragma unroll
      for (int u = 0; u < kApplyUnroll; ++u)
        if (j - u >= 0) buf[u] = *reinterpret_cast<const Vec<T, V>*>(x + off + (j - u) * step);
#pragma unroll
      for (int u = 0; u < kApplyUnroll; ++u) {
        if (j - u >= 0) {
          Vec<T, V> out;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            float t = fmaf(to_f32(buf[u].v[k]) - cen[k], sc[k], sh[k]);
            if (a.silu) t = __fdividef(t, 1.f + __expf(-t));
            out.v[k] = from_f32<T>(t);
          }
          *reinterpret_cast<Vec<T, V>*>(y + off + (j - u) * step) = out;
        }
      }
    }
  }
}

template <typename T, int V>
cudaError_t launch_stats(const GnArgs& a, int threads, int smem_bytes, cudaStream_t st) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(gn_welford_reduce_kernel<T, V>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  gn_welford_reduce_kernel<T, V><<<dim3(a.tiles, a.b), threads, smem_bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_apply(const GnArgs& a, int threads, cudaStream_t st) {
  gn_affine_silu_elementwise_kernel<T, V><<<dim3(a.tiles, a.b), threads, 0, st>>>(a);
  return cudaGetLastError();
}

// The numbers checked: the vector width (elements a load) must divide C and,
// above 1, be 16 bytes at 16-byte-aligned x and y; the tiles cover s; the
// block holds tpr * rpp threads.
bool valid(const GnShape& p, const void* x, const void* y) {
  const int full = p.dtype == 0 ? 8 : 4;
  if ((p.dtype != 0 && p.dtype != 1) || (p.vec != 1 && p.vec != full) || (p.silu != 0 && p.silu != 1)) return false;
  if (p.b < 1 || p.b > 65535 || p.s < 1 || p.c < 1 || p.groups < 1 || p.c % p.groups || p.c % p.vec) return false;
  if (p.tiles < 1 || p.rows < 1 || (long long)p.tiles * p.rows < p.s || (long long)(p.tiles - 1) * p.rows >= p.s)
    return false;
  if (p.tpr < 1 || p.rpp < 1 || p.threads % 32 || p.threads > 256 || p.tpr * p.rpp > p.threads) return false;
  if (p.vec > 1 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) return false;
  return x != nullptr;
}

GnArgs args_of(const GnShape& p, const void* x, void* y, void* work) {
  GnArgs a{};
  a.x = x;
  a.y = y;
  a.partial = static_cast<float*>(work);
  a.coef = static_cast<float*>(work) + (size_t)p.b * p.tiles * p.groups * 2;
  a.b = p.b, a.s = p.s, a.c = p.c, a.groups = p.groups, a.tiles = p.tiles, a.rows = p.rows, a.tpr = p.tpr;
  a.rpp = p.rpp, a.add_stride = p.add_stride, a.scale_stride = p.scale_stride, a.shift_stride = p.shift_stride;
  a.silu = p.silu, a.eps = p.eps;
  return a;
}

}  // namespace

// The statistics launch of one GroupNorm of x (b, s, c) in the dtype (0 =
// bf16, 1 = fp32): gamma, beta (c,) fp32; add (b, c) and film_scale /
// film_shift (b, c) fp32 with their row strides, or null; work, fp32, the
// per-tile group partials (b, tiles, groups, 2) followed by the coefficients
// (3, b, c); counter (b,) unsigned, 0 on entry and on exit.  `shape` holds
// the rest: tiles x rows cover s; tpr threads a row of vectors, rpp rows at
// once, `threads` a block (a multiple of 32), `smem_bytes` of dynamic shared
// memory (the planner's numbers).  Returns a cudaError_t (0 = launched).
extern "C" int jig_gn_stats(const void* x, const void* add, const void* gamma, const void* beta,
                            const void* film_scale, const void* film_shift, void* work, void* counter,
                            const GnShape* shape, void* stream) {
  if (!shape || !valid(*shape, x, nullptr) || !gamma || !beta || !work || !counter || !film_scale != !film_shift)
    return static_cast<int>(cudaErrorInvalidValue);
  const GnShape& p = *shape;
  if (p.smem_bytes < (int)sizeof(float) * (2 * p.c + 2 * p.rpp * p.tpr * p.vec) || p.smem_bytes > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  GnArgs a = args_of(p, x, nullptr, work);
  a.add = static_cast<const float*>(add);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.film_scale = static_cast<const float*>(film_scale);
  a.film_shift = static_cast<const float*>(film_shift);
  a.counter = static_cast<unsigned int*>(counter);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.dtype == 0)
    return static_cast<int>(p.vec == 8 ? launch_stats<__nv_bfloat16, 8>(a, p.threads, p.smem_bytes, st)
                                       : launch_stats<__nv_bfloat16, 1>(a, p.threads, p.smem_bytes, st));
  return static_cast<int>(p.vec == 4 ? launch_stats<float, 4>(a, p.threads, p.smem_bytes, st)
                                     : launch_stats<float, 1>(a, p.threads, p.smem_bytes, st));
}

// The apply launch: y (b, s, c) in x's dtype = act((x - centre) * scale +
// shift) with the coefficients jig_gn_stats left in work, SiLU where
// shape->silu is 1.  Returns a cudaError_t.
extern "C" int jig_gn_apply(const void* x, const void* work, void* y, const GnShape* shape, void* stream) {
  if (!shape || !valid(*shape, x, y) || !work || !y) return static_cast<int>(cudaErrorInvalidValue);
  const GnShape& p = *shape;
  const GnArgs a = args_of(p, x, y, const_cast<void*>(work));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.dtype == 0)
    return static_cast<int>(p.vec == 8 ? launch_apply<__nv_bfloat16, 8>(a, p.threads, st)
                                       : launch_apply<__nv_bfloat16, 1>(a, p.threads, st));
  return static_cast<int>(p.vec == 4 ? launch_apply<float, 4>(a, p.threads, st)
                                     : launch_apply<float, 1>(a, p.threads, st));
}
