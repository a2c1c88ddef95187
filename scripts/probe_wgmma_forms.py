#!/usr/bin/env python3
"""Check the wgmma forms of `jointimagegeneration_torch/csrc/hopper.cuh` on one
NVIDIA Hopper card, one instruction shape at a time, against torch.matmul.

    python3 scripts/probe_wgmma_forms.py                  # the forms, at D = 16, 32, 64, 128
    python3 scripts/probe_wgmma_forms.py --rate           # instruction throughput per form and N
    python3 scripts/probe_wgmma_forms.py --ptxas flash_bwd conv3d   # registers and spills

For each head width D a one-warpgroup kernel stores two (64, D) bf16 tiles A
and B in the swizzled layout the flash backward uses (rows of min(D, 64)
columns, 32-, 64- or 128-byte swizzle) and computes
  * the SS form, K-major A and B:  A . B^T  (64 x 64, K = D), and
  * the RS form with B MN-major (the transpose bit): C . B (64 x D, K = 64)
    with C (64 x 64) in registers, per 64-column chunk of B,
then compares each with torch.matmul in fp32 (the products of bf16 values are
exact, so only the summation order differs: the limit is 1e-5 of max |ref|).

`--rate` times long runs of one instruction on every SM (one to four
one-warpgroup blocks per SM, 4 or 16 instructions into one accumulator
between commit and wait, as a kernel's k loop issues them) for the SS form
(m64n64k16, A and B K-major), the RS form with B K-major (N = 32, 64, 128) and
with B MN-major (N = 32, 64), and prints the SM clocks each instruction takes
per SM (at the card's maximum SM clock) and the rate in TFLOP/s.

`--ptxas` compiles the named csrc/ sources with `-Xptxas -v` and prints each
kernel's registers, spills and shared memory.  Needs nvcc and a CUDA card;
writes only under build/probe/.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "jointimagegeneration_torch" / "csrc"
OUT = ROOT / "build" / "probe"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]

PROBE_CU = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include "hopper.cuh"

template <int HD>
__global__ void __launch_bounds__(128) probe_kernel(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                                    const __nv_bfloat16* c, float* out_ss, float* out_rs) {
  constexpr int AC = HD < 64 ? HD : 64, RB = 2 * AC, ATOM = 64 * RB, TB = 64 * HD * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t4 = tid & 3;
  for (int e = tid; e < 64 * HD / 8; e += 128) {
    const int r = e / (HD / 8), ch = e % (HD / 8);
    const int off = (ch / (AC / 8)) * ATOM + swizzle_off<RB>(r, ch % (AC / 8));
    *reinterpret_cast<uint4*>(sm + off) = *reinterpret_cast<const uint4*>(a + r * HD + ch * 8);
    *reinterpret_cast<uint4*>(sm + TB + off) = *reinterpret_cast<const uint4*>(b + r * HD + ch * 8);
  }
  fence_async_shared();
  __syncthreads();
  const uint32_t tA = base, tB = base + TB;

  float acc[32];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int koff = (ks * 16 / AC) * ATOM + (ks * 16 % AC) * 2;
    wgmma_ss64(acc, kmajor_desc<RB>(tA + koff), kmajor_desc<RB>(tB + koff), ks);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    out_ss[(warp * 16 + g + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * t4 + (i & 1)] = acc[i];

  uint32_t cf[4][4];  // C's A fragments: rows warp * 16 + g (+ 8), columns 16kk + 2t4 (+ 8)
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = warp * 16 + g + 8 * (q & 1), col = 16 * kk + 2 * t4 + 8 * (q >> 1);
      cf[kk][q] = *reinterpret_cast<const uint32_t*>(c + row * 64 + col);
    }
  for (int chunk = 0; chunk < HD / AC; ++chunk) {
    float acc2[AC / 2];
#pragma unroll
    for (int i = 0; i < AC / 2; ++i) acc2[i] = 0.f;
    fence_operands(acc2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<AC, true>(acc2, cf[kk], mnmajor_desc<RB>(tB + chunk * ATOM + kk * 16 * RB, ATOM));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc2);
#pragma unroll
    for (int i = 0; i < AC / 2; ++i)
      out_rs[(warp * 16 + g + 8 * ((i >> 1) & 1)) * HD + chunk * AC + 8 * (i >> 2) + 2 * t4 + (i & 1)] = acc2[i];
  }
}

template <int HD>
int run(const void* a, const void* b, const void* c, void* ss, void* rs) {
  const int smem = 1024 + 2 * 64 * HD * 2;
  cudaFuncSetAttribute(probe_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  probe_kernel<HD><<<1, 128, smem>>>(static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
                                      static_cast<const __nv_bfloat16*>(c), static_cast<float*>(ss),
                                      static_cast<float*>(rs));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe(const void* a, const void* b, const void* c, void* ss, void* rs, int hd) {
  switch (hd) {
    case 16: return run<16>(a, b, c, ss, rs);
    case 32: return run<32>(a, b, c, ss, rs);
    case 64: return run<64>(a, b, c, ss, rs);
    case 128: return run<128>(a, b, c, ss, rs);
  }
  return 1;
}
"""

RATE_CU = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include "hopper.cuh"

// FORM 0: SS m64n64k16, A and B K-major; 1: RS, B K-major; 2: RS, B MN-major.
// Shared memory (zeros): A 64 rows x 128 bytes, B up to 128 rows x 128 bytes.
template <int FORM, int N, int PER>
__global__ void __launch_bounds__(128) rate_kernel(int iters, float* out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  uint4* sm = reinterpret_cast<uint4*>(smem_raw + (base - raw));
  for (int i = threadIdx.x; i < 24576 / 16; i += 128) sm[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_async_shared();
  __syncthreads();
  const uint32_t tA = base, tB = base + 8192;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint32_t a[4] = {0u, 0u, 0u, 0u};
  for (int it = 0; it < iters; ++it) {
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if constexpr (FORM == 0) {
        wgmma_ss64(acc, kmajor_desc<128>(tA + (k & 3) * 32), kmajor_desc<128>(tB + (k & 3) * 32), 1);
      } else if constexpr (FORM == 1) {
        wgmma_rs<N>(acc, a, kmajor_desc<128>(tB + (k & 3) * 32));
      } else {
        constexpr int RB = 2 * N;  // one swizzle atom of N columns
        wgmma_rs<N, true>(acc, a, mnmajor_desc<RB>(tB + (k & 3) * 16 * RB, 64 * RB));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
  }
  out[blockIdx.x * 128 + threadIdx.x] = acc[0];
}

template <int FORM, int N, int PER>
int launch(int blocks, int iters, void* out) {
  constexpr int smem = 1024 + 24576;
  cudaFuncSetAttribute(rate_kernel<FORM, N, PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  rate_kernel<FORM, N, PER><<<blocks, 128, smem>>>(iters, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rate(int form, int n, int per, int blocks, int iters, void* out) {
  const int key = form * 10000 + n * 10 + per;
  switch (key) {
    case 644: return launch<0, 64, 4>(blocks, iters, out);
    case 656: return launch<0, 64, 16>(blocks, iters, out);
    case 10324: return launch<1, 32, 4>(blocks, iters, out);
    case 10644: return launch<1, 64, 4>(blocks, iters, out);
    case 11284: return launch<1, 128, 4>(blocks, iters, out);
    case 10336: return launch<1, 32, 16>(blocks, iters, out);
    case 10656: return launch<1, 64, 16>(blocks, iters, out);
    case 11296: return launch<1, 128, 16>(blocks, iters, out);
    case 20324: return launch<2, 32, 4>(blocks, iters, out);
    case 20644: return launch<2, 64, 4>(blocks, iters, out);
    case 20336: return launch<2, 32, 16>(blocks, iters, out);
    case 20656: return launch<2, 64, 16>(blocks, iters, out);
  }
  return 1;
}
"""
RATE_FORMS = [(0, 64, "SS, A and B K-major"), (1, 32, "RS, B K-major"), (1, 64, "RS, B K-major"),
              (1, 128, "RS, B K-major"), (2, 32, "RS, B MN-major"), (2, 64, "RS, B MN-major")]


def nvcc() -> str:
    from jointimagegeneration_torch.ops.cuda.build import nvcc_path

    return nvcc_path()


def ptxas_report(names) -> None:
    """Registers, spills and shared memory of every kernel in csrc/<name>.cu."""
    OUT.mkdir(parents=True, exist_ok=True)
    for name in names:
        r = subprocess.run([nvcc(), *ARCH, "-Xptxas", "-v", "-c", "-o", str(OUT / f"{name}.o"),
                            str(CSRC / f"{name}.cu")], capture_output=True, text=True)
        log = (r.stdout + r.stderr).splitlines()
        if r.returncode != 0:
            print("\n".join(log))
            raise SystemExit(f"nvcc failed for {name}.cu")
        kernel, notes = None, {}
        for ln in log:
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                kernel = m.group(1)
            elif "C75" in ln:  # ptxas' notes on the wgmma pipeline, by kernel and code
                code = re.search(r"C75\d\d", ln).group(0)
                notes.setdefault((kernel, code), ln.split(")")[-1].strip()[:160])
            elif kernel and ("registers" in ln or "spill" in ln):
                print(f"{name}: {kernel}: {ln.split('info    :')[-1].strip()}")
            elif "warning" in ln.lower():
                print(f"{name}: {ln.strip()}")
        for (kern, code), text in notes.items():
            print(f"{name}: {kern}: {code} {text}")


def probe_forms() -> bool:
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "wgmma_probe.cu", OUT / "wgmma_probe.so"
    src.write_text(PROBE_CU)
    r = subprocess.run([nvcc(), *ARCH, "-shared", "-Xcompiler", "-fPIC", f"-I{CSRC}", "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        print(r.stdout + r.stderr)
        raise SystemExit("nvcc failed for the probe")
    fn = ctypes.CDLL(str(lib)).probe
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    g = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for hd in (16, 32, 64, 128):
        a, b = (torch.randn(64, hd, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        c = torch.randn(64, 64, generator=g, device="cuda").to(torch.bfloat16)
        want_ss, want_rs = a.float() @ b.float().T, c.float() @ b.float()
        ss = torch.full((64, 64), float("nan"), device="cuda")
        rs = torch.full((64, hd), float("nan"), device="cuda")
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), ss.data_ptr(), rs.data_ptr(), hd)
        torch.cuda.synchronize()
        if err:
            print(f"D = {hd}: launch failed, cudaError {err}")
            ok = False
            continue
        e_ss, e_rs = (ss - want_ss).abs().max().item(), (rs - want_rs).abs().max().item()
        lim_ss, lim_rs = 1e-5 * want_ss.abs().max().item(), 1e-5 * want_rs.abs().max().item()
        print(f"D = {hd} ({2 * min(hd, 64)}-byte swizzle): SS K-major A.B^T max err {e_ss:.3g} (limit "
              f"{lim_ss:.3g}) {'ok' if e_ss <= lim_ss else 'WRONG'}; RS MN-major C.B max err {e_rs:.3g} "
              f"(limit {lim_rs:.3g}) {'ok' if e_rs <= lim_rs else 'WRONG'}", flush=True)
        ok &= e_ss <= lim_ss and e_rs <= lim_rs
    return ok


def probe_rate() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "wgmma_rate.cu", OUT / "wgmma_rate.so"
    src.write_text(RATE_CU)
    r = subprocess.run([nvcc(), *ARCH, "-shared", "-Xcompiler", "-fPIC", f"-I{CSRC}", "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        print(r.stdout + r.stderr)
        raise SystemExit("nvcc failed for the rate probe")
    fn = ctypes.CDLL(str(lib)).rate
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,name,power.limit", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0].split(", ")
    clk_hz, sms = float(smi[0]) * 1e6, torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(4 * sms * 128, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    iters = 4096
    for form, n, what in RATE_FORMS:
        for per in (4, 16):
            for bps in (1, 2, 4):
                blocks = bps * sms
                if fn(form, n, per, blocks, 16, out.data_ptr()):
                    raise SystemExit(f"rate probe launch failed: form {form} N {n}")
                start.record()
                fn(form, n, per, blocks, iters, out.data_ptr())
                end.record()
                torch.cuda.synchronize()
                sec = start.elapsed_time(end) / 1e3
                per_sm = bps * iters * per
                tflops = 2.0 * 64 * n * 16 * blocks * iters * per / sec / 1e12
                print(f"wgmma rate: m64n{n}k16 {what}, {per} per commit and wait, {bps} block(s) of one "
                      f"warpgroup per SM: {sec * clk_hz / per_sm:.1f} SM clocks per instruction at "
                      f"{smi[0]} MHz, {tflops:.1f} TFLOP/s; card {smi[1]}, {smi[2]} W", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_wgmma_forms: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == ["--ptxas"]:
        ptxas_report(sys.argv[2:])
        return 0
    if sys.argv[1:2] == ["--rate"]:
        probe_rate()
        return 0
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    return 0 if probe_forms() else 1


if __name__ == "__main__":
    sys.exit(main())
