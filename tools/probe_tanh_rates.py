#!/usr/bin/env python3
"""Throughput and accuracy of the instructions an additive-attention
element can be built from, on one NVIDIA card (sm_90a).

    python3 tools/probe_tanh_rates.py      # from the repository root

Rates: a kernel per instruction (and per pair of instructions, alternated,
to show which share a pipe), every SM full (8 blocks of 256 threads), each
thread running 8 independent chains. Reported as results per SM per clock
(the span of each block by clock64, all blocks resident at once) and per
second (CUDA events). Instructions:
  tanh.approx.f32, tanh.approx.bf16x2 (two results), cvt.rn.bf16x2.f32
  (two roundings), __hadd2 on __nv_bfloat162 (two sums), round to nearest
  even f32 -> bf16 by integer operations (two, packed by one prmt),
  fma.rn.f32, mma.sync m16n8k16 bf16 (per warp instruction), and the
  additive kernels' element (bf16x2 add, unpack, two tanh.approx.f32, one
  cvt), also for about 0.1 s with the SM clock and power read meanwhile.
Accuracy: every finite bf16 x through tanh.approx.bf16x2, and through
tanh.approx.f32 then cvt.rn to bf16, against torch.tanh of x in f32 on the
card rounded to bf16 (what the plain version computes) and against tanh in
f64 rounded to bf16: the largest distance in bf16 ulps, the share of
inputs that differ, and the mean signed error in ulps over x in [2^-4, 4]
(a bias adds up over a sum of 256 terms).

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SRC = r"""
#include <cuda_bf16.h>
#include <stdint.h>

#define CH 8
__device__ __forceinline__ float u2f(uint32_t u) { return __uint_as_float(u); }
__device__ __forceinline__ uint32_t f2u(float f) { return __float_as_uint(f); }

__device__ __forceinline__ uint32_t op_tanh_f32(uint32_t r) {
  float y; asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(u2f(r))); return f2u(y);
}
__device__ __forceinline__ uint32_t op_tanh_bf2(uint32_t r) {
  uint32_t y; asm("tanh.approx.bf16x2 %0, %1;" : "=r"(y) : "r"(r)); return y;
}
__device__ __forceinline__ uint32_t op_cvt(uint32_t r) {
  uint32_t y;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(y) : "f"(u2f(r)), "f"(u2f(r ^ 0x10000u)));
  return y;
}
__device__ __forceinline__ uint32_t op_hadd2(uint32_t r) {
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&r);
  const __nv_bfloat162 c = __floats2bfloat162_rn(0.25f, -0.5f);
  a = __hadd2(a, c);
  return *reinterpret_cast<uint32_t*>(&a);
}
__device__ __forceinline__ uint32_t op_int_rne(uint32_t r) {
  const uint32_t a = r, b = r ^ 0x5a5a5a5au;
  const uint32_t ra = a + 0x7fffu + ((a >> 16) & 1u);
  const uint32_t rb = b + 0x7fffu + ((b >> 16) & 1u);
  return __byte_perm(ra, rb, 0x7632);
}
__device__ __forceinline__ uint32_t op_ffma(uint32_t r) {
  return f2u(fmaf(u2f(r), 0.999f, 1e-3f));
}
// the additive kernels' element, two at once: bf16x2 add, unpack, two
// tanh.approx.f32, one cvt.rn.bf16x2.f32
__device__ __forceinline__ uint32_t op_element(uint32_t r) {
  const uint32_t x = op_hadd2(r);
  float lo, hi;
  asm("tanh.approx.f32 %0, %1;" : "=f"(lo) : "f"(u2f(x << 16)));
  asm("tanh.approx.f32 %0, %1;" : "=f"(hi) : "f"(u2f(x & 0xffff0000u)));
  uint32_t y;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(y) : "f"(hi), "f"(lo));
  return y;
}

template <int A, int B>
__device__ __forceinline__ uint32_t apply(uint32_t r, int i) {
  const int op = (B >= 0 && (i & 1)) ? B : A;
  switch (op) {
    case 0: return op_tanh_f32(r);
    case 1: return op_tanh_bf2(r);
    case 2: return op_cvt(r);
    case 3: return op_hadd2(r);
    case 4: return op_int_rne(r);
    case 6: return op_element(r);
    default: return op_ffma(r);
  }
}

// ops A (and B, alternated over the chains) ITER times on CH chains
template <int A, int B>
__global__ void __launch_bounds__(256, 8) rate_kernel(uint32_t* out, long long* span, int iters) {
  uint32_t r[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) r[i] = 0x3f003f00u + threadIdx.x * 7u + i;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < CH; ++i) r[i] = apply<A, B>(r[i], i);
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < CH; ++i) s ^= r[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) span[blockIdx.x] = t1 - t0;
}

__global__ void __launch_bounds__(256, 8) mma_kernel(float* out, long long* span, int iters) {
  float c[4][4] = {};
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = 0x3f803f80u + threadIdx.x;
  b[0] = 0x3f803f80u; b[1] = 0x3f003f00u;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) span[blockIdx.x] = t1 - t0;
}

__global__ void accuracy_kernel(const uint32_t* x, uint32_t* bf2, uint32_t* f32cvt, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t w = x[i];
  bf2[i] = op_tanh_bf2(w);
  const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
  float tl, th;
  asm("tanh.approx.f32 %0, %1;" : "=f"(tl) : "f"(lo));
  asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(hi));
  uint32_t y;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(y) : "f"(th), "f"(tl));
  f32cvt[i] = y;
}

#define RATE(NAME, A, B) \
  extern "C" int NAME(void* out, void* span, int blocks, int iters, void* s) { \
    rate_kernel<A, B><<<blocks, 256, 0, (cudaStream_t)s>>>((uint32_t*)out, (long long*)span, iters); \
    return (int)cudaGetLastError(); }
RATE(r_tanh_f32, 0, -1)
RATE(r_tanh_bf16x2, 1, -1)
RATE(r_cvt_bf16x2, 2, -1)
RATE(r_hadd2, 3, -1)
RATE(r_int_rne, 4, -1)
RATE(r_ffma, 5, -1)
RATE(r_tanh_f32_cvt, 0, 2)
RATE(r_tanh_f32_int_rne, 0, 4)
RATE(r_tanh_f32_ffma, 0, 5)
RATE(r_tanh_bf16x2_hadd2, 1, 3)
RATE(r_tanh_bf16x2_cvt, 1, 2)
RATE(r_cvt_int_rne, 2, 4)
RATE(r_element, 6, -1)
extern "C" int r_mma(void* out, void* span, int blocks, int iters, void* s) {
  mma_kernel<<<blocks, 256, 0, (cudaStream_t)s>>>((float*)out, (long long*)span, iters);
  return (int)cudaGetLastError();
}
extern "C" int accuracy(void* x, void* bf2, void* f32cvt, int n, void* s) {
  accuracy_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)s>>>(
      (const uint32_t*)x, (uint32_t*)bf2, (uint32_t*)f32cvt, n);
  return (int)cudaGetLastError();
}
"""

# results per op, per lane: two for packed ops, one otherwise
PER_OP = {"tanh_f32": 1, "tanh_bf16x2": 2, "cvt_bf16x2": 2, "hadd2": 2,
          "int_rne": 2, "ffma": 1, "element": 2}
PAIRS = {"tanh_f32_cvt": ("tanh_f32", "cvt_bf16x2"),
         "tanh_f32_int_rne": ("tanh_f32", "int_rne"),
         "tanh_f32_ffma": ("tanh_f32", "ffma"),
         "tanh_bf16x2_hadd2": ("tanh_bf16x2", "hadd2"),
         "tanh_bf16x2_cvt": ("tanh_bf16x2", "cvt_bf16x2"),
         "cvt_int_rne": ("cvt_bf16x2", "int_rne")}
CH, THREADS, PER_SM, ITERS = 8, 256, 8, 4096


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def build() -> ctypes.CDLL:
    sys.path.insert(0, ROOT)
    from case_rg_tpu_torch.kernels import _build
    d = os.path.join(ROOT, "build", "probe_tanh")
    os.makedirs(d, exist_ok=True)
    src, lib = os.path.join(d, "probe.cu"), os.path.join(d, "libprobe.so")
    with open(src, "w") as f:
        f.write(SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True, stdout=subprocess.DEVNULL)
    return ctypes.CDLL(lib)


def run_rate(lib, name, sms, dev):
    fn = getattr(lib, f"r_{name}")
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    blocks = sms * PER_SM
    out = torch.empty(blocks * THREADS * 4, dtype=torch.uint8, device=dev)
    span = torch.empty(blocks, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    assert fn(out.data_ptr(), span.data_ptr(), blocks, 64, stream) == 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    assert fn(out.data_ptr(), span.data_ptr(), blocks, ITERS, stream) == 0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), int(span.max().item())


def rates(lib, sms, dev, mhz):
    """Per SM per clock by clock64 (the longest block's span, every block
    resident at once) and, as a check, by event time at ``mhz``."""
    res = {}
    lanes = sms * PER_SM * THREADS
    for name in list(PER_OP) + list(PAIRS) + ["mma"]:
        ms, cycles = run_rate(lib, name, sms, dev)
        if name == "mma":       # warp instructions
            n = sms * PER_SM * (THREADS // 32) * ITERS * 4
            res[name] = {"ms": ms, "mma_per_sm_clock": n / sms / cycles,
                         "by_events": n / sms / (ms * mhz * 1e3),
                         "per_s": n / ms * 1e3}
            continue
        if name in PER_OP:
            n_ops = lanes * ITERS * CH
            res[name] = {"ms": ms, "ops_per_sm_clock": n_ops / sms / cycles,
                         "results_per_sm_clock":
                             n_ops * PER_OP[name] / sms / cycles,
                         "by_events": n_ops / sms / (ms * mhz * 1e3),
                         "results_per_s": n_ops * PER_OP[name] / ms * 1e3}
        else:
            a, b = PAIRS[name]
            alone = res[a]["ms"] / 2 + res[b]["ms"] / 2
            apart = max(res[a]["ms"], res[b]["ms"]) / 2
            # one pipe: the halves add up; two pipes: the slower half sets
            # the time
            res[name] = {"ms": ms, "sum_of_halves_ms": alone,
                         "max_of_halves_ms": apart,
                         "share_a_pipe": ms - apart > 0.5 * (alone - apart)}
    return res


def sustained(lib, sms, dev):
    """The element kernel run for about a tenth of a second: its rate, and
    the SM clock and power draw nvidia-smi reads while it runs."""
    fn = lib.r_element
    blocks = sms * PER_SM
    out = torch.empty(blocks * THREADS * 4, dtype=torch.uint8, device=dev)
    span = torch.empty(blocks, dtype=torch.int64, device=dev)
    iters = ITERS * 24
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    assert fn(out.data_ptr(), span.data_ptr(), blocks, iters,
              torch.cuda.current_stream().cuda_stream) == 0
    end.record()
    during = smi("clocks.sm,power.draw")      # while the kernel runs
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    n = blocks * THREADS * iters * CH * PER_OP["element"]
    return {"ms": ms, "results_per_s": n / ms * 1e3,
            "results_per_sm_clock": n / sms / int(span.max().item()),
            "clock_and_power_during": during}


def ulp_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 ulps between two bf16 bit patterns (int32), across zero too."""
    def ordered(u):
        u = u.to(torch.int64)
        return torch.where(u >= 0x8000, 0x8000 - u, u)
    return (ordered(a) - ordered(b)).abs()


def accuracy(lib, dev):
    lib.accuracy.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                     ctypes.c_void_p]
    bits = torch.arange(65536, dtype=torch.int64)
    words = (bits[1::2] << 16 | bits[0::2]).to(torch.int64)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    x_w = words.to(torch.int32).to(dev)
    n = x_w.numel()
    bf2, f32cvt = torch.empty_like(x_w), torch.empty_like(x_w)
    assert lib.accuracy(x_w.data_ptr(), bf2.data_ptr(), f32cvt.data_ptr(), n,
                        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()

    def halves(w):
        w = w.cpu().to(torch.int64) & 0xffffffff
        return torch.stack([w & 0xffff, w >> 16], 1).reshape(-1)

    x_bits = halves(x_w)
    x_bf = torch.tensor(x_bits.numpy().astype("uint16").view("int16")) \
        .view(torch.bfloat16)
    finite = torch.isfinite(x_bf.float())
    card = torch.tanh(x_bf.to(dev).float()).to(torch.bfloat16).cpu()
    exact = torch.tanh(x_bf.double()).to(torch.bfloat16)
    as_bits = lambda t: t.view(torch.int16).to(torch.int64) & 0xffff
    out = {}
    # tanh is odd, so a bias shows over positive x only
    mid = finite & (x_bf.float() >= 2 ** -4) & (x_bf.float() <= 4)
    for name, got in (("tanh_bf16x2", halves(bf2)),
                      ("tanh_f32_cvt_rn", halves(f32cvt))):
        got_bf = torch.tensor(got.numpy().astype("uint16").view("int16")) \
            .view(torch.bfloat16)
        row = {}
        for ref_name, ref in (("vs_card_tanh", card), ("vs_f64", exact)):
            d = ulp_dist(got, as_bits(ref))[finite]
            signed = ((got_bf.double() - ref.double())
                      / torch.exp2(torch.floor(torch.log2(
                          ref.double().abs().clamp_min(2.0 ** -126))) - 7))
            row[ref_name] = {
                "max_ulps": int(d.max()), "share_differing":
                    float((d > 0).double().mean()),
                "count_over_1": int((d > 1).sum()),
                "mean_signed_ulps_mid": float(signed[mid].mean())}
        out[name] = row
    out["card_tanh_vs_f64_max_ulps"] = int(
        ulp_dist(as_bits(card), as_bits(exact))[finite].max())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_tanh_rates: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    print(card, flush=True)
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    res = {"card": card, "sms": sms, "max_sm_mhz": mhz,
           "rates": rates(lib, sms, dev, mhz),
           "element_sustained": sustained(lib, sms, dev),
           "accuracy": accuracy(lib, dev),
           "sm_mhz_after": smi("clocks.sm")}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
