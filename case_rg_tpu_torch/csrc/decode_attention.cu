// Single-query multi-head attention for the decode step, for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel case_rg_tpu/kernels/decode_attention.py
// (single_query_mha, body _kernel). Same function as its
// single_query_mha_xla and as the decode branch of
// MultiHeadAttention.attend_with_kv_merged, with that branch's rounding
// points:
//   qs = bf16(q * scale);  s_j = qs . k_j  in f32;
//   masked keys drop out;  p_j = exp(s_j - max) / sum  in f32;  p -> bf16;
//   ctx = sum_j p_j * v_j  accumulated in f32, cast once to bf16;
//   a row whose keys are all masked gives exact zeros.
// q [B, 1, E] bf16 (projected), k/v [B, L, E] bf16 in merged-head layout
// (head h owns lanes [h*d, (h+1)*d)), each with its own batch (and row)
// strides, so the query third of a packed QKV projection and the two
// halves of a packed [B, T, 2E] K|V cache are read in place; keep [B, L]
// bool (or null); out [B, 1, E] bf16, contiguous.
//
// What bounds it on an H100: bytes. K and V are read once, 4 * L * E bytes
// a row against 4 * L * E operations: one operation a byte, far below the
// ~295 the tensor cores need. At [64, 1000, 256] that is 65.5 MB, 0.020 ms
// at 3.35 TB/s; at CaSE's decode shapes (L = 60 query memory, L <= 40
// history) it is about 1 us, so there the launch itself is the cost.
//
// What this design does about it: one block of 128 threads per (row,
// head). A key's d lanes are read by a group of d / 8 threads, 16 bytes
// each, so a warp reads 256 / d keys at once and a row of K or V is one
// coalesced sweep; each thread keeps four keys' loads in flight before it
// uses them, so the sweeps are not a chain of memory latencies. Pass 1:
// scores (the group's partial dots added by shuffles) go to shared memory
// in f32 (4 bytes a key: the whole row of scores stays on the SM, so K is
// read once and the probabilities are normalised BEFORE they are rounded to
// bf16, as the path it replaces rounds them; an online softmax, as the TPU
// kernel runs, would rescale rounded partial sums). Two block reductions
// give the max and the sum. Pass 2: each thread accumulates p_j * v_j over
// its keys for its 8 lanes in f32; shuffles, then the four warps in a fixed
// order, add the partial contexts, so the result is deterministic. Masked
// keys are neither read nor summed. No tensor cores (one query), no TMA:
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;           // keys of a thread in flight at once

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Block-wide reduction of one float (op: 0 = max, 1 = sum); every thread
// gets the result. `red` holds kWarps floats.
__device__ __forceinline__ float block_reduce(float x, int op, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = op == 0 ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                     // red may still be read
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x = op == 0 ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// Shared memory (f32): qs [d], s [L], part [kWarps][d], red [kWarps].
// A thread's key slot: lanes [slot * lpk, (slot + 1) * lpk) of its warp
// share a key, lpk = d / 8, each owning 8 lanes of the head from c0.
__global__ void __launch_bounds__(kThreads)
single_query_mha_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const uint8_t* __restrict__ keep,
                        __nv_bfloat16* __restrict__ out,
                        int l, int e, int d, long long qb, long long kb,
                        long long kl, long long vb, long long vl,
                        float scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  float* qs = smem;
  float* s = qs + d;
  float* part = s + l;
  float* red = part + kWarps * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lpk = d / 8;               // threads a key
  const int kpw = 32 / lpk;            // keys a warp at once
  const int slot = lane / lpk;
  const int c0 = (lane % lpk) * 8;
  const int step = kWarps * kpw;       // keys the block at once

  for (int c = threadIdx.x; c < d; c += kThreads)
    qs[c] = bf16_round(
        __bfloat162float(q[b * qb + h * d + c]) * scale);
  __syncthreads();
  float q8[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) q8[i] = qs[c0 + i];

  // ---- pass 1: scores of the valid keys, and their max ----
  const uint8_t* keep_r = keep ? keep + static_cast<size_t>(b) * l : nullptr;
  const __nv_bfloat16* kr = k + b * kb + h * d + c0;
  float mx = -INFINITY;
  // j0 is the same on every lane of a warp, so the group shuffles below
  // run on full warps
  for (int j0 = warp * kpw; j0 < l; j0 += kUnroll * step) {
    uint4 raw[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * step + slot;
      live[u] = j < l && (keep_r == nullptr || keep_r[j]);
      raw[u] = live[u] ? __ldg(reinterpret_cast<const uint4*>(kr + j * kl))
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 f = __bfloat1622float2(k2[t]);
        dot = fmaf(q8[2 * t], f.x, dot);
        dot = fmaf(q8[2 * t + 1], f.y, dot);
      }
      for (int o = 1; o < lpk; o <<= 1)   // the key's group: lpk lanes
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int j = j0 + u * step + slot;
      if (live[u]) mx = fmaxf(mx, dot);
      if (j < l && lane % lpk == 0) s[j] = live[u] ? dot : -INFINITY;
    }
  }
  mx = block_reduce(mx, 0, red);       // its barriers publish s[]
  if (mx == -INFINITY) {               // no valid key: zeros
    for (int c = threadIdx.x; c < d; c += kThreads)
      out[static_cast<size_t>(b) * e + h * d + c] = __float2bfloat16_rn(0.f);
    return;
  }
  float sum = 0.f;
  for (int j = threadIdx.x; j < l; j += kThreads) {
    const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - mx);
    s[j] = p;
    sum += p;
  }
  sum = block_reduce(sum, 1, red);

  // ---- pass 2: context = sum_j bf16(p_j / sum) * v_j ----
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  const __nv_bfloat16* vr = v + b * vb + h * d + c0;
  for (int j0 = warp * kpw; j0 < l; j0 += kUnroll * step) {
    uint4 raw[kUnroll];
    float p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * step + slot;
      const float e_j = j < l ? s[j] : 0.f;
      p[u] = e_j == 0.f ? 0.f : bf16_round(e_j / sum);
      raw[u] = p[u] != 0.f
                   ? __ldg(reinterpret_cast<const uint4*>(vr + j * vl))
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 f = __bfloat1622float2(v2[t]);
        acc[2 * t] = fmaf(p[u], f.x, acc[2 * t]);
        acc[2 * t + 1] = fmaf(p[u], f.y, acc[2 * t + 1]);
      }
    }
  }
  // the warp's key slots, then the warps in order
#pragma unroll
  for (int i = 0; i < 8; ++i)
    for (int o = lpk; o < 32; o <<= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  if (slot == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) part[warp * d + c0 + i] = acc[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float o = part[c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) o += part[w * d + c];
    out[static_cast<size_t>(b) * e + h * d + c] = __float2bfloat16_rn(o);
  }
}

}  // namespace

extern "C" {

// Whether the kernel takes these shapes: d = 8, 16, 32, 64, 128 or 256
// (d / 8 threads share a key, and they tile a warp).
int single_query_mha_supports(int e, int h) {
  if (h < 1 || e % h || h > 65535) return 0;
  const int d = e / h;
  return d >= 8 && d <= 256 && (d & (d - 1)) == 0;
}

// Bytes of dynamic shared memory one block needs.
int single_query_mha_smem_bytes(int l, int d) {
  return 4 * (d + l + kWarps * d + kWarps);
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched). Strides
// are in elements; k and v rows must start on 16-byte boundaries.
int single_query_mha_bf16(const void* q, const void* k, const void* v,
                          const void* keep, void* out, int b, int l, int e,
                          int h, long long qb, long long kb, long long kl,
                          long long vb, long long vl, float scale,
                          void* stream) {
  if (!single_query_mha_supports(e, h) || b < 1 || l < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = e / h;
  const int smem = single_query_mha_smem_bytes(l, d);
  cudaFuncSetAttribute(single_query_mha_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(b, h);
  single_query_mha_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(keep),
      static_cast<__nv_bfloat16*>(out), l, e, d, qb, kb, kl, vb, vl, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
