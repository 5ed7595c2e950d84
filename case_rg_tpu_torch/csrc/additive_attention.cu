// Additive (Bahdanau) attention scores, forward and backward, for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel case_rg_tpu/kernels/additive_attention.py
// (additive_scores: forward _scores_pallas / _kernel; its custom VJP _bwd
// ran in XLA and built the [B, T, L, H] tensor). Same functions:
//   forward   s[b, t, l] = sum_h tanh(wq[b, t, h] + uh[b, l, h]) * v[h]
//   backward  dwq[b, t, h] = v[h] * sum_l g[b, t, l] * (1 - th^2)
//             duh[b, l, h] = v[h] * sum_t g[b, t, l] * (1 - th^2)
//             dv[h]        = sum_{b, t, l} th * g[b, t, l]
// with the rounding points of the plain versions (the eager path it
// replaces): wq + uh rounded to bf16, th = tanh of that rounded to bf16,
// every sum accumulated in f32 and rounded once to bf16. wq [B, T, H],
// uh [B, L, H], v [H], g [B, T, L], all bf16 and contiguous.
//
// tanh is the special-function unit's tanh.approx.f32 (one instruction,
// relative error about 2^-11), not tanhf (a routine of a dozen
// instructions and two special-function ops); its result is rounded to
// bf16 (2^-8) at once, so it moves an element of th by at most one bf16
// ulp, and only where the exact value lies near a rounding boundary.
//
// What bounds it on an H100: the tanh throughput, 16 special-function
// results a clock on each of 132 SMs, about 4.2e12/s at 1.98 GHz. Teacher
// forcing at [64, 40, 1000, 256] takes 655 M tanh (0.16 ms) and moves
// 39 MB (0.012 ms at 3.35 TB/s); a decode step at [64, 1, 1000, 256]
// moves uh's 32.8 MB (0.010 ms) for 16 M tanh (0.004 ms), bytes.
//
// What this design does about it: no [B, T, L, H] value ever leaves the
// registers. Forward: one block of 8 warps per (row b, 32 queries t, 32
// keys l), the block's rows of wq staged in shared memory in f32; a warp
// takes one key at a time, its 32 lanes split H (8 lanes each at H = 256),
// read the key's uh row once (coalesced) and keep it in registers for every
// query of the block, and add their partial sums by shuffles. So a decode
// step (T = 1) still spreads each key over a warp and keeps all of B * L /
// 32 blocks busy, where a thread per key would leave each with a long chain
// of loads. Every rounding to bf16 converts two values in one instruction.
// Backward, three launches and no atomics, so the
// result is the same on every run: (1) one block per (b, 8 queries), a
// thread per h, walks every key in order: dwq, and the block's partial of
// dv; (2) one block per (b, 8 keys), a thread per h, walks every query in
// order: duh; (3) one block, a thread per h, adds the dv partials in
// block order. Both gradient launches recompute th (twice the forward's
// tanh work). g is staged in shared memory, uh and wq are read coalesced
// along h. No tensor cores: the function has no product to give them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdWarps = 8;     // forward: warps a block
constexpr int kFwdKeys = 32;     // forward: keys a block
constexpr int kFwdRows = 32;     // forward: queries a block
constexpr int kMaxH = 256;       // H <= 256 (CaSE: 256)
constexpr int kPerLane = kMaxH / 32;      // forward: lanes of H a thread
constexpr int kKeysPerWarp = kFwdKeys / kFwdWarps;
constexpr int kTT = 8;           // backward: queries a block (dwq pass)
constexpr int kLT = 8;           // backward: keys a block (duh pass)
constexpr int kChunk = 128;      // backward: g values staged a row a round

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// th = bf16(tanh(bf16(a + b))), the plain version's two rounding points,
// for two pairs at once: each rounding of the two is one paired conversion
// (cvt.rn.bf16x2.f32)
__device__ __forceinline__ float2 th2_of(float a0, float b0, float a1,
                                         float b1) {
  const float2 x = __bfloat1622float2(__floats2bfloat162_rn(a0 + b0, a1 + b1));
  return __bfloat1622float2(
      __floats2bfloat162_rn(tanh_approx(x.x), tanh_approx(x.y)));
}

// Shared memory (f32): wq_s [kFwdRows][H], v_s [H], out_s
// [kFwdRows][kFwdKeys]. Warp w takes keys w, w + 8, w + 16, w + 24 of the
// block's 32 together (their loads in flight at once, four independent
// sums); lane c owns lanes h = c, c + 32, ... of H (so the warp's
// shared-memory reads of a wq row are conflict-free) and holds the keys' uh
// there in registers across the block's queries.
__global__ void __launch_bounds__(kFwdWarps * 32)
additive_fwd_kernel(const __nv_bfloat16* __restrict__ wq,
                    const __nv_bfloat16* __restrict__ uh,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int t_len, int l_len,
                    int hd) {
  extern __shared__ __align__(16) float smem[];
  float* wq_s = smem;
  float* v_s = wq_s + kFwdRows * hd;
  float* out_s = v_s + hd;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kFwdRows;
  const int nt = min(kFwdRows, t_len - t0);
  const int l0 = blockIdx.x * kFwdKeys;
  const int nl = min(kFwdKeys, l_len - l0);
  const __nv_bfloat16* wqb = wq + (static_cast<size_t>(b) * t_len + t0) * hd;
  for (int i = threadIdx.x; i < nt * hd; i += blockDim.x)
    wq_s[i] = __bfloat162float(wqb[i]);
  for (int i = threadIdx.x; i < hd; i += blockDim.x)
    v_s[i] = __bfloat162float(v[i]);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float u[kKeysPerWarp][kPerLane];
#pragma unroll
  for (int k = 0; k < kKeysPerWarp; ++k) {
    const int ll = warp + kFwdWarps * k;
    const __nv_bfloat16* ur =
        uh + (static_cast<size_t>(b) * l_len + l0 + min(ll, nl - 1)) * hd;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int h = lane + 32 * i;
      u[k][i] = h < hd ? __bfloat162float(ur[h]) : 0.f;
    }
  }
  __syncthreads();
  for (int tt = 0; tt < nt; ++tt) {
    const float* w = wq_s + tt * hd;
    float acc[kKeysPerWarp];
#pragma unroll
    for (int k = 0; k < kKeysPerWarp; ++k) acc[k] = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; i += 2) {
      const int h = lane + 32 * i;     // and h + 32
      if (h < hd) {
        const float w0 = w[h], w1 = h + 32 < hd ? w[h + 32] : 0.f;
        const float v0 = v_s[h], v1 = h + 32 < hd ? v_s[h + 32] : 0.f;
#pragma unroll
        for (int k = 0; k < kKeysPerWarp; ++k) {
          const float2 th = th2_of(w0, u[k][i], w1, u[k][i + 1]);
          acc[k] = fmaf(th.x, v0, acc[k]);
          acc[k] = fmaf(th.y, v1, acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kKeysPerWarp; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
      const int ll = warp + kFwdWarps * k;
      if (lane == 0 && ll < nl) out_s[tt * kFwdKeys + ll] = acc[k];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nt * kFwdKeys; i += blockDim.x) {
    const int tt = i / kFwdKeys, ll = i % kFwdKeys;
    if (ll < nl)
      out[(static_cast<size_t>(b) * t_len + t0 + tt) * l_len + l0 + ll] =
          __float2bfloat16_rn(out_s[i]);
  }
}

// dwq and the dv partials. Block (t-tile, b), a thread per h.
// Shared memory: g_s [kTT][kChunk] f32.
__global__ void __launch_bounds__(kMaxH)
additive_bwd_q_kernel(const __nv_bfloat16* __restrict__ wq,
                      const __nv_bfloat16* __restrict__ uh,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ g,
                      __nv_bfloat16* __restrict__ dwq,
                      float* __restrict__ dv_part, int t_len, int l_len,
                      int hd) {
  __shared__ float g_s[kTT][kChunk];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTT;
  const int nt = min(kTT, t_len - t0);
  const int h = threadIdx.x;
  const bool live = h < hd;
  float w[kTT], acc[kTT];
#pragma unroll
  for (int tt = 0; tt < kTT; ++tt) {
    acc[tt] = 0.f;
    w[tt] = live && tt < nt ? __bfloat162float(
        wq[(static_cast<size_t>(b) * t_len + t0 + tt) * hd + h]) : 0.f;
  }
  float acc_v = 0.f;
  const __nv_bfloat16* gb = g + (static_cast<size_t>(b) * t_len + t0) * l_len;
  for (int l0 = 0; l0 < l_len; l0 += kChunk) {
    const int nl = min(kChunk, l_len - l0);
    __syncthreads();                   // g_s of the last round is read
    for (int i = threadIdx.x; i < kTT * kChunk; i += blockDim.x) {
      const int tt = i / kChunk, ll = i % kChunk;
      g_s[tt][ll] = tt < nt && ll < nl ? __bfloat162float(
          gb[static_cast<size_t>(tt) * l_len + l0 + ll]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int ll = 0; ll < nl; ++ll) {
      const float u = __bfloat162float(
          uh[(static_cast<size_t>(b) * l_len + l0 + ll) * hd + h]);
#pragma unroll
      for (int tt = 0; tt < kTT; tt += 2) {
        if (tt < nt) {                 // a pair; g_s is 0 past nt
          const float2 th = th2_of(w[tt], u, w[tt + 1], u);
          const float g0 = g_s[tt][ll], g1 = g_s[tt + 1][ll];
          acc[tt] = fmaf(g0, 1.f - th.x * th.x, acc[tt]);
          acc[tt + 1] = fmaf(g1, 1.f - th.y * th.y, acc[tt + 1]);
          acc_v = fmaf(th.x, g0, acc_v);
          acc_v = fmaf(th.y, g1, acc_v);
        }
      }
    }
  }
  if (!live) return;
  const float vh = __bfloat162float(v[h]);
#pragma unroll
  for (int tt = 0; tt < kTT; ++tt)
    if (tt < nt)
      dwq[(static_cast<size_t>(b) * t_len + t0 + tt) * hd + h] =
          __float2bfloat16_rn(acc[tt] * vh);
  dv_part[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * hd + h] = acc_v;
}

// duh. Block (l-tile, b), a thread per h. Shared memory: g_s [kChunk][kLT].
__global__ void __launch_bounds__(kMaxH)
additive_bwd_k_kernel(const __nv_bfloat16* __restrict__ wq,
                      const __nv_bfloat16* __restrict__ uh,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ g,
                      __nv_bfloat16* __restrict__ duh, int t_len, int l_len,
                      int hd) {
  __shared__ float g_s[kChunk][kLT];
  const int b = blockIdx.y;
  const int l0 = blockIdx.x * kLT;
  const int nl = min(kLT, l_len - l0);
  const int h = threadIdx.x;
  const bool live = h < hd;
  float u[kLT], acc[kLT];
#pragma unroll
  for (int ll = 0; ll < kLT; ++ll) {
    acc[ll] = 0.f;
    u[ll] = live && ll < nl ? __bfloat162float(
        uh[(static_cast<size_t>(b) * l_len + l0 + ll) * hd + h]) : 0.f;
  }
  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int nt = min(kChunk, t_len - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * kLT; i += blockDim.x) {
      const int tt = i / kLT, ll = i % kLT;
      g_s[tt][ll] = tt < nt && ll < nl ? __bfloat162float(
          g[(static_cast<size_t>(b) * t_len + t0 + tt) * l_len + l0 + ll])
          : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const float w = __bfloat162float(
          wq[(static_cast<size_t>(b) * t_len + t0 + tt) * hd + h]);
#pragma unroll
      for (int ll = 0; ll < kLT; ll += 2) {
        if (ll < nl) {                 // a pair; g_s is 0 past nl
          const float2 th = th2_of(w, u[ll], w, u[ll + 1]);
          acc[ll] = fmaf(g_s[tt][ll], 1.f - th.x * th.x, acc[ll]);
          acc[ll + 1] = fmaf(g_s[tt][ll + 1], 1.f - th.y * th.y,
                             acc[ll + 1]);
        }
      }
    }
  }
  if (!live) return;
  const float vh = __bfloat162float(v[h]);
#pragma unroll
  for (int ll = 0; ll < kLT; ++ll)
    if (ll < nl)
      duh[(static_cast<size_t>(b) * l_len + l0 + ll) * hd + h] =
          __float2bfloat16_rn(acc[ll] * vh);
}

// dv[h] = sum of the n partials, in order.
__global__ void additive_dv_reduce_kernel(const float* __restrict__ dv_part,
                                          __nv_bfloat16* __restrict__ dv,
                                          int n, int hd) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= hd) return;
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += dv_part[static_cast<size_t>(i) * hd + h];
  dv[h] = __float2bfloat16_rn(s);
}

int threads_for(int hd) { return (hd + 31) / 32 * 32; }

}  // namespace

extern "C" {

// Whether the kernels take hidden width H: a multiple of 8, at most 256.
int additive_supports(int hd) { return hd >= 8 && hd % 8 == 0 && hd <= kMaxH; }

// Bytes of dynamic shared memory a forward block needs.
int additive_fwd_smem_bytes(int hd) {
  return 4 * ((kFwdRows + 1) * hd + kFwdRows * kFwdKeys);
}

// Rows of dv partials the backward needs (the caller allocates
// [rows, H] f32 of scratch).
int additive_dv_rows(int b, int t_len) { return b * ((t_len + kTT - 1) / kTT); }

// Each returns cudaGetLastError() after its launches (0 = launched).
int additive_scores_fwd_bf16(const void* wq, const void* uh, const void* v,
                             void* out, int b, int t_len, int l_len, int hd,
                             void* stream) {
  if (!additive_supports(hd) || b < 1 || b > 65535 || t_len < 1 || l_len < 1
      || (t_len + kFwdRows - 1) / kFwdRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = additive_fwd_smem_bytes(hd);
  cudaFuncSetAttribute(additive_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((l_len + kFwdKeys - 1) / kFwdKeys,
            (t_len + kFwdRows - 1) / kFwdRows, b);
  additive_fwd_kernel<<<grid, kFwdWarps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(wq),
      static_cast<const __nv_bfloat16*>(uh),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      t_len, l_len, hd);
  return static_cast<int>(cudaGetLastError());
}

int additive_scores_bwd_bf16(const void* wq, const void* uh, const void* v,
                             const void* g, void* dwq, void* duh, void* dv,
                             void* dv_part, int b, int t_len, int l_len,
                             int hd, void* stream) {
  if (!additive_supports(hd) || b < 1 || b > 65535 || t_len < 1 || l_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(hd);
  const auto* wq_ = static_cast<const __nv_bfloat16*>(wq);
  const auto* uh_ = static_cast<const __nv_bfloat16*>(uh);
  const auto* v_ = static_cast<const __nv_bfloat16*>(v);
  const auto* g_ = static_cast<const __nv_bfloat16*>(g);
  auto* part = static_cast<float*>(dv_part);
  additive_bwd_q_kernel<<<dim3((t_len + kTT - 1) / kTT, b), threads, 0, s>>>(
      wq_, uh_, v_, g_, static_cast<__nv_bfloat16*>(dwq), part, t_len, l_len,
      hd);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  additive_bwd_k_kernel<<<dim3((l_len + kLT - 1) / kLT, b), threads, 0, s>>>(
      wq_, uh_, v_, g_, static_cast<__nv_bfloat16*>(duh), t_len, l_len, hd);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  additive_dv_reduce_kernel<<<(hd + 127) / 128, 128, 0, s>>>(
      part, static_cast<__nv_bfloat16*>(dv), additive_dv_rows(b, t_len), hd);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
