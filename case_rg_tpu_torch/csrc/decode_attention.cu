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
// What bounds it on an H100: bytes, and at CaSE's decode shapes the chain
// of dependent steps of one launch. K and V are read once, 4 * L * E bytes
// a row against 4 * L * E operations: one operation a byte, far below the
// ~295 the tensor cores need. At the decode shapes (B = 64 or 256 rows,
// L = 60 query-memory keys or L <= 40 packed history keys, E = 256, d = 32)
// that is 1-4 MB, about 0.5 us at 3.35 TB/s, while a launch of the first
// design (a block of 128 threads a (row, head): q, then K, then two block
// reductions, then V, then a tree of warp partials; three dependent memory
// round trips and five block barriers) read 5.4 us. An empty kernel reads
// about 2 us a launch on the same card, so at these shapes the launch and
// its chain of memory round trips are the cost.
//
// What this design does about it: two layouts, chosen per shape by
// kernels/decode_attention.single_query_mha_plan.
// - "warp" (every decode shape): one warp a (row, head), four a block, no
//   shared memory and no block barrier. A key's d lanes are read by a group
//   of d / 8 lanes, 16 bytes each, so a warp reads 256 / d keys a pass and
//   a lane holds kWarpKeys of them: L <= kWarpKeys * 256 / d (64 keys at
//   d = 32). Each lane reads its keys' keep bytes and its 16 bytes of q;
//   then it requests the K and V of every valid key it holds before it uses
//   any (which keys are valid is known from keep, so V does not wait for
//   the probabilities; the loads are asm volatile, so the compiler does not
//   sink them towards their uses): two memory round trips, the first one a
//   few bytes. (Requesting every key's K and V at once, masked or not, saves
//   the keep round trip but reads the masked keys too, and was slower.)
//   Scores, max, sum and context stay in registers; the group's partial dots
//   and the warp's max and sum are butterflies of shuffles, and the context
//   is a reduce-scatter over the warp's key slots (each step halves what a
//   lane carries), so each lane ends with its share of the head's d outputs.
// - "block" (longer memories, wider heads): one block of 128 threads a
//   (row, head). Pass 1 puts the valid keys' scores into shared memory in
//   f32 (4 bytes a key: the whole row of scores stays on the SM, so K is
//   read once and the probabilities are normalised before they are rounded);
//   two block reductions give the max and the sum; pass 2 accumulates
//   p_j * v_j for 8 lanes a thread, four keys in flight, V requested for the
//   valid keys before their probabilities are read; the four warps' partial
//   contexts are added in a fixed order. Shared memory is 4 * (5 d + L + 4)
//   bytes, within the 48 KB default up to L of about 12000 at d = 32; past
//   that the launcher raises the kernel's limit once per process and device.
// Both layouts sum in a fixed order, so two launches on the same inputs are
// equal bit for bit. No online softmax: the path this replaces rounds
// normalised probabilities. No tensor cores (one query) and no TMA (the
// bytes of a (row, head) are a few KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;          // both layouts
constexpr int kWarps = kThreads / 32;
constexpr int kWarpKeys = 8;           // keys a lane holds, warp layout
constexpr int kUnroll = 4;             // keys in flight a thread, block layout
constexpr int kLayoutWarp = 0, kLayoutBlock = 1;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 x = __bfloat1622float2(p[t]);
    f[2 * t] = x.x;
    f[2 * t + 1] = x.y;
  }
}

// ---- warp layout ----

// 16 read-only bytes, or zeros where `pred` is false. An asm volatile load
// is issued where it stands in the program: the compiler does not sink it
// towards its first use, so every K and V load of a lane is in flight
// before the first score is computed.
__device__ __forceinline__ uint4 ldg16_if(const void* p, bool pred) {
  uint4 r = make_uint4(0, 0, 0, 0);
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %5, 0;\n"
      " @q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "+r"(r.x), "+r"(r.y), "+r"(r.z), "+r"(r.w)
      : "l"(p), "r"(static_cast<int>(pred)));
  return r;
}

// Reduce-scatter of the 8 partial context lanes over the key slots, the
// slot bits from 16 down to kLpk: at a step a lane keeps the half of what it
// carries that its partner does not, adds the partner's copy of that half
// and drops the other. Once one value is left the steps are butterflies.
template <int kO, int kN, int kLpk>
__device__ __forceinline__ void scatter_slots(float (&acc)[8], int lane) {
  if constexpr (kO >= kLpk) {
    if constexpr (kN > 1) {
      constexpr int kHalf = kN / 2;
      const bool up = lane & kO;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float send = up ? acc[i] : acc[i + kHalf];
        const float keep = up ? acc[i + kHalf] : acc[i];
        acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, kO);
      }
      scatter_slots<kO / 2, kHalf, kLpk>(acc, lane);
    } else {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], kO);
      scatter_slots<kO / 2, 1, kLpk>(acc, lane);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
sq_warp_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const uint8_t* __restrict__ keep,
               __nv_bfloat16* __restrict__ out, int b, int h, int l, int e,
               long long qb, long long kb, long long kl, long long vb,
               long long vl, float scale) {
  constexpr int kLpk = kD / 8;           // lanes a key
  constexpr int kKpw = 32 / kLpk;        // keys a warp pass
  const long long unit =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (unit >= static_cast<long long>(b) * h) return;   // whole warps
  const int row = static_cast<int>(unit / h);
  const int head = static_cast<int>(unit % h);
  const int lane = threadIdx.x % 32;
  const int slot = lane / kLpk;
  const int c0 = (lane % kLpk) * 8;
  // phase start

  // keep and q, then K and V of the valid keys, all requested at once
  const uint8_t* keep_r = keep ? keep + static_cast<size_t>(row) * l : nullptr;
  bool live[kWarpKeys];
#pragma unroll
  for (int u = 0; u < kWarpKeys; ++u) {
    const int j = slot + u * kKpw;
    live[u] = j < l && (keep_r == nullptr || __ldg(keep_r + j));
  }
  const uint4 qraw = __ldg(reinterpret_cast<const uint4*>(
      q + row * qb + head * kD + c0));
  const __nv_bfloat16* kr = k + row * kb + head * kD + c0;
  const __nv_bfloat16* vr = v + row * vb + head * kD + c0;
  uint4 kraw[kWarpKeys], vraw[kWarpKeys];
#pragma unroll
  for (int u = 0; u < kWarpKeys; ++u) {
    const int j = slot + u * kKpw;
    kraw[u] = ldg16_if(kr + j * kl, live[u]);
    vraw[u] = ldg16_if(vr + j * vl, live[u]);
  }

  float q8[8];
  unpack8(qraw, q8);
  // phase keep and q
#pragma unroll
  for (int i = 0; i < 8; ++i) q8[i] = bf16_round(q8[i] * scale);

  // scores (the key's group adds its lanes' partial dots) and their max
  float s[kWarpKeys];
  float mx = -INFINITY;
#pragma unroll
  for (int u = 0; u < kWarpKeys; ++u) {
    float kf[8];
    unpack8(kraw[u], kf);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) dot = fmaf(q8[i], kf[i], dot);
#pragma unroll
    for (int o = 1; o < kLpk; o <<= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    s[u] = dot;
    if (live[u]) mx = fmaxf(mx, dot);
  }
#pragma unroll
  for (int o = kLpk; o < 32; o <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  // phase K and scores
  __nv_bfloat16* out_r = out + static_cast<size_t>(row) * e + head * kD;
  if (mx == -INFINITY) {                 // no valid key: zeros
    if (slot == 0)
      *reinterpret_cast<uint4*>(out_r + c0) = make_uint4(0, 0, 0, 0);
    return;
  }
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < kWarpKeys; ++u) {
    s[u] = live[u] ? expf(s[u] - mx) : 0.f;
    sum += s[u];
  }
#pragma unroll
  for (int o = kLpk; o < 32; o <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);

  // context: bf16(p_j) * v_j over the lane's keys, then over the slots
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
  for (int u = 0; u < kWarpKeys; ++u) {
    const float p = s[u] == 0.f ? 0.f : bf16_round(s[u] / sum);
    float vf[8];
    unpack8(vraw[u], vf);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
  }
  // phase softmax, V and context
  scatter_slots<16, 8, kLpk>(acc, lane);
  // phase reduce-scatter
  // what the lane carries: kNv lanes from c0 + idx; the slot bits the
  // scatter did not use (d < 32) hold copies, and only their 0 writes
  constexpr int kNv = kKpw >= 8 ? 1 : 8 / kKpw;
  constexpr int kCopies = kKpw > 8 ? (kKpw / 8 - 1) * kLpk : 0;
  int idx = 0;
  if (kKpw >= 2) idx += (lane & 16) ? 4 : 0;
  if (kKpw >= 4) idx += (lane & 8) ? 2 : 0;
  if (kKpw >= 8) idx += (lane & 4) ? 1 : 0;
  if (lane & kCopies) return;
#pragma unroll
  for (int i = 0; i < kNv; ++i)
    out_r[c0 + idx + i] = __float2bfloat16_rn(acc[i]);
  // phase store
}

// ---- block layout ----

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
sq_block_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const uint8_t* __restrict__ keep,
                __nv_bfloat16* __restrict__ out, int l, int e, int d,
                long long qb, long long kb, long long kl, long long vb,
                long long vl, float scale) {
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
      float kf[8];
      unpack8(raw[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) dot = fmaf(q8[i], kf[i], dot);
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
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {   // valid keys, before their p
      const int j = j0 + u * step + slot;
      raw[u] = j < l && (keep_r == nullptr || keep_r[j])
                   ? __ldg(reinterpret_cast<const uint4*>(vr + j * vl))
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * step + slot;
      const float e_j = j < l ? s[j] : 0.f;
      const float p = e_j == 0.f ? 0.f : bf16_round(e_j / sum);
      float vf[8];
      unpack8(raw[u], vf);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
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

bool pow2_width(int d) { return d >= 8 && d <= 256 && (d & (d - 1)) == 0; }

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block of the layout needs (0 = warp,
// 1 = block); -1 for a layout that does not take (L, d): the warp layout
// holds at most kWarpKeys * 256 / d keys, and both need d = 8, 16, ..., 256
// (d / 8 lanes share a key, and they tile a warp).
int single_query_mha_smem_bytes(int layout, int l, int d) {
  if (!pow2_width(d) || l < 1) return -1;
  if (layout == kLayoutWarp) return l <= kWarpKeys * 256 / d ? 0 : -1;
  if (layout == kLayoutBlock) return 4 * (d + l + kWarps * d + kWarps);
  return -1;
}

// Launches the layout on `stream`; returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for shapes the layout does not take.
// Strides are in elements; q, k and v rows must start on 16-byte
// boundaries.
int single_query_mha_bf16(int layout, const void* q, const void* k,
                          const void* v, const void* keep, void* out, int b,
                          int l, int e, int h, long long qb, long long kb,
                          long long kl, long long vb, long long vl,
                          float scale, void* stream) {
  if (h < 1 || h > 65535 || e % h || b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = e / h;
  const int smem = single_query_mha_smem_bytes(layout, l, d);
  if (smem < 0 || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* keepp = static_cast<const uint8_t*>(keep);
  auto* outp = static_cast<__nv_bfloat16*>(out);
  if (layout == kLayoutWarp) {
    const long long blocks =
        (static_cast<long long>(b) * h + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const auto kern = d == 8     ? sq_warp_kernel<8>
                      : d == 16  ? sq_warp_kernel<16>
                      : d == 32  ? sq_warp_kernel<32>
                      : d == 64  ? sq_warp_kernel<64>
                      : d == 128 ? sq_warp_kernel<128>
                                 : sq_warp_kernel<256>;
    kern<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        qp, kp, vp, keepp, outp, b, h, l, e, qb, kb, kl, vb, vl, scale);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(sq_block_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sq_block_kernel<<<dim3(b, h), kThreads, smem, s>>>(
      qp, kp, vp, keepp, outp, l, e, d, qb, kb, kl, vb, vl, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
