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
// uh [B, L, H], v [H], g [B, T, L], all bf16, contiguous, 16-byte aligned;
// H a multiple of 8, at most 256.
//
// An element: the sum of two elements at once by one bf16x2 add (one
// rounding, as the plain version's f32 add and cast), each unpacked to f32
// by one integer operation, tanh.approx.f32 on the special-function unit,
// and the two tanh rounded and packed by one cvt.rn.bf16x2.f32. On an H100
// (tools/probe_tanh_rates.py) tanh.approx.f32 and tanh.approx.bf16x2 both
// give 16 results a clock on each SM, so packing does not double the rate;
// the conversion runs on another pipe (62 roundings a clock), not on the
// special-function unit; and tanh.approx.f32 rounded to bf16 equals the
// plain version's bf16(tanh) on every finite bf16 input, where the packed
// tanh is one ulp off on 3 % of them. So th is bit for bit the plain one.
//
// What bounds it on an H100: the tanh, 16 a clock on each of 132 SMs (4.18e12
// a second at 1980 MHz). Teacher forcing at [64, 40, 1000, 256] takes 655 M
// tanh (0.157 ms) and moves 39 MB (0.012 ms at 3.35 TB/s); a decode step at
// [64, 1, 1000, 256] moves uh's 32.8 MB (0.0098 ms) for 16 M tanh, bytes.
//
// What this design does about it (kernels/additive_attention.
// additive_scores_plan lays it out per shape; no [B, T, L, H] value leaves
// the registers, no atomics touch a sum, so two runs are equal bit for bit):
// - forward, one layout for every T: a warp takes kKeys keys of one query
//   row, 8 consecutive h and one 16-byte load a lane, so a warp reads a
//   512-byte uh row in one instruction and keeps every key's load in flight
//   before it uses any. wq[b, t] and v are read once a warp into registers;
//   no shared memory and no block barrier; a reduce-scatter of shuffles
//   adds the lanes' partial sums, and the scores are stored from the lanes,
//   kKeys consecutive keys a store. At teacher forcing each query row reads
//   its row's uh again, from L2 (32.8 MB at [64, 1000, 256]).
// - backward, one pass that computes th once: a block a (row b, 64 keys,
//   share of the queries), a thread an h; a thread keeps its 64 keys' duh
//   sums in registers (their uh in its own column of shared memory) while
//   it walks its queries in chunks of g staged in shared memory, and
//   computes th, c = g (1 - th^2) and th g once an element. duh's sum over
//   the queries and dwq's over the keys are each finished inside a thread
//   block cluster through distributed shared memory, in a fixed order: dwq
//   across the key tiles of a row (a cluster of up to 16 blocks covers 1024
//   keys), duh across the query shares of a key tile (the 60-key memory: a
//   row's keys fit one block, so its queries split over a cluster instead).
//   "partials" (clusters of 8; the plan's choice past 8 key tiles, faster
//   at the 1000-key memory's 16 than one cluster of 16, of which fewer fit
//   at once) writes each cluster's dwq sums in f32 and a second launch adds
//   them in order. dv: each cluster's partial in f32, added in cluster
//   order by a launch of its own.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxH = 256;       // H <= 256 (CaSE: 256)
constexpr int kFwdWarps = 4;     // forward: warps a block
constexpr int kNK = 64;          // backward: keys a block
constexpr int kMaxCluster = 16;  // backward: blocks a cluster

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Two elements: bf16(a + b) for a pair of bf16x2 words.
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// th = bf16(tanh(x)) for both halves of a bf16x2 word, packed as they came
__device__ __forceinline__ uint32_t tanh2(uint32_t x) {
  uint32_t y;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;"
      : "=r"(y)
      : "f"(tanh_approx(hi_f(x))), "f"(tanh_approx(lo_f(x))));
  return y;
}

__device__ __forceinline__ uint4 load16(const bf16* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}

// ---- forward ----
// Block (query row r = (b, t), y): warp w takes keys [k0, k0 + kKeys), k0 =
// (4 y + w) kKeys. Lane c holds h in [8 c, 8 c + 8) of every key (lanes
// past H / 8 hold zeros). The warp's kKeys sums are a reduce-scatter: each
// of log2(kKeys) shuffle steps halves what a lane carries, then a butterfly
// over the rest; lane (32 / kKeys) i ends with key k0 + i.
template <int kKeys>
__global__ void __launch_bounds__(kFwdWarps * 32)
fwd_kernel(const bf16* __restrict__ wq, const bf16* __restrict__ uh,
           const bf16* __restrict__ v, bf16* __restrict__ out, int t_len,
           int l_len, int hd) {
  // phase fwd start
  const int lane = threadIdx.x % 32;
  const int k0 = (blockIdx.y * kFwdWarps + threadIdx.x / 32) * kKeys;
  if (k0 >= l_len) return;
  const size_t r = blockIdx.x;
  const int b = static_cast<int>(r / t_len);
  const int h0 = 8 * lane;
  const bool live = h0 < hd;
  const uint4 w4 = load16(wq + r * hd + h0, live);
  const uint4 v4 = load16(v + h0, live);
  uint4 u[kKeys];
  const bf16* ub = uh + (static_cast<size_t>(b) * l_len + k0) * hd + h0;
#pragma unroll
  for (int i = 0; i < kKeys; ++i)
    u[i] = load16(ub + static_cast<size_t>(i) * hd, live && k0 + i < l_len);
  // phase fwd loads sent
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&w4);
  const uint32_t* vw = reinterpret_cast<const uint32_t*>(&v4);
  float acc[kKeys];
#pragma unroll
  for (int i = 0; i < kKeys; ++i) {
    const uint32_t* x = reinterpret_cast<const uint32_t*>(&u[i]);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t th = tanh2(add2(w[j], x[j]));
      s = fmaf(lo_f(th), lo_f(vw[j]), s);
      s = fmaf(hi_f(th), hi_f(vw[j]), s);
    }
    acc[i] = s;
  }
  // phase fwd elements
  int o = 16;
#pragma unroll
  for (int n = kKeys; n > 1; n /= 2, o /= 2) {
    const bool up = lane & o;      // keep the upper half, send the lower
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? acc[i] : acc[i + n / 2];
      const float keep = up ? acc[i + n / 2] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  for (; o > 0; o /= 2) acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
  // phase fwd reduce
  constexpr int kStep = 32 / kKeys;
  const int key = k0 + lane / kStep;
  if (lane % kStep == 0 && key < l_len)
    out[r * l_len + key] = __float2bfloat16_rn(acc[0]);
  // phase fwd store
}

// ---- backward ----

struct BwdArgs {
  const bf16* wq;
  const bf16* uh;
  const bf16* v;
  const bf16* g;
  bf16* dwq;
  bf16* duh;
  bf16* dv;
  float* dq_part;    // "partials": [B][clusters a row][T][H], else null
  float* dv_part;    // [clusters][H]
  int t_len, l_len, hd;
  int t_per;         // queries a block
  int chunk;         // queries a chunk (g staged, dq partials kept)
  int red_rows;      // rows of H floats in red_s
};

// Two elements of one query and two keys: th, c = g (1 - th^2) in f32 (th^2
// is exact; nvcc contracts c's product into the fma of each sum, a rounding
// finer than the plain version's separate one), duh's and dq's sums of c and
// dv's of th g.
__device__ __forceinline__ void bwd_pair(uint32_t w2, uint32_t u2, float g0,
                                         float g1, float& d0, float& d1,
                                         float& dq, float& dv) {
  const uint32_t th = tanh2(add2(w2, u2));
  const float t0 = lo_f(th), t1 = hi_f(th);
  const float c0 = g0 * fmaf(-t0, t0, 1.f);
  const float c1 = g1 * fmaf(-t1, t1, 1.f);
  d0 += c0;
  d1 += c1;
  dq += c0;
  dq += c1;
  dv = fmaf(t0, g0, dv);
  dv = fmaf(t1, g1, dv);
}

// dwq[b, t] at h from the cluster's sum s over its key tiles; in
// "partials" (dq_part) the sum of cluster c of the row's nc instead.
__device__ __forceinline__ void put_dq(const BwdArgs& a, float s, float vh,
                                       int b, int t, int c, int nc, int h) {
  if (a.dq_part == nullptr)
    a.dwq[(static_cast<size_t>(b) * a.t_len + t) * a.hd + h] =
        __float2bfloat16_rn(s * vh);
  else
    a.dq_part[((static_cast<size_t>(b) * nc + c) * a.t_len + t) * a.hd + h] =
        s;
}

// A chunk's g ([cn] queries x [nl] keys from g0, row stride l_len) into
// g_s [chunk][64] as f32, zeros past cn and nl; kWide loads a thread in
// flight at once.
template <int kWide>
__device__ __forceinline__ void stage_g(float* g_s, const bf16* g0, int l_len,
                                        int chunk, int cn, int nl) {
  const int n = chunk * kNK;
  for (int i0 = 0; i0 < n; i0 += kWide * blockDim.x) {
    float gv[kWide];
#pragma unroll
    for (int r = 0; r < kWide; ++r) {
      const int i = i0 + threadIdx.x + r * blockDim.x;
      const int tt = i / kNK, kk = i % kNK;
      gv[r] = i < n && tt < cn && kk < nl
          ? __bfloat162float(g0[static_cast<size_t>(tt) * l_len + kk]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kWide; ++r) {
      const int i = i0 + threadIdx.x + r * blockDim.x;
      if (i < n) g_s[i] = gv[r];
    }
  }
}

// Block (x, y, b): keys [64 x, 64 x + 64) of row b, queries [y t_per, (y +
// 1) t_per). A cluster is (cx, cy) blocks: cx key tiles of one query share
// and cy query shares of one key tile. Shared memory: red_s [red_rows][H]
// f32 (a chunk's dq partials where dq is added across blocks, then the
// block's duh partials where cy > 1), g_s [chunk][64] f32,
// u_s [16][H] uint2 (the block's uh, four keys an entry, each thread's own
// column, 8 bytes a read: registers would spill beside the 64 duh sums),
// dv_s [H] f32.
__global__ void __launch_bounds__(kMaxH, 2) bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int hd = a.hd;
  float* red_s = smem;
  float* g_s = red_s + a.red_rows * hd;
  uint2* u_s = reinterpret_cast<uint2*>(g_s + a.chunk * kNK);
  float* dv_s = reinterpret_cast<float*>(u_s + kNK / 4 * hd);
  cg::cluster_group cl = cg::this_cluster();
  const dim3 cdim = cl.dim_blocks();
  const dim3 cidx = cl.block_index();
  const int cx = cdim.x, cy = cdim.y;
  const int h = threadIdx.x;
  const bool live = h < hd;
  const int b = blockIdx.z;
  const int l0 = blockIdx.x * kNK;
  const int nl = max(0, min(kNK, a.l_len - l0));
  const int tb = blockIdx.y * a.t_per;
  const int nt = max(0, min(a.t_per, a.t_len - tb));
  const size_t row_t = static_cast<size_t>(b) * a.t_len;
  const bf16* ur0 = a.uh + (static_cast<size_t>(b) * a.l_len + l0) * hd;
  // phase bwd start
  if (live) {   // uh of the block's keys at h: every load in flight at once
    uint32_t k1[kNK];
#pragma unroll
    for (int k = 0; k < kNK; ++k)
      k1[k] = k < nl
          ? __bfloat16_as_ushort(ur0[static_cast<size_t>(k) * hd + h]) : 0u;
#pragma unroll
    for (int q = 0; q < kNK / 4; ++q)
      u_s[q * hd + h] = make_uint2(k1[4 * q] | k1[4 * q + 1] << 16,
                                   k1[4 * q + 2] | k1[4 * q + 3] << 16);
  }
  // the first chunk's g, before the 64 sums take their registers
  stage_g<8>(g_s, a.g + (row_t + tb) * a.l_len + l0, a.l_len, a.chunk,
             min(a.chunk, nt), nl);
  float dsum[kNK];
#pragma unroll
  for (int k = 0; k < kNK; ++k) dsum[k] = 0.f;
  float dv = 0.f;
  const float vh = live ? __bfloat162float(a.v[h]) : 0.f;
  // dq is finished across the cluster's key tiles (or its part written, in
  // "partials") through dq_s; duh across its query shares through duh_s
  const bool dq_across = cx > 1 || a.dq_part != nullptr;
  float* dq_s = red_s;
  float* duh_s = red_s + (dq_across ? a.chunk * hd : 0);
  const int nchunks = (a.t_per + a.chunk - 1) / a.chunk;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int ct = ci * a.chunk;              // first query of the chunk
    const int cn = max(0, min(a.chunk, nt - ct));
    const bool last_chunk = ci == nchunks - 1;
    if (ci > 0) {
      __syncthreads();                        // g_s of the last chunk read
      stage_g<1>(g_s, a.g + (row_t + tb + ct) * a.l_len + l0, a.l_len,
                 a.chunk, cn, nl);
    }
    __syncthreads();                          // u_s and g_s written
    // phase bwd g staged
    for (int tt = 0; tt < cn && live; ++tt) {
      const size_t q = row_t + tb + ct + tt;
      const uint32_t w = __bfloat16_as_ushort(a.wq[q * hd + h]);
      const uint32_t w2 = w | w << 16;
      const float* gr = g_s + tt * kNK;
      float dq = 0.f;
#pragma unroll
      for (int q = 0; q < kNK / 4; ++q) {
        const float4 g4 = *reinterpret_cast<const float4*>(gr + 4 * q);
        const uint2 u4 = u_s[q * hd + h];
        bwd_pair(w2, u4.x, g4.x, g4.y, dsum[4 * q], dsum[4 * q + 1], dq, dv);
        bwd_pair(w2, u4.y, g4.z, g4.w, dsum[4 * q + 2], dsum[4 * q + 3], dq,
                 dv);
      }
      if (dq_across)
        dq_s[tt * hd + h] = dq;
      else                                    // the block saw every key
        a.dwq[q * hd + h] = __float2bfloat16_rn(dq * vh);
    }
    // phase bwd elements
    if (!dq_across || last_chunk) continue;   // the last chunk's: below
    cl.sync();
    for (int tt = cidx.x; tt < cn && live; tt += cx) {
      float s = 0.f;
#pragma unroll 4   // (a full unroll spills beside the 64 duh sums)
      for (int x = 0; x < kMaxCluster; ++x)
        if (x < cx) s += cl.map_shared_rank(dq_s, x + cidx.y * cx)[tt * hd + h];
      put_dq(a, s, vh, b, tb + ct + tt, blockIdx.x / cx, gridDim.x / cx, h);
    }
    cl.sync();                                // dq_s read by every block
  }
  // duh: finished here with one query share (through u_s, free now, so the
  // block's [64][H] tile leaves in 16-byte stores), else across the shares
  bf16* dr = a.duh + (static_cast<size_t>(b) * a.l_len + l0) * hd + h;
  bf16* duh_t = reinterpret_cast<bf16*>(u_s);
  if (cy == 1) __syncthreads();               // u_s read by every thread
#pragma unroll
  for (int k = 0; k < kNK; ++k) {
    if (!live) continue;
    if (cy == 1)
      duh_t[k * hd + h] = __float2bfloat16_rn(dsum[k] * vh);
    else if (k < nl)
      duh_s[k * hd + h] = dsum[k];
  }
  if (cy == 1) {
    __syncthreads();
    const int c8 = hd / 8;
    bf16* d0 = a.duh + (static_cast<size_t>(b) * a.l_len + l0) * hd;
    for (int i = threadIdx.x; i < nl * c8; i += blockDim.x)
      *reinterpret_cast<uint4*>(d0 + static_cast<size_t>(i) * 8) =
          *reinterpret_cast<const uint4*>(duh_t + i * 8);
  }
  if (live) dv_s[h] = dv;
  cl.sync();                      // the last chunk's dq_s, duh_s and dv_s
  if (dq_across) {                // the sums' registers are free: all loads
    const int ct = (nchunks - 1) * a.chunk;   // in flight at once
    const int cn = max(0, min(a.chunk, nt - ct));
    for (int tt = cidx.x; tt < cn && live; tt += cx) {
      float s = 0.f;
#pragma unroll
      for (int x = 0; x < kMaxCluster; ++x)
        if (x < cx) s += cl.map_shared_rank(dq_s, x + cidx.y * cx)[tt * hd + h];
      put_dq(a, s, vh, b, tb + ct + tt, blockIdx.x / cx, gridDim.x / cx, h);
    }
  }
  // phase bwd dq reduced
  if (cy > 1 && live) {
#pragma unroll 4
    for (int k = cidx.y; k < nl; k += cy) {
      float s = 0.f;
#pragma unroll
      for (int y = 0; y < kMaxCluster; ++y)
        if (y < cy) s += cl.map_shared_rank(duh_s, cidx.x + y * cx)[k * hd + h];
      dr[static_cast<size_t>(k) * hd] = __float2bfloat16_rn(s * vh);
    }
  }
  // phase bwd duh written
  if (cl.block_rank() == 0 && live) {          // the cluster's dv, in order
    const unsigned int nb = cl.num_blocks();
    float s = 0.f;
#pragma unroll
    for (unsigned int r = 0; r < kMaxCluster; ++r)
      if (r < nb) s += cl.map_shared_rank(dv_s, r)[h];
    const size_t cid = blockIdx.x / cx + gridDim.x / cx *
                       (blockIdx.y / cy + gridDim.y / cy * blockIdx.z);
    a.dv_part[cid * hd + h] = s;
  }
  cl.sync();                                   // dv_s and duh_s read
  // phase bwd cluster sums
}

// "partials": dwq[b, t, h] = v[h] * the sum of the row's cluster partials,
// in cluster order. Block (t, b), a thread an h.
__global__ void dq_sum_kernel(const float* __restrict__ dq_part,
                              const bf16* __restrict__ v,
                              bf16* __restrict__ dwq, int t_len, int hd,
                              int nc) {
  const int h = threadIdx.x, t = blockIdx.x, b = blockIdx.y;
  if (h >= hd) return;
  float s = 0.f;
  for (int c = 0; c < nc; ++c)
    s += dq_part[((static_cast<size_t>(b) * nc + c) * t_len + t) * hd + h];
  dwq[(static_cast<size_t>(b) * t_len + t) * hd + h] =
      __float2bfloat16_rn(s * __bfloat162float(v[h]));
}

// dv[h] = the sum of n cluster partials, in order.
__global__ void dv_sum_kernel(const float* __restrict__ dv_part,
                              bf16* __restrict__ dv, int n, int hd) {
  const int h = threadIdx.x;
  if (h >= hd) return;
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += dv_part[static_cast<size_t>(i) * hd + h];
  dv[h] = __float2bfloat16_rn(s);
}

// Whether the kernels take hidden width H: a multiple of 8, at most 256.
bool supports(int hd) { return hd >= 8 && hd % 8 == 0 && hd <= kMaxH; }

int bwd_smem(int hd, int chunk, int red_rows) {
  return 4 * (red_rows * hd + chunk * kNK + (kNK / 2 + 1) * hd);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a backward block needs: H floats for each
// of red_rows rows (a chunk's queries where dq is added across blocks, and
// the block's 64 keys where queries split), the chunk's g for 64 keys, the
// block's uh (64 keys of H bf16) and dv's partial.
int additive_bwd_smem_bytes(int hd, int chunk, int red_rows) {
  return bwd_smem(hd, chunk, red_rows);
}

// Forward, as kernels/additive_attention.additive_scores_plan lays it out:
// `keys` keys a warp (fwd_kernel's kKeys: 4 or 8), a block row a query row. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
int additive_scores_fwd_bf16(const void* wq, const void* uh, const void* v,
                             void* out, int b, int t_len, int l_len, int hd,
                             int keys, void* stream) {
  const long long rows = static_cast<long long>(b) * t_len;
  const long long ys = (l_len + 4LL * keys - 1) / (4LL * keys);
  if (!supports(hd) || b < 1 || t_len < 1 || l_len < 1 ||
      (keys != 4 && keys != 8) || rows > 0x7fffffffLL || ys > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wq_ = static_cast<const bf16*>(wq);
  const auto* uh_ = static_cast<const bf16*>(uh);
  const auto* v_ = static_cast<const bf16*>(v);
  auto* out_ = static_cast<bf16*>(out);
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(ys));
  if (keys == 4)
    fwd_kernel<4><<<grid, kFwdWarps * 32, 0, s>>>(wq_, uh_, v_, out_, t_len,
                                                  l_len, hd);
  else
    fwd_kernel<8><<<grid, kFwdWarps * 32, 0, s>>>(wq_, uh_, v_, out_, t_len,
                                                  l_len, hd);
  return static_cast<int>(cudaGetLastError());
}

// Backward, as kernels/additive_attention.additive_scores_plan lays it out:
// a grid of (gx, split, b) blocks of round_up(H, 32) threads in clusters of
// (cx, split); t_per queries a block in chunks of `chunk`. With dq_part
// (partials: gx / cx clusters a row) a second launch adds the clusters'
// dwq sums; a last launch adds dv's. dv_part holds a row of H floats for
// each cluster. Returns cudaGetLastError() after the
// launches (0 = launched), or cudaErrorInvalidValue for a layout the
// kernels do not take.
int additive_scores_bwd_bf16(const void* wq, const void* uh, const void* v,
                             const void* g, void* dwq, void* duh, void* dv,
                             void* dq_part, void* dv_part, int b, int t_len,
                             int l_len, int hd, int gx, int cx, int split,
                             int t_per, int chunk, void* stream) {
  const int red_rows =
      (cx > 1 || dq_part != nullptr ? chunk : 0) + (split > 1 ? kNK : 0);
  const int smem = bwd_smem(hd, chunk, red_rows);
  if (!supports(hd) || b < 1 || b > 65535 || t_len < 1 ||
      l_len < 1 || cx < 1 || split < 1 || cx * split > kMaxCluster ||
      gx % cx || gx * kNK < l_len || split * t_per < t_len || chunk < 1 ||
      chunk > t_per || smem > kSmemLimit ||
      (dq_part == nullptr && gx != cx) || (dq_part != nullptr && split != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs a;
  a.wq = static_cast<const bf16*>(wq);
  a.uh = static_cast<const bf16*>(uh);
  a.v = static_cast<const bf16*>(v);
  a.g = static_cast<const bf16*>(g);
  a.dwq = static_cast<bf16*>(dwq);
  a.duh = static_cast<bf16*>(duh);
  a.dv = static_cast<bf16*>(dv);
  a.dq_part = static_cast<float*>(dq_part);
  a.dv_part = static_cast<float*>(dv_part);
  a.t_len = t_len;
  a.l_len = l_len;
  a.hd = hd;
  a.t_per = t_per;
  a.chunk = chunk;
  a.red_rows = red_rows;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(bwd_kernel), smem, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, split, b);
  cfg.blockDim = dim3(round_up(hd, 32));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cx;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bwd_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dq_part != nullptr) {
    dq_sum_kernel<<<dim3(t_len, b), round_up(hd, 32), 0, s>>>(
        a.dq_part, a.v, a.dwq, t_len, hd, gx / cx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dv_sum_kernel<<<1, round_up(hd, 32), 0, s>>>(
        a.dv_part, a.dv, gx / cx * b, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
