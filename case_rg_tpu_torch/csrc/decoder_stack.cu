// One greedy decode step through every layer of a decoder stack, for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel case_rg_tpu/kernels/decoder_stack.py
// (stack_step, body _decoder_stack_kernel). Per layer, for a [B, E] stream:
//   1. LN1 -> fused QKV (bf16) -> K|V written into the cache at the row's t
//      -> single-query self-attention over the history -> out-projection,
//      added onto the NORMED stream;
//   2. LN2 -> cross-attention on the raw memory m [B, L, E] through the
//      folded operands (scores = x.A_h.m^T + m.u_h; the softmax-invariant
//      terms are dropped; context through wvo plus bout), added onto the
//      normed stream;
//   3. LN3 -> FFN with the exact-erf GELU, added onto the normed stream.
// The bf16 roundings sit where the TPU kernel has them (qkv, qs, self-attn
// probs, qf, cross probs, cf, the FFN hidden), LayerNorm runs in f32 with
// eps 1e-5, and dots accumulate in f32. The GELU uses erff: the TPU kernel's
// polynomial only stood in for an erf that Mosaic lacks.
//
// Layouts: caches [B, nl, T, 2E] bf16 (batch-leading, packed K|V); t [B]
// int32, a row whose t is out of [0, T) skips its cache write; mem/hist keep
// [B, L]/[B, T] bool; folded weights stacked [nl, ...] in the order of
// kernels/decoder_stack.WEIGHT_KEYS. The cache is updated IN PLACE: only
// slot t of each layer is written, never the whole buffer.
//
// What bounds it on an H100: bytes. At CaSE serving shapes (B=64, L=1000,
// E=256, H=8, nl=4) one step must read the memory m once (32.8 MB), the
// folded weights (~2.8 MB a layer, ~11 MB) and the written part of the
// caches, against ~2 GFLOP: about 45 operations a byte.
//
// What this design does about it: one block per batch row walks all
// layers, so the stream, the scores [H, L] (f32) and every intermediate
// vector stay in shared memory, and the raw memory replaces the four layers'
// projected cross K/V (8 [B, L, E] buffers the per-layer chain reads). The
// block streams its row of m twice per layer (scores, then context); the
// folded weights are shared by all blocks and stay in the 50 MB L2. Loads
// from device memory are 16 bytes a thread and are issued in batches before
// any is used (16 weight rows a thread, 4 memory rows a warp), so enough
// bytes are in flight to cover their latency. The matrix-vector products
// split K across thread groups and add the partial sums in a fixed order.
// The cross scores run on the tensor cores (mma.sync m16n8k16: 16 positions
// by the 8 heads per product, bf16 in, f32 accumulate); for the context each
// warp takes a slice of the positions with all heads, so the 16 warps stream
// different rows of m. The kernel takes E = 256 and at most 8 heads (the
// CaSE/Masque widths). Each block still reads all the weights, which bounds
// the matrix-vector products per SM: splitting a row across a cluster of
// blocks, wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kE = 256;          // stream width the kernel takes
constexpr int kMaxHeads = 8;
constexpr int kBatch = 16;       // weight loads in flight per thread
constexpr int kCtxBatch = 4;     // memory rows in flight per warp (context)
constexpr float kNegInf = -1e20f;
constexpr float kLnEps = 1e-5f;
constexpr int kNumWeights = 18;

typedef __nv_bfloat16 bf16;

// Order matches kernels/decoder_stack.WEIGHT_KEYS.
struct StackWeights {
  const bf16 *ln1g, *ln1b, *wqkv, *bqkv, *wos, *bos;
  const bf16 *ln2g, *ln2b, *aq, *u, *wvo, *bout;
  const bf16 *ln3g, *ln3b, *w1, *b1, *w2, *b2;
};

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 8 consecutive bf16 (16 bytes, 16-byte aligned) as floats.
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 v = __bfloat1622float2(h2[q]);
    f[2 * q] = v.x;
    f[2 * q + 1] = v.y;
  }
}

// c += a * b on the tensor cores: A 16x16 (row), B 16x8 (col), f32 C 16x8.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float tot = 0.f;
  for (int i = 0; i < kWarps; ++i) tot += red[i];
  __syncthreads();
  return tot;
}

// xn = bf16(LayerNorm(xs) * g + b), statistics in f32.
__device__ void layer_norm(const float* xs, float* xn, const bf16* g,
                           const bf16* b, float* red) {
  float s = 0.f;
  for (int j = threadIdx.x; j < kE; j += kThreads) s += xs[j];
  const float mu = block_sum(s, red) / kE;
  float s2 = 0.f;
  for (int j = threadIdx.x; j < kE; j += kThreads) {
    const float dv = xs[j] - mu;
    s2 += dv * dv;
  }
  const float inv = rsqrtf(block_sum(s2, red) / kE + kLnEps);
  for (int j = threadIdx.x; j < kE; j += kThreads)
    xn[j] = round_bf16((xs[j] - mu) * inv * bf(g[j]) + bf(b[j]));
  __syncthreads();
}

// epi(j, sum_i in[i] * W[i, j]) for every j < n; W [k, n] row-major bf16,
// n a multiple of 256. Each thread owns 8 consecutive columns (one 16-byte
// load a row) and one of `ksplit` interleaved slices of the rows; the
// slices' partial sums meet in `part` and are added in a fixed order.
template <class Epi>
__device__ void matvec(const float* in, int k, const bf16* __restrict__ w,
                       int n, float* part, Epi epi) {
  const int groups = n / 8;
  const int ksplit = groups >= kThreads ? 1 : kThreads / groups;
  for (int g0 = 0; g0 < groups; g0 += kThreads) {
    const int g = g0 + threadIdx.x % min(groups, kThreads);
    const int s = threadIdx.x / min(groups, kThreads);
    float acc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = 0.f;
    if (s < ksplit && g < groups) {
      const bf16* wp = w + g * 8;
      // kBatch 16-byte loads are issued before any is used, so enough
      // bytes are in flight to cover the latency of the weight stream
      for (int i0 = s; i0 < k; i0 += ksplit * kBatch) {
        uint4 raw[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * ksplit;
          raw[u] = i < k ? __ldg(reinterpret_cast<const uint4*>(wp + static_cast<size_t>(i) * n))
                         : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * ksplit;
          const float xi = i < k ? in[i] : 0.f;
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 wv = __bfloat1622float2(h2[q]);
            acc[2 * q] = fmaf(xi, wv.x, acc[2 * q]);
            acc[2 * q + 1] = fmaf(xi, wv.y, acc[2 * q + 1]);
          }
        }
      }
      float* dst = part + s * kThreads * 8 / ksplit + (g - g0) * 8;
#pragma unroll
      for (int q = 0; q < 8; ++q) dst[q] = acc[q];
    }
    __syncthreads();
    const int cols = min(n - g0 * 8, kThreads * 8 / ksplit);
    for (int j = threadIdx.x; j < cols; j += kThreads) {
      float sum = 0.f;
      for (int s2 = 0; s2 < ksplit; ++s2) sum += part[s2 * kThreads * 8 / ksplit + j];
      epi(g0 * 8 + j, sum);
    }
    __syncthreads();
  }
}

// Shared memory (f32 unless said): xs [E] stream, xn [E] normed stream,
// qkv [3E], qfb [8][E] bf16 folded queries, vec [max(8*E, F)],
// sc [H * max(L, T)] scores/probs, part [8 * threads] matvec partial sums,
// rbuf [8 warps][8 heads][E] context partial sums, red [32], hks [T]
// history mask.
__global__ void __launch_bounds__(kThreads)
stack_step_kernel(const bf16* __restrict__ x, const int* __restrict__ t,
                  bf16* caches, const bf16* __restrict__ m,
                  const uint8_t* __restrict__ mk,
                  const uint8_t* __restrict__ hk, StackWeights w,
                  bf16* __restrict__ xout, int nl, int tmax, int l, int h,
                  int f, float scale) {
  extern __shared__ __align__(16) float sm[];
  constexpr int e = kE;
  const int b = blockIdx.x;
  const int d = e / h;
  const int he = h * e;
  const int lt = l > tmax ? l : tmax;
  float* xs = sm;
  float* xn = xs + e;
  float* qkv = xn + e;
  bf16* qfb = reinterpret_cast<bf16*>(qkv + 3 * e);
  float* vec = qkv + 3 * e + kMaxHeads * e / 2;
  float* sc = vec + (kMaxHeads * e > f ? kMaxHeads * e : f);
  float* part = sc + h * lt;
  float* rbuf = part + 8 * kThreads;
  float* red = rbuf + kWarps / 2 * kMaxHeads * kE;
  float* hks = red + 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const bf16* m_row = m + static_cast<size_t>(b) * l * e;
  const uint8_t* mk_row = mk + static_cast<size_t>(b) * l;
  const uint8_t* hk_row = hk + static_cast<size_t>(b) * tmax;
  const int tb = t[b];
  const bool write = tb >= 0 && tb < tmax;

  int any = 0;
  for (int i = threadIdx.x; i < l; i += kThreads) any |= mk_row[i];
  const float mem_any = __syncthreads_or(any) ? 1.f : 0.f;
  any = 0;
  for (int i = threadIdx.x; i < tmax; i += kThreads) {
    hks[i] = hk_row[i] ? 1.f : 0.f;
    any |= hk_row[i];
  }
  // folded queries of heads >= h stay zero
  for (int i = h * e + threadIdx.x; i < kMaxHeads * e; i += kThreads)
    qfb[i] = __float2bfloat16(0.f);
  const float hist_any = __syncthreads_or(any) ? 1.f : 0.f;

  for (int j = threadIdx.x; j < e; j += kThreads) xs[j] = bf(x[static_cast<size_t>(b) * e + j]);
  __syncthreads();

  for (int layer = 0; layer < nl; ++layer) {
    // ---- self-attention over the KV cache ----
    layer_norm(xs, xn, w.ln1g + layer * e, w.ln1b + layer * e, red);
    {
      const bf16* bqkv = w.bqkv + layer * 3 * e;
      matvec(xn, e, w.wqkv + static_cast<size_t>(layer) * e * 3 * e, 3 * e,
             part, [&](int j, float s) { qkv[j] = round_bf16(s + bf(bqkv[j])); });
    }
    bf16* cache = caches + (static_cast<size_t>(b) * nl + layer) * tmax * 2 * e;
    if (write)
      for (int j = threadIdx.x; j < 2 * e; j += kThreads)
        cache[static_cast<size_t>(tb) * 2 * e + j] = __float2bfloat16(qkv[e + j]);
    for (int j = threadIdx.x; j < e; j += kThreads) qkv[j] = round_bf16(qkv[j] * scale);
    __syncthreads();
    // slot tb is read from shared memory (qkv[e:]), the others from the cache
    for (int hh = warp; hh < h; hh += kWarps) {
      float* srow = sc + hh * tmax;
      float mx = kNegInf;
      for (int s = lane; s < tmax; s += 32) {
        float v = kNegInf;
        if (hks[s] != 0.f) {
          v = 0.f;
          if (write && s == tb) {
            for (int c = hh * d; c < (hh + 1) * d; ++c) v = fmaf(qkv[c], qkv[e + c], v);
          } else {
            const bf16* kr = cache + static_cast<size_t>(s) * 2 * e;
            for (int c = hh * d; c < (hh + 1) * d; c += 8) {
              float kv[8];
              load8(kr + c, kv);
#pragma unroll
              for (int q = 0; q < 8; ++q) v = fmaf(qkv[c + q], kv[q], v);
            }
          }
        }
        srow[s] = v;
        mx = fmaxf(mx, v);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int s = lane; s < tmax; s += 32) {
        const float p = expf(srow[s] - mx);
        srow[s] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      for (int s = lane; s < tmax; s += 32) srow[s] = round_bf16(srow[s] / sum);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < e; j += kThreads) {
      const float* prow = sc + (j / d) * tmax;
      const bf16* vcol = cache + e + j;
      float acc = 0.f;
#pragma unroll 8
      for (int s = 0; s < tmax; ++s) {
        // masked slots weigh 0 (they hold p == 0 unless no slot is valid)
        const float p = hks[s] != 0.f ? prow[s] : 0.f;
        const float vv = (write && s == tb)
            ? qkv[2 * e + j] : bf(vcol[static_cast<size_t>(s) * 2 * e]);
        acc = fmaf(p, vv, acc);
      }
      vec[j] = round_bf16(acc * hist_any);
    }
    __syncthreads();
    {
      const bf16* bos = w.bos + layer * e;
      matvec(vec, e, w.wos + static_cast<size_t>(layer) * e * e, e, part,
             [&](int j, float s) { xs[j] = round_bf16(xn[j] + round_bf16(s + bf(bos[j]))); });
    }

    // ---- folded cross-attention against the raw memory ----
    layer_norm(xs, xn, w.ln2g + layer * e, w.ln2b + layer * e, red);
    {
      const bf16* u = w.u + static_cast<size_t>(layer) * he;
      matvec(xn, e, w.aq + static_cast<size_t>(layer) * e * he, he, part,
             [&](int j, float s) { qfb[j] = __float2bfloat16(s + bf(u[j])); });
    }
    {
      // scores S[pos, head] = m[pos, :] . qf[head, :] on the tensor cores,
      // one 16-position tile per mma row block and the 8 heads as its 8
      // columns. Within each 32-column block of E the contraction order is
      // permuted the same way in A and B, so that a lane's A and B values
      // are 8 contiguous columns (one 16-byte load per row).
      const int gid = lane >> 2, tig = lane & 3;
      uint32_t bq[kE / 32][4];
#pragma unroll
      for (int cb = 0; cb < kE / 32; ++cb) {
        const uint4 raw = *reinterpret_cast<const uint4*>(qfb + gid * e + cb * 32 + tig * 8);
        bq[cb][0] = raw.x;
        bq[cb][1] = raw.y;
        bq[cb][2] = raw.z;
        bq[cb][3] = raw.w;
      }
      for (int p0 = warp * 16; p0 < l; p0 += kWarps * 16) {
        const int r0 = p0 + gid, r1 = p0 + gid + 8;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int cb = 0; cb < kE / 32; ++cb) {
          const int col = cb * 32 + tig * 8;
          uint4 x0 = make_uint4(0, 0, 0, 0), x1 = make_uint4(0, 0, 0, 0);
          if (r0 < l) x0 = __ldg(reinterpret_cast<const uint4*>(m_row + static_cast<size_t>(r0) * e + col));
          if (r1 < l) x1 = __ldg(reinterpret_cast<const uint4*>(m_row + static_cast<size_t>(r1) * e + col));
          const uint32_t a0[4] = {x0.x, x1.x, x0.y, x1.y};
          const uint32_t b0[2] = {bq[cb][0], bq[cb][1]};
          mma16816(c, a0, b0);
          const uint32_t a1[4] = {x0.z, x1.z, x0.w, x1.w};
          const uint32_t b1[2] = {bq[cb][2], bq[cb][3]};
          mma16816(c, a1, b1);
        }
        const int h0 = tig * 2;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (h0 + t < h) {
            if (r0 < l) sc[(h0 + t) * l + r0] = mk_row[r0] ? c[t] : kNegInf;
            if (r1 < l) sc[(h0 + t) * l + r1] = mk_row[r1] ? c[2 + t] : kNegInf;
          }
        }
      }
    }
    __syncthreads();
    for (int hh = warp; hh < h; hh += kWarps) {
      float* srow = sc + hh * l;
      float mx = kNegInf;
      for (int s = lane; s < l; s += 32) mx = fmaxf(mx, srow[s]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int s = lane; s < l; s += 32) {
        const float p = expf(srow[s] - mx);
        srow[s] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      for (int s = lane; s < l; s += 32) srow[s] = round_bf16(srow[s] / sum * mem_any);
    }
    __syncthreads();
    {
      // context: each warp takes every 16th position, each lane 8 columns of
      // all heads; the 16 warps' partial sums then meet in a fixed tree
      float acc[kMaxHeads][8];
#pragma unroll
      for (int hh = 0; hh < kMaxHeads; ++hh)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[hh][q] = 0.f;
      const int c0 = lane * 8;
      // kCtxBatch rows of m are requested before any is used; masked
      // positions (p == 0 exactly) are not loaded and add nothing
      for (int pos0 = warp; pos0 < l; pos0 += kWarps * kCtxBatch) {
        uint4 raw[kCtxBatch];
#pragma unroll
        for (int u = 0; u < kCtxBatch; ++u) {
          const int pos = pos0 + u * kWarps;
          raw[u] = pos < l && mk_row[pos]
              ? __ldg(reinterpret_cast<const uint4*>(m_row + static_cast<size_t>(pos) * e + c0))
              : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kCtxBatch; ++u) {
          const int pos = pos0 + u * kWarps;
          if (pos >= l) break;
          float mv[8];
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 f2 = __bfloat1622float2(h2[q]);
            mv[2 * q] = f2.x;
            mv[2 * q + 1] = f2.y;
          }
#pragma unroll
          for (int hh = 0; hh < kMaxHeads; ++hh) {
            const float p = hh < h ? sc[hh * l + pos] : 0.f;
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[hh][q] = fmaf(p, mv[q], acc[hh][q]);
          }
        }
      }
      for (int width = kWarps / 2; width >= 1; width /= 2) {
        if (warp >= width && warp < 2 * width) {
          float* dst = rbuf + (warp - width) * kMaxHeads * e + c0;
#pragma unroll
          for (int hh = 0; hh < kMaxHeads; ++hh)
#pragma unroll
            for (int q = 0; q < 8; ++q) dst[hh * e + q] = acc[hh][q];
        }
        __syncthreads();
        if (warp < width) {
          const float* src = rbuf + warp * kMaxHeads * e + c0;
#pragma unroll
          for (int hh = 0; hh < kMaxHeads; ++hh)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[hh][q] += src[hh * e + q];
        }
        __syncthreads();
      }
      if (warp == 0)
#pragma unroll
        for (int hh = 0; hh < kMaxHeads; ++hh)
          if (hh < h)
#pragma unroll
            for (int q = 0; q < 8; ++q) vec[hh * e + c0 + q] = round_bf16(acc[hh][q]);
    }
    __syncthreads();
    {
      const bf16* bout = w.bout + layer * e;
      matvec(vec, he, w.wvo + static_cast<size_t>(layer) * he * e, e, part,
             [&](int j, float s) { xs[j] = round_bf16(xn[j] + round_bf16(s + bf(bout[j]))); });
    }

    // ---- FFN, residual around the normed stream ----
    layer_norm(xs, xn, w.ln3g + layer * e, w.ln3b + layer * e, red);
    {
      const bf16* b1 = w.b1 + layer * f;
      matvec(xn, e, w.w1 + static_cast<size_t>(layer) * e * f, f, part,
             [&](int j, float s) {
               const float z = s + bf(b1[j]);
               vec[j] = round_bf16(0.5f * z * (1.f + erff(z * 0.70710678118654752f)));
             });
    }
    {
      const bf16* b2 = w.b2 + layer * e;
      matvec(vec, f, w.w2 + static_cast<size_t>(layer) * f * e, e, part,
             [&](int j, float s) { xs[j] = round_bf16(xn[j] + round_bf16(s + bf(b2[j]))); });
    }
  }
  for (int j = threadIdx.x; j < e; j += kThreads)
    xout[static_cast<size_t>(b) * e + j] = __float2bfloat16(xs[j]);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (E = 256).
int stack_step_smem_bytes(int tmax, int l, int h, int f) {
  const int lt = l > tmax ? l : tmax;
  const int vec = kMaxHeads * kE > f ? kMaxHeads * kE : f;
  return 4 * (5 * kE + kMaxHeads * kE / 2 + vec + h * lt + 8 * kThreads
              + kWarps / 2 * kMaxHeads * kE + 32 + tmax);
}

// The widths the kernel takes: E = 256, at most 8 heads of a width that is
// a multiple of 8, an FFN width that is a multiple of 256.
int stack_step_supports(int e, int h, int f) {
  return e == kE && h >= 1 && h <= kMaxHeads && e % h == 0 && (e / h) % 8 == 0
      && f % 256 == 0;
}

// weights: kNumWeights device pointers in WEIGHT_KEYS order. Launches on
// `stream`; returns cudaGetLastError() (0 = launched).
int stack_step_bf16(const void* x, const void* t, void* caches, const void* m,
                    const void* mk, const void* hk, const void* const* weights,
                    void* xout, int b, int nl, int tmax, int e, int l, int h,
                    int f, float scale, void* stream) {
  if (!stack_step_supports(e, h, f)) return static_cast<int>(cudaErrorInvalidValue);
  StackWeights w;
  const bf16** dst = reinterpret_cast<const bf16**>(&w);
  for (int i = 0; i < kNumWeights; ++i) dst[i] = static_cast<const bf16*>(weights[i]);
  const int smem = stack_step_smem_bytes(tmax, l, h, f);
  cudaFuncSetAttribute(stack_step_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  stack_step_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(t),
      static_cast<bf16*>(caches), static_cast<const bf16*>(m),
      static_cast<const uint8_t*>(mk), static_cast<const uint8_t*>(hk), w,
      static_cast<bf16*>(xout), nl, tmax, l, h, f, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
