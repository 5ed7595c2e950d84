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
// What this design does about it: a row's stream, its scores (f32) and
// every intermediate vector stay in shared memory from the first layer to
// the last, and the raw memory replaces the four layers' projected cross
// K/V (8 [B, L, E] buffers the per-layer chain reads). Each row is run by a
// cluster of kC blocks (kC = 1 or 2, kernels/decoder_stack.stack_step_plan
// picks it): with kC = 2, B = 64 rows fill 128 of the card's 132 SMs where
// one block a row would leave half of them idle, and each block streams
// half of the row's memory and half of every weight matrix.
//   - Weight products (QKV, the out-projection, the folded queries aq, wvo,
//     the FFN): block `rank` computes output columns [rank n / kC, (rank +
//     1) n / kC) and stores each result into its own and its peer's copy of
//     the vector (distributed shared memory); a cluster barrier follows.
//     Each thread owns 8 consecutive columns (one 16-byte load a row, 16
//     rows in flight) and a slice of the rows; the slices' partial sums
//     meet in shared memory and are added in a fixed order.
//   - LayerNorm and the single-query self-attention over the history (at
//     most T positions) run whole in both blocks; block `rank` writes its
//     half of slot t's K|V into the cache.
//   - Cross-attention: block `rank` owns positions [rank lh, (rank + 1) lh)
//     of the row's memory. It takes their scores on the tensor cores
//     (mma.sync m16n8k16: 16 positions by the 8 heads), then the exact
//     per-head max and sum across the cluster (each block's value stored
//     into both, combined in rank order); probabilities are normalised and
//     rounded to bf16 at the TPU kernel's point. Each warp then takes a
//     slice of the block's positions with all heads (3 memory rows in
//     flight); the warps' f32 context partials meet in a fixed tree, the
//     blocks' in rank order. No online softmax and no atomics: two launches
//     give identical bits. Nine cluster barriers a layer.
// The block streams its positions of m twice a layer (scores, then
// context); the folded weights are shared by all rows and stay in the 50
// MB L2. The kernel takes E = 256 and at most 8 heads (the CaSE/Masque
// widths). In the layer loop, a line `// phase <name>` marks the end of
// each phase; chip_smoke.py builds a copy with a clock64 mark at each.

#include <cooperative_groups.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kE = 256;          // stream width the kernel takes
constexpr int kMaxHeads = 8;
constexpr int kBatch = 16;       // weight loads in flight per thread
constexpr int kCtxBatch = 3;     // memory rows in flight per warp (context)
constexpr float kLnEps = 1e-5f;
constexpr int kNumWeights = 18;

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

// Store v into this block's copy of *p and, in a cluster of two, into the
// peer's copy at the same shared-memory offset.
template <int kC, class T>
__device__ __forceinline__ void put(T* p, T v) {
  *p = v;
  if constexpr (kC > 1) {
    cg::cluster_group cl = cg::this_cluster();
    *cl.map_shared_rank(p, cl.block_rank() ^ 1) = v;
  }
}

// After it, every block of the cluster sees what the others stored.
template <int kC>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (kC > 1) cg::this_cluster().sync();
  else __syncthreads();
}

// epi(j, sum_i in[i] * W[i, j]) for every j in [n0, n0 + n); W [k, ldw]
// row-major bf16, n0 and n multiples of 8. Each thread owns 8 consecutive
// columns (one 16-byte load a row) and one of `ksplit` interleaved slices
// of the rows; the slices' partial sums meet in `part` and are added in a
// fixed order.
template <class Epi>
__device__ void matvec(const float* in, int k, const bf16* __restrict__ w,
                       int ldw, int n0, int n, float* part, Epi epi) {
  const int groups = n / 8;
  const int ksplit = groups >= kThreads ? 1 : kThreads / groups;
  for (int g0 = 0; g0 < groups; g0 += kThreads) {
    const int g = g0 + threadIdx.x % min(groups, kThreads);
    const int s = threadIdx.x / min(groups, kThreads);
    float acc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = 0.f;
    if (s < ksplit && g < groups) {
      const bf16* wp = w + n0 + g * 8;
      // kBatch 16-byte loads are issued before any is used, so enough
      // bytes are in flight to cover the latency of the weight stream
      for (int i0 = s; i0 < k; i0 += ksplit * kBatch) {
        uint4 raw[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * ksplit;
          raw[u] = i < k ? __ldg(reinterpret_cast<const uint4*>(wp + static_cast<size_t>(i) * ldw))
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
      epi(n0 + g0 * 8 + j, sum);
    }
    __syncthreads();
  }
}

// Positions of a row's memory each block of a cluster of kC owns.
__host__ __device__ __forceinline__ int span(int kc, int l) {
  return kc == 1 ? l : round_up((l + kc - 1) / kc, 16);
}

// Shared memory (f32 unless said): xs [E] stream, xn [E] normed stream,
// qkv [3E], qfb [8][E] bf16 folded queries, vec [max(8*E, F)],
// sc [H * max(lh, T)] scores/probs of the block's positions, part
// [8 * threads] matvec partial sums, rbuf [8 warps][8 heads][E] context
// partial sums, red [32], hks [T] history mask, xmax and xsum [2][8] the
// cluster's per-head max and sum, and with kC = 2 cpart [2][H * E] the
// blocks' context partials.
int smem_bytes(int kc, int tmax, int l, int h, int f) {
  const int lh = span(kc, l);
  const int lt = lh > tmax ? lh : tmax;
  const int vec = kMaxHeads * kE > f ? kMaxHeads * kE : f;
  return 4 * (5 * kE + kMaxHeads * kE / 2 + vec + h * lt + 8 * kThreads
              + kWarps / 2 * kMaxHeads * kE + 32 + 32 + tmax
              + (kc > 1 ? kc * h * kE : 0));
}

template <int kC>
__global__ void __launch_bounds__(kThreads)
stack_step_kernel(const bf16* __restrict__ x, const int* __restrict__ t,
                  bf16* caches, const bf16* __restrict__ m,
                  const uint8_t* __restrict__ mk,
                  const uint8_t* __restrict__ hk, StackWeights w,
                  bf16* __restrict__ xout, int nl, int tmax, int l, int h,
                  int f, float scale) {
  static_assert(kC == 1 || kC == 2, "a row runs on one block or two");
  extern __shared__ __align__(16) float sm[];
  constexpr int e = kE;
  const int b = blockIdx.x / kC;
  const int rank = kC > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int d = e / h;
  const int he = h * e;
  const int lh = span(kC, l);
  const int lt = lh > tmax ? lh : tmax;
  // the block's positions [rank lh, rank lh + np); their scores are rows
  // of np in sc
  const int np = kC == 1 ? l : max(0, min(l, (rank + 1) * lh) - rank * lh);
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
  float* xmax = hks + tmax;        // [2 blocks][8 heads]
  float* xsum = xmax + 16;         // [2 blocks][8 heads]
  float* cpart = xsum + 16;        // kC = 2: [2 blocks][H * E]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const uint8_t* mk_row = mk + static_cast<size_t>(b) * l;
  const bf16* m_blk = m + (static_cast<size_t>(b) * l + rank * lh) * e;
  const uint8_t* mk_blk = mk_row + rank * lh;
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
  // every block of the cluster runs before any stores into another's
  // shared memory
  cluster_sync<kC>();

  for (int layer = 0; layer < nl; ++layer) {
    // phase start
    // ---- self-attention over the KV cache ----
    layer_norm(xs, xn, w.ln1g + layer * e, w.ln1b + layer * e, red);
    // phase ln1
    {
      const bf16* bqkv = w.bqkv + layer * 3 * e;
      matvec(xn, e, w.wqkv + static_cast<size_t>(layer) * e * 3 * e, 3 * e,
             rank * 3 * e / kC, 3 * e / kC, part,
             [&](int j, float s) { put<kC>(qkv + j, round_bf16(s + bf(bqkv[j]))); });
    }
    cluster_sync<kC>();
    // phase qkv
    bf16* cache = caches + (static_cast<size_t>(b) * nl + layer) * tmax * 2 * e;
    if (write)
      for (int j = rank * 2 * e / kC + threadIdx.x; j < (rank + 1) * 2 * e / kC;
           j += kThreads)
        cache[static_cast<size_t>(tb) * 2 * e + j] = __float2bfloat16(qkv[e + j]);
    for (int j = threadIdx.x; j < e; j += kThreads) qkv[j] = round_bf16(qkv[j] * scale);
    __syncthreads();
    // a warp per head, a lane per slot (two slots at a time); every 16-byte
    // chunk of the slots' keys is requested before any is used (d is a
    // multiple of 32). Slot tb is read from shared memory (qkv[e:]), the
    // others from the cache.
    for (int hh = warp; hh < h; hh += kWarps) {
      float* srow = sc + hh * tmax;
      float mx = kNegInf;
      for (int s0 = lane; s0 < tmax; s0 += 64) {
        float v[2] = {0.f, 0.f};
        for (int c0 = hh * d; c0 < (hh + 1) * d; c0 += 32) {
          uint4 raw[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int s = s0 + 32 * u;
            const bool load = s < tmax && hks[s] != 0.f && !(write && s == tb);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              raw[u][q] = load ? __ldg(reinterpret_cast<const uint4*>(
                                     cache + static_cast<size_t>(s) * 2 * e + c0 + 8 * q))
                               : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const bool own = write && s0 + 32 * u == tb;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = c0 + 8 * q;
              const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw[u][q]);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float2 kv = __bfloat1622float2(h2[i]);
                v[u] = fmaf(qkv[c + 2 * i], own ? qkv[e + c + 2 * i] : kv.x, v[u]);
                v[u] = fmaf(qkv[c + 2 * i + 1], own ? qkv[e + c + 2 * i + 1] : kv.y, v[u]);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int s = s0 + 32 * u;
          if (s < tmax) {
            srow[s] = hks[s] != 0.f ? v[u] : kNegInf;
            mx = fmaxf(mx, srow[s]);
          }
        }
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
    {
      // P V over the history: thread (g, jp) sums slots g, g + 4, ... of
      // columns 2 jp and 2 jp + 1, 8 slots in flight; masked slots (p == 0
      // unless no slot is valid, and then hist_any == 0) are skipped. The 4
      // partials meet in `part` and are added in a fixed order.
      static_assert(kThreads == 4 * kE / 2, "4 slot groups of column pairs");
      const int j = 2 * (threadIdx.x % (e / 2)), g = threadIdx.x / (e / 2);
      const float* prow = sc + (j / d) * tmax;
      const bf16* vcol = cache + e + j;
      float a0 = 0.f, a1 = 0.f;
      for (int s0 = g; s0 < tmax; s0 += 4 * 8) {
        __nv_bfloat162 raw[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int s = s0 + 4 * u;
          raw[u] = s < tmax && hks[s] != 0.f && !(write && s == tb)
              ? *reinterpret_cast<const __nv_bfloat162*>(vcol + static_cast<size_t>(s) * 2 * e)
              : __floats2bfloat162_rn(0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int s = s0 + 4 * u;
          if (s < tmax && hks[s] != 0.f) {
            const float2 vv = write && s == tb ? make_float2(qkv[2 * e + j], qkv[2 * e + j + 1])
                                               : __bfloat1622float2(raw[u]);
            a0 = fmaf(prow[s], vv.x, a0);
            a1 = fmaf(prow[s], vv.y, a1);
          }
        }
      }
      part[g * e + j] = a0;
      part[g * e + j + 1] = a1;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < e; j += kThreads)
      vec[j] = round_bf16((((part[j] + part[e + j]) + part[2 * e + j]) + part[3 * e + j]) *
                          hist_any);
    __syncthreads();
    // phase self-attention
    {
      const bf16* bos = w.bos + layer * e;
      matvec(vec, e, w.wos + static_cast<size_t>(layer) * e * e, e,
             rank * e / kC, e / kC, part,
             [&](int j, float s) { put<kC>(xs + j, round_bf16(xn[j] + round_bf16(s + bf(bos[j])))); });
    }
    cluster_sync<kC>();
    // phase out-projection

    // ---- folded cross-attention against the raw memory ----
    layer_norm(xs, xn, w.ln2g + layer * e, w.ln2b + layer * e, red);
    // phase ln2
    {
      const bf16* u = w.u + static_cast<size_t>(layer) * he;
      matvec(xn, e, w.aq + static_cast<size_t>(layer) * e * he, he,
             rank * he / kC, he / kC, part,
             [&](int j, float s) { put<kC>(qfb + j, __float2bfloat16(s + bf(u[j]))); });
    }
    cluster_sync<kC>();
    // phase folded queries
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
      for (int p0 = warp * 16; p0 < np; p0 += kWarps * 16) {
        const int r0 = p0 + gid, r1 = p0 + gid + 8;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int cb = 0; cb < kE / 32; ++cb) {
          const int col = cb * 32 + tig * 8;
          uint4 x0 = make_uint4(0, 0, 0, 0), x1 = make_uint4(0, 0, 0, 0);
          if (r0 < np) x0 = __ldg(reinterpret_cast<const uint4*>(m_blk + static_cast<size_t>(r0) * e + col));
          if (r1 < np) x1 = __ldg(reinterpret_cast<const uint4*>(m_blk + static_cast<size_t>(r1) * e + col));
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
            if (r0 < np) sc[(h0 + t) * np + r0] = mk_blk[r0] ? c[t] : kNegInf;
            if (r1 < np) sc[(h0 + t) * np + r1] = mk_blk[r1] ? c[2 + t] : kNegInf;
          }
        }
      }
    }
    __syncthreads();
    // phase scores
    // the softmax over the row: each block's max and sum per head, combined
    // across the cluster in rank order
    for (int hh = warp; hh < h; hh += kWarps) {
      const float* srow = sc + hh * np;
      float mx = kNegInf;
      for (int s = lane; s < np; s += 32) mx = fmaxf(mx, srow[s]);
      mx = warp_max(mx);
      if (lane == 0) put<kC>(xmax + rank * kMaxHeads + hh, mx);
    }
    cluster_sync<kC>();
    // phase max
    for (int hh = warp; hh < h; hh += kWarps) {
      float* srow = sc + hh * np;
      float mx = xmax[hh];
      for (int k = 1; k < kC; ++k) mx = fmaxf(mx, xmax[k * kMaxHeads + hh]);
      float sum = 0.f;
      for (int s = lane; s < np; s += 32) {
        const float p = expf(srow[s] - mx);
        srow[s] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) put<kC>(xsum + rank * kMaxHeads + hh, sum);
    }
    cluster_sync<kC>();
    // phase sum
    for (int hh = warp; hh < h; hh += kWarps) {
      float* srow = sc + hh * np;
      float sum = xsum[hh];
      for (int k = 1; k < kC; ++k) sum += xsum[k * kMaxHeads + hh];
      for (int s = lane; s < np; s += 32) srow[s] = round_bf16(srow[s] / sum * mem_any);
    }
    __syncthreads();
    // phase probabilities
    {
      // context: each warp takes every 16th of the block's positions, each
      // lane 8 columns of all heads; the 16 warps' partial sums then meet
      // in a fixed tree, and the blocks' in rank order
      float acc[kMaxHeads][8];
#pragma unroll
      for (int hh = 0; hh < kMaxHeads; ++hh)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[hh][q] = 0.f;
      const int c0 = lane * 8;
      // kCtxBatch rows of m are requested before any is used; masked
      // positions (p == 0 exactly) are not loaded and add nothing
      for (int pos0 = warp; pos0 < np; pos0 += kWarps * kCtxBatch) {
        uint4 raw[kCtxBatch];
#pragma unroll
        for (int u = 0; u < kCtxBatch; ++u) {
          const int pos = pos0 + u * kWarps;
          raw[u] = pos < np && mk_blk[pos]
              ? __ldg(reinterpret_cast<const uint4*>(m_blk + static_cast<size_t>(pos) * e + c0))
              : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kCtxBatch; ++u) {
          const int pos = pos0 + u * kWarps;
          if (pos >= np) break;
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
            const float p = hh < h ? sc[hh * np + pos] : 0.f;
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[hh][q] = fmaf(p, mv[q], acc[hh][q]);
          }
        }
      }
      // (a warp's partials sit lane-minor in rbuf: no bank conflicts)
      for (int width = kWarps / 2; width >= 1; width /= 2) {
        if (warp >= width && warp < 2 * width) {
          float* dst = rbuf + (warp - width) * kMaxHeads * e + lane;
#pragma unroll
          for (int hh = 0; hh < kMaxHeads; ++hh)
#pragma unroll
            for (int q = 0; q < 8; ++q) dst[(hh * 8 + q) * 32] = acc[hh][q];
        }
        __syncthreads();
        if (warp < width) {
          const float* src = rbuf + warp * kMaxHeads * e + lane;
#pragma unroll
          for (int hh = 0; hh < kMaxHeads; ++hh)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[hh][q] += src[(hh * 8 + q) * 32];
        }
        __syncthreads();
      }
      if (warp == 0)
#pragma unroll
        for (int hh = 0; hh < kMaxHeads; ++hh)
          if (hh < h)
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              if constexpr (kC == 1) vec[hh * e + c0 + q] = round_bf16(acc[hh][q]);
              else put<kC>(cpart + rank * he + hh * e + c0 + q, acc[hh][q]);
            }
    }
    // phase context
    if constexpr (kC > 1) {
      cluster_sync<kC>();
      for (int j = threadIdx.x; j < he; j += kThreads) {
        float s = cpart[j];
        for (int k = 1; k < kC; ++k) s += cpart[k * he + j];
        vec[j] = round_bf16(s);
      }
    }
    __syncthreads();
    // phase context exchange
    {
      const bf16* bout = w.bout + layer * e;
      matvec(vec, he, w.wvo + static_cast<size_t>(layer) * he * e, e,
             rank * e / kC, e / kC, part,
             [&](int j, float s) { put<kC>(xs + j, round_bf16(xn[j] + round_bf16(s + bf(bout[j])))); });
    }
    cluster_sync<kC>();
    // phase wvo

    // ---- FFN, residual around the normed stream ----
    layer_norm(xs, xn, w.ln3g + layer * e, w.ln3b + layer * e, red);
    // phase ln3
    {
      const bf16* b1 = w.b1 + layer * f;
      matvec(xn, e, w.w1 + static_cast<size_t>(layer) * e * f, f,
             rank * f / kC, f / kC, part,
             [&](int j, float s) {
               const float z = s + bf(b1[j]);
               put<kC>(vec + j, round_bf16(0.5f * z * (1.f + erff(z * 0.70710678118654752f))));
             });
    }
    cluster_sync<kC>();
    // phase ffn 1
    {
      const bf16* b2 = w.b2 + layer * e;
      matvec(vec, f, w.w2 + static_cast<size_t>(layer) * f * e, e,
             rank * e / kC, e / kC, part,
             [&](int j, float s) { put<kC>(xs + j, round_bf16(xn[j] + round_bf16(s + bf(b2[j])))); });
    }
    cluster_sync<kC>();
    // phase ffn 2
  }
  for (int j = rank * e / kC + threadIdx.x; j < (rank + 1) * e / kC; j += kThreads)
    xout[static_cast<size_t>(b) * e + j] = __float2bfloat16(xs[j]);
}

template <int kC>
cudaError_t launch(int b, int smem, cudaStream_t stream, int* max_clusters,
                   const bf16* x, const int* t, bf16* caches, const bf16* m,
                   const uint8_t* mk, const uint8_t* hk, const StackWeights& w,
                   bf16* xout, int nl, int tmax, int l, int h, int f,
                   float scale) {
  auto kern = stack_step_kernel<kC>;
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kC * b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, kern, &cfg);
  return cudaLaunchKernelEx(&cfg, kern, x, t, caches, m, mk, hk, w, xout, nl,
                            tmax, l, h, f, scale);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (E = 256) where a row
// runs on a cluster of `cluster` blocks (1 or 2).
int stack_step_smem_bytes(int cluster, int tmax, int l, int h, int f) {
  return smem_bytes(cluster, tmax, l, h, f);
}

// The widths the kernel takes: E = 256, at most 8 heads of a width that is
// a multiple of 8, an FFN width that is a multiple of 256.
int stack_step_supports(int e, int h, int f) {
  return e == kE && h >= 1 && h <= kMaxHeads && e % h == 0 && (e / h) % 8 == 0
      && f % 256 == 0 && f > 0;
}

// One launch: a cluster of `cluster` blocks (1 or 2) a row. weights:
// kNumWeights device pointers in WEIGHT_KEYS order. With `max_clusters`
// non-null nothing is launched: it receives cudaOccupancyMaxActiveClusters
// for this launch (the clusters the card holds at once). Launches on
// `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
int stack_step_bf16(const void* x, const void* t, void* caches, const void* m,
                    const void* mk, const void* hk, const void* const* weights,
                    void* xout, int b, int nl, int tmax, int e, int l, int h,
                    int f, float scale, int cluster, void* stream,
                    int* max_clusters) {
  if (!stack_step_supports(e, h, f) || (cluster != 1 && cluster != 2) ||
      b < 1 || tmax < 1 || l < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(cluster, tmax, l, h, f);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  StackWeights w = {};
  const bf16** dst = reinterpret_cast<const bf16**>(&w);
  for (int i = 0; weights && i < kNumWeights; ++i)
    dst[i] = static_cast<const bf16*>(weights[i]);
  cudaError_t (*go)(int, int, cudaStream_t, int*, const bf16*, const int*,
                    bf16*, const bf16*, const uint8_t*, const uint8_t*,
                    const StackWeights&, bf16*, int, int, int, int, int,
                    float) = launch<2>;
  if (cluster == 1) go = launch<1>;
  const cudaError_t err = go(
      b, smem, static_cast<cudaStream_t>(stream), max_clusters,
      static_cast<const bf16*>(x), static_cast<const int*>(t),
      static_cast<bf16*>(caches), static_cast<const bf16*>(m),
      static_cast<const uint8_t*>(mk), static_cast<const uint8_t*>(hk), w,
      static_cast<bf16*>(xout), nl, tmax, l, h, f, scale);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
