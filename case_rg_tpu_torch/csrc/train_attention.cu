// Fused training attention with probs dropout, forward and backward, for
// Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernels of case_rg_tpu/kernels/train_attention.py,
// fused_train_mha (_fwd_kernel, _bwd_kernel) and fused_train_mha_rng
// (_fwd_kernel_rng, _bwd_kernel_rng). Each kernel here is templated on the
// mask source: kRng = false reads the caller's [R, H, Lq, Lk] bool mask,
// kRng = true draws it with Philox4x32-10 keyed by a 64-bit seed, from the
// counter (j / 4, i, h, r), word j % 4, kept when below `thresh` =
// round((1 - rate) * 2^32). The mask is a function of (row, head, query,
// key) alone, so the forward and both backward passes draw the same bits
// whatever their tiling, and kernels/train_attention.philox_keep_mask draws
// them in PyTorch.
//
// Function (the JAX kernels' rounding points):
//   qs = bf16(q * bf16(1/sqrt(d)));  s = qs . k in f32;  masked keys -1e20;
//   p = softmax(s) in f32;  pt = mask ? p * inv_keep : 0;  out = bf16(pt) . v
//   with f32 sums, rows whose keys are all padding give zeros;
//   backward: dv = bf16(pt)^T . do;  dp = mask ? (do . v^T) * inv_keep : 0;
//   ds = bf16(p * (dp - rowsum(dp * p)));  dq = ds . k * (1/sqrt(d) in f32);
//   dk = ds^T . qs;  all three zeroed on all-padding rows.
// The row term rowsum(dp * p) is taken exactly in f32 over every key, as the
// TPU kernel does (not as do . out, which would carry out's bf16 rounding).
// q/do [R, Lq, E], k/v [R, Lk, E] bf16 with head h on lanes [h*d, (h+1)*d);
// keep [R, Lk] bool or null. Head widths d = 32 and 160, Lq <= 128,
// Lk <= 4096.
//
// What bounds it on an H100. Bytes: q, k, v, keep, (mask), do in, out and
// dq/dk/dv out, 2 bytes an element for the tensors, against 3.35 TB/s.
// Operations: 4*R*H*Lq*Lk*d forward and 10*R*H*Lq*Lk*d backward against
// 989 TFLOP/s. At the CaSE shapes (L <= 100, or Lq = 40 over Lk = 1000, d =
// 32) that is 40-90 operations a byte, below the ~295 at which the tensor
// cores become the limit: bytes bound it. The caller-mask variant reads the
// mask (one byte per score) as well; the Philox variant does not, and pays
// in integer instructions instead.
//
// What this design does about it. Every q, k, v, do element is read from
// HBM once per pass with 16-byte loads into shared memory, and scores,
// probabilities and the mask never reach HBM in either direction (the TPU
// kernel's point). The softmax needs a whole key row and the backward a
// whole query column, which at Lk = 1000 do not fit a block's registers, so
// the keys are tiled (64 a tile in shared memory, 16 a step in registers):
//   forward, one block per (row, head), one warp per 16 queries: a first
//     sweep over the key tiles finds each query's max and sum, a second
//     recomputes the scores and accumulates bf16(pt) . v; the max and sum
//     are written for the backward (8 bytes a query);
//   backward pass 1, one block per (row, head): sweeps the key tiles for the
//     row term, then again for ds and dq (no atomics: dq is complete in the
//     block), and writes the row term (4 bytes a query);
//   backward pass 2, one block per (row, head, 64-key tile), one warp per 16
//     keys: the transposed products, over every query 16 at a time, give dk
//     and dv for its keys.
// All products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate); scores are recomputed (3 times in the backward) rather than
// stored, which costs operations the card has to spare at these shapes.
// The TPU kernels' lane-mask trick (contracting the full E axis with
// off-head lanes zeroed) is a TPU layout device and is not carried over:
// blocks tile per head. No TMA, wgmma or pipelining yet: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kKT = 64;              // keys per shared-memory tile
constexpr int kPad = 8;              // bf16 of padding per shared-memory row
constexpr int kMaxQ = 128;           // queries: 8 warps of 16
constexpr int kMaxK = 4096;
constexpr float kNegInf = -1e20f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Where the dropout mask of one (row, head) comes from.
struct MaskSrc {
  const uint8_t* mask;               // [Lq, Lk] of this (row, head), or null
  uint32_t k0, k1;                   // Philox key
  unsigned long long thresh;
  int r, h, lq, lk;
};

template <bool kRng>
__device__ __forceinline__ bool keep_elem(const MaskSrc& m, int i, int j) {
  if (i >= m.lq || j >= m.lk) return false;
  if constexpr (kRng) {
    const uint4 x = philox4x32_10(
        make_uint4(static_cast<uint32_t>(j >> 2), static_cast<uint32_t>(i),
                   static_cast<uint32_t>(m.h), static_cast<uint32_t>(m.r)),
        m.k0, m.k1);
    const int w = j & 3;
    const uint32_t u = w == 0 ? x.x : w == 1 ? x.y : w == 2 ? x.z : x.w;
    return static_cast<unsigned long long>(u) < m.thresh;
  } else {
    return m.mask[static_cast<size_t>(i) * m.lk + j] != 0;
  }
}

template <bool kRng>
__device__ __forceinline__ MaskSrc mask_src(const uint8_t* mask,
                                            const int64_t* seed,
                                            unsigned long long thresh, int r,
                                            int h, int nh, int lq, int lk) {
  MaskSrc m;
  m.mask = kRng ? nullptr
                : mask + (static_cast<size_t>(r) * nh + h) * lq * lk;
  m.k0 = kRng ? static_cast<uint32_t>(seed[0]) : 0u;
  m.k1 = kRng ? static_cast<uint32_t>(seed[1]) : 0u;
  m.thresh = thresh;
  m.r = r;
  m.h = h;
  m.lq = lq;
  m.lk = lk;
  return m;
}

// Stage rows [0, npad) of one head (kD lanes from `src`, row stride e) into
// shared memory: row-major `dst` [npad][ld] and, if `dst_t` is given, also
// transposed `dst_t` [kD][ldt]. Rows >= n are zero; `scale` != 0 multiplies
// and rounds to bf16 on the way in.
template <int kD>
__device__ void stage(bf16* dst, int ld, bf16* dst_t, int ldt,
                      const bf16* __restrict__ src, int n, int npad, int e,
                      float scale) {
  constexpr int c8 = kD / 8;
  for (int i = threadIdx.x; i < npad * c8; i += blockDim.x) {
    const int row = i / c8, c = (i % c8) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row < n) {
      raw = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row) * e + c));
      if (scale != 0.f) {
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = __bfloat1622float2(h2[t]);
          h2[t] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    if (dst) *reinterpret_cast<uint4*>(dst + row * ld + c) = raw;
    if (dst_t) {
      const bf16* vv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int t = 0; t < 8; ++t) dst_t[(c + t) * ldt + row] = vv[t];
    }
  }
}

// A fragments (16 rows from m0, all kD columns) of a row-major tile.
template <int kD>
__device__ __forceinline__ void load_a(uint32_t (&a)[kD / 16][4],
                                       const bf16* sm, int ld, int m0,
                                       int gid, int tig) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const bf16* p = sm + (m0 + gid) * ld + kk * 16 + tig * 2;
    a[kk][0] = lds32(p);
    a[kk][1] = lds32(p + 8 * ld);
    a[kk][2] = lds32(p + 8);
    a[kk][3] = lds32(p + 8 * ld + 8);
  }
}

// c[n] (n = 0, 1) = A . B^T for the 16 rows of `a` against rows
// [n0, n0 + 16) of the row-major tile `bsm` (contracting kD).
template <int kD>
__device__ __forceinline__ void products(float (&c)[2][4],
                                         const uint32_t (&a)[kD / 16][4],
                                         const bf16* bsm, int ld, int n0,
                                         int gid, int tig) {
#pragma unroll
  for (int n = 0; n < 2; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const bf16* bp = bsm + (n0 + n * 8 + gid) * ld + kk * 16 + tig * 2;
      const uint32_t b[2] = {lds32(bp), lds32(bp + 8)};
      mma16816(c[n], a[kk], b);
    }
  }
}

// acc[nt] += A . B for A = the 16 x 16 fragment `a` and B = columns
// [k0, k0 + 16) of the transposed tile `bt` [kD][ldt] (all kD outputs).
template <int kD>
__device__ __forceinline__ void accumulate(float (&acc)[kD / 8][4],
                                           const uint32_t (&a)[4],
                                           const bf16* bt, int ldt, int k0,
                                           int gid, int tig) {
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    const bf16* bp = bt + (nt * 8 + gid) * ldt + k0 + tig * 2;
    const uint32_t b[2] = {lds32(bp), lds32(bp + 8)};
    mma16816(acc[nt], a, b);
  }
}

__device__ __forceinline__ void frag_of(uint32_t (&a)[4],
                                        const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One 16-key step of backward pass 1, in place: s -> p (the forward's
// probabilities, from its max and sum) and dpt -> dp (dropped, scaled).
template <bool kRng>
__device__ __forceinline__ void probs_dp(float (&s)[2][4], float (&dpt)[2][4],
                                         int j0, const float* keep_s,
                                         const float (&rmax)[2],
                                         const float (&rsum)[2],
                                         const MaskSrc& ms, int i0, int tig,
                                         float inv_keep) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = j0 + n * 8 + tig * 2 + (x & 1), row = x >> 1;
      const float sv = keep_s[j] == 0.f ? kNegInf : s[n][x];
      s[n][x] = expf(sv - rmax[row]) / rsum[row];
      dpt[n][x] = keep_elem<kRng>(ms, i0 + 8 * row, j) ? dpt[n][x] * inv_keep
                                                       : 0.f;
    }
}

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// keep_s[j] = 1 for valid keys j < lk, 0 otherwise, for j < n; returns
// whether the row has any valid key (a block-wide vote).
__device__ float stage_keep(float* keep_s, int n, const uint8_t* keep_r,
                            int lk) {
  int any = 0;
  for (int j = threadIdx.x; j < lk; j += blockDim.x)
    any |= keep_r == nullptr || keep_r[j];
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    keep_s[j] = (j < lk && (keep_r == nullptr || keep_r[j])) ? 1.f : 0.f;
  return __syncthreads_or(any) ? 1.f : 0.f;
}

// ---- forward: one block per (row, head), 8 warps of 16 queries ----
// Shared memory: qs [mpad][kD+kPad], ks [kKT][kD+kPad], vt [kD][kKT+kPad]
// (bf16), keep [nall] (f32).
template <int kD, bool kRng>
__global__ void __launch_bounds__(256)
train_mha_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const uint8_t* __restrict__ keep,
              const uint8_t* __restrict__ mask,
              const int64_t* __restrict__ seed, bf16* __restrict__ out,
              float* __restrict__ stats, int lq, int lk, int e, int nh,
              float qscale, float inv_keep, unsigned long long thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x, h = blockIdx.y;
  const int mpad = round_up(lq, 16), nall = round_up(lk, kKT);
  const int ld = kD + kPad, ldt = kKT + kPad;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + mpad * ld;
  bf16* vt = ks + kKT * ld;
  float* keep_s = reinterpret_cast<float*>(vt + kD * ldt);

  stage<kD>(qs, ld, nullptr, 0, q + static_cast<size_t>(r) * lq * e + h * kD,
            lq, mpad, e, qscale);
  const float any_valid = stage_keep(
      keep_s, nall, keep ? keep + static_cast<size_t>(r) * lk : nullptr, lk);
  const MaskSrc ms = mask_src<kRng>(mask, seed, thresh, r, h, nh, lq, lk);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = warp * 16;
  const bool active = m0 < mpad;
  uint32_t qa[kD / 16][4];
  if (active) load_a<kD>(qa, qs, ld, m0, gid, tig);
  const bf16* kbase = k + static_cast<size_t>(r) * lk * e + h * kD;
  const bf16* vbase = v + static_cast<size_t>(r) * lk * e + h * kD;

  // sweep 1: each lane's running max and sum, merged across the quad
  float mx[2] = {kNegInf, kNegInf}, sm[2] = {0.f, 0.f};
  for (int t0 = 0; t0 < lk; t0 += kKT) {
    __syncthreads();
    stage<kD>(ks, ld, nullptr, 0, kbase + static_cast<size_t>(t0) * e,
              lk - t0, kKT, e, 0.f);
    __syncthreads();
    if (!active) continue;
    for (int c0 = 0; c0 < kKT && t0 + c0 < lk; c0 += 16) {
      float s[2][4];
      products<kD>(s, qa, ks, ld, c0, gid, tig);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int j = t0 + c0 + n * 8 + tig * 2 + (x & 1), row = x >> 1;
          const float sv = keep_s[j] == 0.f ? kNegInf : s[n][x];
          if (sv > mx[row]) {
            sm[row] = sm[row] * expf(mx[row] - sv) + 1.f;
            mx[row] = sv;
          } else {
            sm[row] += expf(sv - mx[row]);
          }
        }
    }
  }
  float rmax[2], rsum[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    rmax[row] = quad_max(mx[row]);
    rsum[row] = quad_sum(sm[row] * expf(mx[row] - rmax[row]));
  }
  if (active && tig == 0) {
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int i = m0 + gid + 8 * row;
      if (i < lq) {
        float* st = stats + ((static_cast<size_t>(r) * nh + h) * lq + i) * 2;
        st[0] = rmax[row];
        st[1] = rsum[row];
      }
    }
  }

  // sweep 2: probabilities, dropout, bf16(pt) . v
  float o[kD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  for (int t0 = 0; t0 < lk; t0 += kKT) {
    __syncthreads();
    stage<kD>(ks, ld, nullptr, 0, kbase + static_cast<size_t>(t0) * e,
              lk - t0, kKT, e, 0.f);
    stage<kD>(nullptr, 0, vt, ldt, vbase + static_cast<size_t>(t0) * e,
              lk - t0, kKT, e, 0.f);
    __syncthreads();
    if (!active) continue;
    for (int c0 = 0; c0 < kKT && t0 + c0 < lk; c0 += 16) {
      float s[2][4];
      products<kD>(s, qa, ks, ld, c0, gid, tig);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int j = t0 + c0 + n * 8 + tig * 2 + (x & 1), row = x >> 1;
          const float sv = keep_s[j] == 0.f ? kNegInf : s[n][x];
          const float p = expf(sv - rmax[row]) / rsum[row];
          s[n][x] = keep_elem<kRng>(ms, m0 + gid + 8 * row, j) ? p * inv_keep
                                                               : 0.f;
        }
      uint32_t a[4];
      frag_of(a, s);
      accumulate<kD>(o, a, vt, ldt, c0, gid, tig);
    }
  }
  if (!active) return;
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    const int col = h * kD + nt * 8 + tig * 2;
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int i = m0 + gid + 8 * row;
      if (i < lq)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (static_cast<size_t>(r) * lq + i) * e + col) =
            __floats2bfloat162_rn(o[nt][2 * row] * any_valid,
                                  o[nt][2 * row + 1] * any_valid);
    }
  }
}

// ---- backward pass 1: one block per (row, head); the row term and dq ----
// Shared memory: qs, dos [mpad][kD+kPad], ks, vs [kKT][kD+kPad],
// kt [kD][kKT+kPad] (bf16), keep [nall] (f32).
template <int kD, bool kRng>
__global__ void __launch_bounds__(256)
train_mha_bwd_rows(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v,
                   const uint8_t* __restrict__ keep,
                   const uint8_t* __restrict__ mask,
                   const int64_t* __restrict__ seed,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ stats,
                   float* __restrict__ rowterm, bf16* __restrict__ dq,
                   int lq, int lk, int e, int nh, float qscale,
                   float dqscale, float inv_keep, unsigned long long thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x, h = blockIdx.y;
  const int mpad = round_up(lq, 16), nall = round_up(lk, kKT);
  const int ld = kD + kPad, ldt = kKT + kPad;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + mpad * ld;
  bf16* ks = dos + mpad * ld;
  bf16* vs = ks + kKT * ld;
  bf16* kt = vs + kKT * ld;
  float* keep_s = reinterpret_cast<float*>(kt + kD * ldt);

  const size_t qoff = static_cast<size_t>(r) * lq * e + h * kD;
  stage<kD>(qs, ld, nullptr, 0, q + qoff, lq, mpad, e, qscale);
  stage<kD>(dos, ld, nullptr, 0, dout + qoff, lq, mpad, e, 0.f);
  const float any_valid = stage_keep(
      keep_s, nall, keep ? keep + static_cast<size_t>(r) * lk : nullptr, lk);
  const MaskSrc ms = mask_src<kRng>(mask, seed, thresh, r, h, nh, lq, lk);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = warp * 16;
  const bool active = m0 < mpad;
  uint32_t qa[kD / 16][4], da[kD / 16][4];
  float rmax[2] = {0.f, 0.f}, rsum[2] = {1.f, 1.f};
  if (active) {
    load_a<kD>(qa, qs, ld, m0, gid, tig);
    load_a<kD>(da, dos, ld, m0, gid, tig);
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int i = m0 + gid + 8 * row;
      if (i < lq) {
        const float* st =
            stats + ((static_cast<size_t>(r) * nh + h) * lq + i) * 2;
        rmax[row] = st[0];
        rsum[row] = st[1];
      }
    }
  }
  const bf16* kbase = k + static_cast<size_t>(r) * lk * e + h * kD;
  const bf16* vbase = v + static_cast<size_t>(r) * lk * e + h * kD;

  // sweep 1: the row term D = rowsum(dp * p), exactly in f32
  float dpart[2] = {0.f, 0.f};
  for (int t0 = 0; t0 < lk; t0 += kKT) {
    __syncthreads();
    stage<kD>(ks, ld, nullptr, 0, kbase + static_cast<size_t>(t0) * e,
              lk - t0, kKT, e, 0.f);
    stage<kD>(vs, ld, nullptr, 0, vbase + static_cast<size_t>(t0) * e,
              lk - t0, kKT, e, 0.f);
    __syncthreads();
    if (!active) continue;
    for (int c0 = 0; c0 < kKT && t0 + c0 < lk; c0 += 16) {
      float s[2][4], dp[2][4];
      products<kD>(s, qa, ks, ld, c0, gid, tig);
      products<kD>(dp, da, vs, ld, c0, gid, tig);
      probs_dp<kRng>(s, dp, t0 + c0, keep_s, rmax, rsum, ms, m0 + gid, tig,
                     inv_keep);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) dpart[x >> 1] += s[n][x] * dp[n][x];
    }
  }
  const float dterm[2] = {quad_sum(dpart[0]), quad_sum(dpart[1])};

  // sweep 2: ds = bf16(p * (dp - D)) and dq += ds . k
  float acc[kD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int t0 = 0; t0 < lk; t0 += kKT) {
    __syncthreads();
    stage<kD>(ks, ld, kt, ldt, kbase + static_cast<size_t>(t0) * e, lk - t0,
              kKT, e, 0.f);
    stage<kD>(vs, ld, nullptr, 0, vbase + static_cast<size_t>(t0) * e,
              lk - t0, kKT, e, 0.f);
    __syncthreads();
    if (!active) continue;
    for (int c0 = 0; c0 < kKT && t0 + c0 < lk; c0 += 16) {
      float s[2][4], dp[2][4];
      products<kD>(s, qa, ks, ld, c0, gid, tig);
      products<kD>(dp, da, vs, ld, c0, gid, tig);
      probs_dp<kRng>(s, dp, t0 + c0, keep_s, rmax, rsum, ms, m0 + gid, tig,
                     inv_keep);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          s[n][x] = s[n][x] * (dp[n][x] - dterm[x >> 1]);
      uint32_t a[4];
      frag_of(a, s);
      accumulate<kD>(acc, a, kt, ldt, c0, gid, tig);
    }
  }
  if (!active) return;
  const float f = dqscale * any_valid;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int i = m0 + gid + 8 * row;
    if (i >= lq) continue;
    if (tig == 0)
      rowterm[(static_cast<size_t>(r) * nh + h) * lq + i] = dterm[row];
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(
          dq + (static_cast<size_t>(r) * lq + i) * e + h * kD + nt * 8 +
          tig * 2) = __floats2bfloat162_rn(acc[nt][2 * row] * f,
                                           acc[nt][2 * row + 1] * f);
  }
}

// ---- backward pass 2: one block per (row, head, 64-key tile), 4 warps of
// 16 keys; dk and dv from the transposed products ----
// Shared memory: qs, dos [mpad][kD+kPad], qst, dost [kD][mpad+kPad],
// ks, vs [kKT][kD+kPad] (bf16); rmax, rsum, D [mpad], keep [kKT] (f32).
template <int kD, bool kRng>
__global__ void __launch_bounds__(128)
train_mha_bwd_keys(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v,
                   const uint8_t* __restrict__ keep,
                   const uint8_t* __restrict__ mask,
                   const int64_t* __restrict__ seed,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ stats,
                   const float* __restrict__ rowterm, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int lq, int lk, int e, int nh,
                   float qscale, float inv_keep, unsigned long long thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x, h = blockIdx.y, t0 = blockIdx.z * kKT;
  const int mpad = round_up(lq, 16);
  const int ld = kD + kPad, ldm = mpad + kPad;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + mpad * ld;
  bf16* qst = dos + mpad * ld;
  bf16* dost = qst + kD * ldm;
  bf16* ks = dost + kD * ldm;
  bf16* vs = ks + kKT * ld;
  float* rmax = reinterpret_cast<float*>(vs + kKT * ld);
  float* rsum = rmax + mpad;
  float* dterm = rsum + mpad;
  float* keep_s = dterm + mpad;

  const size_t qoff = static_cast<size_t>(r) * lq * e + h * kD;
  const size_t koff = (static_cast<size_t>(r) * lk + t0) * e + h * kD;
  stage<kD>(qs, ld, qst, ldm, q + qoff, lq, mpad, e, qscale);
  stage<kD>(dos, ld, dost, ldm, dout + qoff, lq, mpad, e, 0.f);
  stage<kD>(ks, ld, nullptr, 0, k + koff, lk - t0, kKT, e, 0.f);
  stage<kD>(vs, ld, nullptr, 0, v + koff, lk - t0, kKT, e, 0.f);
  const size_t rh = static_cast<size_t>(r) * nh + h;
  for (int i = threadIdx.x; i < mpad; i += blockDim.x) {
    const bool in = i < lq;
    rmax[i] = in ? stats[(rh * lq + i) * 2] : 0.f;
    rsum[i] = in ? stats[(rh * lq + i) * 2 + 1] : 1.f;
    dterm[i] = in ? rowterm[rh * lq + i] : 0.f;
  }
  const uint8_t* keep_r = keep ? keep + static_cast<size_t>(r) * lk : nullptr;
  int any = 0;
  for (int j = threadIdx.x; j < lk; j += blockDim.x)
    any |= keep_r == nullptr || keep_r[j];
  for (int j = threadIdx.x; j < kKT; j += blockDim.x)
    keep_s[j] = (t0 + j < lk && (keep_r == nullptr || keep_r[t0 + j]))
                    ? 1.f : 0.f;
  const float any_valid = __syncthreads_or(any) ? 1.f : 0.f;
  const MaskSrc ms = mask_src<kRng>(mask, seed, thresh, r, h, nh, lq, lk);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int kb = warp * 16;                  // this warp's keys in the tile
  if (t0 + kb >= lk) return;
  float gk[kD / 8][4], gv[kD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) gk[nt][x] = gv[nt][x] = 0.f;

  for (int i0 = 0; i0 < mpad; i0 += 16) {
    // transposed scores and dpt: rows = keys, columns = queries i0..i0+15
    float st[2][4], dpt[2][4];
    {
      uint32_t a[kD / 16][4];   // reloaded each step: registers are short
      load_a<kD>(a, ks, ld, kb, gid, tig);
      products<kD>(st, a, qs, ld, i0, gid, tig);
      load_a<kD>(a, vs, ld, kb, gid, tig);
      products<kD>(dpt, a, dos, ld, i0, gid, tig);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int jl = kb + gid + 8 * (x >> 1);
        const int i = i0 + n * 8 + tig * 2 + (x & 1);
        const float sv = keep_s[jl] == 0.f ? kNegInf : st[n][x];
        const float p = expf(sv - rmax[i]) / rsum[i];
        const bool kept = keep_elem<kRng>(ms, i, t0 + jl);
        const float dp = kept ? dpt[n][x] * inv_keep : 0.f;
        st[n][x] = kept ? p * inv_keep : 0.f;        // pt
        dpt[n][x] = p * (dp - dterm[i]);             // ds
      }
    uint32_t a[4];
    frag_of(a, st);
    accumulate<kD>(gv, a, dost, ldm, i0, gid, tig);
    frag_of(a, dpt);
    accumulate<kD>(gk, a, qst, ldm, i0, gid, tig);
  }
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int j = t0 + kb + gid + 8 * row;
    if (j >= lk) continue;
    const size_t off = (static_cast<size_t>(r) * lk + j) * e + h * kD;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      const int col = nt * 8 + tig * 2;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
          __floats2bfloat162_rn(gk[nt][2 * row] * any_valid,
                                gk[nt][2 * row + 1] * any_valid);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
          __floats2bfloat162_rn(gv[nt][2 * row] * any_valid,
                                gv[nt][2 * row + 1] * any_valid);
    }
  }
}

int smem_bytes(int which, int lq, int lk, int d) {
  const int mpad = round_up(lq, 16), nall = round_up(lk, kKT);
  const int ld = d + kPad, ldt = kKT + kPad, ldm = mpad + kPad;
  switch (which) {
    case 0:   // forward
      return 2 * (mpad * ld + kKT * ld + d * ldt) + 4 * nall;
    case 1:   // backward pass 1
      return 2 * (2 * mpad * ld + 2 * kKT * ld + d * ldt) + 4 * nall;
    default:  // backward pass 2
      return 2 * (2 * mpad * ld + 2 * d * ldm + 2 * kKT * ld) +
             4 * (3 * mpad + kKT);
  }
}

template <int kD, bool kRng>
int launch_fwd(const void* q, const void* k, const void* v, const void* keep,
               const void* mask, const void* seed, void* out, void* stats,
               int r, int lq, int lk, int e, int h, float qscale,
               float inv_keep, unsigned long long thresh,
               cudaStream_t stream) {
  const int smem = smem_bytes(0, lq, lk, kD);
  auto kern = train_mha_fwd<kD, kRng>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kern<<<dim3(r, h), 256, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(keep),
      static_cast<const uint8_t*>(mask), static_cast<const int64_t*>(seed),
      static_cast<bf16*>(out), static_cast<float*>(stats), lq, lk, e, h,
      qscale, inv_keep, thresh);
  return static_cast<int>(cudaGetLastError());
}

template <int kD, bool kRng>
int launch_bwd(const void* q, const void* k, const void* v, const void* keep,
               const void* mask, const void* seed, const void* dout,
               const void* stats, void* rowterm, void* dq, void* dk,
               void* dv, int r, int lq, int lk, int e, int h, float qscale,
               float dqscale, float inv_keep, unsigned long long thresh,
               cudaStream_t stream) {
  const int smem1 = smem_bytes(1, lq, lk, kD);
  auto rows = train_mha_bwd_rows<kD, kRng>;
  cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem1);
  rows<<<dim3(r, h), 256, smem1, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(keep),
      static_cast<const uint8_t*>(mask), static_cast<const int64_t*>(seed),
      static_cast<const bf16*>(dout), static_cast<const float*>(stats),
      static_cast<float*>(rowterm), static_cast<bf16*>(dq), lq, lk, e, h,
      qscale, dqscale, inv_keep, thresh);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const int smem2 = smem_bytes(2, lq, lk, kD);
  auto keys = train_mha_bwd_keys<kD, kRng>;
  cudaFuncSetAttribute(keys, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem2);
  keys<<<dim3(r, h, (lk + kKT - 1) / kKT), 128, smem2, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(keep),
      static_cast<const uint8_t*>(mask), static_cast<const int64_t*>(seed),
      static_cast<const bf16*>(dout), static_cast<const float*>(stats),
      static_cast<const float*>(rowterm), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), lq, lk, e, h, qscale, inv_keep, thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Whether the kernels take these shapes: d = 32 or 160, Lq <= 128,
// Lk <= 4096.
int train_mha_supports(int lq, int lk, int d) {
  return (d == 32 || d == 160) && lq >= 1 && lq <= kMaxQ && lk >= 1 &&
         lk <= kMaxK;
}

// Bytes of dynamic shared memory one block needs: which = 0 forward,
// 1 backward pass 1, 2 backward pass 2.
int train_mha_smem_bytes(int which, int lq, int lk, int d) {
  return smem_bytes(which, lq, lk, d);
}

// Forward. mask (rng = 0) or seed (rng = 1, two u32 words in int64 [2]);
// stats [R, H, Lq, 2] f32 receives each query's softmax max and sum.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int train_mha_fwd_bf16(const void* q, const void* k, const void* v,
                       const void* keep, const void* mask, const void* seed,
                       void* out, void* stats, int r, int lq, int lk, int e,
                       int h, float qscale, float inv_keep,
                       unsigned long long thresh, int rng, void* stream) {
  const int d = e / h;
  if (e % h || !train_mha_supports(lq, lk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32)
    return rng ? launch_fwd<32, true>(q, k, v, keep, mask, seed, out, stats,
                                      r, lq, lk, e, h, qscale, inv_keep,
                                      thresh, s)
               : launch_fwd<32, false>(q, k, v, keep, mask, seed, out, stats,
                                       r, lq, lk, e, h, qscale, inv_keep,
                                       thresh, s);
  return rng ? launch_fwd<160, true>(q, k, v, keep, mask, seed, out, stats, r,
                                     lq, lk, e, h, qscale, inv_keep, thresh,
                                     s)
             : launch_fwd<160, false>(q, k, v, keep, mask, seed, out, stats,
                                      r, lq, lk, e, h, qscale, inv_keep,
                                      thresh, s);
}

// Backward: pass 1 writes dq and the row term [R, H, Lq] f32 (scratch),
// pass 2 reads it and writes dk and dv. Returns cudaGetLastError().
int train_mha_bwd_bf16(const void* q, const void* k, const void* v,
                       const void* keep, const void* mask, const void* seed,
                       const void* dout, const void* stats, void* rowterm,
                       void* dq, void* dk, void* dv, int r, int lq, int lk,
                       int e, int h, float qscale, float dqscale,
                       float inv_keep, unsigned long long thresh, int rng,
                       void* stream) {
  const int d = e / h;
  if (e % h || !train_mha_supports(lq, lk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRAIN_MHA_BWD(D, RNG)                                                \
  launch_bwd<D, RNG>(q, k, v, keep, mask, seed, dout, stats, rowterm, dq,   \
                     dk, dv, r, lq, lk, e, h, qscale, dqscale, inv_keep,     \
                     thresh, s)
  if (d == 32) return rng ? TRAIN_MHA_BWD(32, true) : TRAIN_MHA_BWD(32, false);
  return rng ? TRAIN_MHA_BWD(160, true) : TRAIN_MHA_BWD(160, false);
#undef TRAIN_MHA_BWD
}

}  // extern "C"
