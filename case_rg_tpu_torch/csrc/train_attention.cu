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
// key) alone, so every kernel draws the same bits whatever its tiling, and
// kernels/train_attention.philox_keep_mask draws them in PyTorch.
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
// No online softmax: it would round unnormalised partial probabilities.
// q/do [R, Lq, E], k/v [R, Lk, E] bf16 with head h on lanes [h*d, (h+1)*d);
// keep [R, Lk] bool or null. Head widths d = 32 and 160, Lq <= 128,
// Lk <= 4096.
//
// What bounds it on an H100. Bytes: q, k, v, keep, (mask), do in, out and
// dq/dk/dv out, 2 bytes an element for the tensors, against 3.35 TB/s.
// Operations: 4*R*H*Lq*Lk*d forward and 10*R*H*Lq*Lk*d backward against
// 989 TFLOP/s. At the CaSE shapes that is 40-90 operations a byte, below the
// ~295 at which the tensor cores become the limit: bytes bound it, and what
// stands between a kernel and that bound is latency and repeated work
// (Philox draws, sweeps over the keys, staging), not tensor-core rate.
//
// What this design does about it. Every block works on one (row, head), or
// one key tile of it; q, k, v, do and the caller's mask reach shared memory
// by cp.async (16 bytes a thread, zero-filled past the end), and every
// mma.sync fragment is read by ldmatrix (.trans for the transposed
// operands), so nothing is transposed on the way in. Scores, probabilities
// and the mask never reach HBM. Philox runs once per (query, 4-key group):
// the two lanes that hold a group's keys each draw one of their two query
// rows and swap the words the other needs with one shuffle (keep_rows;
// every kernel draws in that layout). The host picks the path and the
// launch shape (kernels/train_attention.train_mha_plan) and passes it in:
//   short keys (Lk <= 128; kNT = 4, 7 or 8 16-key steps in registers):
//     forward, one block per (row, head), a warp per 16 queries: K and V
//       staged once, the warp's 16 x Lk scores in registers, the exact max
//       and sum, then bf16(pt) . v over 32 output columns at a time (at
//       d = 160 the caller's mask tile is staged where K was, once the
//       scores are taken, so that two blocks fit an SM);
//     backward, one launch, one block per (row, head): each warp computes
//       its queries' scores, p, the keep bits, the row term and ds once
//       (do . v^T twice: held in registers, it would cost the second block
//       an SM holds), puts bf16(pt) and bf16(ds) in shared memory and
//       writes dq; then the block's warps share out (16 keys, 32 columns)
//       units of dk = ds^T . qs and dv = pt^T . do. No scratch in HBM, no
//       atomics.
//   long keys (Lk > 128, or a short backward that does not fit shared
//     memory): the keys are tiled by 64 and double buffered (cp.async);
//     forward, one block per (row, head): ceil(Lq/16) query warps times
//       `wk` key warps (wk > 1 at Lq <= 64), which take every wk-th 16-key
//       step and merge their max, sum and f32 PV partials through shared
//       memory in a fixed order; an exact max-and-sum sweep, then the PV
//       sweep;
//     backward pass 1 (bwd_rows), one block per (row, head), a warp per 16
//       queries: a sweep for the row term that keeps each element's keep
//       bit in shared memory, then a sweep for ds and dq;
//     backward pass 2: the short backward's kernel over key tiles, with
//       the row term read back and no dq.
// Head width 160: no operand is held whole in registers (A fragments are
// re-read by ldmatrix, outputs go 32 columns at a time), so no instance
// spills. The TPU kernels' lane-mask trick (contracting the full E axis with
// off-head lanes zeroed) is a TPU layout device and is not carried over.

#include "sm90.cuh"

namespace {

constexpr int kMaxQ = 128;
constexpr int kMaxK = 4096;
constexpr int kShortK = 128;         // keys a short-path block holds
constexpr int kKT = 64;              // keys per tile of the long path
constexpr int kMaxWarps = 8;

enum Kind { kFwdShort = 0, kFwdLong = 1, kBwdShort = 2, kBwdRows = 3,
            kBwdKeys = 4 };

// Wait until at most n (0 or 1) of this thread's cp.async groups pend.
__device__ __forceinline__ void cp_wait_n(int n) {
  if (n <= 0)
    cp_wait<0>();
  else
    cp_wait<1>();
}


// keep_s[j] = 1 for valid keys t0 + j < lk, 0 otherwise, for j < n;
// returns whether this thread saw a valid key of the row (the caller's
// __syncthreads_or makes it the block's vote, after its cp.async waits, so
// these loads overlap the copies).
__device__ int stage_keep(uint8_t* keep_s, int n, int t0,
                          const uint8_t* keep_r, int lk) {
  int any = 0;
  for (int j = threadIdx.x; j < lk; j += blockDim.x)
    any |= keep_r == nullptr || keep_r[j];
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    keep_s[j] = t0 + j < lk && (keep_r == nullptr || keep_r[t0 + j]);
  return any;
}

// The caller's mask, one tile: rows i < nrow of n bytes from g + i * lk,
// staged at shared `s` with row pitch `pitch` (a multiple of 16, >= n + 16).
// Each row keeps the 16-byte phase of its global address, so whole aligned
// chunks go by cp.async and only a row's ragged ends byte by byte.
struct MaskTile {
  const uint8_t* s;
  const uint8_t* g;
  int pitch, lk, j0;                 // j0: the tile's first key
  __device__ __forceinline__ bool at(int i, int j) const {
    const uintptr_t a = reinterpret_cast<uintptr_t>(g + static_cast<size_t>(i) * lk);
    return s[i * pitch + (a & 15) + (j - j0)] != 0;
  }
};

__device__ void stage_mask(uint8_t* s, int pitch, const uint8_t* g, int lk,
                           int nrow, int n) {
  const int nch = (n + 30) / 16;     // 16-byte chunks a row can touch
  for (int t = threadIdx.x; t < nrow * nch; t += blockDim.x) {
    const int row = t / nch, ch = t % nch;
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(g + static_cast<size_t>(row) * lk);
    const uintptr_t c0 = (a & ~static_cast<uintptr_t>(15)) + 16 * ch;
    if (c0 >= a + n) continue;
    uint8_t* d = s + row * pitch + 16 * ch;
    if (c0 >= a && c0 + 16 <= a + n) {
      cp_async16(d, reinterpret_cast<const void*>(c0), 16);
    } else {
      for (int b = 0; b < 16; ++b)
        if (c0 + b >= a && c0 + b < a + n)
          d[b] = *reinterpret_cast<const uint8_t*>(c0 + b);
    }
  }
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
  uint32_t k0, k1;                   // Philox key
  unsigned long long thresh;
  int r, h;
  MaskTile tile;                     // the caller's mask (kRng = false)
};

// The four keep bits of Philox group `grp` (keys 4 grp .. 4 grp + 3) of
// query i: bit w = word w below thresh.
__device__ __forceinline__ uint32_t draw4(const MaskSrc& m, int grp, int i) {
  const uint4 x = philox4x32_10(
      make_uint4(static_cast<uint32_t>(grp), static_cast<uint32_t>(i),
                 static_cast<uint32_t>(m.h), static_cast<uint32_t>(m.r)),
      m.k0, m.k1);
  return (x.x < m.thresh) | (x.y < m.thresh) << 1 | (x.z < m.thresh) << 2 |
         (x.w < m.thresh) << 3;
}

// Keep bits of one 16 x 16 step in the accumulator layout with rows =
// queries i0.., columns = keys j0.. (j0 a multiple of 8): bit 4n + x is
// element c[n][x] of this lane (row gid + 8 (x >> 1), key j0 + 8n + 2 tig +
// (x & 1)). Lanes tig and tig ^ 1 hold the same 4-key group; the even lane
// draws it for row gid, the odd lane for row gid + 8, and one shuffle swaps
// the two words each needs. Called by the whole warp.
template <bool kRng>
__device__ __forceinline__ uint32_t keep_rows(const MaskSrc& m, int i0,
                                              int j0, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  if constexpr (kRng) {
    const int odd = tig & 1;
    uint32_t mine = 0;
#pragma unroll
    for (int n = 0; n < 2; ++n)
      mine |= draw4(m, (j0 + 8 * n) / 4 + (tig >> 1), i0 + gid + 8 * odd)
              << (4 * n);
    const uint32_t send = odd ? mine & 0x33u : (mine >> 2) & 0x33u;
    const uint32_t recv = __shfl_xor_sync(0xffffffffu, send, 1);
    uint32_t bits = 0;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const uint32_t lo = ((odd ? recv : mine) >> (4 * n)) & 3u;
      const uint32_t hi = (odd ? mine >> (4 * n + 2) : recv >> (4 * n)) & 3u;
      bits |= (lo | hi << 2) << (4 * n);
    }
    return bits;
  } else {
    uint32_t bits = 0;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int n = x >> 2, row = (x >> 1) & 1;
      bits |= static_cast<uint32_t>(m.tile.at(
                  i0 + gid + 8 * row, j0 + 8 * n + 2 * tig + (x & 1)))
              << x;
    }
    return bits;
  }
}

// s[n] = A . B^T for 16 rows from m0 of the row-major tile `as` against
// keys n0 .. n0 + 15 of the row-major tile `bs`, contracting kD.
template <int kD>
__device__ __forceinline__ void scores16(float (&s)[2][4], const bf16* as,
                                         int m0, const bf16* bs, int n0,
                                         int lane) {
  constexpr int ld = kD + kPad;
#pragma unroll
  for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[4], b[4];
    ldsm4(a, a_ptr(as, ld, m0, kk * 16, lane));
    ldsm4(b, bt_ptr(bs, ld, n0, kk * 16, lane));
    mma16816(s[0], a, b);
    mma16816(s[1], a, b + 2);
  }
}


// What every kernel is given; `out` is the forward's output or dq.
struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const uint8_t* keep;               // [R, Lk] or null
  const uint8_t* mask;               // [R, H, Lq, Lk] (kRng = false)
  const int64_t* seed;               // [2] (kRng = true)
  float* stats;                      // [R, H, Lq, 2]: softmax max and sum
  float* rowterm;                    // [R, H, Lq] (long backward only)
  bf16* out;
  bf16* dk;
  bf16* dv;
  int lq, lk, e, nh, wk, nbuf;
  float qscale, dqscale, inv_keep;
  unsigned long long thresh;
};

template <bool kRng>
__device__ __forceinline__ MaskSrc mask_src(const Args& a, int r, int h) {
  MaskSrc m;
  m.k0 = kRng ? static_cast<uint32_t>(a.seed[0]) : 0u;
  m.k1 = kRng ? static_cast<uint32_t>(a.seed[1]) : 0u;
  m.thresh = a.thresh;
  m.r = r;
  m.h = h;
  m.tile = MaskTile{nullptr, nullptr, 0, a.lk, 0};
  return m;
}

__device__ __forceinline__ const uint8_t* mask_of(const Args& a, int r,
                                                  int h) {
  return a.mask + (static_cast<size_t>(r) * a.nh + h) * a.lq * a.lk;
}

// ---- forward, short keys: one block per (row, head), a warp per 16
// queries, kNT 16-key steps (kNT * 16 >= Lk) in registers ----
// Shared memory: qs [mpad][ld], ks, vs [nk][ld] (bf16), keep [nk],
// mask [mpad][nk + 16] (u8, kRng = false).
template <int kD, int kNT, bool kRng>
__global__ void __launch_bounds__(256, kD == 32 && kNT <= 7 ? 3 : 2)
    fwd_short(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = kD + kPad, nk = kNT * 16;
  const int r = blockIdx.x, h = blockIdx.y, lq = a.lq, lk = a.lk, e = a.e;
  const int mpad = round_up(lq, 16);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + mpad * ld;
  bf16* vs = ks + nk * ld;
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(vs + nk * ld);
  uint8_t* mask_s = keep_s + nk;

  const size_t qoff = static_cast<size_t>(r) * lq * e + h * kD;
  const size_t koff = static_cast<size_t>(r) * lk * e + h * kD;
  stage_async<kD>(qs, a.q + qoff, lq, mpad, e);
  cp_commit();
  stage_async<kD>(ks, a.k + koff, lk, nk, e);
  stage_async<kD>(vs, a.v + koff, lk, nk, e);
  // The caller's mask: staged with K and V, or at d = 160 (where shared
  // memory is short) into K's place once the scores are taken.
  constexpr bool kLateMask = !kRng && kD == 160;
  MaskSrc ms = mask_src<kRng>(a, r, h);
  if constexpr (!kRng) {
    ms.tile = MaskTile{kLateMask ? reinterpret_cast<uint8_t*>(ks) : mask_s,
                       mask_of(a, r, h), nk + 16, lk, 0};
    if (!kLateMask) stage_mask(mask_s, nk + 16, ms.tile.g, lk, lq, lk);
  }
  cp_commit();
  const int any = stage_keep(
      keep_s, nk, 0, a.keep ? a.keep + static_cast<size_t>(r) * lk : nullptr,
      lk);
  cp_wait<1>();
  scale_rows<kD>(qs, mpad, a.qscale);
  cp_wait<0>();
  const float av = __syncthreads_or(any) ? 1.f : 0.f;

  const int lane = threadIdx.x & 31, tig = lane & 3, gid = lane >> 2;
  const int m0 = (threadIdx.x >> 5) * 16, nkt = (lk + 15) >> 4;
  float s[kNT][2][4];
#pragma unroll
  for (int kt = 0; kt < kNT; ++kt) zero(s[kt]);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t qa[4];
    ldsm4(qa, a_ptr(qs, ld, m0, kk * 16, lane));
#pragma unroll
    for (int kt = 0; kt < kNT; ++kt)
      if (kt < nkt) {
        uint32_t b[4];
        ldsm4(b, bt_ptr(ks, ld, kt * 16, kk * 16, lane));
        mma16816(s[kt][0], qa, b);
        mma16816(s[kt][1], qa, b + 2);
      }
  }
  if constexpr (kLateMask) {
    __syncthreads();
    stage_mask(reinterpret_cast<uint8_t*>(ks), nk + 16, ms.tile.g, lk, lq,
               lk);
    cp_commit();
  }
  // the exact max and sum of each query's row
  float mx[2] = {kNegInf, kNegInf}, sm[2] = {0.f, 0.f};
#pragma unroll
  for (int kt = 0; kt < kNT; ++kt)
    if (kt < nkt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          if (!keep_s[kt * 16 + n * 8 + tig * 2 + (x & 1)])
            s[kt][n][x] = kNegInf;
          mx[x >> 1] = fmaxf(mx[x >> 1], s[kt][n][x]);
        }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
#pragma unroll
  for (int kt = 0; kt < kNT; ++kt)
    if (kt < nkt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          s[kt][n][x] = expf(s[kt][n][x] - mx[x >> 1]);
          sm[x >> 1] += s[kt][n][x];
        }
  sm[0] = quad_sum(sm[0]);
  sm[1] = quad_sum(sm[1]);
  const float rinv[2] = {1.f / sm[0], 1.f / sm[1]};
  const size_t rh = static_cast<size_t>(r) * a.nh + h;
  if (tig == 0)
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int i = m0 + gid + 8 * row;
      if (i < lq) {
        a.stats[(rh * lq + i) * 2] = mx[row];
        a.stats[(rh * lq + i) * 2 + 1] = sm[row];
      }
    }
  if constexpr (kLateMask) {
    cp_wait<0>();
    __syncthreads();
  }
  // probabilities, dropout, bf16(pt) as A fragments
  uint32_t pa[kNT][4];
#pragma unroll
  for (int kt = 0; kt < kNT; ++kt)
    if (kt < nkt) {
      const uint32_t bits = keep_rows<kRng>(ms, m0, kt * 16, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          s[kt][n][x] = (bits >> (4 * n + x)) & 1u
                            ? s[kt][n][x] * rinv[x >> 1] * a.inv_keep
                            : 0.f;
      frag_of(pa[kt], s[kt]);
    }
  // out = bf16(pt) . v, 32 columns at a time
  bf16* out = a.out + static_cast<size_t>(r) * lq * e + h * kD;
#pragma unroll
  for (int c0 = 0; c0 < kD; c0 += 32) {
    float o[4][4];
    zero(o);
#pragma unroll
    for (int kt = 0; kt < kNT; ++kt)
      if (kt < nkt)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          uint32_t b[4];
          ldsm4t(b, b_ptr(vs, ld, kt * 16, c0 + nn * 16, lane));
          mma16816(o[2 * nn], pa[kt], b);
          mma16816(o[2 * nn + 1], pa[kt], b + 2);
        }
    store_rows<4>(out, e, m0, c0, lq, o, av, lane);
  }
}

// The long path's key tiles: tile t (kKT keys) of K, and of V and the
// caller's mask when asked, into buffer t % nbuf, as one cp.async group.
template <int kD, bool kRng>
struct Tiles {
  bf16* kv;                          // [nbuf][2][kKT][ld]
  uint8_t* mask_s;                   // [nbuf][mpad][kKT + 16]
  const bf16* k;                     // this (row, head)'s first key
  const bf16* v;
  const uint8_t* mask;               // this (row, head)'s [Lq, Lk] mask
  int lq, lk, e, mpad, nbuf;
  static constexpr int ld = kD + kPad, mpitch = kKT + 16;
  __device__ void start(int t, bool with_v, bool with_mask) const {
    const int b = t % nbuf, t0 = t * kKT, n = min(kKT, lk - t0);
    stage_async<kD>(kbuf(t), k + static_cast<size_t>(t0) * e, n, kKT, e);
    if (with_v)
      stage_async<kD>(vbuf(t), v + static_cast<size_t>(t0) * e, n, kKT, e);
    if (!kRng && with_mask)
      stage_mask(mask_s + b * mpad * mpitch, mpitch, mask + t0, lk, lq, n);
    cp_commit();
  }
  __device__ bf16* kbuf(int t) const { return kv + (t % nbuf) * 2 * kKT * ld; }
  __device__ bf16* vbuf(int t) const { return kbuf(t) + kKT * ld; }
  __device__ MaskTile tile(int t) const {
    return MaskTile{mask_s + (t % nbuf) * mpad * mpitch, mask + t * kKT,
                    mpitch, lk, t * kKT};
  }
  // Tiles 0 .. nbuf - 2 in flight before the first before(); returns how
  // many cp.async groups that started.
  __device__ int prologue(int nt, bool with_v, bool with_mask) const {
    const int n = min(nbuf - 1, nt);
    for (int t = 0; t < n; ++t) start(t, with_v, with_mask);
    return n;
  }
  // Before computing tile t: start tile t + nbuf - 1 (into the buffer tile
  // t - 1 freed) and wait for tile t.
  __device__ void before(int t, int nt, bool with_v, bool with_mask) const {
    if (t + nbuf - 1 < nt) start(t + nbuf - 1, with_v, with_mask);
    cp_wait_n(min(nbuf - 1, nt - 1 - t));
    __syncthreads();
  }
  // After computing tile t: its buffer is free.
  __device__ void after() const { __syncthreads(); }
};

// Merge of the key warps' f32 partials (kN x 4 a lane) into key warp 0, in
// the order of the key warps: through `part`, [(wk - 1) * wq][kN * 4][32].
template <int kN>
__device__ void merge_partials(float (&c)[kN][4], float* part, int qg,
                               int kw, int wq, int wk, int lane) {
  if (kw > 0) {
    float* p = part + ((kw - 1) * wq + qg) * kN * 4 * 32;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) p[(n * 4 + x) * 32 + lane] = c[n][x];
  }
  __syncthreads();
  if (kw == 0)
    for (int w = 1; w < wk; ++w) {
      const float* p = part + ((w - 1) * wq + qg) * kN * 4 * 32;
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) c[n][x] += p[(n * 4 + x) * 32 + lane];
    }
}

// ---- forward, long keys: one block per (row, head), wq query warps times
// wk key warps; tiles of kKT keys, nbuf buffers ----
// Shared memory: qs [mpad][ld] (bf16), keep [nall] (u8), red [2][wk][mpad]
// (f32), mask [nbuf][mpad][kKT + 16] (u8, kRng = false), then the tiles
// [nbuf][2][kKT][ld] (bf16), reused for the merge [(wk-1) wq][16 kD] (f32).
template <int kD, bool kRng>
__global__ void __launch_bounds__(256, kD == 32 ? 3 : 1)
    fwd_long(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = kD + kPad;
  const int r = blockIdx.x, h = blockIdx.y, lq = a.lq, lk = a.lk, e = a.e;
  const int mpad = round_up(lq, 16), wq = mpad / 16, wk = a.wk;
  const int nt = (lk + kKT - 1) / kKT, nall = nt * kKT;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(qs + mpad * ld);
  float* red = reinterpret_cast<float*>(keep_s + nall);
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(red + 2 * wk * mpad);
  bf16* kv = reinterpret_cast<bf16*>(
      mask_s + (kRng ? 0 : a.nbuf * mpad * (kKT + 16)));

  const size_t qoff = static_cast<size_t>(r) * lq * e + h * kD;
  const size_t koff = static_cast<size_t>(r) * lk * e + h * kD;
  const Tiles<kD, kRng> tl{kv, mask_s, a.k + koff, a.v + koff,
                           kRng ? nullptr : mask_of(a, r, h), lq, lk, e,
                           mpad, a.nbuf};
  stage_async<kD>(qs, a.q + qoff, lq, mpad, e);
  cp_commit();
  const int ahead = tl.prologue(nt, false, false);
  const int any = stage_keep(
      keep_s, nall, 0,
      a.keep ? a.keep + static_cast<size_t>(r) * lk : nullptr, lk);
  cp_wait_n(ahead);
  scale_rows<kD>(qs, mpad, a.qscale);
  const float av = __syncthreads_or(any) ? 1.f : 0.f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tig = lane & 3, gid = lane >> 2;
  const int qg = warp % wq, kw = warp / wq, m0 = qg * 16;
  // sweep 1: each lane's running max and sum over its keys
  float mx[2] = {kNegInf, kNegInf}, sm[2] = {0.f, 0.f};
  for (int t = 0; t < nt; ++t) {
    tl.before(t, nt, false, false);
    for (int c = kw; c < kKT / 16 && t * kKT + c * 16 < lk; c += wk) {
      float s[2][4];
      scores16<kD>(s, qs, m0, tl.kbuf(t), c * 16, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int row = x >> 1;
          const float sv = keep_s[t * kKT + c * 16 + n * 8 + tig * 2 + (x & 1)]
                               ? s[n][x] : kNegInf;
          if (sv > mx[row]) {
            sm[row] = sm[row] * expf(mx[row] - sv) + 1.f;
            mx[row] = sv;
          } else {
            sm[row] += expf(sv - mx[row]);
          }
        }
    }
    tl.after();
  }
  // merge: the quad, then the key warps in order
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const float m = quad_max(mx[row]);
    sm[row] = quad_sum(sm[row] * expf(mx[row] - m));
    mx[row] = m;
    if (tig == 0) {
      red[kw * mpad + m0 + gid + 8 * row] = mx[row];
      red[(wk + kw) * mpad + m0 + gid + 8 * row] = sm[row];
    }
  }
  tl.prologue(nt, true, true);
  __syncthreads();
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int i = m0 + gid + 8 * row;
    float m = kNegInf, l = 0.f;
    for (int w = 0; w < wk; ++w) m = fmaxf(m, red[w * mpad + i]);
    for (int w = 0; w < wk; ++w)
      l += red[(wk + w) * mpad + i] * expf(red[w * mpad + i] - m);
    mx[row] = m;
    sm[row] = 1.f / l;
    if (kw == 0 && tig == 0 && i < lq) {
      const size_t rh = static_cast<size_t>(r) * a.nh + h;
      a.stats[(rh * lq + i) * 2] = m;
      a.stats[(rh * lq + i) * 2 + 1] = l;
    }
  }
  // sweep 2: probabilities, dropout, bf16(pt) . v (sm: 1 / sum)
  MaskSrc ms = mask_src<kRng>(a, r, h);
  float o[kD / 8][4];
  zero(o);
  for (int t = 0; t < nt; ++t) {
    tl.before(t, nt, true, true);
    if constexpr (!kRng) ms.tile = tl.tile(t);
    for (int c = kw; c < kKT / 16 && t * kKT + c * 16 < lk; c += wk) {
      const int j0 = t * kKT + c * 16;
      float s[2][4];
      scores16<kD>(s, qs, m0, tl.kbuf(t), c * 16, lane);
      const uint32_t bits = keep_rows<kRng>(ms, m0, j0, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int row = x >> 1;
          const float sv =
              keep_s[j0 + n * 8 + tig * 2 + (x & 1)] ? s[n][x] : kNegInf;
          s[n][x] = (bits >> (4 * n + x)) & 1u
                        ? expf(sv - mx[row]) * sm[row] * a.inv_keep
                        : 0.f;
        }
      uint32_t pa[4];
      frag_of(pa, s);
#pragma unroll
      for (int nn = 0; nn < kD / 16; ++nn) {
        uint32_t b[4];
        ldsm4t(b, b_ptr(tl.vbuf(t), ld, c * 16, nn * 16, lane));
        mma16816(o[2 * nn], pa, b);
        mma16816(o[2 * nn + 1], pa, b + 2);
      }
    }
    tl.after();
  }
  merge_partials<kD / 8>(o, reinterpret_cast<float*>(kv), qg, kw, wq, wk,
                         lane);
  if (kw == 0)
    store_rows<kD / 8>(a.out + qoff, e, m0, 0, lq, o, av, lane);
}

// One 16-key step of the backward, in place: s -> p (the forward's
// probabilities, from its max and 1 / sum; 0 on rows past Lq) and dpt -> dp
// (dropped with the keep `bits`, scaled).
__device__ __forceinline__ void probs_dp(float (&s)[2][4], float (&dpt)[2][4],
                                         const uint8_t* keep_s, uint32_t bits,
                                         const float (&rmax)[2],
                                         const float (&rinv)[2], bool live0,
                                         bool live1, float inv_keep,
                                         int lane) {
  const int tig = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = x >> 1;
      const float sv = keep_s[n * 8 + tig * 2 + (x & 1)] ? s[n][x] : kNegInf;
      s[n][x] = (row ? live1 : live0) ? expf(sv - rmax[row]) * rinv[row]
                                      : 0.f;
      dpt[n][x] = (bits >> (4 * n + x)) & 1u ? dpt[n][x] * inv_keep : 0.f;
    }
}

// ---- backward over one key tile: the short path's single launch (kLong =
// false: the block holds every key, computes the row term and writes dq),
// and the long path's pass 2 (kLong = true: a block per 64-key tile, the
// row term read back from pass 1, no dq). One warp per 16 queries. ----
// Shared memory: qs, dos [mpad][ld], ks, vs [nk][ld], ps, dss [mpad][nk+8]
// (bf16), keep [nk], mask [mpad][nk + 16] (u8, kRng = false).
template <int kD, int kNT, bool kRng, bool kLong>
__global__ void __launch_bounds__(256) bwd_tile(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = kD + kPad, nk = kNT * 16, ldp = nk + kPad;
  const int r = blockIdx.x, h = blockIdx.y, t0 = blockIdx.z * nk;
  const int lq = a.lq, lk = a.lk, e = a.e, mpad = round_up(lq, 16);
  const int nkeys = min(nk, lk - t0), nkt = (nkeys + 15) >> 4;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + mpad * ld;
  bf16* ks = dos + mpad * ld;
  bf16* vs = ks + nk * ld;
  bf16* ps = vs + nk * ld;
  bf16* dss = ps + mpad * ldp;
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(dss + mpad * ldp);
  uint8_t* mask_s = keep_s + nk;

  const size_t qoff = static_cast<size_t>(r) * lq * e + h * kD;
  const size_t koff = (static_cast<size_t>(r) * lk + t0) * e + h * kD;
  stage_async<kD>(qs, a.q + qoff, lq, mpad, e);
  cp_commit();
  stage_async<kD>(dos, a.dout + qoff, lq, mpad, e);
  stage_async<kD>(ks, a.k + koff, nkeys, nk, e);
  stage_async<kD>(vs, a.v + koff, nkeys, nk, e);
  MaskSrc ms = mask_src<kRng>(a, r, h);
  if constexpr (!kRng) {
    ms.tile = MaskTile{mask_s, mask_of(a, r, h) + t0, nk + 16, lk, t0};
    stage_mask(mask_s, nk + 16, ms.tile.g, lk, lq, nkeys);
  }
  cp_commit();
  const int any = stage_keep(
      keep_s, nk, t0,
      a.keep ? a.keep + static_cast<size_t>(r) * lk : nullptr, lk);
  cp_wait<1>();
  scale_rows<kD>(qs, mpad, a.qscale);
  cp_wait<0>();
  const float av = __syncthreads_or(any) ? 1.f : 0.f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tig = lane & 3, gid = lane >> 2, m0 = warp * 16;
  const size_t rh = static_cast<size_t>(r) * a.nh + h;
  float rmax[2], rinv[2], dterm[2] = {0.f, 0.f};
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int i = m0 + gid + 8 * row;
    const bool in = i < lq;
    rmax[row] = in ? a.stats[(rh * lq + i) * 2] : 0.f;
    rinv[row] = in ? 1.f / a.stats[(rh * lq + i) * 2 + 1] : 1.f;
    if (kLong) dterm[row] = in ? a.rowterm[rh * lq + i] : 0.f;
  }
  const bool live0 = m0 + gid < lq, live1 = m0 + gid + 8 < lq;
  // Each 16-key step: the scores (computed once), p from the forward's max
  // and sum, the keep bits (drawn once), bf16(pt) to shared memory and the
  // row term's part. p and the bits stay in registers; dpt = do . v^T is
  // recomputed for ds below rather than held (registers for occupancy).
  float p[kNT][2][4];
  uint32_t kbits[kNT];
#pragma unroll
  for (int kt = 0; kt < kNT; ++kt)
    if (kt < nkt) {
      float dpt[2][4];
      scores16<kD>(p[kt], qs, m0, ks, kt * 16, lane);
      scores16<kD>(dpt, dos, m0, vs, kt * 16, lane);
      kbits[kt] = keep_rows<kRng>(ms, m0, t0 + kt * 16, lane);
      probs_dp(p[kt], dpt, keep_s + kt * 16, kbits[kt], rmax, rinv, live0,
               live1, a.inv_keep, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          float pt[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int x = 2 * row + c;
            pt[c] = (kbits[kt] >> (4 * n + x)) & 1u ? p[kt][n][x] * a.inv_keep
                                                    : 0.f;
            if (!kLong) dterm[row] += p[kt][n][x] * dpt[n][x];
          }
          *reinterpret_cast<uint32_t*>(
              ps + (m0 + gid + 8 * row) * ldp + kt * 16 + n * 8 + tig * 2) =
              pack_bf16(pt[0], pt[1]);
        }
    }
  if (!kLong) {
    dterm[0] = quad_sum(dterm[0]);
    dterm[1] = quad_sum(dterm[1]);
  }
  // ds = bf16(p * (dp - D)) to shared memory
#pragma unroll
  for (int kt = 0; kt < kNT; ++kt)
    if (kt < nkt) {
      float dpt[2][4];
      scores16<kD>(dpt, dos, m0, vs, kt * 16, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          float ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int x = 2 * row + c;
            const float dp = (kbits[kt] >> (4 * n + x)) & 1u
                                 ? dpt[n][x] * a.inv_keep : 0.f;
            ds[c] = p[kt][n][x] * (dp - dterm[row]);
          }
          *reinterpret_cast<uint32_t*>(
              dss + (m0 + gid + 8 * row) * ldp + kt * 16 + n * 8 + tig * 2) =
              pack_bf16(ds[0], ds[1]);
        }
    }
  if constexpr (!kLong) {
    // dq = ds . k, 32 columns at a time; the warp's own rows of dss
    __syncwarp();
    bf16* dq = a.out + qoff;
#pragma unroll
    for (int c0 = 0; c0 < kD; c0 += 32) {
      float acc[4][4];
      zero(acc);
#pragma unroll
      for (int kt = 0; kt < kNT; ++kt)
        if (kt < nkt) {
          uint32_t af[4];
          ldsm4(af, a_ptr(dss, ldp, m0, kt * 16, lane));
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            uint32_t b[4];
            ldsm4t(b, b_ptr(ks, ld, kt * 16, c0 + nn * 16, lane));
            mma16816(acc[2 * nn], af, b);
            mma16816(acc[2 * nn + 1], af, b + 2);
          }
        }
      store_rows<4>(dq, e, m0, c0, lq, acc, a.dqscale * av, lane);
    }
  }
  __syncthreads();
  // dk = ds^T . qs and dv = pt^T . do, a (16 keys, 32 columns) unit a warp
  const int units = 2 * nkt * (kD / 32), nw = blockDim.x >> 5;
  for (int u = warp; u < units; u += nw) {
    const int dv_unit = u & 1, kt = (u >> 1) % nkt, c0 = (u >> 1) / nkt * 32;
    const bf16* as = dv_unit ? ps : dss;
    const bf16* bs = dv_unit ? dos : qs;
    float acc[4][4];
    zero(acc);
    for (int k0 = 0; k0 < mpad; k0 += 16) {
      uint32_t af[4];
      ldsm4t(af, at_ptr(as, ldp, k0, kt * 16, lane));
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        uint32_t b[4];
        ldsm4t(b, b_ptr(bs, ld, k0, c0 + nn * 16, lane));
        mma16816(acc[2 * nn], af, b);
        mma16816(acc[2 * nn + 1], af, b + 2);
      }
    }
    bf16* dst = (dv_unit ? a.dv : a.dk) +
                static_cast<size_t>(r) * lk * e + h * kD;
    store_rows<4>(dst, e, t0 + kt * 16, c0, lk, acc, av, lane);
  }
}

// ---- long backward pass 1: one block per (row, head), a warp per 16
// queries; the row term (kept in HBM for pass 2) and dq. No key warps: at
// (64, 40, 1000) two of them per query warp made it two waves of blocks
// instead of one, and slower. ----
// Shared memory: qs, dos [mpad][ld] (bf16), keep [nall] (u8), bits
// [mpad / 16][nall / 16][32] (u8), mask [nbuf][mpad][kKT + 16] (u8, kRng =
// false), then the tiles [nbuf][2][kKT][ld] (bf16).
template <int kD, bool kRng>
__global__ void __launch_bounds__(256, 1) bwd_rows(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = kD + kPad;
  const int r = blockIdx.x, h = blockIdx.y, lq = a.lq, lk = a.lk, e = a.e;
  const int mpad = round_up(lq, 16);
  const int nt = (lk + kKT - 1) / kKT, nall = nt * kKT;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + mpad * ld;
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(dos + mpad * ld);
  uint8_t* bits_s = keep_s + nall;
  uint8_t* mask_s = bits_s + mpad * nall / 8;
  bf16* kv = reinterpret_cast<bf16*>(
      mask_s + (kRng ? 0 : a.nbuf * mpad * (kKT + 16)));

  const size_t qoff = static_cast<size_t>(r) * lq * e + h * kD;
  const size_t koff = static_cast<size_t>(r) * lk * e + h * kD;
  const Tiles<kD, kRng> tl{kv, mask_s, a.k + koff, a.v + koff,
                           kRng ? nullptr : mask_of(a, r, h), lq, lk, e,
                           mpad, a.nbuf};
  stage_async<kD>(qs, a.q + qoff, lq, mpad, e);
  stage_async<kD>(dos, a.dout + qoff, lq, mpad, e);
  cp_commit();
  const int ahead = tl.prologue(nt, true, true);
  const int any = stage_keep(
      keep_s, nall, 0,
      a.keep ? a.keep + static_cast<size_t>(r) * lk : nullptr, lk);
  cp_wait_n(ahead);
  scale_rows<kD>(qs, mpad, a.qscale);
  const float av = __syncthreads_or(any) ? 1.f : 0.f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tig = lane & 3, gid = lane >> 2;
  const int m0 = warp * 16;
  const size_t rh = static_cast<size_t>(r) * a.nh + h;
  float rmax[2], rinv[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int i = m0 + gid + 8 * row;
    rmax[row] = i < lq ? a.stats[(rh * lq + i) * 2] : 0.f;
    rinv[row] = i < lq ? 1.f / a.stats[(rh * lq + i) * 2 + 1] : 1.f;
  }
  uint8_t* my_bits = bits_s + warp * (nall / 16) * 32 + lane;
  MaskSrc ms = mask_src<kRng>(a, r, h);
  // sweep 1: the row term D = rowsum(dp * p), exactly in f32; the keep
  // bits are drawn (or read) here once and kept for sweep 2
  float dpart[2] = {0.f, 0.f};
  for (int t = 0; t < nt; ++t) {
    tl.before(t, nt, true, true);
    if constexpr (!kRng) ms.tile = tl.tile(t);
    for (int c = 0; c < kKT / 16 && t * kKT + c * 16 < lk; ++c) {
      const int j0 = t * kKT + c * 16;
      float s[2][4], dpt[2][4];
      scores16<kD>(s, qs, m0, tl.kbuf(t), c * 16, lane);
      scores16<kD>(dpt, dos, m0, tl.vbuf(t), c * 16, lane);
      const uint32_t bits = keep_rows<kRng>(ms, m0, j0, lane);
      my_bits[(j0 / 16) * 32] = static_cast<uint8_t>(bits);
      probs_dp(s, dpt, keep_s + j0, bits, rmax, rinv, m0 + gid < lq,
               m0 + gid + 8 < lq, a.inv_keep, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) dpart[x >> 1] += s[n][x] * dpt[n][x];
    }
    tl.after();
  }
  tl.prologue(nt, true, false);
  float dterm[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int i = m0 + gid + 8 * row;
    dterm[row] = quad_sum(dpart[row]);
    if (tig == 0 && i < lq) a.rowterm[rh * lq + i] = dterm[row];
  }
  // sweep 2: ds = bf16(p * (dp - D)) and dq += ds . k
  float acc[kD / 8][4];
  zero(acc);
  for (int t = 0; t < nt; ++t) {
    tl.before(t, nt, true, false);
    for (int c = 0; c < kKT / 16 && t * kKT + c * 16 < lk; ++c) {
      const int j0 = t * kKT + c * 16;
      float s[2][4], dpt[2][4];
      scores16<kD>(s, qs, m0, tl.kbuf(t), c * 16, lane);
      scores16<kD>(dpt, dos, m0, tl.vbuf(t), c * 16, lane);
      probs_dp(s, dpt, keep_s + j0, my_bits[(j0 / 16) * 32], rmax, rinv,
               m0 + gid < lq, m0 + gid + 8 < lq, a.inv_keep, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) s[n][x] *= dpt[n][x] - dterm[x >> 1];
      uint32_t dsa[4];
      frag_of(dsa, s);
#pragma unroll
      for (int nn = 0; nn < kD / 16; ++nn) {
        uint32_t b[4];
        ldsm4t(b, b_ptr(tl.kbuf(t), ld, c * 16, nn * 16, lane));
        mma16816(acc[2 * nn], dsa, b);
        mma16816(acc[2 * nn + 1], dsa, b + 2);
      }
    }
    tl.after();
  }
  store_rows<kD / 8>(a.out + qoff, e, m0, 0, lq, acc, a.dqscale * av, lane);
}

// Bytes of dynamic shared memory a launch of `kind` needs (the layouts
// above); kt: keys a block holds (short kinds 64, 112 or 128; bwd_keys 64).
int smem_need(int kind, int lq, int lk, int d, int kt, int wk, int nbuf,
              int rng) {
  const int mpad = round_up(lq, 16), ld = d + kPad, nall = round_up(lk, kKT);
  const int mask_tile = rng ? 0 : mpad * (kt + 16);
  const int mask_tiles = rng ? 0 : nbuf * mpad * (kKT + 16);
  const int kv = nbuf * 2 * kKT * ld * 2;
  const int merge = (wk - 1) * (mpad / 16) * 16 * d * 4;
  const int tiles = kv > merge ? kv : merge;
  switch (kind) {
    case kFwdShort:   // at d = 160 the mask goes where K was
      return 2 * (mpad + 2 * kt) * ld + kt + (d == 160 ? 0 : mask_tile);
    case kFwdLong:
      return 2 * mpad * ld + nall + 4 * 2 * wk * mpad + mask_tiles + tiles;
    case kBwdShort:
    case kBwdKeys:
      return 2 * (2 * mpad + 2 * kt) * ld + 4 * mpad * (kt + kPad) + kt +
             mask_tile;
    case kBwdRows:
      return 4 * mpad * ld + nall + mpad * nall / 8 + mask_tiles + kv;
  }
  return -1;
}

bool supports(int lq, int lk, int d) {
  return (d == 32 || d == 160) && lq >= 1 && lq <= kMaxQ && lk >= 1 &&
         lk <= kMaxK;
}

// Whether (warps, wk, kt, z, nbuf) is a launch shape `kind` takes.
bool shape_ok(int kind, int lq, int lk, int warps, int wk, int kt, int z,
              int nbuf) {
  const int wq = round_up(lq, 16) / 16;
  switch (kind) {
    case kFwdShort:
    case kBwdShort:
      return (kt == 64 || kt == 112 || kt == kShortK) && lk <= kt &&
             z == 1 && wk == 1 && warps == wq;
    case kBwdKeys:
      return kt == kKT && z == (lk + kKT - 1) / kKT && wk == 1 && warps == wq;
    case kFwdLong:
    case kBwdRows:
      return wk >= 1 && (kind == kFwdLong || wk == 1) && warps == wq * wk &&
             warps <= kMaxWarps && z == 1 && (nbuf == 1 || nbuf == 2);
  }
  return false;
}

template <int kD, bool kRng>
int launch(int kind, const Args& a, int r, int h, int warps, int kt, int z,
           int smem, cudaStream_t stream) {
  void (*kern)(const Args) = nullptr;
  switch (kind) {
    case kFwdShort:
      kern = kt == 64    ? fwd_short<kD, 4, kRng>
             : kt == 112 ? fwd_short<kD, 7, kRng>
                         : fwd_short<kD, 8, kRng>;
      break;
    case kFwdLong:
      kern = fwd_long<kD, kRng>;
      break;
    case kBwdShort:
      kern = kt == 64    ? bwd_tile<kD, 4, kRng, false>
             : kt == 112 ? bwd_tile<kD, 7, kRng, false>
                         : bwd_tile<kD, 8, kRng, false>;
      break;
    case kBwdRows:
      kern = bwd_rows<kD, kRng>;
      break;
    default:
      kern = bwd_tile<kD, 4, kRng, true>;
  }
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(r, h, z), warps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Whether the kernels take these shapes: d = 32 or 160, Lq <= 128,
// Lk <= 4096.
int train_mha_supports(int lq, int lk, int d) { return supports(lq, lk, d); }

// Bytes of dynamic shared memory one block of `kind` needs (kinds: 0
// fwd_short, 1 fwd_long, 2 bwd_short, 3 bwd_rows, 4 bwd_keys).
int train_mha_smem_need(int kind, int lq, int lk, int d, int kt, int wk,
                        int nbuf, int rng) {
  return smem_need(kind, lq, lk, d, kt, wk, nbuf, rng);
}

// One launch of the plan (kernels/train_attention.train_mha_plan): grid
// (r, h, z), `warps` warps a block, smem_need's bytes of shared memory. The
// forward kinds write out and stats [R, H, Lq, 2]; bwd_short writes dq (in
// `out`), dk and dv; bwd_rows dq and the row term [R, H, Lq] (scratch);
// bwd_keys dk and dv. mask (rng = 0) or seed (rng = 1, two u32 words in
// int64 [2]). Launches on `stream`; returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a shape or plan it does not take.
int train_mha_launch(int kind, const void* q, const void* k, const void* v,
                     const void* keep, const void* mask, const void* seed,
                     const void* dout, void* stats, void* rowterm, void* out,
                     void* dk, void* dv, int r, int lq, int lk, int e, int h,
                     float qscale, float dqscale, float inv_keep,
                     unsigned long long thresh, int rng, int warps, int wk,
                     int kt, int z, int nbuf, void* stream) {
  const int d = e / h;
  if (e % h || !supports(lq, lk, d) ||
      !shape_ok(kind, lq, lk, warps, wk, kt, z, nbuf))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_need(kind, lq, lk, d, kt, wk, nbuf, rng);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.keep = static_cast<const uint8_t*>(keep);
  a.mask = static_cast<const uint8_t*>(mask);
  a.seed = static_cast<const int64_t*>(seed);
  a.stats = static_cast<float*>(stats);
  a.rowterm = static_cast<float*>(rowterm);
  a.out = static_cast<bf16*>(out);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.lq = lq;
  a.lk = lk;
  a.e = e;
  a.nh = h;
  a.wk = wk;
  a.nbuf = nbuf;
  a.qscale = qscale;
  a.dqscale = dqscale;
  a.inv_keep = inv_keep;
  a.thresh = thresh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32)
    return rng ? launch<32, true>(kind, a, r, h, warps, kt, z, smem, s)
               : launch<32, false>(kind, a, r, h, warps, kt, z, smem, s);
  return rng ? launch<160, true>(kind, a, r, h, warps, kt, z, smem, s)
             : launch<160, false>(kind, a, r, h, warps, kt, z, smem, s);
}

}  // extern "C"
