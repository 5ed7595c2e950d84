// Fused multi-head attention on merged-head projections, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel case_rg_tpu/kernels/encoder_attention.py
// (fused_mha, body _kernel). Same function as its _kernel and fused_mha_xla:
//   qs = bf16(q * bf16(1/sqrt(d)));  s = qs . k  in f32;
//   masked keys -> -1e20;  p = softmax(s) in f32;  p -> bf16;
//   ctx = sum p * v  accumulated in f32, cast once to bf16;
//   a row whose keys are all padding gives exact zeros.
// The softmax is not online: each query's exact max and sum are taken over
// all its keys, and 1/sum once a row, before any probability is rounded.
// q [R, Lq, E], k/v [R, Lk, E] bf16, keep [R, Lk] bool (or null), out
// [R, Lq, E] bf16; head h owns lanes [h*d, (h+1)*d) of E. The kernel takes
// head widths d that are multiples of 16, at most 128 keys, and any Lq whose
// tiles fit a block's shared memory.
//
// What bounds it on an H100: bytes. One site reads q, k, v and writes the
// context, 2 bytes an element, and does 4*R*H*Lq*Lk*d operations: at the
// CaSE shapes (L <= 100) that is ~50 operations a byte, far below the ~295
// the tensor cores need before they, and not HBM, are the limit. What stands
// between the kernel and that bound is latency: staging, fragment loads and
// the occupancy that registers and shared memory allow.
//
// What this design does about it (the short forward path of
// train_attention.cu, without dropout): one block per (row, head), a warp
// per 16 queries (so Lq = 60 runs 4 warps and Lq = 100 runs 7, none idle;
// more queries than 8 warps hold loop over the tiles). q, K and V reach
// shared memory by cp.async, 16 bytes a thread, zero-filled past the end, in
// two groups so q is scaled while K and V land; the key mask is read while
// the copies fly. Every mma.sync (m16n8k16, bf16 in, f32 accumulate)
// fragment is read by ldmatrix, V by ldmatrix.trans, so nothing is
// transposed on the way in. The kernel is a template on the head width
// (d = 32 and 160 compiled for the served sites; 0 = any multiple of 16,
// read at run time) and on kNT, the 16-key steps a block holds (4, 7 or 8,
// as train_mha_plan picks them), so the warp's 16 x Lk f32 scores sit whole
// in registers and no register goes to a key tile that holds no key. The
// rounded probabilities are reused in registers as the A operand of the PV
// product, taken over 32 output columns at a time. The TPU kernel's
// lane-mask trick (contracting the full E axis with off-head lanes zeroed)
// is a TPU layout device and is not carried over.

#include "sm90.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxKeys = 128;

struct MhaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* keep;               // [R, Lk] or null
  bf16* out;
  int lq, lk, e, d;
  float scale;
};

// 16-key steps a block holds for Lk keys (train_mha_plan's kt / 16).
int key_steps(int lk) { return lk <= 64 ? 4 : lk <= 112 ? 7 : 8; }

// Shared memory: qs [mpad][ld], ks and vs [16 kNT][ld] (bf16), keep [16 kNT].
int smem_need(int lq, int lk, int d) {
  const int nk = 16 * key_steps(lk);
  return 2 * (round_up(lq, 16) + 2 * nk) * (d + kPad) + nk;
}

int warps_for(int lq) {
  const int wq = round_up(lq, 16) / 16;
  return wq < kMaxWarps ? wq : kMaxWarps;
}

template <int kD, int kNT>
__global__ void __launch_bounds__(256, kD == 32 && kNT <= 4 ? 3 : 2)
    fused_mha_kernel(const MhaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = kD ? kD : a.d;
  const int ld = d + kPad, nk = kNT * 16;
  const int r = blockIdx.x, h = blockIdx.y, lq = a.lq, lk = a.lk, e = a.e;
  const int mpad = round_up(lq, 16);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + mpad * ld;
  bf16* vs = ks + nk * ld;
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(vs + nk * ld);

  const size_t qoff = static_cast<size_t>(r) * lq * e + h * d;
  const size_t koff = static_cast<size_t>(r) * lk * e + h * d;
  stage_async<kD>(qs, a.q + qoff, lq, mpad, e, d);
  cp_commit();
  stage_async<kD>(ks, a.k + koff, lk, nk, e, d);
  stage_async<kD>(vs, a.v + koff, lk, nk, e, d);
  cp_commit();
  const uint8_t* keep_r = a.keep ? a.keep + static_cast<size_t>(r) * lk : nullptr;
  int any = 0;
  for (int j = threadIdx.x; j < nk; j += blockDim.x) {
    const bool valid = j < lk && (keep_r == nullptr || keep_r[j]);
    keep_s[j] = valid;
    any |= valid;
  }
  cp_wait<1>();
  scale_rows<kD>(qs, mpad, a.scale, d);
  cp_wait<0>();
  const float av = __syncthreads_or(any) ? 1.f : 0.f;

  const int lane = threadIdx.x & 31, tig = lane & 3;
  const int nwarps = blockDim.x >> 5, nkt = (lk + 15) >> 4;
  bf16* out = a.out + qoff;
  for (int m0 = (threadIdx.x >> 5) * 16; m0 < mpad; m0 += nwarps * 16) {
    // ---- scores S = qs . K^T, 16 x Lk, in registers ----
    float s[kNT][2][4];
#pragma unroll
    for (int kt = 0; kt < kNT; ++kt) zero(s[kt]);
#pragma unroll
    for (int kk = 0; kk < d / 16; ++kk) {
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
    // ---- the exact max and sum of each query's row; masked keys -1e20 ----
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
    // probabilities rounded to bf16, as the PV product's A fragments;
    // padding keys (j >= Lk) carry p = 0 unless every key of the row is
    // masked, and such rows are zeroed at the store
    uint32_t pa[kNT][4];
#pragma unroll
    for (int kt = 0; kt < kNT; ++kt)
      if (kt < nkt) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) s[kt][n][x] *= rinv[x >> 1];
        frag_of(pa[kt], s[kt]);
      }
    // ---- context = bf16(p) . V, 32 head lanes at a time ----
#pragma unroll
    for (int c0 = 0; c0 < d; c0 += 32) {
      const bool full = c0 + 32 <= d;
      float o[4][4];
      zero(o);
#pragma unroll
      for (int kt = 0; kt < kNT; ++kt)
        if (kt < nkt)
#pragma unroll
          for (int nn = 0; nn < 2; ++nn)
            if (nn == 0 || full) {
              uint32_t b[4];
              ldsm4t(b, b_ptr(vs, ld, kt * 16, c0 + nn * 16, lane));
              mma16816(o[2 * nn], pa[kt], b);
              mma16816(o[2 * nn + 1], pa[kt], b + 2);
            }
      if (full)
        store_rows<4>(out, e, m0, c0, lq, o, av, lane);
      else
        store_rows<2>(out, e, m0, c0, lq,
                      reinterpret_cast<const float(&)[2][4]>(o), av, lane);
    }
  }
}

template <int kD>
void* kernel_for(int lk) {
  switch (key_steps(lk)) {
    case 4:
      return reinterpret_cast<void*>(fused_mha_kernel<kD, 4>);
    case 7:
      return reinterpret_cast<void*>(fused_mha_kernel<kD, 7>);
    default:
      return reinterpret_cast<void*>(fused_mha_kernel<kD, 8>);
  }
}

}  // namespace

extern "C" {

// Whether the kernel takes these shapes: d a multiple of 16, 1 <= Lk <= 128,
// Lq >= 1 with its tiles in a block's shared memory.
int fused_mha_supports(int lq, int lk, int d) {
  return d >= 16 && d % 16 == 0 && lk >= 1 && lk <= kMaxKeys && lq >= 1 &&
         smem_need(lq, lk, d) <= 232448;
}

// Bytes of dynamic shared memory one block needs.
int fused_mha_smem_bytes(int lq, int lk, int d) { return smem_need(lq, lk, d); }

// Launches on `stream`: grid (R, H), a warp per 16 queries (at most 8),
// fused_mha_smem_bytes of shared memory; the instance is <d, kNT> for d =
// 32 and 160, <0, kNT> (the width read at run time) for any other d.
// Returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// shape the kernel does not take.
int fused_mha_bf16(const void* q, const void* k, const void* v,
                   const void* keep, void* out, int r, int lq, int lk, int e,
                   int h, float scale, void* stream) {
  const int d = e / h;
  if (e % h || !fused_mha_supports(lq, lk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  MhaArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.keep = static_cast<const uint8_t*>(keep);
  a.out = static_cast<bf16*>(out);
  a.lq = lq;
  a.lk = lk;
  a.e = e;
  a.d = d;
  a.scale = scale;
  void* kern = d == 32 ? kernel_for<32>(lk)
               : d == 160 ? kernel_for<160>(lk)
                          : kernel_for<0>(lk);
  const int smem = smem_need(lq, lk, d);
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  cudaLaunchKernel(kern, dim3(r, h), dim3(32 * warps_for(lq)), args, smem,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
