// Fused multi-head attention on merged-head projections, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel case_rg_tpu/kernels/encoder_attention.py
// (fused_mha, body _kernel). Same function as its _kernel and fused_mha_xla:
//   qs = bf16(q * bf16(1/sqrt(d)));  s = qs . k  in f32;
//   masked keys -> -1e20;  p = softmax(s) in f32;  p -> bf16;
//   ctx = sum p * v  accumulated in f32, cast once to bf16;
//   a row whose keys are all padding gives exact zeros.
// q [R, Lq, E], k/v [R, Lk, E] bf16, keep [R, Lk] bool (or null), out
// [R, Lq, E] bf16; head h owns lanes [h*d, (h+1)*d) of E. The kernel takes
// head widths d that are multiples of 16 and at most 128 keys.
//
// What bounds it on an H100: bytes. One site reads q, k, v and writes the
// context, 2 bytes an element, and does 4*R*H*Lq*Lk*d operations: at the
// CaSE shapes (L <= 100) that is ~50 operations a byte, far below the ~295
// the tensor cores need before they, and not HBM, are the limit.
//
// What this design does about it: one block per (row, head) stages that
// head's q (scaled and rounded), K and V^T tiles in shared memory once, so
// every q, k, v element is read from HBM once with 16-byte loads, and the
// [Lq, Lk] scores never leave the SM. Each warp takes 16-row tiles of the
// queries and runs both products on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 accumulate): the scores of its tile stay in registers, the
// softmax runs there with two shuffles across each row's four lanes, and
// the rounded probabilities are reused in registers as the A operand of
// the PV product. The TPU kernel's lane-mask trick (contracting the full E
// axis with off-head lanes zeroed) is a TPU layout device and is not
// carried over. Shared-memory rows are padded by 16 bytes so the fragment
// loads of the eight rows of a tile fall in different banks. No TMA,
// wgmma or pipelining across blocks yet: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKeyTiles = 16;     // n-tiles of 8 keys: Lk <= 128
constexpr int kPad = 8;              // bf16 of padding per shared-memory row
constexpr float kNegInf = -1e20f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
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

// Shared memory (bf16): qs [mpad][d + kPad], ks [npad][d + kPad],
// vt [d][npad + kPad]; then keep [npad] f32. mpad/npad: Lq/Lk rounded up
// to 16; the padding rows of qs and ks and the padding keys of vt are zero.
__global__ void __launch_bounds__(kThreads)
fused_mha_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const uint8_t* __restrict__ keep,
                 __nv_bfloat16* __restrict__ out,
                 int lq, int lk, int e, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int mpad = (lq + 15) / 16 * 16;
  const int npad = (lk + 15) / 16 * 16;
  const int dq = d + kPad;             // row stride of qs and ks
  const int dv = npad + kPad;          // row stride of vt
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + mpad * dq;
  __nv_bfloat16* vt = ks + npad * dq;
  float* keep_s = reinterpret_cast<float*>(vt + d * dv);

  // ---- stage the head's tiles: 16-byte loads, 8 lanes of E each ----
  const int c8 = d / 8;
  const size_t q_base = static_cast<size_t>(r) * lq * e + h * d;
  const size_t kv_base = static_cast<size_t>(r) * lk * e + h * d;
  for (int i = threadIdx.x; i < mpad * c8; i += kThreads) {
    const int row = i / c8, c = (i % c8) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row < lq) {
      raw = __ldg(reinterpret_cast<const uint4*>(q + q_base + static_cast<size_t>(row) * e + c));
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 f = __bfloat1622float2(h2[t]);
        h2[t] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(qs + row * dq + c) = raw;
  }
  for (int i = threadIdx.x; i < npad * c8; i += kThreads) {
    const int row = i / c8, c = (i % c8) * 8;
    uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
    if (row < lk) {
      const size_t off = kv_base + static_cast<size_t>(row) * e + c;
      kr = __ldg(reinterpret_cast<const uint4*>(k + off));
      vr = __ldg(reinterpret_cast<const uint4*>(v + off));
    }
    *reinterpret_cast<uint4*>(ks + row * dq + c) = kr;
    const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
    for (int t = 0; t < 8; ++t) vt[(c + t) * dv + row] = vv[t];
  }
  const uint8_t* keep_r = keep ? keep + static_cast<size_t>(r) * lk : nullptr;
  int any = 0;
  for (int j = threadIdx.x; j < npad; j += kThreads) {
    const bool valid = j < lk && (keep_r == nullptr || keep_r[j]);
    keep_s[j] = valid ? 1.f : 0.f;
    any |= valid;
  }
  const float any_valid = __syncthreads_or(any) ? 1.f : 0.f;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;           // row within the 8-row half of a tile
  const int tig = lane & 3;            // column pair within a fragment
  const int ntiles = npad / 8;
  for (int m0 = warp * 16; m0 < mpad; m0 += kWarps * 16) {
    // ---- scores S = qs . K^T, 16 x npad, in registers ----
    float s[kMaxKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kMaxKeyTiles; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int k0 = 0; k0 < d; k0 += 16) {
      uint32_t a[4];
      const __nv_bfloat16* qa = qs + (m0 + gid) * dq + k0 + tig * 2;
      a[0] = lds32(qa);
      a[1] = lds32(qa + 8 * dq);
      a[2] = lds32(qa + 8);
      a[3] = lds32(qa + 8 * dq + 8);
#pragma unroll
      for (int j = 0; j < kMaxKeyTiles; ++j) {
        if (j < ntiles) {
          uint32_t b[2];
          const __nv_bfloat16* kb = ks + (j * 8 + gid) * dq + k0 + tig * 2;
          b[0] = lds32(kb);
          b[1] = lds32(kb + 8);
          mma16816(s[j], a, b);
        }
      }
    }
    // ---- masked softmax per row; a row's 4 lanes share a quad ----
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kMaxKeyTiles; ++j) {
      if (j < ntiles) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (keep_s[j * 8 + tig * 2 + t] == 0.f) {
            s[j][t] = kNegInf;
            s[j][2 + t] = kNegInf;
          }
          mx0 = fmaxf(mx0, s[j][t]);
          mx1 = fmaxf(mx1, s[j][2 + t]);
        }
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxKeyTiles; ++j) {
      if (j < ntiles) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          s[j][t] = expf(s[j][t] - mx0);
          s[j][2 + t] = expf(s[j][2 + t] - mx1);
          sum0 += s[j][t];
          sum1 += s[j][2 + t];
        }
      }
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    // probabilities rounded to bf16, packed as the PV product's A operand.
    // Padding keys (j >= Lk) carry p = 0 exactly unless every key of the
    // row is masked, and such rows are zeroed below.
    uint32_t p[kMaxKeyTiles][2];
#pragma unroll
    for (int j = 0; j < kMaxKeyTiles; ++j) {
      p[j][0] = pack_bf16(s[j][0] / sum0, s[j][1] / sum0);
      p[j][1] = pack_bf16(s[j][2] / sum1, s[j][3] / sum1);
    }
    // ---- context = P . V, 8 head lanes at a time ----
    const int row0 = m0 + gid, row1 = m0 + gid + 8;
    for (int n0 = 0; n0 < d; n0 += 8) {
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kMaxKeyTiles / 2; ++kk) {
        if (2 * kk < ntiles) {
          const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1],
                                 p[2 * kk + 1][0], p[2 * kk + 1][1]};
          uint32_t b[2];
          const __nv_bfloat16* vb = vt + (n0 + gid) * dv + kk * 16 + tig * 2;
          b[0] = lds32(vb);
          b[1] = lds32(vb + 8);
          mma16816(o, a, b);
        }
      }
      const int col = h * d + n0 + tig * 2;
      if (row0 < lq)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (static_cast<size_t>(r) * lq + row0) * e + col) =
            __floats2bfloat162_rn(o[0] * any_valid, o[1] * any_valid);
      if (row1 < lq)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (static_cast<size_t>(r) * lq + row1) * e + col) =
            __floats2bfloat162_rn(o[2] * any_valid, o[3] * any_valid);
    }
  }
}

}  // namespace

extern "C" {

// Whether the kernel takes these shapes: d a multiple of 16, Lk <= 128.
int fused_mha_supports(int lk, int d) {
  return d % 16 == 0 && lk >= 1 && lk <= 8 * kMaxKeyTiles;
}

// Bytes of dynamic shared memory one block needs.
int fused_mha_smem_bytes(int lq, int lk, int d) {
  const int mpad = (lq + 15) / 16 * 16;
  const int npad = (lk + 15) / 16 * 16;
  return 2 * ((mpad + npad) * (d + kPad) + d * (npad + kPad)) + 4 * npad;
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int fused_mha_bf16(const void* q, const void* k, const void* v,
                   const void* keep, void* out, int r, int lq, int lk, int e,
                   int h, float scale, void* stream) {
  const int d = e / h;
  if (e % h || !fused_mha_supports(lk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fused_mha_smem_bytes(lq, lk, d);
  cudaFuncSetAttribute(fused_mha_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(r, h);
  fused_mha_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(keep),
      static_cast<__nv_bfloat16*>(out), lq, lk, e, d, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
