// Device helpers shared by the port's Hopper (sm_90a) kernels: mma.sync
// m16n8k16 (bf16 in, f32 accumulate), ldmatrix fragment loads and their
// addresses, cp.async staging, quad reductions, the attention kernels'
// staging, fragment and store helpers, and the host's raising of a
// kernel's shared-memory and cluster limits. Included by every source
// under csrc/; the build
// (kernels/_build.py) hashes every header under csrc/ with each source, so
// an edit here rebuilds them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kPad = 8;              // bf16 of padding per shared-memory row
constexpr float kNegInf = -1e20f;
constexpr int kDefaultSmem = 48 * 1024;   // dynamic shared memory, no opt-in
constexpr int kSmemLimit = 232448;        // a block's most on sm_90

// A kernel may use more than kDefaultSmem of dynamic shared memory, or run
// in clusters of more than 8 blocks, only after its limits are raised. This
// raises them once per process, device and kernel: the dynamic shared
// memory to kSmemLimit less the kernel's static shared memory, and with
// `wide_clusters` non-portable cluster sizes (up to 16
// blocks). A table of the kernels raised so far keeps a bit a device each.
// Every launcher of the port goes through it: no launch calls
// cudaFuncSetAttribute again once its kernel is raised.
inline cudaError_t allow_smem(const void* kernel, int smem,
                              bool wide_clusters = false) {
  constexpr int kSlots = 64;
  static const void* kernels[kSlots];
  static unsigned long long raised[kSlots];
  if (smem <= kDefaultSmem && !wide_clusters) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int i = 0;
  while (i < kSlots && kernels[i] && kernels[i] != kernel) ++i;
  const bool kept = i < kSlots && dev < 64;
  if (kept && kernels[i] && (raised[i] >> dev & 1ull)) return cudaSuccess;
  cudaFuncAttributes fa;               // the limit counts static bytes too
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit - static_cast<int>(fa.sharedSizeBytes));
  if (err == cudaSuccess && wide_clusters)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && kept) {
    kernels[i] = kernel;
    raised[i] |= 1ull << dev;
  }
  return err;
}

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two 8x8 bf16 matrices; lane l < 16 gives the address of row l % 8 of
// matrix l / 8 (the other lanes' addresses are not read).
__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Fragment addresses for lane l, for a tile at (row0, col0) of a row-major
// shared array with leading dimension ld:
//   A (16x16, rows = m, cols = k), row-major:                a_ptr
//   B for two 8-column n-tiles, stored [n][k] (B^T row-major): bt_ptr
//     -> r[0..1] = n-tile 0, r[2..3] = n-tile 1 (ldsm4)
//   B for two n-tiles, stored [k][n] (row-major):              b_ptr
//     -> same registers, by ldsm4t
//   A stored transposed [k][m]:                                at_ptr (ldsm4t)
__device__ __forceinline__ const bf16* a_ptr(const bf16* s, int ld, int m0,
                                             int k0, int l) {
  return s + (m0 + (l & 15)) * ld + k0 + (l >> 4) * 8;
}
__device__ __forceinline__ const bf16* bt_ptr(const bf16* s, int ld, int n0,
                                              int k0, int l) {
  return s + (n0 + (l & 7) + ((l >> 4) << 3)) * ld + k0 + ((l >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* b_ptr(const bf16* s, int ld, int k0,
                                             int n0, int l) {
  return s + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8;
}
__device__ __forceinline__ const bf16* at_ptr(const bf16* s, int ld, int k0,
                                              int m0, int l) {
  return s + (k0 + (l & 7) + ((l >> 4) & 1) * 8) * ld + m0 +
         ((l >> 3) & 1) * 8;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [0, npad) of one head (d lanes from `src`, row stride e) into
// shared memory [npad][d + kPad] by cp.async; rows >= n (n >= 1) are zero.
// d is kD, or the runtime `d` where kD = 0.
template <int kD>
__device__ void stage_async(bf16* dst, const bf16* __restrict__ src, int n,
                            int npad, int e, int d = kD) {
  const int c8 = (kD ? kD : d) / 8, ld = (kD ? kD : d) + kPad;
  for (int i = threadIdx.x; i < npad * c8; i += blockDim.x) {
    const int row = i / c8, c = (i % c8) * 8;
    cp_async16(dst + row * ld + c,
               src + static_cast<size_t>(row < n ? row : n - 1) * e + c,
               row < n ? 16 : 0);
  }
}

// After this thread's copies of stage_async(dst, .., npad) landed: the same
// chunks become bf16(x * scale).
template <int kD>
__device__ void scale_rows(bf16* dst, int npad, float scale, int d = kD) {
  const int c8 = (kD ? kD : d) / 8, ld = (kD ? kD : d) + kPad;
  for (int i = threadIdx.x; i < npad * c8; i += blockDim.x) {
    uint4* p = reinterpret_cast<uint4*>(dst + (i / c8) * ld + (i % c8) * 8);
    uint4 raw = *p;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h2[t]);
      h2[t] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *p = raw;
  }
}

__device__ __forceinline__ void frag_of(uint32_t (&a)[4],
                                        const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

template <int kN>
__device__ __forceinline__ void zero(float (&c)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// Store 16 rows (from m0) x 8 kN columns (from col0) of f32 accumulators
// times f, as bf16, into dst with row stride e; rows >= nrows are skipped.
template <int kN>
__device__ __forceinline__ void store_rows(bf16* dst, int e, int m0, int col0,
                                           int nrows, const float (&c)[kN][4],
                                           float f, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int i = m0 + gid + 8 * row;
    if (i >= nrows) continue;
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(
          dst + static_cast<size_t>(i) * e + col0 + nt * 8 + tig * 2) =
          __floats2bfloat162_rn(c[nt][2 * row] * f, c[nt][2 * row + 1] * f);
  }
}

}  // namespace
