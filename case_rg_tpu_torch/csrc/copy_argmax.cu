// Duplicate-id copy-mass combine for the candidate argmax, for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel case_rg_tpu/kernels/copy_argmax.py
// (combine_copy_mass, bodies _kernel_unrolled and _kernel_looped). Same
// function as combine_copy_mass_xla:
//   comb[b, j] = sum_l cw[b, l] * [ids[b, l] == ids[b, j]],  summed in f32,
// so every member of a duplicate-id group carries the whole group's copy
// mass and a later argmax lands on the group's first position. cw [B, Ls]
// is f32 or bf16, ids [B, Ls] int32 >= 0 (padding positions carry id 0 and
// weight 0 and stay inert), comb [B, Ls] f32.
//
// What bounds it on an H100: bytes. The function needs per row a sort of
// its (id, position) pairs and a segmented sum, so
// B * Ls * (ceil(log2 Ls) + 2) operations in all: 0.88 M at the CaSE
// decode shape (B = 64, Ls = 60 + 10 * 100 = 1060), 0.013 us at
// 67 TFLOP/s. The bytes (bf16 weights and int32 ids in, f32 comb out:
// 0.68 MB) take 0.20 us at 3.35 TB/s. This kernel does more work than
// that: a compare, a select and an add for each of the B * Ls^2 = 71.9 M
// (l, j) pairs, about 144 M SIMT operations, ~2.1 us at 67 TFLOP/s, so it
// sits at ten times the bound before any overhead.
//
// What this design does about it: one block per (row, tile of 128
// positions j). The block stages its row's ids and weights in shared
// memory once (8 bytes a position: 8.5 KB at Ls = 1060, so tens of
// thousands of positions fit in a block's 227 KB and no second body is
// needed, unlike the TPU kernel, whose scoped VMEM forced a looped body past
// 10 chunks of 128). Each thread owns one j and walks l in order, four
// positions per 16-byte shared-memory read that every thread of the warp
// reads at the same address (a broadcast), and accumulates in f32. The sum
// order is fixed, so the result is deterministic, and every member of a
// group sums the same values in the same order, so a group's members carry
// bit-identical mass. B * ceil(Ls / 128) = 576 blocks fill the 132 SMs.
// A design that reaches the bound (one block per row: sort the ids,
// segmented sum) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ls: positions per row; lsp: ls rounded up to a multiple of 4 (the padded
// tail of the staged row carries id -1, which matches no id, and weight 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_copy_mass_kernel(const T* __restrict__ cw,
                         const int32_t* __restrict__ ids,
                         float* __restrict__ out, int ls, int lsp) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_ids = reinterpret_cast<int32_t*>(smem);
  float* s_cw = reinterpret_cast<float*>(smem + sizeof(int32_t) * lsp);
  const size_t row = static_cast<size_t>(blockIdx.y) * ls;
  for (int l = threadIdx.x; l < lsp; l += kThreads) {
    const bool in = l < ls;
    s_ids[l] = in ? ids[row + l] : -1;
    s_cw[l] = in ? to_f32(cw[row + l]) : 0.f;
  }
  __syncthreads();
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= ls) return;
  const int32_t id = s_ids[j];
  const int4* ids4 = reinterpret_cast<const int4*>(s_ids);
  const float4* cw4 = reinterpret_cast<const float4*>(s_cw);
  float acc = 0.f;
  for (int q = 0; q < lsp / 4; ++q) {
    const int4 i4 = ids4[q];
    const float4 w4 = cw4[q];
    acc += (i4.x == id) ? w4.x : 0.f;
    acc += (i4.y == id) ? w4.y : 0.f;
    acc += (i4.z == id) ? w4.z : 0.f;
    acc += (i4.w == id) ? w4.w : 0.f;
  }
  out[row + j] = acc;
}

template <typename T>
int launch(const void* cw, const void* ids, void* out, int b, int ls,
           int smem, cudaStream_t stream) {
  if (smem > kDefaultSmem)
    cudaFuncSetAttribute(combine_copy_mass_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((ls + kThreads - 1) / kThreads, b);
  combine_copy_mass_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(cw), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), ls, (ls + 3) / 4 * 4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for rows of `ls`
// positions.
int combine_copy_mass_smem_bytes(int ls) { return 8 * ((ls + 3) / 4 * 4); }

// cw [b, ls] (bf16 if cw_is_bf16, else f32), ids [b, ls] int32, out [b, ls]
// f32, all contiguous. Launches on `stream`; returns cudaGetLastError()
// (0 = launched).
int combine_copy_mass(const void* cw, int cw_is_bf16, const void* ids,
                      void* out, int b, int ls, void* stream) {
  if (b < 1 || ls < 1 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = combine_copy_mass_smem_bytes(ls);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cw_is_bf16 ? launch<__nv_bfloat16>(cw, ids, out, b, ls, smem, s)
                    : launch<float>(cw, ids, out, b, ls, smem, s);
}

}  // extern "C"
