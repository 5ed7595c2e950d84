// Duplicate-id copy-mass combine for the candidate argmax, for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel case_rg_tpu/kernels/copy_argmax.py
// (combine_copy_mass, bodies _kernel_unrolled and _kernel_looped). Same
// function as combine_copy_mass_xla:
//   comb[b, j] = sum_l cw[b, l] * [ids[b, l] == ids[b, j]],  summed in f32,
// so every member of a duplicate-id group carries the whole group's copy
// mass and a later argmax lands on the group's first position. cw [B, Ls]
// is f32 or bf16, ids [B, Ls] int32 (padding positions carry id 0 and
// weight 0), comb [B, Ls] f32.
//
// What bounds it on an H100: bytes. The function needs per row a sort of
// its (id, position) pairs and a segmented sum, so
// B * Ls * (ceil(log2 Ls) + 2) operations in all: 0.88 M at the CaSE
// decode shape (B = 64, Ls = 60 + 10 * 100 = 1060), 0.013 us at
// 67 TFLOP/s. The bytes (bf16 weights and int32 ids in, f32 comb out:
// 0.68 MB) take 0.20 us at 3.35 TB/s. A single launch of 64 blocks gets
// near neither: it costs the launch itself (about 2 us on an H100) and the
// chain of dependent steps inside a block. The first design compared every
// (l, j) pair, B * Ls^2 = 71.9 M compares (16 us a launch).
//
// What this design does about it: two bodies, chosen per shape by
// kernels/copy_argmax.combine_copy_mass_plan.
// - "sort" (384 < Ls <= 4096, every served shape): one block a row, n / 8
//   threads for n = Ls rounded up to a power of two (at least 256), each
//   holding 8 keys in registers, n a template argument so that the whole
//   network unrolls. The block reads the row at once (a thread's 8 ids; the
//   weights, striped, into shared memory), takes the row's largest id, and
//   packs each position's key as id << log2(n) | pos in 32 bits where that
//   fits (ids below 2^21 - 1 at n = 2048), else as id << 32 | pos in 64
//   bits; padding to n takes the largest key. A bitonic network sorts the
//   keys: strides below 8 within a thread's registers, below 256 by warp
//   shuffles, and the few larger ones through shared memory, one barrier
//   each (two buffers; a pad word every 8 keys keeps the exchanges free of
//   bank conflicts): 6 barriers at n = 2048 against 66 for a network of one
//   key a thread. Through a merge a thread's keys all run one way, so a
//   thread whose run descends holds them complemented and every step within
//   it is a min and a max. Then a segmented inclusive scan of the sorted
//   weights that also carries each group's head index (a thread's 8 keys in
//   order, a shuffle scan over the warp, the warps before in order: every
//   group, the long padding group too, is summed by many threads at once,
//   in an order fixed by the input). Each group's last member writes the
//   total into a slot indexed by the group's head, and every member copies
//   that slot to its original position. Every member carries one value, so
//   members are equal bit for bit, and no step depends on timing (no
//   atomics), so two launches are too. 11 barriers at n = 2048.
// - "brute" (short rows, where its few compares take less than the sort's
//   chain of steps: up to 384 positions on an H100; and rows longer than
//   the sort's 512 threads hold, up to 29056): one block a (row, tile of 128
//   positions j), the row's ids and weights staged in shared memory, each
//   thread walking every l for its j in order: B * Ls^2 compares, the first
//   design.
// A body that needs more than the 48 KB default of shared memory has its
// limit raised once per process and device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;          // brute body
constexpr int kKeys = 8;               // sort body: keys a thread holds
constexpr int kMinLog = 8;             // the sort's smallest n: 256 (a warp)
constexpr int kMaxLog = 12;            // its largest n: 4096 (512 threads)
constexpr int kBodySort = 0, kBodyBrute = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---- sort body ----

struct Agg {       // a segmented sum: a head seen, the sum since the last
  int f;           // head, and that head's sorted index
  float x;
  int h;
};

__host__ __device__ constexpr int xbuf_keys(int n) { return n + n / 8; }
__device__ __forceinline__ int padded(int e) { return e + (e >> 3); }

// Shared memory: the row's weights by position, f32 [n] (then its group
// sums by position); two exchange buffers of xbuf_keys(n) 64-bit keys (after
// the sort, the group totals by head index, f32 [n]); the warps' aggregates;
// the warps' largest ids, then their first and last group ids.
__host__ __device__ constexpr int sort_smem(int n) {
  return 4 * n + 2 * xbuf_keys(n) * 8 + 32 * 12 + 3 * 32 * 4;
}

// Ascending bitonic sort of kN keys, thread t holding sorted positions
// [t * kKeys, (t + 1) * kKeys); the network is unrolled whole. From merges
// of kKeys keys on, a thread's keys all run one way through a merge, so a
// thread whose run descends holds them complemented (~key reverses the
// order) and every step within the thread is a min and a max.
template <int kN, typename Key>
__device__ __forceinline__ void bitonic_sort(Key (&key)[kKeys], Key* xa,
                                             Key* xb) {
  const int t = threadIdx.x;
  const int e0 = t * kKeys;
  int second = 0;
  Key flip = 0;                               // ~0 while the run descends
#pragma unroll
  for (int k = 2; k <= kN; k <<= 1) {
    if (k >= kKeys) {
      const Key want = (e0 & k) ? ~Key(0) : Key(0);
#pragma unroll
      for (int r = 0; r < kKeys; ++r) key[r] ^= flip ^ want;
      flip = want;
    }
#pragma unroll
    for (int j = k >> 1; j >= kKeys; j >>= 1) {
      const int m = j / kKeys;                 // partner thread t ^ m
      const bool lower = (t & m) == 0;
      if (m < 32) {                            // within the warp
#pragma unroll
        for (int r = 0; r < kKeys; ++r) {
          const Key o = __shfl_xor_sync(0xffffffffu, key[r], m);
          key[r] = lower ? min(key[r], o) : max(key[r], o);
        }
      } else {                                 // across warps
        Key* x = second ? xb : xa;
        second ^= 1;
#pragma unroll
        for (int r = 0; r < kKeys; ++r) x[padded(e0 + r)] = key[r];
        __syncthreads();
        const int p0 = (t ^ m) * kKeys;
#pragma unroll
        for (int r = 0; r < kKeys; ++r) {
          const Key o = x[padded(p0 + r)];
          key[r] = lower ? min(key[r], o) : max(key[r], o);
        }
      }
    }
#pragma unroll
    for (int j = (k >> 1 < kKeys ? k >> 1 : kKeys / 2); j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {        // within the thread
        if (r & j) continue;
        const Key lo = min(key[r], key[r + j]), hi = max(key[r], key[r + j]);
        const bool asc = k >= kKeys || (r & k) == 0;
        key[r] = asc ? lo : hi;
        key[r + j] = asc ? hi : lo;
      }
    }
  }
}

// a then b, for segmented sums
__device__ __forceinline__ Agg combine(const Agg& a, const Agg& b) {
  return {a.f | b.f, b.f ? b.x : a.x + b.x, b.f ? b.h : a.h};
}

// Segmented inclusive scan over a warp's lanes.
__device__ __forceinline__ Agg warp_scan(Agg a, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Agg l = {__shfl_up_sync(0xffffffffu, a.f, o),
                   __shfl_up_sync(0xffffffffu, a.x, o),
                   __shfl_up_sync(0xffffffffu, a.h, o)};
    if (lane >= o) a = combine(l, a);
  }
  return a;
}

template <int kN, typename Key>
__device__ __forceinline__ void sort_body(const int32_t (&id)[kKeys],
                                          float* s_w, unsigned char* xbuf,
                                          Agg* s_agg, uint32_t* s_edge,
                                          float* out, int ls, int shift) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int warps = blockDim.x / 32;
  const int e0 = t * kKeys;
  Key key[kKeys];
#pragma unroll
  for (int r = 0; r < kKeys; ++r)
    key[r] = e0 + r < ls
                 ? (static_cast<Key>(static_cast<uint32_t>(id[r])) << shift)
                       | static_cast<Key>(e0 + r)
                 : ~Key(0);                    // padding: the largest key
  Key* xa = reinterpret_cast<Key*>(xbuf);
  bitonic_sort<kN>(key, xa, xa + xbuf_keys(kN));
  const auto gid = [&](int r) {
    return static_cast<uint32_t>(key[r] >> shift);
  };
  const auto pos = [&](int r) {
    return static_cast<int>(key[r] & static_cast<Key>(kN - 1));
  };
  // the group ids beside each thread's run: the lanes' by shuffles, the
  // warps' through shared memory
  if (lane == 0) s_edge[warp] = gid(0);
  if (lane == 31) s_edge[32 + warp] = gid(kKeys - 1);
  __syncthreads();                    // (also: the buffers take new roles)
  // phase sort
  uint32_t prev = __shfl_up_sync(0xffffffffu, gid(kKeys - 1), 1);
  uint32_t next = __shfl_down_sync(0xffffffffu, gid(0), 1);
  if (lane == 0) prev = warp > 0 ? s_edge[32 + warp - 1] : ~gid(0);
  if (lane == 31) next = warp + 1 < warps ? s_edge[warp + 1] : ~gid(kKeys - 1);

  // segmented inclusive sums, each with its group's head: the thread's
  // keys in order, then the lanes before it, then the warps before it
  float v[kKeys];
  int hd[kKeys];
  bool seen[kKeys];
  Agg a = {0, 0.f, 0};
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    const bool head = gid(r) != prev;
    prev = gid(r);
    a = combine(a, Agg{head, s_w[pos(r)], e0 + r});  // a pad weighs 0
    v[r] = a.x;
    hd[r] = a.h;
    seen[r] = a.f;
  }
  const Agg inc = warp_scan(a, lane);
  Agg carry = {__shfl_up_sync(0xffffffffu, inc.f, 1),
               __shfl_up_sync(0xffffffffu, inc.x, 1),
               __shfl_up_sync(0xffffffffu, inc.h, 1)};
  if (lane == 0) carry = {0, 0.f, 0};
  if (lane == 31) s_agg[warp] = inc;
  __syncthreads();
  Agg before = {0, 0.f, 0};            // the warps before, in order
  for (int w = 0; w < warp; ++w) before = combine(before, s_agg[w]);
  carry = combine(before, carry);
  // phase segmented scan
  // a group's last member puts the total where its head's index points
  float* s_tot = reinterpret_cast<float*>(xbuf);
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    if (!seen[r]) {
      v[r] = carry.x + v[r];
      hd[r] = carry.h;
    }
    if (gid(r) != (r + 1 < kKeys ? gid(r + 1 < kKeys ? r + 1 : r) : next))
      s_tot[hd[r]] = v[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kKeys; ++r)
    if (pos(r) < ls) s_w[pos(r)] = s_tot[hd[r]];
  __syncthreads();
  // phase group totals
  for (int e = t; e < ls; e += blockDim.x) out[e] = s_w[e];
  // phase store
}

template <int kLog>
__global__ void __launch_bounds__((1 << kLog) / kKeys, 1)
combine_sort_kernel(const void* __restrict__ cw, int cw_is_bf16,
                    const int32_t* __restrict__ ids,
                    float* __restrict__ out, int ls) {
  constexpr int kN = 1 << kLog;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_w = reinterpret_cast<float*>(smem);
  unsigned char* xbuf = smem + 4 * kN;
  Agg* s_agg = reinterpret_cast<Agg*>(xbuf + 2 * xbuf_keys(kN) * 8);
  uint32_t* s_max = reinterpret_cast<uint32_t*>(s_agg + 32);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const size_t row = static_cast<size_t>(blockIdx.x) * ls;
  // phase start

  // the row, read at once: this thread's ids, and the weights striped
  int32_t id[kKeys];
  uint32_t mx = 0;
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    const int e = t * kKeys + r;
    id[r] = e < ls ? __ldg(ids + row + e) : 0;
  }
  if (cw_is_bf16) {
    const __nv_bfloat16* c = static_cast<const __nv_bfloat16*>(cw) + row;
    for (int e = t; e < kN; e += blockDim.x)
      s_w[e] = e < ls ? to_f32(c[e]) : 0.f;
  } else {
    const float* c = static_cast<const float*>(cw) + row;
    for (int e = t; e < kN; e += blockDim.x) s_w[e] = e < ls ? c[e] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kKeys; ++r)
    mx = max(mx, static_cast<uint32_t>(id[r]));
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) s_max[warp] = mx;
  __syncthreads();
  // phase load
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w)
    mx = max(mx, s_max[w]);
  // 32-bit keys where id << kLog | pos stays below the pad key and the
  // pad's group id is no real id
  if (mx < (0xffffffffu >> kLog))
    sort_body<kN, uint32_t>(id, s_w, xbuf, s_agg, s_max + 32, out + row,
                            ls, kLog);
  else
    sort_body<kN, unsigned long long>(id, s_w, xbuf, s_agg, s_max + 32,
                                      out + row, ls, 32);
}

// ---- brute body ----

// ls: positions per row; lsp: ls rounded up to a multiple of 4 (the padded
// tail of the staged row carries id -1, which matches no id, and weight 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_brute_kernel(const T* __restrict__ cw,
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

int sort_log(int ls) {
  int lg = kMinLog;
  while ((1 << lg) < ls) ++lg;
  return lg;
}

template <int kLog>
int launch_sort(const void* cw, int cw_is_bf16, const int32_t* ids,
                float* out, int b, int ls, int smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(combine_sort_kernel<kLog>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_sort_kernel<kLog><<<b, (1 << kLog) / kKeys, smem, stream>>>(
      cw, cw_is_bf16, ids, out, ls);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_brute(const void* cw, const int32_t* ids, float* out, int b,
                 int ls, int smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(combine_brute_kernel<T>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((ls + kThreads - 1) / kThreads, b);
  combine_brute_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(cw), ids, out, ls, (ls + 3) / 4 * 4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the body (0 = sort, 1 =
// brute) needs for rows of `ls` positions; -1 where the body does not take
// them (the sort holds at most 4096 positions).
int combine_copy_mass_smem_bytes(int body, int ls) {
  if (ls < 1) return -1;
  if (body == kBodySort)
    return ls <= (1 << kMaxLog) ? sort_smem(1 << sort_log(ls)) : -1;
  if (body == kBodyBrute) return 8 * ((ls + 3) / 4 * 4);
  return -1;
}

// cw [b, ls] (bf16 if cw_is_bf16, else f32), ids [b, ls] int32, out [b, ls]
// f32, all contiguous. Launches the body on `stream`; returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for shapes
// the body does not take.
int combine_copy_mass(int body, const void* cw, int cw_is_bf16,
                      const void* ids, void* out, int b, int ls,
                      void* stream) {
  const int smem = combine_copy_mass_smem_bytes(body, ls);
  if (b < 1 || b > 65535 || smem < 0 || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* i = static_cast<const int32_t*>(ids);
  float* o = static_cast<float*>(out);
  if (body == kBodyBrute)
    return cw_is_bf16 ? launch_brute<__nv_bfloat16>(cw, i, o, b, ls, smem, s)
                      : launch_brute<float>(cw, i, o, b, ls, smem, s);
  switch (sort_log(ls)) {
    case 8: return launch_sort<8>(cw, cw_is_bf16, i, o, b, ls, smem, s);
    case 9: return launch_sort<9>(cw, cw_is_bf16, i, o, b, ls, smem, s);
    case 10: return launch_sort<10>(cw, cw_is_bf16, i, o, b, ls, smem, s);
    case 11: return launch_sort<11>(cw, cw_is_bf16, i, o, b, ls, smem, s);
    default: return launch_sort<12>(cw, cw_is_bf16, i, o, b, ls, smem, s);
  }
}

}  // extern "C"
