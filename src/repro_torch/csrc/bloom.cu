// bloom_build, bloom_probe and bloom_probe_tier: the per-SSTable Bloom
// filter of the LSM engine, one byte per slot, laid out as bool
// [128, n_slots / 128] (slot = row * W + col, so the flat index is the
// slot).
//
// Replace the TPU kernels build_filter (src/repro/kernels/bloom/bloom.py:64,
// body _build_kernel) and probe_filter (bloom.py:212, body _probe_kernel);
// bloom_probe_tier computes, per query, probe_filter against its own
// table's filter, the per-query function of probe_filters_multi
// (bloom.py:118). The TPU kernels accumulate int32 counts into a [128, W]
// VMEM block through one-hot compares, a TPU artifact: here a thread sets
// or tests one byte per (key, hash) pair, and racing stores of the same
// byte are benign because they all store 1.
//
// bloom_build has two paths, chosen by the filter's size alone; both
// write every byte of the filter, so the caller allocates it
// uninitialised:
//
//   shared  up to kSharedMaxSlots slots: one block zeroes the filter in
//           shared memory, walks every key and sets its k slots with
//           shared-memory byte stores, then writes the filter out with
//           coalesced 16-byte stores. A thread's first keys load while the
//           filter is zeroed. Bound by the one SM's walk: k slots per key
//           on 1,024 threads, and launch latency.
//   global  above: cudaMemsetAsync zeroes the filter, then eight threads
//           a key each store the slots j = lane, lane + 8, ... of their
//           key straight into device memory, one random byte store (a
//           32 B sector in L2) per (key, hash) pair, spread over the whole
//           card. Bound by the scattered stores and, for small filters,
//           by the memset's and the kernel's launch latency.
//
// kSharedMaxSlots is the crossover that tools/bloom_paths.py measures on
// the card (it builds copies of this file with the constant changed): the
// smallest size at which the global path's device time is below the
// shared path's. On an H100 80GB HBM3 at 700 W, the device time of a
// whole call is 1.64 us shared against 2.46 global (memset included) at
// 256 keys and 2.85 against 3.17 at 2,048 (20,480 slots, the engine's
// tables); at 4,096 keys it is 4.17 against 3.54 and at 16,384 12.9
// against 5.25: past 2,048 keys the walk that one SM makes over every key
// outgrows a memset and a scatter over 132 SMs. The shared path can hold
// at most kMaxSharedSlots (227 KB, 16,384 keys at 10 bits a key).
//
// bloom_probe (one filter) and bloom_probe_tier (a table of filter
// pointers and slot counts, and each query's table) are one kernel: one
// thread per query, k read-only byte loads from the filter. A tier's
// filters (20 KB per 2,048-key table) sit in the 50 MB L2, so the bound is
// the dependent loads; at the engine's sizes launch latency is the floor,
// and one launch serves every table a Get batch reaches in a tier.
//
// Hash math and the slot walk without 64-bit %: bloom_hash.cuh, shared
// with the fused lookup kernels.
#include <cstdint>
#include <cuda_runtime.h>

#include "bloom_hash.cuh"

namespace {

using repro_bloom::hashes;
using repro_bloom::next_slot;

constexpr int kBuildThreads = 1024;
constexpr int kKeysPerThread = 4;               // key loads in flight
constexpr uint32_t kMaxSharedSlots = 232448;    // 227 KB of shared memory
constexpr uint32_t kSharedMaxSlots = 20480;     // shared up to here
static_assert(kSharedMaxSlots <= kMaxSharedSlots, "one block's filter");
constexpr int kLanesPerKey = 8;                 // global path
constexpr int kThreads = 256;

// Keys i, i + blockDim.x, ... of the kKeysPerThread starting at ``base``
// (0 past n): the loads are all in flight before the first is used.
__device__ __forceinline__ void load_keys(const int64_t* __restrict__ keys,
                                          int64_t n, int64_t base,
                                          int64_t* k) {
#pragma unroll
  for (int u = 0; u < kKeysPerThread; ++u) {
    const int64_t i = base + static_cast<int64_t>(u) * blockDim.x;
    k[u] = i < n ? keys[i] : 0;
  }
}

__global__ void __launch_bounds__(kBuildThreads)
bloom_build_kernel_shared(const int64_t* __restrict__ keys, int64_t n,
                          uint32_t n_slots, int k_hashes,
                          uint8_t* __restrict__ filt) {
  extern __shared__ uint4 smem[];
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem);
  const uint32_t words = n_slots / 16;    // n_slots is a multiple of 128
  const int64_t stride = static_cast<int64_t>(blockDim.x) * kKeysPerThread;
  int64_t k[kKeysPerThread];
  load_keys(keys, n, threadIdx.x, k);     // in flight while smem zeroes
  for (uint32_t i = threadIdx.x; i < words; i += blockDim.x) {
    smem[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  for (int64_t base = threadIdx.x; base < n; base += stride) {
#pragma unroll
    for (int u = 0; u < kKeysPerThread; ++u) {
      if (base + static_cast<int64_t>(u) * blockDim.x >= n) break;
      uint32_t s, h2;
      hashes(k[u], n_slots, &s, &h2);
      for (int j = 0; j < k_hashes; ++j) {
        bytes[s] = 1;
        s = next_slot(s, h2, n_slots);
      }
    }
    if (base + stride < n) load_keys(keys, n, base + stride, k);
  }
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(filt);
  for (uint32_t i = threadIdx.x; i < words; i += blockDim.x) {
    out[i] = smem[i];
  }
}

// Lane l of a key's kLanesPerKey threads stores slots l, l + 8, ...: each
// lane walks all k slots (no division, no 64-bit %) and stores its own.
__global__ void bloom_build_kernel_global(const int64_t* __restrict__ keys,
                                          int64_t n, uint32_t n_slots,
                                          int k_hashes,
                                          uint8_t* __restrict__ filt) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  const int64_t i = t / kLanesPerKey;
  const int lane = static_cast<int>(t % kLanesPerKey);
  if (i >= n || lane >= k_hashes) return;
  uint32_t s, h2;
  hashes(keys[i], n_slots, &s, &h2);
  for (int j = 0; j < k_hashes; ++j) {
    if (j % kLanesPerKey == lane) filt[s] = 1;
    s = next_slot(s, h2, n_slots);
  }
}

// tidx == nullptr: every query against ``filt`` of ``n_slots`` slots.
// Otherwise query q against table t = tidx[q] of ``tables``: int64 [2, T],
// row 0 the filters' device addresses, row 1 their slot counts.
__global__ void bloom_probe_kernel(const uint8_t* __restrict__ filt,
                                   uint32_t n_slots,
                                   const int64_t* __restrict__ tables,
                                   int64_t n_tables,
                                   const int64_t* __restrict__ tidx,
                                   int k_hashes,
                                   const int64_t* __restrict__ keys,
                                   int64_t n, uint8_t* __restrict__ out) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (q >= n) return;
  if (tidx != nullptr) {
    const int64_t t = tidx[q];
    filt = reinterpret_cast<const uint8_t*>(tables[t]);
    n_slots = static_cast<uint32_t>(tables[n_tables + t]);
  }
  out[q] = repro_bloom::member(filt, n_slots, k_hashes, keys[q]);
}

int build_shared(const int64_t* keys, int64_t n, uint32_t n_slots,
                 int k_hashes, uint8_t* filt, cudaStream_t stream) {
  // Needed above 48 KB, where tools/bloom_paths.py moves the constant.
  static const cudaError_t attr = cudaFuncSetAttribute(
      bloom_build_kernel_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSharedMaxSlots));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  bloom_build_kernel_shared<<<1, kBuildThreads, n_slots, stream>>>(
      keys, n, n_slots, k_hashes, filt);
  return static_cast<int>(cudaGetLastError());
}

int build_global(const int64_t* keys, int64_t n, uint32_t n_slots,
                 int k_hashes, uint8_t* filt, cudaStream_t stream) {
  const cudaError_t rc = cudaMemsetAsync(filt, 0, n_slots, stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t threads = n * kLanesPerKey;
  if (threads > 0) {
    bloom_build_kernel_global<<<static_cast<unsigned>((threads + kThreads - 1)
                                                      / kThreads),
                                kThreads, 0, stream>>>(keys, n, n_slots,
                                                       k_hashes, filt);
  }
  return static_cast<int>(cudaGetLastError());
}

int probe(const uint8_t* filt, uint32_t n_slots, const int64_t* tables,
          int64_t n_tables, const int64_t* tidx, int k_hashes,
          const int64_t* keys, int64_t n, uint8_t* out, cudaStream_t stream) {
  bloom_probe_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(filt, n_slots, tables, n_tables,
                                              tidx, k_hashes, keys, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ``filt`` is 16-byte aligned and n_slots a positive multiple of 128 below
// 2**31 (the wrapper checks both).
extern "C" int bloom_build(const void* keys, int64_t n, int32_t n_slots,
                           int k_hashes, void* filt, void* stream) {
  const auto* k = static_cast<const int64_t*>(keys);
  auto* f = static_cast<uint8_t*>(filt);
  const auto ns = static_cast<uint32_t>(n_slots);
  const auto s = static_cast<cudaStream_t>(stream);
  return ns <= kSharedMaxSlots ? build_shared(k, n, ns, k_hashes, f, s)
                               : build_global(k, n, ns, k_hashes, f, s);
}

extern "C" int bloom_probe(const void* filt, int32_t n_slots, int k_hashes,
                           const void* keys, int64_t n, void* out,
                           void* stream) {
  return probe(static_cast<const uint8_t*>(filt),
               static_cast<uint32_t>(n_slots), nullptr, 0, nullptr, k_hashes,
               static_cast<const int64_t*>(keys), n,
               static_cast<uint8_t*>(out), static_cast<cudaStream_t>(stream));
}

// tables: int64 [2, n_tables] (filter addresses, slot counts); tidx: int64
// [n], each in [0, n_tables).
extern "C" int bloom_probe_tier(const void* tables, int64_t n_tables,
                                int k_hashes, const void* keys,
                                const void* tidx, int64_t n, void* out,
                                void* stream) {
  return probe(nullptr, 0, static_cast<const int64_t*>(tables), n_tables,
               static_cast<const int64_t*>(tidx), k_hashes,
               static_cast<const int64_t*>(keys), n,
               static_cast<uint8_t*>(out), static_cast<cudaStream_t>(stream));
}
