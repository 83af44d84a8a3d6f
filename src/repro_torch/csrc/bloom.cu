// bloom_build and bloom_probe: the per-SSTable Bloom filter of the LSM
// engine, one byte per slot, laid out as bool [128, n_slots / 128]
// (slot = row * W + col, so the flat index is the slot).
//
// Replace the TPU kernels build_filter (src/repro/kernels/bloom/bloom.py:64,
// body _build_kernel) and probe_filter (bloom.py:212, body _probe_kernel).
// Those accumulate int32 counts into a [128, W] VMEM block through one-hot
// compares, a TPU artifact: here a thread stores one byte per (key, hash)
// pair, and racing stores of the same byte are benign because they all
// store 1.
//
// What bounds them on the H100: scattered memory traffic. Every slot a key
// touches is a random byte, so each access moves one 32 B sector; the
// filters of the engine's tables (2.5 KB to 10 MB) sit in L2 after the
// first touch. At the main path's sizes launch latency is the floor.
//
// Hash math, bit-identical to the host reference (_bloom_slots): truncate
// the key to int32, multiply in uint32 (wraps, no signed overflow),
// reinterpret as int32, take floor-mod by n_slots (C++ % truncates), and
// add j * h2 in int64 before the last mod.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kC1 = 0x9E3779B1u;
constexpr uint32_t kC2 = 0x85EBCA77u;

__device__ __forceinline__ int64_t floor_mod(int32_t x, int32_t n) {
  int32_t r = x % n;
  if (r < 0) r += n;
  return r;
}

__device__ __forceinline__ void hashes(int64_t key, int32_t n_slots,
                                       int64_t* h1, int64_t* h2) {
  const uint32_t u = static_cast<uint32_t>(static_cast<uint64_t>(key));
  *h1 = floor_mod(static_cast<int32_t>(u * kC1), n_slots);
  *h2 = floor_mod(static_cast<int32_t>((u * kC2) | 1u), n_slots);
}

__global__ void bloom_build_kernel(const int64_t* __restrict__ keys,
                                   int64_t n, int32_t n_slots, int k_hashes,
                                   uint8_t* __restrict__ filt) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n * k_hashes) return;
  const int64_t i = t / k_hashes;
  const int64_t j = t - i * k_hashes;
  int64_t h1, h2;
  hashes(keys[i], n_slots, &h1, &h2);
  filt[(h1 + j * h2) % n_slots] = 1;
}

__global__ void bloom_probe_kernel(const uint8_t* __restrict__ filt,
                                   int32_t n_slots, int k_hashes,
                                   const int64_t* __restrict__ keys,
                                   int64_t n, uint8_t* __restrict__ out) {
  int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n) return;
  int64_t h1, h2;
  hashes(keys[q], n_slots, &h1, &h2);
  uint8_t member = 1;
  for (int j = 0; j < k_hashes; ++j) {
    member &= filt[(h1 + j * h2) % n_slots] != 0;
  }
  out[q] = member;
}

}  // namespace

extern "C" int bloom_build(const void* keys, int64_t n, int32_t n_slots,
                           int k_hashes, void* filt, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n * k_hashes + threads - 1) / threads;
  bloom_build_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), n, n_slots, k_hashes,
      static_cast<uint8_t*>(filt));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bloom_probe(const void* filt, int32_t n_slots, int k_hashes,
                           const void* keys, int64_t n, void* out,
                           void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  bloom_probe_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(filt), n_slots, k_hashes,
      static_cast<const int64_t*>(keys), n, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
