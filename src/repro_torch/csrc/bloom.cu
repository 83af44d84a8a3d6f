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
// Hash math: bloom_hash.cuh, shared with the fused lookup kernels.
#include <cstdint>
#include <cuda_runtime.h>

#include "bloom_hash.cuh"

namespace {

using repro_bloom::hashes;

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
  out[q] = repro_bloom::member(filt, n_slots, k_hashes, keys[q]);
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
