// Double-hash slot math of the engine's Bloom filters, shared by the
// Bloom kernels (bloom.cu) and the fused lookup kernels (lookup.cu).
//
// Bit-identical to the host reference (_bloom_slots): truncate the key to
// int32, multiply in uint32 (wraps, no signed overflow), reinterpret as
// int32, take floor-mod by n_slots (C++ % truncates), and add j * h2 in
// int64 before the last mod.
#pragma once

#include <cstdint>

namespace repro_bloom {

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

// True iff all k_hashes slots of ``key`` are set in the filter of
// ``n_slots`` bytes at ``filt``.
__device__ __forceinline__ bool member(const uint8_t* __restrict__ filt,
                                       int32_t n_slots, int k_hashes,
                                       int64_t key) {
  int64_t h1, h2;
  hashes(key, n_slots, &h1, &h2);
  bool in = true;
  for (int j = 0; j < k_hashes; ++j) {
    in &= filt[(h1 + j * h2) % n_slots] != 0;
  }
  return in;
}

}  // namespace repro_bloom
