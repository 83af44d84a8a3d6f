// Double-hash slot math of the engine's Bloom filters, shared by the
// Bloom kernels (bloom.cu) and the fused lookup kernels (lookup.cu).
//
// Bit-identical to the host reference (_bloom_slots): truncate the key to
// int32, multiply in uint32 (wraps, no signed overflow), reinterpret as
// int32 and take floor-mod by n_slots (C++ % truncates) for h1 and h2;
// slot j is (h1 + j * h2) mod n_slots.
//
// The slot walk needs no 64-bit %: h1, h2 < n_slots < 2**31, so slot j + 1
// is slot j + h2 less n_slots where the sum reaches n_slots, and that sum
// stays below 2**32 in uint32. Every slot then equals the reference's
// (h1 + j * h2) mod n_slots exactly.
#pragma once

#include <cstdint>

namespace repro_bloom {

constexpr uint32_t kC1 = 0x9E3779B1u;
constexpr uint32_t kC2 = 0x85EBCA77u;

__device__ __forceinline__ uint32_t floor_mod(int32_t x, int32_t n) {
  int32_t r = x % n;
  if (r < 0) r += n;
  return static_cast<uint32_t>(r);
}

__device__ __forceinline__ void hashes(int64_t key, uint32_t n_slots,
                                       uint32_t* h1, uint32_t* h2) {
  const uint32_t u = static_cast<uint32_t>(static_cast<uint64_t>(key));
  const int32_t n = static_cast<int32_t>(n_slots);
  *h1 = floor_mod(static_cast<int32_t>(u * kC1), n);
  *h2 = floor_mod(static_cast<int32_t>((u * kC2) | 1u), n);
}

// Slot j + 1 from slot j (both < n_slots).
__device__ __forceinline__ uint32_t next_slot(uint32_t s, uint32_t h2,
                                              uint32_t n_slots) {
  s += h2;
  return s >= n_slots ? s - n_slots : s;
}

// True iff all k_hashes slots of ``key`` are set in the filter of
// ``n_slots`` bytes at ``filt`` (read through the read-only path).
__device__ __forceinline__ bool member(const uint8_t* __restrict__ filt,
                                       uint32_t n_slots, int k_hashes,
                                       int64_t key) {
  uint32_t s, h2;
  hashes(key, n_slots, &s, &h2);
  bool in = true;
  for (int j = 0; j < k_hashes; ++j) {
    in &= __ldg(filt + s) != 0;
    s = next_slot(s, h2, n_slots);
  }
  return in;
}

}  // namespace repro_bloom
