// probe_tier and probe_store: the fused read path over a device-resident
// view of one lookup tier (probe_tier) or of every lookup tier of a tree
// (probe_store). A view holds the tables' int64 key and value runs
// concatenated (each tier's segment is sorted: its tables are disjoint and
// min_key-ordered), their Bloom filters as one flat byte concatenation,
// and per global table t: the filter's slot offset f_offs[t] and slot
// count nslots[t], and the run's entry offset offs[t] and length lens[t].
// The host assigns every query its covering table of each tier
// (assign_bounds, clipped to the tier whether or not the query lies in
// it); the kernels compute, per (tier, query), from that table alone:
//
//   positive  all k Bloom slots set, with the table's own slot count as
//             the modulus;
//   pos       the lower bound of the query in the table's run, relative
//             to the run;
//   hit       pos < len and the key there equals the query;
//   val       the value there where hit, else 0.
//
// Output is one int64 buffer, so the host reads it back in one copy:
// probe_tier writes rows positive, pos, hit, val of [4, K]; probe_store
// writes [4 * R + 1, K]: R rows of each field, tier-major within a field,
// then win[q], the lowest (newest) tier rank that hit, or -1.
//
// Replace the TPU kernels probe_filters_multi (src/repro/kernels/bloom/
// bloom.py:118, paired with lookup_runs_device in merge/ops.py:164) and
// probe_filters_tiered (bloom.py:179, composed in merge/ops.py:188
// _store_probe with _ranged_lookup, a segment_sum over tables and the
// newest-wins argmin). Those loop the grid over every table of a
// zero-padded [T * 128, Wmax] filter stack and compare each query with
// every table; here a thread reads only its own table's filter bytes and
// binary-searches only its own table's run, so a table not assigned to a
// query is never touched. probe_store is one launch per lookup batch: a
// thread walks the R tiers newest-first, writes every tier's fields (the
// host's page-pin replay reads tiers after the winner too) and keeps the
// first hit as win, so no segment sum and no second pass.
//
// What bounds them on the H100: dependent loads. Each (tier, query) does
// k scattered filter reads and ceil(log2 len) dependent reads of the
// binary search; the view (tens of MB at the main path's sizes) stays in
// the 50 MB L2 across calls. At the main path's sizes (4096 queries, R <= 8)
// the grid is a few blocks and launch latency is the floor.
#include <cstdint>
#include <cuda_runtime.h>

#include "bloom_hash.cuh"

namespace {

struct View {
  const int64_t* keys;
  const int64_t* vals;
  const uint8_t* fbits;
  const int64_t* f_offs;
  const int64_t* nslots;
  const int64_t* offs;
  const int64_t* lens;
};

// Probe one query against global table t of the view; writes the four
// fields and returns hit.
__device__ __forceinline__ bool probe_one(const View& v, int64_t t,
                                          int k_hashes, int64_t key,
                                          int64_t* positive, int64_t* pos,
                                          int64_t* hit, int64_t* val) {
  *positive = repro_bloom::member(v.fbits + v.f_offs[t],
                                  static_cast<uint32_t>(v.nslots[t]),
                                  k_hashes, key);
  const int64_t off = v.offs[t];
  const int64_t end = off + v.lens[t];
  int64_t lo = off, hi = end;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (v.keys[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const bool h = lo < end && v.keys[lo] == key;
  *pos = lo - off;
  *hit = h;
  *val = h ? v.vals[lo] : 0;
  return h;
}

__global__ void probe_tier_kernel(View v, int k_hashes,
                                  const int64_t* __restrict__ q,
                                  const int64_t* __restrict__ ti, int64_t n,
                                  int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= n) return;
  probe_one(v, ti[i], k_hashes, q[i], out + i, out + n + i,
            out + 2 * n + i, out + 3 * n + i);
}

__global__ void probe_store_kernel(View v, const int64_t* __restrict__ t_off,
                                   int64_t n_tiers, int k_hashes,
                                   const int64_t* __restrict__ q,
                                   const int64_t* __restrict__ ti, int64_t n,
                                   int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= n) return;
  const int64_t key = q[i];
  const int64_t field = n_tiers * n;          // stride between fields
  int64_t win = -1;
  for (int64_t r = 0; r < n_tiers; ++r) {
    const int64_t at = r * n + i;
    const bool h = probe_one(v, t_off[r] + ti[at], k_hashes, key, out + at,
                             out + field + at, out + 2 * field + at,
                             out + 3 * field + at);
    if (h && win < 0) win = r;
  }
  out[4 * field + i] = win;
}

View make_view(const void* keys, const void* vals, const void* fbits,
               const void* f_offs, const void* nslots, const void* offs,
               const void* lens) {
  return View{static_cast<const int64_t*>(keys),
              static_cast<const int64_t*>(vals),
              static_cast<const uint8_t*>(fbits),
              static_cast<const int64_t*>(f_offs),
              static_cast<const int64_t*>(nslots),
              static_cast<const int64_t*>(offs),
              static_cast<const int64_t*>(lens)};
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int probe_tier(const void* keys, const void* vals,
                          const void* fbits, const void* f_offs,
                          const void* nslots, const void* offs,
                          const void* lens, int k_hashes, const void* q,
                          const void* ti, int64_t n, void* out,
                          void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  probe_tier_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      make_view(keys, vals, fbits, f_offs, nslots, offs, lens), k_hashes,
      static_cast<const int64_t*>(q), static_cast<const int64_t*>(ti), n,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_store(const void* keys, const void* vals,
                           const void* fbits, const void* f_offs,
                           const void* nslots, const void* offs,
                           const void* lens, const void* t_off,
                           int64_t n_tiers, int k_hashes, const void* q,
                           const void* ti, int64_t n, void* out,
                           void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  probe_store_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      make_view(keys, vals, fbits, f_offs, nslots, offs, lens),
      static_cast<const int64_t*>(t_off), n_tiers, k_hashes,
      static_cast<const int64_t*>(q), static_cast<const int64_t*>(ti), n,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
