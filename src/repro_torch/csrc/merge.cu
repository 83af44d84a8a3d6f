// K1: stable merge of sorted int64 runs, newest run first, with the
// first-occurrence keep flag of every output slot.
//
// Replaces the TPU kernel merge_tiles (src/repro/kernels/merge/merge.py:68,
// body _merge_kernel) and its composition in src/repro/kernels/merge/ops.py
// (_diag_splits, merge_sorted_runs, merge_runs_dedup, ingest_run,
// merge_runs_device). That kernel ranks each element of a 512-wide tile
// pair by cross-tile compare counts and scatters keys and values through
// exact one-hot f32 matmuls on 15-bit halves, a layout forced by the TPU's
// matrix unit and its int32 lanes; the host folds k runs pairwise. None of
// that carries over. Keys and values stay int64 with explicit lengths: no
// sentinel padding, no limit on the key range.
//
// Ranks. Runs 0..k-1 are newest first; run s spans [offs[s], offs[s+1]).
// Element j of run r with key x goes to slot
//   j + sum over newer s < r of #{keys of s <= x}
//     + sum over older s > r of #{keys of s <  x}.
// These slots are a permutation of [0, n) even when runs hold duplicates,
// and they order equal keys newest run first, each run's copies in run
// order: the stable merge. So a slot holds the first occurrence of its key
// iff its element is the first x of its own run and no newer run holds x,
// which a thread reads off the runs it has searched anyway (the newer run
// holds x iff the key just below its count is x). No thread reads the
// output. For k = 2 this is rank(a[i]) = i + #{b < a[i]}, rank(b[j]) =
// j + #{a <= b[j]}.
//
// Tiles (k = 2). Output diagonal d splits at the largest ai with
// a[ai-1] <= b[d-ai] (A wins ties), as _diag_splits does: the first d
// slots are a[0, ai) and b[0, d-ai). Ties across a split are safe: all of
// A's copies of a key precede B's, so a split inside a run of equal keys
// only decides which tile writes which copy. A tile's keep flags compare
// each slot with the one before it; at the tile's first slot that is slot
// d0 - 1, the larger of the last keys before the split, read from the
// runs.
//
// Routes, chosen inside merge_runs by (k, n) alone and reported to the
// caller through ``route``:
//
//   shared      two runs of at most kSharedMaxPairKeys keys in all, or
//               k != 2 runs of at most kSharedMaxKeys (k <= kSharedMaxRuns):
//               each block stages the offsets and every key of the call in
//               shared memory, and each thread ranks kRankItems elements by
//               k - 1 binary searches there, writing key, value and flag
//               to the slot. Scans (about 100 entries a run), flushes,
//               ingest batches whose halves join, most disk merges. Bound
//               by latency: the staging loads, then the dependent searches
//               of one block (4-30 us up to 24,576 keys).
//   merge_path  two runs above kSharedMaxPairKeys (a level merge once the
//               host joins a level's adjacent tables; ingest batches whose
//               halves overlap; the timed 2^20 + 2^20 pair): one block per
//               output tile of kTile = 256 threads x 4 slots. Two warps
//               find the tile's two diagonal splits, 32 candidates a round;
//               the block copies its A and B windows into shared memory
//               with cp.async (keys in one group, values in a second that
//               lands while the keys merge); each thread finds its own
//               split in shared memory and merges its 4 slots serially,
//               deciding the flags in the same pass; the stores go out
//               coalesced through shared memory. Bound by bytes: 16 B read
//               and 17 B written per element. 19 KB of shared memory a
//               block lets 8 blocks (2,048 threads) share an SM to keep
//               loads in flight; of the tile shapes that
//               tools/merge_paths.py --tiles tries, this one was the
//               quickest at 2^20 + 2^20 keys.
//   global      k != 2 runs above kSharedMaxKeys (runs that do not join):
//               the shared route's ranking from device memory. Rare on the
//               engine's path; bound by the dependent loads of k - 1
//               binary searches.
//
// kSharedMaxPairKeys and kSharedMaxKeys are what tools/merge_paths.py
// measures on the card (it builds copies of this file with both changed;
// --tiles does the same for the tile's shape). On an H100 80GB HBM3 at
// 700 W, a call's device time in a CUDA graph, the reading PERF.md §6
// gives: two runs, shared 2.55 us against merge_path 2.95 at 256 keys and
// 3.58 against 3.09 at 512, then merge_path ahead at every size up to
// 24,576 (9.97 against 4.79); three, four or eight runs, shared ahead of
// global from 256 keys up to the largest size one block holds (24,576:
// 13.2 against 18.9 for k = 3, 28.1 against 52.1 for k = 8). At 256 keys
// the two k-run routes lie within 0.4 us of each other and other runs of
// the tool put global ahead there by up to 0.2 us; from 512 keys shared
// leads by 0.5 us or more in every run.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileThreads = 256;
constexpr int kTileItems = 4;
constexpr int kTile = kTileThreads * kTileItems;   // a merge_path block
constexpr int kRankThreads = 256;
constexpr int kRankItems = 4;                      // elements a rank thread
constexpr int kMaxSharedBytes = 232448;            // 227 KB a block
constexpr int kSharedMaxRuns = 64;
constexpr int64_t kMaxSharedKeys =
    kMaxSharedBytes / 8 - (kSharedMaxRuns + 1);
// The shared route's crossovers (tools/merge_paths.py, see above): two runs
// leave it for merge-path tiles above kSharedMaxPairKeys keys, any other
// number of runs for the global route above kSharedMaxKeys, the largest
// size measured that one block's shared memory holds.
constexpr int64_t kSharedMaxPairKeys = 256;
constexpr int64_t kSharedMaxKeys = 24576;
static_assert(kSharedMaxKeys <= kMaxSharedKeys, "one block's keys");
static_assert(kSharedMaxPairKeys <= kMaxSharedKeys, "one block's keys");

enum Route : int { kRouteShared = 0, kRouteMergePath = 1, kRouteGlobal = 2 };

int route_of(int k, int64_t n) {
  if (k == 2) return n <= kSharedMaxPairKeys ? kRouteShared : kRouteMergePath;
  return n <= kSharedMaxKeys && k <= kSharedMaxRuns ? kRouteShared
                                                    : kRouteGlobal;
}

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a < b ? b : a;
}

// First position in x[lo, hi) whose key is >= v (lower) or > v (upper).
__device__ __forceinline__ int64_t lower_bound(const int64_t* x, int64_t lo,
                                               int64_t hi, int64_t v) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (x[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int64_t upper_bound(const int64_t* x, int64_t lo,
                                               int64_t hi, int64_t v) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (x[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// packed: int64 [k + 1 + 2n], the offsets, the keys and the values of the
// runs back to back. With kStaged the offsets and keys are first copied to
// shared memory (the shared route), else read in place (the global route).
template <bool kStaged>
__global__ void __launch_bounds__(kRankThreads) merge_rank_kernel(
    const int64_t* __restrict__ packed, int k, int64_t n,
    int64_t* __restrict__ out_k, int64_t* __restrict__ out_v,
    uint8_t* __restrict__ keep) {
  extern __shared__ int64_t staged[];
  const int64_t* offs = packed;
  const int64_t* keys = packed + k + 1;
  const int64_t* vals = keys + n;
  if (kStaged) {
    for (int64_t i = threadIdx.x; i < k + 1 + n; i += kRankThreads)
      staged[i] = packed[i];
    __syncthreads();
    offs = staged;
    keys = staged + k + 1;
  }
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kRankThreads * kRankItems +
      threadIdx.x;
  for (int u = 0; u < kRankItems; ++u) {
    const int64_t i = base + static_cast<int64_t>(u) * kRankThreads;
    if (i >= n) return;
    const int64_t x = keys[i];
    int r = 0, hi = k - 1;            // the run of i: the last r, offs[r] <= i
    while (r < hi) {
      const int mid = (r + hi + 1) >> 1;
      if (offs[mid] <= i) r = mid; else hi = mid - 1;
    }
    int64_t rank = i - offs[r];
    bool first = i == offs[r] || keys[i - 1] != x;
    for (int s = 0; s < r; ++s) {     // newer runs: their copies of x first
      const int64_t c = upper_bound(keys, offs[s], offs[s + 1], x);
      rank += c - offs[s];
      first = first && !(c > offs[s] && keys[c - 1] == x);
    }
    for (int s = r + 1; s < k; ++s)   // older runs: their copies of x after
      rank += lower_bound(keys, offs[s], offs[s + 1], x) - offs[s];
    out_k[rank] = x;
    out_v[rank] = vals[i];
    keep[rank] = first ? 1 : 0;
  }
}

// The split of output diagonal d: the largest ai in [max(0, d - nb),
// min(d, na)] with a[ai-1] <= b[d-ai]. One warp tests 32 evenly spaced
// candidates a round (the test is true up to the split and false after),
// so 2^20 candidates take 4 rounds of loads. Inside the range both
// indices are in bounds; the lower end needs no test.
__device__ int64_t diagonal_split(const int64_t* ak, int64_t na,
                                  const int64_t* bk, int64_t nb, int64_t d,
                                  int lane) {
  int64_t lo = d > nb ? d - nb : 0;
  int64_t hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t c = lo + (lane + 1) * step;
    const bool ok = c <= hi && ak[c - 1] <= bk[d - c];
    lo += __popc(__ballot_sync(0xffffffffu, ok)) * step;
    hi = imin(hi, lo + step - 1);
  }
  return lo;
}

__device__ __forceinline__ void cp_async8(void* dst, const int64_t* src) {
  const auto s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One block per output tile [d0, d0 + kTile) of the pair in ``packed``
// (k = 2: the offsets 0, na, n, then the keys and the values of A and B).
__global__ void __launch_bounds__(kTileThreads) merge_path_kernel(
    const int64_t* __restrict__ packed, int64_t* __restrict__ out_k,
    int64_t* __restrict__ out_v, uint8_t* __restrict__ keep) {
  __shared__ int64_t s_key[kTile];
  __shared__ int64_t s_val[kTile];
  __shared__ int16_t s_src[kTile];
  __shared__ uint8_t s_keep[kTile];
  __shared__ int64_t s_split[2];
  __shared__ int64_t s_prev;
  __shared__ int s_has_prev;
  const int64_t na = packed[1];
  const int64_t n = packed[2];
  const int64_t nb = n - na;
  const int64_t* ak = packed + 3;
  const int64_t* bk = ak + na;
  const int64_t* av = ak + n;
  const int64_t* bv = av + na;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t d1 = imin(d0 + kTile, n);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < 2) {
    const int64_t a = diagonal_split(ak, na, bk, nb, warp == 0 ? d0 : d1,
                                     lane);
    if (lane == 0) {
      s_split[warp] = a;
      if (warp == 0) {                // slot d0 - 1, just before the tile
        const int64_t b = d0 - a;
        s_has_prev = d0 > 0;
        if (d0 > 0)
          s_prev = a == 0   ? bk[b - 1]
                   : b == 0 ? ak[a - 1]
                            : imax(ak[a - 1], bk[b - 1]);
      }
    }
  }
  __syncthreads();
  const int64_t a0 = s_split[0];
  const int64_t b0 = d0 - a0;
  const int m = static_cast<int>(d1 - d0);
  const int la = static_cast<int>(s_split[1] - a0);
  const int lb = m - la;
  for (int t = threadIdx.x; t < m; t += kTileThreads)
    cp_async8(&s_key[t], t < la ? ak + a0 + t : bk + b0 + (t - la));
  cp_async_commit();
  for (int t = threadIdx.x; t < m; t += kTileThreads)
    cp_async8(&s_val[t], t < la ? av + a0 + t : bv + b0 + (t - la));
  cp_async_commit();
  cp_async_wait<1>();                 // this thread's key copies
  __syncthreads();
  const int64_t* sa = s_key;
  const int64_t* sb = s_key + la;
  const int dt = threadIdx.x * kTileItems;
  if (dt < m) {
    int lo = dt > lb ? dt - lb : 0, hi = dt < la ? dt : la;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (sa[mid - 1] <= sb[dt - mid]) lo = mid; else hi = mid - 1;
    }
    int ia = lo, ib = dt - lo;
    bool has_prev = true;
    int64_t prev;
    if (dt == 0) {
      has_prev = s_has_prev != 0;
      prev = s_prev;
    } else {
      prev = ia == 0 ? sb[ib - 1] : ib == 0 ? sa[ia - 1]
                                            : imax(sa[ia - 1], sb[ib - 1]);
    }
#pragma unroll
    for (int u = 0; u < kTileItems; ++u) {
      const int slot = dt + u;
      if (slot >= m) break;
      const bool take_a = ib >= lb || (ia < la && sa[ia] <= sb[ib]);
      const int src = take_a ? ia++ : la + ib++;
      const int64_t x = s_key[src];
      s_src[slot] = static_cast<int16_t>(src);
      s_keep[slot] = (!has_prev || x != prev) ? 1 : 0;
      prev = x;
      has_prev = true;
    }
  }
  cp_async_wait<0>();                 // and its value copies
  __syncthreads();
  for (int t = threadIdx.x; t < m; t += kTileThreads) {
    const int src = s_src[t];
    out_k[d0 + t] = s_key[src];
    out_v[d0 + t] = s_val[src];
    keep[d0 + t] = s_keep[t];
  }
}

int launch_merge_path(const int64_t* packed, int64_t n, int64_t* out_k,
                      int64_t* out_v, uint8_t* keep, cudaStream_t stream) {
  merge_path_kernel<<<static_cast<unsigned>((n + kTile - 1) / kTile),
                      kTileThreads, 0, stream>>>(packed, out_k, out_v, keep);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStaged>
int launch_rank(const int64_t* packed, int k, int64_t n, int64_t* out_k,
                int64_t* out_v, uint8_t* keep, cudaStream_t stream) {
  size_t smem = 0;
  if (kStaged) {
    // Needed above 48 KB, where tools/merge_paths.py moves the constant.
    static const cudaError_t attr = cudaFuncSetAttribute(
        merge_rank_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(8 * (kSharedMaxRuns + 1 +
                              (kSharedMaxKeys > kSharedMaxPairKeys
                                   ? kSharedMaxKeys
                                   : kSharedMaxPairKeys))));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    smem = static_cast<size_t>(8 * (k + 1 + n));
  }
  const int64_t per_block = static_cast<int64_t>(kRankThreads) * kRankItems;
  merge_rank_kernel<kStaged>
      <<<static_cast<unsigned>((n + per_block - 1) / per_block), kRankThreads,
         smem, stream>>>(packed, k, n, out_k, out_v, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ``packed`` is int64 [k + 1 + 2n] (offsets, keys, values; runs newest
// first), ``out`` int64 [2n + ceil(n / 8)]: the merged keys, the merged
// values, then one keep byte a slot. n > 0, k >= 1. ``route`` receives the
// route taken: 0 shared, 1 merge_path, 2 global.
extern "C" int merge_runs(const void* packed, int k, int64_t n, void* out,
                          void* stream, int* route) {
  const auto* pk = static_cast<const int64_t*>(packed);
  auto* ok = static_cast<int64_t*>(out);
  int64_t* ov = ok + n;
  auto* keep = reinterpret_cast<uint8_t*>(ok + 2 * n);
  const auto st = static_cast<cudaStream_t>(stream);
  *route = route_of(k, n);
  switch (*route) {
    case kRouteShared:
      return launch_rank<true>(pk, k, n, ok, ov, keep, st);
    case kRouteMergePath:
      return launch_merge_path(pk, n, ok, ov, keep, st);
    default:
      return launch_rank<false>(pk, k, n, ok, ov, keep, st);
  }
}
