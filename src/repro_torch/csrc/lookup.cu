// K4 probe_tier and K3 probe_store: the fused read path over a
// device-resident view of one lookup tier (probe_tier) or of every lookup
// tier of a tree (probe_store).
//
// Replace the TPU kernels probe_filters_multi (src/repro/kernels/bloom/
// bloom.py:118, paired with lookup_runs_device in merge/ops.py:164) and
// probe_filters_tiered (bloom.py:179, composed in merge/ops.py:188
// _store_probe with _ranged_lookup, a segment_sum over tables and the
// newest-wins argmin). Those loop the grid over every table of a
// zero-padded [T * 128, Wmax] filter stack and compare each query with
// every table, after the host assigned each query its table. Here the
// kernel assigns the table itself and touches only that table's filter
// bytes and run.
//
// A view (lookup.py View) holds the tables' int64 key and value runs
// concatenated (each tier's segment sorted: its tables are disjoint and
// min_key-ordered), their Bloom filters as one flat byte concatenation,
// and one int64 metadata array: per global table t its filter's slot
// offset and slot count, its run's entry offset and length, its min_key
// and max_key (rows of T), then t_off[R + 1], each tier's first table.
// Per (tier, query) the kernels compute:
//
//   ti        upper_bound(starts of the tier, q) - 1, clipped into the
//             tier, tier-local;
//   ok        the unclipped ti >= 0 and q <= max_key of table ti (the
//             host's assign_bounds, exactly);
//   positive  all k Bloom slots of table ti set, with its own slot count
//             as the modulus;
//   pos       the lower bound of q in table ti's run, relative to the run;
//   hit       pos < len and the key there equals q;
//   val       the value there where hit, else 0;
//
// and probe_store also win[q], the lowest (newest) tier rank that hit, or
// -1. Every tier's fields are written: the host's page-pin replay reads
// those of every tier a query reaches, not only the winner's. The output
// is one buffer, so the host reads a lookup back in one copy (lookup.py
// layout): val int64 [R, K], pos int32 [R, K], ti int32 [R, K], win int32
// [K] (probe_store only), then bytes positive, hit, ok [R, K] each.
//
// What bounds them on the H100: the chain of dependent loads of one pair,
// and when a call has many pairs, the instructions every lane of a pair
// issues. The view (tens of MB at the main path's sizes) stays in the
// 50 MB L2 across calls, so each step of the chain is an L2 round trip,
// and a pair's own work is tiny (k slot reads and a search of
// ceil(log2 len) steps). The design shortens the chain and runs many
// chains at once:
//
//   * L lanes serve one (tier, query) pair. They search together: in each
//     round L - 1 lanes compare one splitter each, cutting the range into
//     L parts, and __ballot_sync/__popc pick the part that holds the
//     bound, so a search of n entries takes ceil(log_L(n + 1)) rounds (3
//     at the 2,048-key tables and 16 or 32 lanes, 6 at 4 lanes, against
//     11 binary-search steps). The assignment searches the tier's starts
//     the same way, in device memory (L2). Each round's loads are issued
//     before the work that does not need them, and the key at the range's
//     upper end is kept from the lane whose splitter set it, so the hit
//     is known when the search ends.
//   * The table's k Bloom slots are read by k of the lanes (slot j by lane
//     j mod L) and tested only after the run's search, so those loads are
//     in flight during its first round.
//   * A block of 256 threads takes Q = max(1, (256 / L) / R) queries across
//     all R tiers, one pair per group of lanes, so the R tiers of a query
//     run side by side. K3's winner is the lowest tier rank with a hit: a
//     shared-memory atomicMin per query within the block, written once
//     after the block's pairs end. No global atomic, no second launch.
//   * L follows the call's pairs, R times its queries (lanes_for): few
//     pairs leave most of the card idle behind each pair's chain, and
//     more lanes shorten it; many pairs keep every SM issuing, and fewer
//     lanes issue less for the same pairs. One kernel template serves
//     both kernels at 32, 16, 8 and 4 lanes.
//
// tools/lookup_paths.py measures the rule on the card: it builds copies
// of this file with every call forced to 4, 8, 16 and 32 lanes and times
// each at chip_smoke.py's timed shapes and at the pool phase's. On an
// H100 80GB HBM3 at 700 W, a call's device time in a CUDA graph (the
// reading PERF.md §6 gives, us at 4, 8, 16 and 32 lanes): K4 with 560
// queries over 75 tables of 2,048 keys (the pool phase's median call)
// 8.11, 5.36, 4.39, 4.07; with 4,096 queries over 512 tables 9.12, 5.86,
// 5.41, 6.06; K3 with 560 queries over tiers of 50 and 462 tables (the
// pool's median) 9.21, 5.96, 4.97, 4.41; with 4,096 queries over six
// tiers of 512 tables 10.42, 12.81, 14.11, 20.63. The rule's count had
// the least time at 12 of the 13 shapes; at 2,760 pairs 16 and 32 lanes
// swap between calls.
//
// Staging every table's min_key in shared memory with cp.async before
// the search was measured and dropped: at the pool phase's shapes (1-533
// tables) it gained K4 at most 0.15 us a call and cost K3 0.1-0.2 us,
// since with 16 or 32 lanes the starts take two rounds from L2.
#include <cstdint>
#include <cuda_runtime.h>

#include "bloom_hash.cuh"

namespace {

constexpr int kThreads = 256;
// Lanes serving one (tier, query) pair, chosen by the call's pairs (R
// times its queries): 32 up to kPairsFor32Lanes pairs, 16 up to
// kPairsFor16Lanes, 8 up to kPairsFor8Lanes, 4 above. The first L - 1
// lanes probe one splitter each, cutting a range into L parts (a shift,
// not a division); the last probes nothing.
constexpr int64_t kPairsFor32Lanes = 2048;
constexpr int64_t kPairsFor16Lanes = 8192;
constexpr int64_t kPairsFor8Lanes = 16384;
// Bloom hashes per probe that the lanes' slot reads cover.
constexpr int kMaxHashes = 16;

// What follows from L lanes a pair.
template <int L>
struct Lanes {
  static_assert(L >= 2 && L <= 32 && (L & (L - 1)) == 0,
                "lanes a pair: a power of two from 2 to a warp");
  static constexpr int kGroups = kThreads / L;     // pairs a block at once
  static constexpr int kLog2 = L >= 32 ? 5 : L >= 16 ? 4 : L >= 8 ? 3
                               : L >= 4 ? 2 : 1;
  static constexpr int kSlotReads = (kMaxHashes + L - 1) / L;
};

struct Args {
  const int64_t* keys;
  const int64_t* vals;
  const uint8_t* fbits;
  const int64_t* f_offs;
  const int64_t* nslots;
  const int64_t* offs;
  const int64_t* lens;
  const int64_t* starts;
  const int64_t* ends;
  const int64_t* t_off;
  int n_tiers;
  int k_hashes;
  const int64_t* q;
  int64_t n;
  int q_per_block;
  int64_t* val;
  int32_t* pos;
  int32_t* ti;
  int32_t* win;
  uint8_t* positive;
  uint8_t* hit;
  uint8_t* ok;
};

// Splitter i (0 <= i < L - 1) of the range [lo, lo + n): the L - 1
// splitters cut it into L parts.
template <int L>
__device__ __forceinline__ uint32_t splitter(uint32_t lo, uint32_t n, int i) {
  return lo + static_cast<uint32_t>((static_cast<uint64_t>(i + 1) * n) >>
                                    Lanes<L>::kLog2);
}

// One round of a search of [lo, hi) by a group's lanes: c of the splitters
// hold keys below the bound (they are the first c), so the bound lies in
// [splitter c - 1 + 1, splitter c]. Returns whether the upper end moved to
// splitter c, whose key the lane c then holds.
template <int L>
__device__ __forceinline__ bool narrow(uint32_t& lo, uint32_t& hi, int c) {
  const uint32_t m = hi - lo;
  const bool moved = c < L - 1;
  if (moved) hi = splitter<L>(lo, m, c);
  if (c > 0) lo = splitter<L>(lo, m, c - 1) + 1;
  return moved;
}

// The number of x[0, n) that are <= key (x sorted), searched by the
// group's lanes together (``mask``: the group's lanes in the warp).
template <int L>
__device__ __forceinline__ uint32_t group_upper_bound(const int64_t* x,
                                                      uint32_t n, int64_t key,
                                                      int lane,
                                                      unsigned mask) {
  uint32_t lo = 0, hi = n;
  while (lo < hi) {
    const bool le = lane < L - 1 &&
                    __ldg(x + splitter<L>(lo, hi - lo, lane)) <= key;
    narrow<L>(lo, hi, __popc(__ballot_sync(mask, le) & mask));
  }
  return lo;
}

template <int L>
__device__ __forceinline__ unsigned group_mask() {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned ones = L == 32 ? 0xffffffffu : (1u << L) - 1u;
  return ones << (lane & ~static_cast<unsigned>(L - 1));
}

template <int L, bool kStore>
__global__ void __launch_bounds__(kThreads) probe_kernel(Args a) {
  constexpr int kGroups = Lanes<L>::kGroups;
  constexpr int kSlotReads = Lanes<L>::kSlotReads;
  __shared__ int s_win[kGroups];
  const int group = threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const unsigned mask = group_mask<L>();
  const int Q = a.q_per_block;
  const int R = a.n_tiers;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * Q;
  if constexpr (kStore) {
    for (int j = threadIdx.x; j < Q; j += kThreads) s_win[j] = R;
    __syncthreads();
  }
  for (int p = group; p < Q * R; p += kGroups) {   // uniform in a group
    const int r = p / Q;
    const int j = p - r * Q;
    const int64_t i = q0 + j;
    if (i >= a.n) continue;
    const int64_t key = __ldg(a.q + i);
    const int64_t t0 = __ldg(a.t_off + r);
    const auto tn = static_cast<uint32_t>(__ldg(a.t_off + r + 1) - t0);
    // Assignment: the covering table of the tier, clipped into it.
    const uint32_t ub =
        group_upper_bound<L>(a.starts + t0, tn, key, lane, mask);
    const uint32_t t = ub > 0 ? ub - 1 : 0;
    const int64_t gt = t0 + t;
    const bool ok = ub > 0 && key <= __ldg(a.ends + gt);
    const int64_t off = __ldg(a.offs + gt);
    const int64_t* run = a.keys + off;
    const int64_t* vrun = a.vals + off;
    const auto len = static_cast<uint32_t>(__ldg(a.lens + gt));
    const uint8_t* filt = a.fbits + __ldg(a.f_offs + gt);
    const auto ns = static_cast<uint32_t>(__ldg(a.nslots + gt));
    // The lower bound of key in the run. Each round's splitter load is
    // issued before the work that does not need it (first the Bloom
    // slots), and the key at the upper end of the range is kept from the
    // lane whose splitter set it.
    const bool probe = lane < L - 1;
    uint32_t lo = 0, hi = len;
    uint32_t at = splitter<L>(lo, hi - lo, lane);
    int64_t kx = probe ? __ldg(run + at) : 0;
    // Bloom: lane l reads slots l, l + L, ...; tested after the search.
    uint8_t bit[kSlotReads];
    {
      uint32_t s, h2;
      repro_bloom::hashes(key, ns, &s, &h2);
      const int skip = lane < a.k_hashes ? lane : 0;
      for (int u = 0; u < skip; ++u) s = repro_bloom::next_slot(s, h2, ns);
#pragma unroll
      for (int u = 0; u < kSlotReads; ++u) {
        bit[u] = lane + u * L < a.k_hashes ? __ldg(filt + s) : 1;
        if (u + 1 < kSlotReads && lane + (u + 1) * L < a.k_hashes) {
          for (int v = 0; v < L; ++v) s = repro_bloom::next_slot(s, h2, ns);
        }
      }
    }
    int64_t hk = 0;
    bool have = false;
    while (lo < hi) {
      const int c = __popc(__ballot_sync(mask, probe && kx < key) & mask);
      if (narrow<L>(lo, hi, c)) {
        hk = __shfl_sync(mask, kx, c, L);
        have = true;
      }
      if (lo < hi) {
        at = splitter<L>(lo, hi - lo, lane);
        kx = probe ? __ldg(run + at) : 0;
      }
    }
    bool in = true;
#pragma unroll
    for (int u = 0; u < kSlotReads; ++u) in &= bit[u] != 0;
    const bool positive = (__ballot_sync(mask, !in) & mask) == 0;
    const bool h = have && hk == key;
    if (lane == 0) {
      const int64_t o = static_cast<int64_t>(r) * a.n + i;
      a.val[o] = h ? __ldg(vrun + lo) : 0;
      a.pos[o] = static_cast<int32_t>(lo);
      a.ti[o] = static_cast<int32_t>(t);
      a.positive[o] = positive;
      a.hit[o] = h;
      a.ok[o] = ok;
      if constexpr (kStore) {
        if (h) atomicMin(&s_win[j], r);
      }
    }
  }
  if constexpr (kStore) {
    __syncthreads();
    for (int j = threadIdx.x; j < Q; j += kThreads) {
      if (q0 + j < a.n) a.win[q0 + j] = s_win[j] == R ? -1 : s_win[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

int lanes_for(int64_t pairs) {
  return pairs <= kPairsFor32Lanes   ? 32
         : pairs <= kPairsFor16Lanes ? 16
         : pairs <= kPairsFor8Lanes  ? 8
                                     : 4;
}

// Queries a block takes at ``lanes`` lanes a pair: one pair per group of
// lanes across the R tiers.
int queries_per_block(int lanes, int64_t n_tiers) {
  const int groups = kThreads / lanes;
  return n_tiers >= groups ? 1 : static_cast<int>(groups / n_tiers);
}

unsigned blocks_of(int lanes, int64_t n_tiers, int64_t n) {
  const int per = queries_per_block(lanes, n_tiers);
  return static_cast<unsigned>((n + per - 1) / per);
}

template <int L, bool kStore>
int launch(Args a, cudaStream_t stream) {
  a.q_per_block = queries_per_block(L, a.n_tiers);
  const unsigned blocks = blocks_of(L, a.n_tiers, a.n);
  probe_kernel<L, kStore><<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ``desc`` is the view's host descriptor, int64 [6]: the addresses of
// keys, vals, fbits and meta, the table count T and the tier count R.
// ``out`` is laid out as the header says (lookup.py layout). With
// ``q_host`` (pinned) the n queries are first copied from there to ``q``;
// with ``out_host`` (pinned) the fields are copied back there and the
// stream synchronised: the engine's whole round trip in one call.
template <bool kStore>
int probe(const int64_t* desc, int k_hashes, void* q, int64_t n, void* out,
          void* stream, const void* q_host, void* out_host) {
  if (k_hashes < 1 || k_hashes > kMaxHashes || n < 1 || desc[4] < 1 ||
      desc[5] < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  const int64_t T = desc[4];
  const auto* meta = reinterpret_cast<const int64_t*>(desc[3]);
  a.keys = reinterpret_cast<const int64_t*>(desc[0]);
  a.vals = reinterpret_cast<const int64_t*>(desc[1]);
  a.fbits = reinterpret_cast<const uint8_t*>(desc[2]);
  a.f_offs = meta;
  a.nslots = meta + T;
  a.offs = meta + 2 * T;
  a.lens = meta + 3 * T;
  a.starts = meta + 4 * T;
  a.ends = meta + 5 * T;
  a.t_off = meta + 6 * T;
  a.n_tiers = static_cast<int>(desc[5]);
  a.k_hashes = k_hashes;
  a.q = static_cast<const int64_t*>(q);
  a.n = n;
  const int64_t R = desc[5];
  const int64_t RK = R * n;
  auto* base = static_cast<uint8_t*>(out);
  a.val = reinterpret_cast<int64_t*>(base);
  a.pos = reinterpret_cast<int32_t*>(base + 8 * RK);
  a.ti = reinterpret_cast<int32_t*>(base + 12 * RK);
  a.win = reinterpret_cast<int32_t*>(base + 16 * RK);
  const int64_t flags = 16 * RK + (kStore ? 4 * n : 0);
  a.positive = base + flags;
  a.hit = base + flags + RK;
  a.ok = base + flags + 2 * RK;
  const auto st = static_cast<cudaStream_t>(stream);
  if (q_host != nullptr) {
    const cudaError_t rc = cudaMemcpyAsync(q, q_host, 8 * n,
                                           cudaMemcpyHostToDevice, st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  int rc;
  switch (lanes_for(RK)) {
    case 32: rc = launch<32, kStore>(a, st); break;
    case 16: rc = launch<16, kStore>(a, st); break;
    case 8: rc = launch<8, kStore>(a, st); break;
    default: rc = launch<4, kStore>(a, st);
  }
  if (rc != 0 || out_host == nullptr) return rc;
  const cudaError_t back = cudaMemcpyAsync(
      out_host, out, flags + 3 * RK, cudaMemcpyDeviceToHost, st);
  if (back != cudaSuccess) return static_cast<int>(back);
  return static_cast<int>(cudaStreamSynchronize(st));
}

}  // namespace

// K4: every query against its covering table of a one-tier view (R = 1).
// ``q_host`` and ``out_host`` may be null (see probe).
extern "C" int probe_tier(const int64_t* desc, int k_hashes, void* q,
                          int64_t n, void* out, void* stream,
                          const void* q_host, void* out_host) {
  return probe<false>(desc, k_hashes, q, n, out, stream, q_host, out_host);
}

// K3: every query against every tier of a store view, and the winner.
extern "C" int probe_store(const int64_t* desc, int k_hashes, void* q,
                           int64_t n, void* out, void* stream,
                           const void* q_host, void* out_host) {
  return probe<true>(desc, k_hashes, q, n, out, stream, q_host, out_host);
}

// An empty kernel on the grid probe_store or probe_tier would take for
// this view and n queries: the floor of their launch and device time.
extern "C" int probe_floor(const int64_t* desc, int64_t n, void* stream) {
  const unsigned blocks = blocks_of(lanes_for(desc[5] * n), desc[5], n);
  empty_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
