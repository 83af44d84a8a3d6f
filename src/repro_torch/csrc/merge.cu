// merge_pair: stable merge of two sorted int64 runs by rank, with the
// first-occurrence keep flag of every output slot.
//
// Replaces the TPU kernel merge_tiles (src/repro/kernels/merge/merge.py:68,
// body _merge_kernel). That kernel ranks each element of a 512-wide tile
// pair by cross-tile compare counts and scatters keys and values through
// exact one-hot f32 matmuls on 15-bit halves, a layout forced by the TPU's
// matrix unit and its int32 lanes. None of that carries over: here every
// element finds its own rank by binary search and stores straight to it.
//
// What bounds it on the H100: memory traffic. Each element is read once
// (key and value, 16 B) and written once (16 B plus a 1 B flag); the
// log2(n) probes of the other run mostly hit L2. At the engine's run sizes
// (2K to 1M entries) a launch is a few microseconds, so launch latency is
// the practical floor; the design spends no shared memory and no second
// pass, so one launch does the whole merge.
//
// Ranks: run A is the newer run and wins ties.
//   rank(a[i]) = i + #{b < a[i]}        rank(b[j]) = j + #{a <= b[j]}
// The ranks are a permutation of [0, na + nb) even when a run holds
// duplicates, so every slot is written exactly once. Among equal keys all
// of A's copies precede all of B's, so a slot holds a first occurrence iff
//   a[i]: i == 0 or a[i-1] != a[i]
//   b[j]: (j == 0 or b[j-1] != b[j]) and no a equals b[j]
// which each thread decides from the runs alone, without reading the
// output.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int64_t count_less(const int64_t* x, int64_t n,
                                              int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (x[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int64_t count_less_equal(const int64_t* x,
                                                    int64_t n, int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (x[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void merge_pair_kernel(const int64_t* __restrict__ ak,
                                  const int64_t* __restrict__ av, int64_t na,
                                  const int64_t* __restrict__ bk,
                                  const int64_t* __restrict__ bv, int64_t nb,
                                  int64_t* __restrict__ out_k,
                                  int64_t* __restrict__ out_v,
                                  uint8_t* __restrict__ keep) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= na + nb) return;
  int64_t key, val, rank;
  bool first;
  if (t < na) {
    key = ak[t];
    val = av[t];
    rank = t + count_less(bk, nb, key);
    first = t == 0 || ak[t - 1] != key;
  } else {
    int64_t j = t - na;
    key = bk[j];
    val = bv[j];
    int64_t c = count_less_equal(ak, na, key);
    rank = j + c;
    first = (j == 0 || bk[j - 1] != key) && (c == 0 || ak[c - 1] != key);
  }
  out_k[rank] = key;
  out_v[rank] = val;
  keep[rank] = first ? 1 : 0;
}

}  // namespace

extern "C" int merge_pair(const void* ak, const void* av, int64_t na,
                          const void* bk, const void* bv, int64_t nb,
                          void* out_k, void* out_v, void* keep,
                          void* stream) {
  const int64_t n = na + nb;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  merge_pair_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ak), static_cast<const int64_t*>(av), na,
      static_cast<const int64_t*>(bk), static_cast<const int64_t*>(bv), nb,
      static_cast<int64_t*>(out_k), static_cast<int64_t*>(out_v),
      static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}
