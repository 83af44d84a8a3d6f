// flash_attention: the flash-attention forward of the serving path, run
// for every attention call of prefill and decode.
//
// Replaces the TPU kernel flash_attention_bhsd
// (src/repro/kernels/attention/flash.py:66, body _flash_kernel) behind its
// wrapper flash_attention (src/repro/kernels/attention/ops.py:15), and
// computes exactly that function:
//   * scores q.k in f32 times hd^-0.5 of the real head dim; with a nonzero
//     softcap c, c * tanh(s / c);
//   * with causal, key kp is kept for query qp iff kp <= qp and, when
//     window > 0, kp > qp - window; both indices count from 0 (top-left
//     alignment). Without causal every key is kept. A masked key scores
//     -2e38;
//   * online softmax over key tiles with f32 m, l and acc; p is rounded to
//     the value dtype before p.v; the output is acc / max(l, 1e-30) in q's
//     dtype.
// GQA: query head h reads KV head h / (H / KV) directly; the repeat is
// never materialised. The TPU wrapper's head-dim padding to 128 lanes is a
// TPU artifact and is not carried over.
//
// Layout: q, k, v and o are [B, S, heads, hd] with any batch, sequence and
// head strides and a contiguous last dim, so a slice of rows of the KV
// cache is read in place.
//
// Design (simple first): one block per (batch * head, tile of query rows);
// each warp owns kRows query rows and keeps their m, l and acc in
// registers (lane owns dims lane, lane + 32, ...). The block stages a tile
// of kBK keys and values in shared memory as f32; in the score step lane j
// takes key j of the tile, in the p.v step lane d takes output dim d and
// p_j arrives by shuffle. Key tiles that every query row of the block
// masks are skipped when each row keeps some key (then their terms are 0
// exactly: exp(-2e38 - m) with a real running max m, or a partial sum that
// a later corr = exp(-2e38 - m) = 0 wipes), so causal and windowed calls
// read only the keys they keep.
//
// What bounds it on the H100: at the serving path's shapes (48 queries of
// 64 keys, decode over at most 64 cached rows) launch latency and the
// bytes of q, k and v; at 4096-8192 tokens the f32 FMAs from shared memory
// outside the tensor cores, far from the bf16 tensor-core bound.
// mma.sync/wgmma tiles and TMA staging are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 32;        // keys per tile: one per lane
constexpr int kRows = 2;       // query rows per warp
constexpr int kMaxWarps = 8;
constexpr float kMasked = -2.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  int64_t b, s, h;    // batch, sequence and head strides, in elements
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int32_t sq, sk, h, kv;
  Strides qs, ks, vs, os;
  int32_t causal, window;
  float softcap, scale;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_attention_kernel(const Args a) {
  constexpr int NT = (HD + 31) / 32;    // output dims per lane
  __shared__ float qs[kMaxWarps * kRows][HD];
  __shared__ float ks[kBK][HD + 1];     // +1: lane j reads row j, no conflicts
  __shared__ float vs[kBK][HD];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bq = (blockDim.x / 32) * kRows;
  const int b = blockIdx.y / a.h;
  const int h = blockIdx.y % a.h;
  const int kh = h / (a.h / a.kv);
  const int q0 = blockIdx.x * bq;
  const int q_last = min(q0 + bq, a.sq) - 1;
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + kh * a.vs.h;
  T* o = static_cast<T*>(a.o) + b * a.os.b + h * a.os.h;

  for (int i = threadIdx.x; i < bq * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD;
    qs[r][d] = q0 + r < a.sq ? to_f32(q[(q0 + r) * a.qs.s + d]) : 0.f;
  }
  // Keys that some row of this block keeps. A row qp >= sk keeps a key
  // only while qp < sk - 1 + window; if some row keeps none, every key
  // counts (its output is the mean of v, as on the TPU) and none is
  // skipped.
  int k_begin = 0, k_end = a.sk;
  if (a.causal && (a.window <= 0 || q_last < a.sk - 1 + a.window)) {
    k_end = min(a.sk, q_last + 1);
    if (a.window > 0) k_begin = max(0, q0 - a.window + 1);
  }

  float m[kRows], l[kRows], acc[kRows][NT];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[r][t] = 0.f;
  }

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();    // the previous tile is consumed
    for (int i = threadIdx.x; i < kBK * HD; i += blockDim.x) {
      const int j = i / HD, d = i % HD;
      const int kp = kt + j;
      const bool in = kp < k_end;
      ks[j][d] = in ? to_f32(k[kp * a.ks.s + d]) : 0.f;
      vs[j][d] = in ? to_f32(v[kp * a.vs.s + d]) : 0.f;
    }
    __syncthreads();
    const int kp = kt + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r;
      const int qp = q0 + row;
      if (qp >= a.sq) break;    // uniform across the warp
      float s = -INFINITY;      // beyond k_end: no term at all
      if (kp < k_end) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qs[row][d], ks[lane][d], dot);
        s = dot * a.scale;
        if (a.softcap != 0.f) s = a.softcap * tanhf(s / a.softcap);
        if (a.causal && (kp > qp || (a.window > 0 && kp <= qp - a.window)))
          s = kMasked;
      }
      float tmax = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[r], tmax);
      const float p = expf(s - m_new);
      const float corr = expf(m[r] - m_new);
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[r] = l[r] * corr + psum;
      const float pv = to_f32(from_f32<T>(p));    // p in the value dtype
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[r][t] *= corr;
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pv, j);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int d = lane + 32 * t;
          if (d < HD) acc[r][t] = fmaf(pj, vs[j][d], acc[r][t]);
        }
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    if (qp >= a.sq) break;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = lane + 32 * t;
      if (d < HD) o[qp * a.os.s + d] = from_f32<T>(acc[r][t] / denom);
    }
  }
}

template <typename T, int HD>
int launch(const Args& a, int64_t batch, cudaStream_t stream) {
  const int warps = min(kMaxWarps, (a.sq + kRows - 1) / kRows);
  const int bq = warps * kRows;
  const dim3 grid(static_cast<unsigned>((a.sq + bq - 1) / bq),
                  static_cast<unsigned>(batch * a.h));
  flash_attention_kernel<T, HD><<<grid, warps * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int64_t hd, const Args& a, int64_t batch, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(a, batch, s);
    case 64: return launch<T, 64>(a, batch, s);
    case 80: return launch<T, 80>(a, batch, s);
    case 128: return launch<T, 128>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Sq, H, hd], k and v [B, Sk, KV, hd], o [B, Sq, H, hd], all of one
// dtype (bf16 when is_bf16, else f32), with the given batch, sequence and
// head strides in elements. The wrapper checks shapes and sizes.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, int64_t batch,
    int64_t sq, int64_t sk, int64_t h, int64_t kv, int64_t hd, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int causal, int window, float softcap, float scale,
    int is_bf16, void* stream) {
  const Args a{q, k, v, o,
               static_cast<int32_t>(sq), static_cast<int32_t>(sk),
               static_cast<int32_t>(h), static_cast<int32_t>(kv),
               {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
               {o_sb, o_ss, o_sh}, causal, window, softcap, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_hd<__nv_bfloat16>(hd, a, batch, s)
                 : launch_hd<float>(hd, a, batch, s);
}
