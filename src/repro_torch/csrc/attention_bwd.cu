// flash_attention_bwd_{prep,dkv,dq}: the backward of K6 (attention.cu), run
// for every attention call of a training step.
//
// The TPU kernel flash_attention_bhsd (src/repro/kernels/attention/flash.py:66)
// has no backward: the reference trains by jax.vjp of the jnp
// full_attention (src/repro/models/attention.py:224-236), while the port runs
// K6 on every attention call, so it needs the derivative of K6's function
// written by hand. With scores s = c * tanh(scale * q.k / c) (s = scale * q.k
// without a softcap), the keep mask of K6, P = exp(s - lse) where lse = m +
// log l is the forward's per-row log-sum-exp (attention.cu writes it), and
// the forward's rounding of p to the value dtype taken as the identity (as
// JAX's VJP of astype takes it):
//   D   = rowsum(dO * O)                        (prep)
//   dP  = dO . V^T,  dS = P * (dP - D) * (1 - (s / c)^2)
//   dV  = P^T . dO,  dK = scale * dS^T . Q      (dkv; summed over the H / KV
//                                                query heads of a KV head)
//   dQ  = scale * dS . K                        (dq)
// A masked pair has P = dS = 0. A row that keeps no key (causal, window > 0,
// Sq > Sk - 1 + window: K6 gives it p = 1 for every key, the mean of v) has
// P = 1 / Sk and dS = 0: its scores are constants of the mask.
//
// Each kernel recomputes S and dP from Q, K, V, dO and the LSE (as FlashAttn-2
// does), accumulates in f32 and writes its outputs once, in the inputs'
// dtype. dQ and dK/dV come from two kernels so that no sum needs atomics
// (the result does not depend on the order blocks run in):
//   * dkv: one block per (batch, KV head, tile of kBK keys), 8 warps; loops
//     over the group's query heads and the tiles of kBQ query rows that keep
//     some key of the tile. Lane j scores key j against a warp's query rows
//     (q broadcast from shared memory, k rows padded by one float so that
//     lanes hit distinct banks); then each warp owns kBK / 8 keys and each
//     lane output dims lane, lane + 32, ... of dK and dV in registers.
//   * dq: one block per (batch * head, tile of kBQ query rows); loops over
//     the key tiles the rows keep (K6's key_range); each warp owns kBQ / 8
//     rows of dQ in registers.
// CUDA-core FMAs in f32 from shared memory, for both dtypes: a simple tiled
// kernel. Bound on the H100 by shared-memory loads (about one per FMA), so
// far from the tensor cores' rate that bounds the function; mma/wgmma tiles
// are the way there.
//
// Layout: q, k, v, dO and O are [B, S, heads, hd] with any batch, sequence
// and head strides and a contiguous last dim (k, v may be row views of a
// cache); lse and D are [B, H, Sq] f32; dq is [B, Sq, H, hd] and dk, dv are
// [B, Sk, KV, hd], contiguous.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32;                   // query rows of a tile
constexpr int kBK = 32;                   // keys of a tile (one a lane)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr int kKeysPerWarp = kBK / kWarps;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  int64_t b, s, h;    // batch, sequence and head strides, in elements
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* g0;           // dkv: dk; dq: dq
  void* g1;           // dkv: dv
  int32_t sq, sk, h, kv;
  Strides qs, ks, vs, dos;
  int32_t causal, window;
  float softcap, scale;
};

// The keys [k_begin, k_end) that some query row in [q_first, q_last] keeps,
// as attention.cu's key_range: all keys if some row keeps none.
__device__ __forceinline__ void key_range(const Args& a, int q_first,
                                          int q_last, int& k_begin,
                                          int& k_end) {
  k_begin = 0;
  k_end = a.sk;
  if (a.causal && (a.window <= 0 || q_last < a.sk - 1 + a.window)) {
    k_end = min(a.sk, q_last + 1);
    if (a.window > 0) k_begin = max(0, q_first - a.window + 1);
  }
}

// P and dS of one (query row i, key kp) pair, from dot = q.k, dpv = dO.v,
// the row's lse and D.
__device__ __forceinline__ void pair(const Args& a, int i, int kp, float dot,
                                     float dpv, float lse, float delta,
                                     float& p, float& ds) {
  if (a.causal && a.window > 0 && i >= a.sk - 1 + a.window) {
    p = 1.f / a.sk;     // a row that keeps no key: the mean of v
    ds = 0.f;
    return;
  }
  if (a.causal && (kp > i || (a.window > 0 && kp <= i - a.window))) {
    p = 0.f;
    ds = 0.f;
    return;
  }
  float s = dot * a.scale;
  float t = 0.f;
  if (a.softcap != 0.f) {
    t = tanhf(s / a.softcap);
    s = a.softcap * t;
  }
  p = expf(s - lse);
  ds = p * (dpv - delta);
  if (a.softcap != 0.f) ds *= 1.f - t * t;
}

// ------------------------------- D = rowsum(dO * O) ----------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_prep_kernel(const T* o, const T* dout, float* delta,
                                int32_t sq, int32_t h, int32_t hd,
                                Strides os, Strides dos) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / h, hh = blockIdx.y % h;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= sq) return;
  const T* orow = o + b * os.b + i * os.s + hh * os.h;
  const T* drow = dout + b * dos.b + i * dos.s + hh * dos.h;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[static_cast<int64_t>(blockIdx.y) * sq + i] = acc;
}

// Shared memory of the two main kernels, in floats.
template <int HD>
struct Smem {
  static constexpr int KV = 2 * kBK * (HD + 1);     // K and V tiles, padded
  static constexpr int QD = 2 * kBQ * HD;           // Q and dO tiles
  static constexpr int PD = 2 * kBQ * (kBK + 1);    // P and dS tiles
  static constexpr int ROWS = 2 * kBQ;              // lse and D of the rows
  static constexpr int BYTES = (KV + QD + PD + ROWS) * 4;
};

// Rows r0 .. r0 + kBQ - 1 (< r_end) of head hh: Q and dO into shared memory
// as f32, lse and D beside them.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(const Args& a, int b, int hh,
                                          int r0, int r_end, float* qs,
                                          float* dos, float* rows) {
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + hh * a.qs.h;
  const T* dout = static_cast<const T*>(a.dout) + b * a.dos.b + hh * a.dos.h;
  for (int idx = threadIdx.x; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int i = r0 + r;
    const bool in = i < r_end;
    qs[idx] = in ? to_f32(q[static_cast<int64_t>(i) * a.qs.s + d]) : 0.f;
    dos[idx] = in ? to_f32(dout[static_cast<int64_t>(i) * a.dos.s + d]) : 0.f;
  }
  if (threadIdx.x < kBQ) {
    const int i = r0 + threadIdx.x;
    const int64_t base = (static_cast<int64_t>(b) * a.h + hh) * a.sq;
    rows[threadIdx.x] = i < r_end ? a.lse[base + i] : 0.f;
    rows[kBQ + threadIdx.x] = i < r_end ? a.delta[base + i] : 0.f;
  }
}

// Keys k0 .. k0 + kBK - 1 (< k_end) of KV head kh: K and V into shared
// memory as f32, rows padded to HD + 1.
template <typename T, int HD>
__device__ __forceinline__ void load_keys(const Args& a, int b, int kh,
                                          int k0, int k_end, float* ks,
                                          float* vs) {
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + kh * a.vs.h;
  for (int idx = threadIdx.x; idx < kBK * HD; idx += kThreads) {
    const int j = idx / HD, d = idx % HD;
    const int kp = k0 + j;
    const bool in = kp < k_end;
    ks[j * (HD + 1) + d] =
        in ? to_f32(k[static_cast<int64_t>(kp) * a.ks.s + d]) : 0.f;
    vs[j * (HD + 1) + d] =
        in ? to_f32(v[static_cast<int64_t>(kp) * a.vs.s + d]) : 0.f;
  }
}

// P and dS of the tile: row warp * kRowsPerWarp + r against key lane, into
// ps and dss ([kBQ][kBK + 1]). Rows past r_end and keys past k_end give 0.
template <int HD>
__device__ __forceinline__ void tile_pairs(const Args& a, int r0, int r_end,
                                           int k0, int k_end, const float* qs,
                                           const float* dos, const float* ks,
                                           const float* vs, const float* rows,
                                           float* ps, float* dss) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kp = k0 + lane;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    const int i = r0 + row;
    float p = 0.f, ds = 0.f;
    if (i < r_end && kp < k_end) {
      const float* qr = qs + row * HD;
      const float* dr = dos + row * HD;
      const float* kr = ks + lane * (HD + 1);
      const float* vr = vs + lane * (HD + 1);
      float dot = 0.f, dpv = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) {
        dot = fmaf(qr[d], kr[d], dot);
        dpv = fmaf(dr[d], vr[d], dpv);
      }
      pair(a, i, kp, dot, dpv, rows[row], rows[kBQ + row], p, ds);
    }
    ps[row * (kBK + 1) + lane] = p;
    dss[row * (kBK + 1) + lane] = ds;
  }
}

// ------------------------------- dK, dV -----------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const Args a) {
  using S = Smem<HD>;
  constexpr int NT = (HD + 31) / 32;     // output dims a lane
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + kBK * (HD + 1);
  float* qs = sm + S::KV;
  float* dos = qs + kBQ * HD;
  float* ps = sm + S::KV + S::QD;
  float* dss = ps + kBQ * (kBK + 1);
  float* rows = sm + S::KV + S::QD + S::PD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = a.h / a.kv;
  const int b = blockIdx.y / a.kv, kh = blockIdx.y % a.kv;
  const int k0 = blockIdx.x * kBK;
  const int k_last = min(k0 + kBK, a.sk) - 1;
  load_keys<T, HD>(a, b, kh, k0, a.sk, ks, vs);

  // Query rows that keep some key of the tile; every row when some row
  // keeps none (it takes every key).
  int q_begin = 0, q_end = a.sq;
  if (a.causal && !(a.window > 0 && a.sq > a.sk - 1 + a.window)) {
    q_begin = k0;
    if (a.window > 0) q_end = min(a.sq, k_last + a.window);
  }

  float dk[kKeysPerWarp][NT], dv[kKeysPerWarp][NT];
#pragma unroll
  for (int r = 0; r < kKeysPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < NT; ++t) dk[r][t] = dv[r][t] = 0.f;

  for (int hg = 0; hg < g; ++hg) {
    const int hh = kh * g + hg;
    for (int r0 = q_begin; r0 < q_end; r0 += kBQ) {
      __syncthreads();      // the previous tile's rows are consumed
      load_rows<T, HD>(a, b, hh, r0, q_end, qs, dos, rows);
      __syncthreads();
      tile_pairs<HD>(a, r0, q_end, k0, a.sk, qs, dos, ks, vs, rows, ps, dss);
      __syncthreads();
      for (int row = 0; row < kBQ; ++row) {
        float qd[NT], dd[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int d = lane + 32 * t;
          qd[t] = d < HD ? qs[row * HD + d] : 0.f;
          dd[t] = d < HD ? dos[row * HD + d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kKeysPerWarp; ++r) {
          const int j = warp * kKeysPerWarp + r;
          const float p = ps[row * (kBK + 1) + j];
          const float ds = dss[row * (kBK + 1) + j];
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            dv[r][t] = fmaf(p, dd[t], dv[r][t]);
            dk[r][t] = fmaf(ds, qd[t], dk[r][t]);
          }
        }
      }
    }
  }

  T* gk = static_cast<T*>(a.g0);
  T* gv = static_cast<T*>(a.g1);
#pragma unroll
  for (int r = 0; r < kKeysPerWarp; ++r) {
    const int kp = k0 + warp * kKeysPerWarp + r;
    if (kp >= a.sk) break;    // uniform across the warp
    const int64_t base = ((static_cast<int64_t>(b) * a.sk + kp) * a.kv + kh) * HD;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = lane + 32 * t;
      if (d < HD) {
        gk[base + d] = from_f32<T>(dk[r][t] * a.scale);
        gv[base + d] = from_f32<T>(dv[r][t]);
      }
    }
  }
}

// ------------------------------- dQ ---------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const Args a) {
  using S = Smem<HD>;
  constexpr int NT = (HD + 31) / 32;
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + kBK * (HD + 1);
  float* qs = sm + S::KV;
  float* dos = qs + kBQ * HD;
  float* ps = sm + S::KV + S::QD;
  float* dss = ps + kBQ * (kBK + 1);
  float* rows = sm + S::KV + S::QD + S::PD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = a.h / a.kv;
  const int b = blockIdx.y / a.h, hh = blockIdx.y % a.h, kh = hh / g;
  const int r0 = blockIdx.x * kBQ;
  const int r_end = min(r0 + kBQ, a.sq);
  load_rows<T, HD>(a, b, hh, r0, r_end, qs, dos, rows);
  int k_begin, k_end;
  key_range(a, r0, r_end - 1, k_begin, k_end);

  float dq[kRowsPerWarp][NT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < NT; ++t) dq[r][t] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();        // the previous key tile is consumed
    load_keys<T, HD>(a, b, kh, k0, k_end, ks, vs);
    __syncthreads();
    tile_pairs<HD>(a, r0, r_end, k0, k_end, qs, dos, ks, vs, rows, ps, dss);
    __syncthreads();
    for (int j = 0; j < kBK; ++j) {
      float kd[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int d = lane + 32 * t;
        kd[t] = d < HD ? ks[j * (HD + 1) + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float ds = dss[(warp * kRowsPerWarp + r) * (kBK + 1) + j];
#pragma unroll
        for (int t = 0; t < NT; ++t) dq[r][t] = fmaf(ds, kd[t], dq[r][t]);
      }
    }
  }

  T* gq = static_cast<T*>(a.g0);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = r0 + warp * kRowsPerWarp + r;
    if (i >= a.sq) break;     // uniform across the warp
    const int64_t base = ((static_cast<int64_t>(b) * a.sq + i) * a.h + hh) * HD;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = lane + 32 * t;
      if (d < HD) gq[base + d] = from_f32<T>(dq[r][t] * a.scale);
    }
  }
}

template <typename K>
int launch_main(K kern, int smem, dim3 grid, const Args& a,
                cudaStream_t stream) {
  // Shared memory above 48 KB is opt-in; set on every launch (cheap).
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv(const Args& a, int64_t batch, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.sk + kBK - 1) / kBK),
                  static_cast<unsigned>(batch * a.kv));
  return launch_main(flash_attention_bwd_dkv_kernel<T, HD>, Smem<HD>::BYTES,
                     grid, a, s);
}

template <typename T, int HD>
int launch_dq(const Args& a, int64_t batch, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(batch * a.h));
  return launch_main(flash_attention_bwd_dq_kernel<T, HD>, Smem<HD>::BYTES,
                     grid, a, s);
}

template <typename T>
int launch_by_hd(int which, const Args& a, int64_t batch, int64_t hd,
                 cudaStream_t s) {
  switch (hd) {
    case 16: return which ? launch_dq<T, 16>(a, batch, s)
                          : launch_dkv<T, 16>(a, batch, s);
    case 64: return which ? launch_dq<T, 64>(a, batch, s)
                          : launch_dkv<T, 64>(a, batch, s);
    case 80: return which ? launch_dq<T, 80>(a, batch, s)
                          : launch_dkv<T, 80>(a, batch, s);
    case 128: return which ? launch_dq<T, 128>(a, batch, s)
                           : launch_dkv<T, 128>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_bwd(int which, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* g0, void* g1, int64_t batch, int64_t sq, int64_t sk,
               int64_t h, int64_t kv, int64_t hd, int64_t q_sb, int64_t q_ss,
               int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
               int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t do_sb,
               int64_t do_ss, int64_t do_sh, int causal, int window,
               float softcap, float scale, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, lse, delta, g0, g1,
               static_cast<int32_t>(sq), static_cast<int32_t>(sk),
               static_cast<int32_t>(h), static_cast<int32_t>(kv),
               {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
               {do_sb, do_ss, do_sh}, causal, window, softcap, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_by_hd<bf16>(which, a, batch, hd, s)
                 : launch_by_hd<float>(which, a, batch, hd, s);
}

}  // namespace

// D [B, H, Sq] f32 = rowsum(dO * O) over the head dim; o and dout
// [B, Sq, H, hd] of one dtype with the given strides.
extern "C" int flash_attention_bwd_prep(
    const void* o, const void* dout, float* delta, int64_t batch, int64_t sq,
    int64_t h, int64_t hd, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t do_sb, int64_t do_ss, int64_t do_sh, int is_bf16, void* stream) {
  const dim3 grid(static_cast<unsigned>((sq + kWarps - 1) / kWarps),
                  static_cast<unsigned>(batch * h));
  const auto s = static_cast<cudaStream_t>(stream);
  const Strides os{o_sb, o_ss, o_sh}, dos{do_sb, do_ss, do_sh};
  if (is_bf16)
    flash_attention_bwd_prep_kernel<bf16><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta,
        static_cast<int32_t>(sq), static_cast<int32_t>(h),
        static_cast<int32_t>(hd), os, dos);
  else
    flash_attention_bwd_prep_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), delta,
        static_cast<int32_t>(sq), static_cast<int32_t>(h),
        static_cast<int32_t>(hd), os, dos);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv [B, Sk, KV, hd] (contiguous, the inputs' dtype) from q [B, Sq, H,
// hd], k, v [B, Sk, KV, hd], dout [B, Sq, H, hd] (strided), lse and D
// [B, H, Sq] f32.
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int64_t batch,
    int64_t sq, int64_t sk, int64_t h, int64_t kv, int64_t hd, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t do_sb, int64_t do_ss,
    int64_t do_sh, int causal, int window, float softcap, float scale,
    int is_bf16, void* stream) {
  return launch_bwd(0, q, k, v, dout, lse, delta, dk, dv, batch, sq, sk, h,
                    kv, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                    v_sh, do_sb, do_ss, do_sh, causal, window, softcap, scale,
                    is_bf16, stream);
}

// dq [B, Sq, H, hd] (contiguous, the inputs' dtype), from the same inputs.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int64_t batch, int64_t sq,
    int64_t sk, int64_t h, int64_t kv, int64_t hd, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh,
    int causal, int window, float softcap, float scale, int is_bf16,
    void* stream) {
  return launch_bwd(1, q, k, v, dout, lse, delta, dq, nullptr, batch, sq, sk,
                    h, kv, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                    v_sh, do_sb, do_ss, do_sh, causal, window, softcap, scale,
                    is_bf16, stream);
}
