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
// Log-sum-exp for the backward: given a non-null lse ([B, H, Sq] f32,
// contiguous), each kernel also writes every row's m + log l in the units
// of the scores (scaled, softcapped), which attention_bwd.cu reads to
// recompute p / l. The serving path passes null and writes nothing more.
//
// Both kernels skip key tiles that every query row of the block masks,
// but only when each row keeps some key: then a skipped term is 0 exactly
// (exp(-2e38 - m) with a real running max m, or a partial sum that a later
// corr = exp(-2e38 - m) = 0 wipes). A row that keeps no key (Sq > Sk with
// a window) scores -2e38 everywhere, gets p = 1 for every key and so the
// mean of v, as on the TPU. Keys past the block's range score -inf: no
// term at all.
//
// Three paths, chosen per call in flash_attention below:
//
// * bf16 on the tensor cores (flash_attention_kernel_mma), for every bf16
//   call whose pointers are 16-byte aligned and whose strides are
//   multiples of 8 elements; FlashAttention-2 style. The rows of a block
//   are (query, head of one KV group) pairs, so one block serves all H/KV
//   heads of its KV head and reads each K/V row once for all of them.
//   Each warp owns MT tiles of 16 rows. S = Q.K^T and O += P.V run as
//   mma.sync.m16n8k16 with bf16 inputs and f32 accumulation, which is the
//   TPU kernel's dot_general(..., preferred_element_type=f32). P enters
//   the second product as a bf16 A fragment, which is the function's
//   rounding of p to the value dtype; l sums the unrounded f32 p. Q and
//   tiles of 64 keys and values are staged in shared memory as bf16 by
//   16-byte cp.async copies, K/V double-buffered, rows padded by 16 bytes
//   so that ldmatrix reads them without bank conflicts. Row max and row
//   sum are reduced across the four threads of a quad in registers. The
//   softcap and mask passes run only where they can change a score, and
//   p is exp2 of the scaled difference.
//   - Long prefills (at least one 128-row block per SM): 4 warps x 2 row
//     tiles. Bound by operations: 4 hd flops per kept (query, key) pair
//     at the tensor cores' bf16 rate. With mma.sync every warp reads its
//     K and V fragments from shared memory, and those reads take about as
//     long as the products; two row tiles per warp (255 registers) halve
//     them per flop against one. wgmma, whose B operand a warpgroup reads
//     once, is the way past this. Causal grids run the longest row tiles
//     first.
//   - Decode (Sq * H/KV <= 16 rows: one query and up to 16 heads a
//     group): one block of one warp per (batch, KV head), its 16-row tile
//     holding the group's heads. Bound by bytes: each K/V row is read once
//     per call by 16-byte copies; at the serving path's <= 64 cached rows
//     what is left is the launch and one round trip to memory. A longer
//     cache loops over tiles in the same block: right, but not spread over
//     the card.
//   - Anything between (the serving path's 48-token prefill): 4 warps x 1
//     row tile (64 rows), for twice the blocks.
// * f32, and bf16 with a misaligned pointer or stride
//   (flash_attention_kernel): CUDA-core FMAs in f32, one block per (batch
//   * head, tile of query rows); each warp owns kRows query rows and keeps
//   their m, l and acc in registers (lane owns dims lane, lane + 32, ...);
//   the block stages kBK keys and values in shared memory as f32, lane j
//   scores key j, and in p.v lane d takes output dim d with p_j arriving
//   by shuffle. f32 stays off the tensor cores: TF32 would change the
//   function. Bound on the H100 by the f32 FMAs from shared memory at
//   long prefills, and by launch latency and scalar loads at the serving
//   path's shapes.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 32;        // SIMT: keys per tile, one per lane
constexpr int kRows = 2;       // SIMT: query rows per warp
constexpr int kMaxWarps = 8;
constexpr float kMasked = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;

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
  void* o;
  float* lse;         // [B, H, Sq], or null
  int32_t sq, sk, h, kv;
  Strides qs, ks, vs, os;
  int32_t causal, window;
  float softcap, scale;
};

// Keys [k_begin, k_end) that some query row in [q_first, q_last] keeps.
// A row qp >= sk keeps a key only while qp < sk - 1 + window; if some row
// keeps none, every key counts and none is skipped.
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

// ------------------------- SIMT path (f32, misaligned bf16) --------------
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
  int k_begin, k_end;
  key_range(a, q0, q_last, k_begin, k_end);

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
    if (a.lse != nullptr && lane == 0)
      a.lse[static_cast<int64_t>(blockIdx.y) * a.sq + qp] = m[r] + logf(l[r]);
  }
}

template <typename T, int HD>
int launch_simt(const Args& a, int64_t batch, cudaStream_t stream) {
  const int warps = min(kMaxWarps, (a.sq + kRows - 1) / kRows);
  const int bq = warps * kRows;
  const dim3 grid(static_cast<unsigned>((a.sq + bq - 1) / bq),
                  static_cast<unsigned>(batch * a.h));
  flash_attention_kernel<T, HD><<<grid, warps * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------- bf16 tensor-core path -------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zero-filled when !valid (src is then
// not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x; flushes results below 2^-126 to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 as bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD, int WARPS, int MT>
struct Mma {
  static constexpr int BM = WARPS * MT * 16;    // rows of a block
  static constexpr int BN = 64;                 // keys of a tile
  static constexpr int LD = HD + 8;             // padded smem row, elements
  static constexpr int SMEM = (BM + 4 * BN) * LD * 2;   // Q, 2x K, 2x V
};

// Rows of a block: (query qp, head hg of the KV group) pairs r = qp * g +
// hg of the B x KV problem of blockIdx.y. Thread (warp, lane) of quad
// row gr = lane / 4 owns rows warp * MT * 16 + mt * 16 + gr + 8 * hr.
template <int HD, int WARPS, int MT>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_kernel_mma(const Args a) {
  using C = Mma<HD, WARPS, MT>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD;
  constexpr int CH = HD / 8;        // 16-byte chunks of a row
  constexpr int NS = BN / 8;        // n-tiles of S
  constexpr int ND = HD / 8;        // n-tiles of O
  constexpr int NT = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const qsm = reinterpret_cast<bf16*>(smem);
  bf16* const ksm = qsm + BM * LD;          // [2][BN][LD]
  bf16* const vsm = ksm + 2 * BN * LD;      // [2][BN][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, gc = lane % 4;
  const int g = a.h / a.kv;
  const int b = blockIdx.y / a.kv, kh = blockIdx.y % a.kv;
  const int64_t rows = static_cast<int64_t>(a.sq) * g;
  // Causal: the longest row tiles first.
  const int tile = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int64_t r0 = static_cast<int64_t>(tile) * BM;
  const int q_first = static_cast<int>(r0 / g);
  const int q_last = static_cast<int>((min(r0 + BM, rows) - 1) / g);
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qs.b +
                  static_cast<int64_t>(kh) * g * a.qs.h;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vs.b + kh * a.vs.h;
  bf16* o = static_cast<bf16*>(a.o) + b * a.os.b +
            static_cast<int64_t>(kh) * g * a.os.h;

  for (int i = tid; i < BM * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const int64_t rg = r0 + r;
    const bool in = rg < rows;
    const int64_t off = in ? (rg / g) * a.qs.s + (rg % g) * a.qs.h + c * 8 : 0;
    cp_async16(smem_addr(qsm + r * LD + c * 8), q + off, in);
  }
  int k_begin, k_end;
  key_range(a, q_first, q_last, k_begin, k_end);
  auto load_kv = [&](int kt, int buf) {
    const uint32_t kd = smem_addr(ksm + buf * BN * LD);
    const uint32_t vd = smem_addr(vsm + buf * BN * LD);
    for (int i = tid; i < BN * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      const int kp = kt + r;
      const bool in = kp < k_end;
      const int64_t kp64 = in ? kp : 0;
      const uint32_t so = (r * LD + c * 8) * 2;
      cp_async16(kd + so, k + kp64 * a.ks.s + c * 8, in);
      cp_async16(vd + so, v + kp64 * a.vs.s + c * 8, in);
    }
  };
  load_kv(k_begin, 0);
  cp_async_commit();

  // The query of each owned row, for the causal mask.
  int qrow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      qrow[mt][hr] = static_cast<int>(
          (r0 + warp * MT * 16 + mt * 16 + gr + 8 * hr) / g);

  float m[MT][2], l[MT][2], acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[mt][hr] = kMasked;
      l[mt][hr] = 0.f;    // this thread's share; the quad sums at the end
    }
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][d][e] = 0.f;
  }
  const bool capped = a.softcap != 0.f;
  const float inv_cap = capped ? 1.f / a.softcap : 0.f;
  // log2(e) per unit of the scores as held: scaled with a softcap, raw
  // without.
  const float sl = capped ? kLog2e : a.scale * kLog2e;
  const bf16* qw = qsm + warp * MT * 16 * LD;

  int buf = 0;
  for (int kt = k_begin; kt < k_end; kt += BN, buf ^= 1) {
    cp_async_wait_all();      // this thread's copies of Q and this tile
    __syncthreads();          // everyone's; and the other buffer is free
    if (kt + BN < k_end) {
      load_kv(kt + BN, buf ^ 1);
      cp_async_commit();
    }
    const bf16* kb = ksm + buf * BN * LD;
    const bf16* vb = vsm + buf * BN * LD;

    // S = Q . K^T
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(qa[mt], smem_addr(qw + (mt * 16 + lane % 16) * LD +
                                      kk * 16 + (lane / 16) * 8));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb4[4];
        ldmatrix_x4(kb4, smem_addr(kb + (np * 16 + lane % 8 + 8 * (lane / 16))
                                            * LD + kk * 16
                                        + ((lane / 8) % 2) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qa[mt], kb4[0], kb4[1]);
          mma_bf16(s[mt][2 * np + 1], qa[mt], kb4[2], kb4[3]);
        }
      }
    }

    // Softcap and mask, each pass free of branches; then the online
    // softmax per row. Without a softcap the scores stay unscaled and the
    // scale enters the exponent (sl): the max commutes with a positive
    // scale, a masked -2e38 still gives p = exp((-2e38 - m) * scale) = 0
    // beside a real m, and p = 1 in a row masked so far (m = -2e38).
    if (capped) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][j][e] = a.softcap * tanhf(s[mt][j][e] * a.scale * inv_cap);
    }
    const bool full = kt + BN <= k_end &&
        (!a.causal || (kt + BN - 1 <= q_first &&
                       (a.window <= 0 || kt > q_last - a.window)));
    if (!full) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = qrow[mt][e / 2];
            const int kp = kt + j * 8 + 2 * gc + e % 2;
            if (kp >= k_end)
              s[mt][j][e] = -INFINITY;
            else if (a.causal &&
                     (kp > qp || (a.window > 0 && kp <= qp - a.window)))
              s[mt][j][e] = kMasked;
          }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = m[mt][hr];
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * hr], s[mt][j][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float corr = exp2_approx((m[mt][hr] - mx) * sl);
        m[mt][hr] = mx;
        // (s - m) before the multiply, never one fma: s = m = -2e38 must
        // give exactly 0, which an fma's unrounded product would not.
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float p0 = exp2_approx((s[mt][j][2 * hr] - mx) * sl);
          const float p1 = exp2_approx((s[mt][j][2 * hr + 1] - mx) * sl);
          s[mt][j][2 * hr] = p0;
          s[mt][j][2 * hr + 1] = p1;
          ps0 += p0;
          ps1 += p1;
        }
        l[mt][hr] = l[mt][hr] * corr + (ps0 + ps1);
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          acc[mt][d][2 * hr] *= corr;
          acc[mt][d][2 * hr + 1] *= corr;
        }
      }
    }

    // O += P . V, p rounded to bf16 as the A fragment.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, smem_addr(vb + (kk * 16 + lane % 8
                                               + 8 * ((lane / 8) % 2)) * LD
                                         + dp * 16 + (lane / 16) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * dp], pa[mt], vb4[0], vb4[1]);
          mma_bf16(acc[mt][2 * dp + 1], pa[mt], vb4[2], vb4[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lt = l[mt][hr];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float denom = fmaxf(lt, 1e-30f);
      const int64_t rg = r0 + warp * MT * 16 + mt * 16 + gr + 8 * hr;
      if (rg >= rows) continue;
      if (a.lse != nullptr && gc == 0)    // m is raw without a softcap
        a.lse[(static_cast<int64_t>(b) * a.h + kh * g + rg % g) * a.sq +
              rg / g] = (capped ? m[mt][hr] : m[mt][hr] * a.scale) + logf(lt);
      bf16* orow = o + (rg / g) * a.os.s + (rg % g) * a.os.h + 2 * gc;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<uint32_t*>(orow + d * 8) = pack_bf16(
            acc[mt][d][2 * hr] / denom, acc[mt][d][2 * hr + 1] / denom);
    }
  }
}

template <int HD, int WARPS, int MT>
int launch_mma(const Args& a, int64_t batch, cudaStream_t stream) {
  using C = Mma<HD, WARPS, MT>;
  const auto kern = flash_attention_kernel_mma<HD, WARPS, MT>;
  // Shared memory above 48 KB is opt-in, once per kernel.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int64_t rows = static_cast<int64_t>(a.sq) * (a.h / a.kv);
  const dim3 grid(static_cast<unsigned>((rows + C::BM - 1) / C::BM),
                  static_cast<unsigned>(batch * a.kv));
  kern<<<grid, WARPS * 32, C::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The card's SM count, read once.
cudaError_t sm_count(int* n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *n = sms;
  return cudaSuccess;
}

template <int HD>
int launch_bf16(const Args& a, int64_t batch, cudaStream_t s) {
  const int64_t rows = static_cast<int64_t>(a.sq) * (a.h / a.kv);
  if (rows <= 16) return launch_mma<HD, 1, 1>(a, batch, s);      // decode
  constexpr int kLong = Mma<HD, 4, 2>::BM;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (batch * a.kv * ((rows + kLong - 1) / kLong) >= sms)
    return launch_mma<HD, 4, 2>(a, batch, s);
  return launch_mma<HD, 4, 1>(a, batch, s);
}

bool aligned16(const void* p, const Strides& st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 &&
         st.s % 8 == 0 && st.h % 8 == 0;
}

template <int HD>
int launch(const Args& a, int is_bf16, int64_t batch, cudaStream_t s) {
  if (!is_bf16) return launch_simt<float, HD>(a, batch, s);
  if (aligned16(a.q, a.qs) && aligned16(a.k, a.ks) && aligned16(a.v, a.vs) &&
      aligned16(a.o, a.os))
    return launch_bf16<HD>(a, batch, s);
  return launch_simt<bf16, HD>(a, batch, s);
}

}  // namespace

// q [B, Sq, H, hd], k and v [B, Sk, KV, hd], o [B, Sq, H, hd], all of one
// dtype (bf16 when is_bf16, else f32), with the given batch, sequence and
// head strides in elements; lse [B, H, Sq] f32 or null. The wrapper checks
// shapes and sizes.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int64_t batch,
    int64_t sq, int64_t sk, int64_t h, int64_t kv, int64_t hd, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int causal, int window, float softcap, float scale,
    int is_bf16, void* stream) {
  const Args a{q, k, v, o, lse,
               static_cast<int32_t>(sq), static_cast<int32_t>(sk),
               static_cast<int32_t>(h), static_cast<int32_t>(kv),
               {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
               {o_sb, o_ss, o_sh}, causal, window, softcap, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(a, is_bf16, batch, s);
    case 64: return launch<64>(a, is_bf16, batch, s);
    case 80: return launch<80>(a, is_bf16, batch, s);
    case 128: return launch<128>(a, is_bf16, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
