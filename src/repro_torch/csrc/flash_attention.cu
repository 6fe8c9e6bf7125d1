// Flash attention for Hopper (sm_90a): the forward pass and both halves of
// its gradient, for q (B, Sq, Hq, D) and k/v (B, Sk, Hkv, D), GQA with
// rep = Hq / Hkv query heads per KV head.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` in
// src/repro/kernels/flash_attention/flash_attention.py (body `_flash_kernel`)
// and the custom VJP `_flash_vjp_bwd` of src/repro/models/layers.py, and
// computes the same functions: blockwise online softmax with fp32 m/l/acc,
// the causal / window / chunk / prefix-LM masks of `_flash_mask` plus key
// padding, masked scores set to the finite -1e30 (never -inf, so a live
// tile whose row is all masked gives exp(0) = 1, which a later alpha = 0
// wipes), out in q's type, lse = m + log(max(l, 1e-30)) in fp32 (B, Hq, Sq),
// and a backward that recomputes p = exp(s - lse) from (q, k, lse).
//
// Bound: operations.  At StarCoder2's training shape (S = 4096, D = 128,
// 24 query heads) a causal forward does 4 * S^2/2 * D * Hq = 103 GFLOP on
// 50 MB of q/k/v/out, ~2000 flops per byte, far above the ~295 where the
// tensor cores rather than device memory become the limit; the backward
// does 2.5 times the forward's work.  What the design does about it:
//   * bf16 with D <= 128 (the training path) runs every product on the
//     tensor cores, mma.sync m16n8k16 bf16 -> fp32, with tiles in shared
//     memory read by ldmatrix and the score fragments kept in registers
//     and fed straight back as the next product's operand (FlashAttention-2
//     style; see the tensor-core section below);
//   * float32, and bf16 with D > 128, run fp32 kernels on the CUDA cores:
//     a thread owns a 4 x 4 (or 2 x 2) patch of every score tile and a
//     4-row patch of every output tile, so each pass reads its operands as
//     float4 from shared memory without bank conflicts;
//   * tiles that the mask cannot reach are skipped at block level, with a
//     rule at least as tight as the Pallas one (prefix-LM keeps the causal
//     skip for keys past the prefix, the chunk rule compares chunk ranges);
//   * the dK/dV kernel owns one KV tile and loops over the rep query heads
//     of its group and the q tiles that see it, summing dK/dV over the
//     group inside the block: no atomics, deterministic.  dQ has its own
//     kernel, one block per q tile, looping over the KV tiles.
// Loads are not yet overlapped with compute, and Hopper's wgmma and TMA are
// not used: that is later work.  Nothing is allocated here; launches go on
// the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads: ty = tid / 16, tx = tid % 16
constexpr float kNegInf = -1e30f;

// q/k tile rows: 64 up to D = 128, 32 for D up to 256 (shared memory).
template <int DMAX> struct Tiles {
  static constexpr int BQ = DMAX <= 128 ? 64 : 32;
  static constexpr int BK = BQ;
  static constexpr int LD = DMAX + 4;  // row stride of a (rows, D) tile: 16 B apart in banks
};

// Four consecutive elements of a row, widened to / narrowed from fp32.
template <typename T> struct V4;
template <> struct V4<float> {
  __device__ __forceinline__ static float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};
template <> struct V4<__nv_bfloat16> {
  __device__ __forceinline__ static float4 load(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float4 v) {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(v.x, v.y);
    h[1] = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// The element mask of `_flash_mask` with key padding, and its block-level
// test.  Indices are row numbers; a query's position is q_offset + row.
struct Mask {
  int sq, sk, causal, window, chunk, prefix_len, q_offset;

  __device__ __forceinline__ bool ok(int qi, int kj) const {
    if (kj >= sk) return false;
    const int qp = q_offset + qi;
    if (causal && qp < kj && kj >= prefix_len) return false;
    if (window && qp - kj >= window) return false;
    if (chunk && qp / chunk != kj / chunk) return false;
    return true;
  }

  // Can any (query, key) pair of rows [q0, q0 + nq) x [k0, k0 + nk) be valid?
  __device__ __forceinline__ bool live(int q0, int nq, int k0, int nk) const {
    if (q0 >= sq || k0 >= sk) return false;
    const int qlo = q_offset + q0, qhi = q_offset + min(q0 + nq, sq) - 1;
    const int klo = k0, khi = min(k0 + nk, sk) - 1;
    if (causal && klo > qhi && klo >= prefix_len) return false;
    if (window && qlo - khi >= window) return false;
    if (chunk && (klo / chunk > qhi / chunk || qlo / chunk > khi / chunk)) return false;
    return true;
  }
};

struct Tensor4 {          // a (B, S, H, D) tensor: base pointer and element strides
  const void* p;
  long long sb, ss, sh;
};

struct Args {
  Tensor4 q, k, v, o, g, dq, dk, dv;  // o: out (forward writes it); g: dO
  float* lse;                          // (B, Hq, Sq)
  const float* delta;                  // (B, Hq, Sq): sum over D of dO * out
  int hq, hkv, d;
  float scale;
  Mask mask;
};

// Rows [row0, row0 + R) of one head of a (B, S, H, D) tensor into a
// shared (R, LD) fp32 tile, times `scale`; rows at or past `rows` are zeros.
template <typename T, int R, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long s_stride,
                                          int row0, int rows, int d, float scale) {
  const int vpr = d / 4;
  for (int idx = threadIdx.x; idx < R * vpr; idx += kThreads) {
    const int r = idx / vpr, c = (idx - r * vpr) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) {
      x = V4<T>::load(src + (row0 + r) * s_stride + c);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

// acc[i][j] = sum_d X[ty + 16 i][d] * Y[tx + 16 j][d] for two row-major tiles.
template <int MI, int MJ, int LD>
__device__ __forceinline__ void dot_rows(float (&acc)[MI][MJ], const float* X, const float* Y,
                                         int d, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < d; c += 4) {
    float4 x[MI], y[MJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) x[i] = *reinterpret_cast<const float4*>(X + (ty + 16 * i) * LD + c);
#pragma unroll
    for (int j = 0; j < MJ; ++j) y[j] = *reinterpret_cast<const float4*>(Y + (tx + 16 * j) * LD + c);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        float a = acc[i][j];
        a = fmaf(x[i].x, y[j].x, a);
        a = fmaf(x[i].y, y[j].y, a);
        a = fmaf(x[i].z, y[j].z, a);
        a = fmaf(x[i].w, y[j].w, a);
        acc[i][j] = a;
      }
  }
}

// acc[i][j][e] += sum_k X[ty + 16 i][k] * Y[k][n], n = 4 tx + 64 j + e < d,
// for X (rows, K) with row stride LDX and Y (K, D) with row stride LDY.
template <int MI, int NJ, int K, int LDX, int LDY>
__device__ __forceinline__ void acc_rows(float (&acc)[MI][NJ][4], const float* X,
                                         const float* Y, int d, int ty, int tx) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 x[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) x[i] = *reinterpret_cast<const float4*>(X + (ty + 16 * i) * LDX + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = 4 * tx + 64 * j;
        if (n < d) {
          const float4 y = *reinterpret_cast<const float4*>(Y + (k + kk) * LDY + n);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const float xi = kk == 0 ? x[i].x : kk == 1 ? x[i].y : kk == 2 ? x[i].z : x[i].w;
            acc[i][j][0] = fmaf(xi, y.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(xi, y.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(xi, y.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(xi, y.w, acc[i][j][3]);
          }
        }
      }
    }
  }
}

// Reduce over the 16 lanes of a half warp (the threads of one ty).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Store rows ty + 16 i of an fp32 (rows, D) accumulator as T, rows < rows_valid.
template <typename T, int MI, int NJ>
__device__ __forceinline__ void store_rows(const Tensor4& t, int b, int h, int row0,
                                           int rows_valid, int d, const float (&acc)[MI][NJ][4],
                                           const float (&inv)[MI], int ty, int tx) {
  T* base = static_cast<T*>(const_cast<void*>(t.p)) + b * t.sb + h * t.sh;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= rows_valid) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = 4 * tx + 64 * j;
      if (n < d)
        V4<T>::store(base + row * t.ss + n,
                     make_float4(acc[i][j][0] * inv[i], acc[i][j][1] * inv[i],
                                 acc[i][j][2] * inv[i], acc[i][j][3] * inv[i]));
    }
  }
}

// ------------------------------------------------------------------ forward
// grid (ceil(Sq / BQ), Hq, B): one block per (q tile, q head, batch).
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  constexpr int BQ = Tiles<DMAX>::BQ, BK = Tiles<DMAX>::BK, LD = Tiles<DMAX>::LD;
  constexpr int LDP = BK + 4, MI = BQ / 16, MJ = BK / 16, NJ = (DMAX + 63) / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, g = h / (a.hq / a.hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const Mask& mk = a.mask;
  load_tile<T, BQ, LD>(Qs, static_cast<const T*>(a.q.p) + b * a.q.sb + h * a.q.sh, a.q.ss, q0,
                       mk.sq, a.d, a.scale);
  const T* kbase = static_cast<const T*>(a.k.p) + b * a.k.sb + g * a.k.sh;
  const T* vbase = static_cast<const T*>(a.v.p) + b * a.v.sb + g * a.v.sh;

  float m[MI], l[MI], acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  for (int k0 = 0; k0 < mk.sk; k0 += BK) {
    if (!mk.live(q0, BQ, k0, BK)) continue;
    __syncthreads();  // the last tile's readers are done; the q tile is in place
    load_tile<T, BK, LD>(Ks, kbase, a.k.ss, k0, mk.sk, a.d, 1.f);
    load_tile<T, BK, LD>(Vs, vbase, a.v.ss, k0, mk.sk, a.d, 1.f);
    __syncthreads();
    float s[MI][MJ];
    dot_rows<MI, MJ, LD>(s, Qs, Ks, a.d, ty, tx);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        if (!mk.ok(qi, k0 + tx + 16 * j)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha;
    }
    __syncthreads();
    acc_rows<MI, NJ, BK, LDP, LD>(acc, Ps, Vs, a.d, ty, tx);
  }

  float inv[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const float lmax = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / lmax;
    const int qi = q0 + ty + 16 * i;
    if (tx == 0 && qi < mk.sq)
      a.lse[((long long)b * a.hq + h) * mk.sq + qi] = m[i] + logf(lmax);
  }
  store_rows<T, MI, NJ>(a.o, b, h, q0, mk.sq, a.d, acc, inv, ty, tx);
}

// Scores of one (q tile, kv tile) pair in the backward: p = exp(s - lse)
// with s = q.k * scale (masked to -1e30), ds = p * (dp - delta) * scale with
// dp = dO.v.  Rows at or past Sq get p = ds = 0.
template <int MI, int MJ, int LD>
__device__ __forceinline__ void bwd_scores(float (&p)[MI][MJ], float (&ds)[MI][MJ],
                                           const float* Qs, const float* Gs, const float* Ks,
                                           const float* Vs, const float* lse_s,
                                           const float* del_s, int q0, int k0, const Args& a,
                                           int ty, int tx) {
  float dp[MI][MJ];
  dot_rows<MI, MJ, LD>(p, Qs, Ks, a.d, ty, tx);
  dot_rows<MI, MJ, LD>(dp, Gs, Vs, a.d, ty, tx);
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      float pij = 0.f;
      if (qi < a.mask.sq) {
        const float s = a.mask.ok(qi, k0 + tx + 16 * j) ? p[i][j] * a.scale : kNegInf;
        pij = expf(s - lse_s[r]);
      }
      p[i][j] = pij;
      ds[i][j] = pij * (dp[i][j] - del_s[r]) * a.scale;
    }
  }
}

// q, dO, lse and delta of one q tile into shared memory.
template <typename T, int BQ, int LD>
__device__ __forceinline__ void load_q_side(float* Qs, float* Gs, float* lse_s, float* del_s,
                                            const Args& a, int b, int h, int q0) {
  const int sq = a.mask.sq;
  load_tile<T, BQ, LD>(Qs, static_cast<const T*>(a.q.p) + b * a.q.sb + h * a.q.sh, a.q.ss, q0,
                       sq, a.d, 1.f);
  load_tile<T, BQ, LD>(Gs, static_cast<const T*>(a.g.p) + b * a.g.sb + h * a.g.sh, a.g.ss, q0,
                       sq, a.d, 1.f);
  const long long row = ((long long)b * a.hq + h) * sq;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = q0 + r < sq;
    lse_s[r] = in ? a.lse[row + q0 + r] : 0.f;
    del_s[r] = in ? a.delta[row + q0 + r] : 0.f;
  }
}

// ------------------------------------------------------------ backward dK/dV
// grid (ceil(Sk / BK), Hkv, B): one block per (kv tile, KV head, batch).
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const Args a) {
  constexpr int BQ = Tiles<DMAX>::BQ, BK = Tiles<DMAX>::BK, LD = Tiles<DMAX>::LD;
  constexpr int LDT = BQ + 4, MI = BQ / 16, MJ = BK / 16, MK = BK / 16, NJ = (DMAX + 63) / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* Gs = Qs + BQ * LD;
  float* Pt = Gs + BQ * LD;   // (BK, BQ): p transposed
  float* Dt = Pt + BK * LDT;  // (BK, BQ): ds transposed
  float* lse_s = Dt + BK * LDT;
  float* del_s = lse_s + BQ;

  const int k0 = blockIdx.x * BK, g = blockIdx.y, b = blockIdx.z, rep = a.hq / a.hkv;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const Mask& mk = a.mask;
  load_tile<T, BK, LD>(Ks, static_cast<const T*>(a.k.p) + b * a.k.sb + g * a.k.sh, a.k.ss, k0,
                       mk.sk, a.d, 1.f);
  load_tile<T, BK, LD>(Vs, static_cast<const T*>(a.v.p) + b * a.v.sb + g * a.v.sh, a.v.ss, k0,
                       mk.sk, a.d, 1.f);

  float dk[MK][NJ][4], dv[MK][NJ][4];
#pragma unroll
  for (int i = 0; i < MK; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][j][e] = dv[i][j][e] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    for (int q0 = 0; q0 < mk.sq; q0 += BQ) {
      if (!mk.live(q0, BQ, k0, BK)) continue;
      __syncthreads();
      load_q_side<T, BQ, LD>(Qs, Gs, lse_s, del_s, a, b, h, q0);
      __syncthreads();
      float p[MI][MJ], ds[MI][MJ];
      bwd_scores<MI, MJ, LD>(p, ds, Qs, Gs, Ks, Vs, lse_s, del_s, q0, k0, a, ty, tx);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < MJ; ++j) {
          Pt[(tx + 16 * j) * LDT + ty + 16 * i] = p[i][j];
          Dt[(tx + 16 * j) * LDT + ty + 16 * i] = ds[i][j];
        }
      __syncthreads();
      acc_rows<MK, NJ, BQ, LDT, LD>(dv, Pt, Gs, a.d, ty, tx);  // dV += p^T dO
      acc_rows<MK, NJ, BQ, LDT, LD>(dk, Dt, Qs, a.d, ty, tx);  // dK += ds^T q
    }
  }
  float one[MK];
#pragma unroll
  for (int i = 0; i < MK; ++i) one[i] = 1.f;
  store_rows<T, MK, NJ>(a.dk, b, g, k0, mk.sk, a.d, dk, one, ty, tx);
  store_rows<T, MK, NJ>(a.dv, b, g, k0, mk.sk, a.d, dv, one, ty, tx);
}

// --------------------------------------------------------------- backward dQ
// grid (ceil(Sq / BQ), Hq, B): one block per (q tile, q head, batch).
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Args a) {
  constexpr int BQ = Tiles<DMAX>::BQ, BK = Tiles<DMAX>::BK, LD = Tiles<DMAX>::LD;
  constexpr int LDP = BK + 4, MI = BQ / 16, MJ = BK / 16, NJ = (DMAX + 63) / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + BQ * LD;
  float* Ks = Gs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ds = Vs + BK * LD;  // (BQ, BK): ds
  float* lse_s = Ds + BQ * LDP;
  float* del_s = lse_s + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, g = h / (a.hq / a.hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const Mask& mk = a.mask;
  load_q_side<T, BQ, LD>(Qs, Gs, lse_s, del_s, a, b, h, q0);
  const T* kbase = static_cast<const T*>(a.k.p) + b * a.k.sb + g * a.k.sh;
  const T* vbase = static_cast<const T*>(a.v.p) + b * a.v.sb + g * a.v.sh;

  float dq[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[i][j][e] = 0.f;

  for (int k0 = 0; k0 < mk.sk; k0 += BK) {
    if (!mk.live(q0, BQ, k0, BK)) continue;
    __syncthreads();
    load_tile<T, BK, LD>(Ks, kbase, a.k.ss, k0, mk.sk, a.d, 1.f);
    load_tile<T, BK, LD>(Vs, vbase, a.v.ss, k0, mk.sk, a.d, 1.f);
    __syncthreads();
    float p[MI][MJ], ds[MI][MJ];
    bwd_scores<MI, MJ, LD>(p, ds, Qs, Gs, Ks, Vs, lse_s, del_s, q0, k0, a, ty, tx);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MJ; ++j) Ds[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    acc_rows<MI, NJ, BK, LDP, LD>(dq, Ds, Ks, a.d, ty, tx);  // dQ += ds k
  }
  float one[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) one[i] = 1.f;
  store_rows<T, MI, NJ>(a.dq, b, h, q0, mk.sq, a.d, dq, one, ty, tx);
}

// ------------------------------------------------- bf16 tensor-core kernels
// For bf16 inputs with D <= 128 (StarCoder2's training path) the three
// kernels run their products on the tensor cores with mma.sync m16n8k16
// (bf16 in, fp32 accumulate).  Tiles stay bf16 in shared memory (rows
// padded by 16 bytes, so ldmatrix reads 8 rows without bank conflicts),
// loaded with cp.async.  A warp owns 16 rows of its block's tile; scores,
// probabilities and accumulators live in mma fragments in registers, and
// the fp32 score fragment is repacked as the bf16 A operand of the next
// product, as FlashAttention-2 does.  Softmax, masks and lse stay fp32.

constexpr int kMmaThreads = 128;  // 4 warps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c += a (16 x 16, row) * b (16 x 8, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Rows [row0, row0 + R) of one head into a shared (R, LDS) bf16 tile;
// rows at or past `rows` and columns at or past d (up to DMAX) are zeros.
template <int R, int DMAX, int LDS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long s_stride, int row0, int rows, int d,
                                               int nthreads) {
  constexpr int VPR = DMAX / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < R * VPR; idx += nthreads) {
    const int r = idx / VPR, c = (idx - r * VPR) * 8;
    const bool ok = row0 + r < rows && c < d;
    cp_async16(dst + r * LDS + c, ok ? src + (row0 + r) * s_stride + c : src, ok);
  }
}

// The A fragments (16 x 16 at rows r0, columns 16 kk) of a row-major tile.
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const __nv_bfloat16* t, int lds,
                                       int r0, int kk, int lane) {
  ldsm_x4(a, t + (r0 + (lane & 15)) * lds + kk * 16 + (lane >> 4) * 8);
}
// B fragments of two n-tiles (rows n0..n0+15 of a row-major tile read as
// (k = column, n = row)), columns 16 kk: b[0..1] for n0, b[2..3] for n0 + 8.
__device__ __forceinline__ void ldsm_b_rows(uint32_t (&b)[4], const __nv_bfloat16* t, int lds,
                                            int n0, int kk, int lane) {
  ldsm_x4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * lds + kk * 16 + ((lane >> 3) & 1) * 8);
}
// B fragments of two n-tiles (columns n0..n0+15) of a row-major tile read
// as (k = row, n = column), rows 16 kk.. : b[0..1] for n0, b[2..3] for n0 + 8.
__device__ __forceinline__ void ldsm_b_cols(uint32_t (&b)[4], const __nv_bfloat16* t, int lds,
                                            int n0, int kk, int lane) {
  ldsm_x4_t(b, t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * lds + n0 + (lane >> 4) * 8);
}
// A fragment of k-step t from an fp32 accumulator of n-tiles 2t and 2t + 1.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// acc[j] (16 x 8 n-tiles, NT of them) = tile rows r0.. of X times rows of Y
// over DMAX columns: X (rows, DMAX), Y (NT * 8 rows, DMAX), both row-major.
template <int NT, int DMAX, int LDS>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], const __nv_bfloat16* X, int r0,
                                         const __nv_bfloat16* Y, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    uint32_t a[4];
    ldsm_a(a, X, LDS, r0, kk, lane);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t b[4];
      ldsm_b_rows(b, Y, LDS, jj * 16, kk, lane);
      mma16816(acc[2 * jj], a, b[0], b[1]);
      mma16816(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// out[n] (16 x DMAX as DMAX / 8 n-tiles) += P (16 x 8 NT, fp32 fragments)
// times Y (8 NT rows, DMAX), Y row-major.
template <int NT, int DMAX, int LDS>
__device__ __forceinline__ void mma_acc(float (&out)[DMAX / 8][4], const float (&p)[NT][4],
                                        const __nv_bfloat16* Y, int lane) {
#pragma unroll
  for (int t = 0; t < NT / 2; ++t) {
    uint32_t a[4];
    acc_to_a(a, p[2 * t], p[2 * t + 1]);
#pragma unroll
    for (int nn = 0; nn < DMAX / 16; ++nn) {
      uint32_t b[4];
      ldsm_b_cols(b, Y, LDS, nn * 16, t, lane);
      mma16816(out[2 * nn], a, b[0], b[1]);
      mma16816(out[2 * nn + 1], a, b[2], b[3]);
    }
  }
}

// Store a warp's 16 x DMAX fp32 fragments (rows row0 + gid, + 8) as bf16.
template <int DMAX>
__device__ __forceinline__ void store_frag_rows(const Tensor4& t, int b, int h, int row0,
                                                int rows_valid, int d,
                                                const float (&acc)[DMAX / 8][4], float s_lo,
                                                float s_hi, int lane) {
  __nv_bfloat16* base = static_cast<__nv_bfloat16*>(const_cast<void*>(t.p)) + b * t.sb + h * t.sh;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + gid + 8 * half;
    if (row >= rows_valid) continue;
    const float sc = half ? s_hi : s_lo;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      const int col = n * 8 + tig * 2;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(base + row * t.ss + col) =
            __floats2bfloat162_rn(acc[n][2 * half] * sc, acc[n][2 * half + 1] * sc);
    }
  }
}

template <int DMAX> struct MmaTiles {
  static constexpr int BQ = 64, BK = 64, BQB = 32;  // BQB: q rows per step of the dK/dV loop
  static constexpr int LDS = DMAX + 8;
};

// grid (ceil(Sq / 64), Hq, B)
template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(const Args a) {
  constexpr int BQ = MmaTiles<DMAX>::BQ, BK = MmaTiles<DMAX>::BK, LDS = MmaTiles<DMAX>::LDS;
  constexpr int NT = BK / 8, NO = DMAX / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Ks = Qs + BQ * LDS;
  __nv_bfloat16* Vs = Ks + BK * LDS;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, g = h / (a.hq / a.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const Mask& mk = a.mask;
  using bf = __nv_bfloat16;
  load_tile_bf16<BQ, DMAX, LDS>(Qs, static_cast<const bf*>(a.q.p) + b * a.q.sb + h * a.q.sh,
                                a.q.ss, q0, mk.sq, a.d, kMmaThreads);
  cp_async_wait_all();
  const bf* kbase = static_cast<const bf*>(a.k.p) + b * a.k.sb + g * a.k.sh;
  const bf* vbase = static_cast<const bf*>(a.v.p) + b * a.v.sb + g * a.v.sh;
  const int r_lo = q0 + warp * 16 + gid, r_hi = r_lo + 8;

  float o[NO][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int k0 = 0; k0 < mk.sk; k0 += BK) {
    if (!mk.live(q0, BQ, k0, BK)) continue;
    __syncthreads();
    load_tile_bf16<BK, DMAX, LDS>(Ks, kbase, a.k.ss, k0, mk.sk, a.d, kMmaThreads);
    load_tile_bf16<BK, DMAX, LDS>(Vs, vbase, a.v.ss, k0, mk.sk, a.d, kMmaThreads);
    cp_async_wait_all();
    __syncthreads();
    float s[NT][4];
    mma_rows<NT, DMAX, LDS>(s, Qs, warp * 16, Ks, lane);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + tig * 2 + (e & 1);
        const float v = mk.ok(e < 2 ? r_lo : r_hi, col) ? s[j][e] * a.scale : kNegInf;
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];  // this thread's columns
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }
    mma_acc<NT, DMAX, LDS>(o, s, Vs, lane);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float lmax = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / lmax;
    const int row = i ? r_hi : r_lo;
    if (tig == 0 && row < mk.sq)
      a.lse[((long long)b * a.hq + h) * mk.sq + row] = m[i] + logf(lmax);
  }
  store_frag_rows<DMAX>(a.o, b, h, q0 + warp * 16, mk.sq, a.d, o, inv[0], inv[1], lane);
}

// p = exp(s * scale - lse) (masked s = -1e30; rows past Sq give 0) and
// ds = p * (dp - delta) * scale for fragments whose element e sits at
// (qi(e), kj(e)).  lse_s / del_s are indexed by qi - q0.
template <int NT, typename QI, typename KJ>
__device__ __forceinline__ void mma_bwd_scores(float (&s)[NT][4], float (&dp)[NT][4],
                                               const float* lse_s, const float* del_s, int q0,
                                               const Args& a, QI qi_of, KJ kj_of) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = qi_of(j, e), kj = kj_of(j, e);
      float p = 0.f;
      if (qi < a.mask.sq)
        p = expf((a.mask.ok(qi, kj) ? s[j][e] * a.scale : kNegInf) - lse_s[qi - q0]);
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - del_s[qi - q0]) * a.scale;
    }
}

template <int BQ, int DMAX, int LDS>
__device__ __forceinline__ void load_q_side_bf16(__nv_bfloat16* Qs, __nv_bfloat16* Gs,
                                                 float* lse_s, float* del_s, const Args& a,
                                                 int b, int h, int q0) {
  using bf = __nv_bfloat16;
  const int sq = a.mask.sq;
  load_tile_bf16<BQ, DMAX, LDS>(Qs, static_cast<const bf*>(a.q.p) + b * a.q.sb + h * a.q.sh,
                                a.q.ss, q0, sq, a.d, kMmaThreads);
  load_tile_bf16<BQ, DMAX, LDS>(Gs, static_cast<const bf*>(a.g.p) + b * a.g.sb + h * a.g.sh,
                                a.g.ss, q0, sq, a.d, kMmaThreads);
  const long long row = ((long long)b * a.hq + h) * sq;
  for (int r = threadIdx.x; r < BQ; r += kMmaThreads) {
    const bool in = q0 + r < sq;
    lse_s[r] = in ? a.lse[row + q0 + r] : 0.f;
    del_s[r] = in ? a.delta[row + q0 + r] : 0.f;
  }
}

// grid (ceil(Sk / 64), Hkv, B): a warp owns 16 keys; q steps of 32 rows.
template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkdv_mma_kernel(const Args a) {
  constexpr int BK = MmaTiles<DMAX>::BK, BQ = MmaTiles<DMAX>::BQB, LDS = MmaTiles<DMAX>::LDS;
  constexpr int NT = BQ / 8, NO = DMAX / 8;
  using bf = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  bf* Ks = reinterpret_cast<bf*>(smem4);
  bf* Vs = Ks + BK * LDS;
  bf* Qs = Vs + BK * LDS;
  bf* Gs = Qs + BQ * LDS;
  float* lse_s = reinterpret_cast<float*>(Gs + BQ * LDS);
  float* del_s = lse_s + BQ;

  const int k0 = blockIdx.x * BK, g = blockIdx.y, b = blockIdx.z, rep = a.hq / a.hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const Mask& mk = a.mask;
  load_tile_bf16<BK, DMAX, LDS>(Ks, static_cast<const bf*>(a.k.p) + b * a.k.sb + g * a.k.sh,
                                a.k.ss, k0, mk.sk, a.d, kMmaThreads);
  load_tile_bf16<BK, DMAX, LDS>(Vs, static_cast<const bf*>(a.v.p) + b * a.v.sb + g * a.v.sh,
                                a.v.ss, k0, mk.sk, a.d, kMmaThreads);
  cp_async_wait_all();
  const int key_lo = k0 + warp * 16 + gid;

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    for (int q0 = 0; q0 < mk.sq; q0 += BQ) {
      if (!mk.live(q0, BQ, k0, BK)) continue;
      __syncthreads();
      load_q_side_bf16<BQ, DMAX, LDS>(Qs, Gs, lse_s, del_s, a, b, h, q0);
      cp_async_wait_all();
      __syncthreads();
      float st[NT][4], dpt[NT][4];  // (keys, q): s^T and dp^T
      mma_rows<NT, DMAX, LDS>(st, Ks, warp * 16, Qs, lane);
      mma_rows<NT, DMAX, LDS>(dpt, Vs, warp * 16, Gs, lane);
      mma_bwd_scores<NT>(
          st, dpt, lse_s, del_s, q0, a,
          [&](int j, int e) { return q0 + j * 8 + tig * 2 + (e & 1); },
          [&](int j, int e) { return key_lo + (e >> 1) * 8; });
      mma_acc<NT, DMAX, LDS>(dv, st, Gs, lane);   // dV += p^T dO
      mma_acc<NT, DMAX, LDS>(dk, dpt, Qs, lane);  // dK += ds^T q
    }
  }
  store_frag_rows<DMAX>(a.dk, b, g, k0 + warp * 16, mk.sk, a.d, dk, 1.f, 1.f, lane);
  store_frag_rows<DMAX>(a.dv, b, g, k0 + warp * 16, mk.sk, a.d, dv, 1.f, 1.f, lane);
}

// grid (ceil(Sq / 64), Hq, B): a warp owns 16 q rows.
template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_mma_kernel(const Args a) {
  constexpr int BQ = MmaTiles<DMAX>::BQ, BK = MmaTiles<DMAX>::BK, LDS = MmaTiles<DMAX>::LDS;
  constexpr int NT = BK / 8, NO = DMAX / 8;
  using bf = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  bf* Qs = reinterpret_cast<bf*>(smem4);
  bf* Gs = Qs + BQ * LDS;
  bf* Ks = Gs + BQ * LDS;
  bf* Vs = Ks + BK * LDS;
  float* lse_s = reinterpret_cast<float*>(Vs + BK * LDS);
  float* del_s = lse_s + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, g = h / (a.hq / a.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const Mask& mk = a.mask;
  load_q_side_bf16<BQ, DMAX, LDS>(Qs, Gs, lse_s, del_s, a, b, h, q0);
  cp_async_wait_all();
  const bf* kbase = static_cast<const bf*>(a.k.p) + b * a.k.sb + g * a.k.sh;
  const bf* vbase = static_cast<const bf*>(a.v.p) + b * a.v.sb + g * a.v.sh;
  const int r_lo = q0 + warp * 16 + gid;

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int k0 = 0; k0 < mk.sk; k0 += BK) {
    if (!mk.live(q0, BQ, k0, BK)) continue;
    __syncthreads();
    load_tile_bf16<BK, DMAX, LDS>(Ks, kbase, a.k.ss, k0, mk.sk, a.d, kMmaThreads);
    load_tile_bf16<BK, DMAX, LDS>(Vs, vbase, a.v.ss, k0, mk.sk, a.d, kMmaThreads);
    cp_async_wait_all();
    __syncthreads();
    float s[NT][4], dp[NT][4];
    mma_rows<NT, DMAX, LDS>(s, Qs, warp * 16, Ks, lane);
    mma_rows<NT, DMAX, LDS>(dp, Gs, warp * 16, Vs, lane);
    mma_bwd_scores<NT>(
        s, dp, lse_s, del_s, q0, a, [&](int j, int e) { return r_lo + (e >> 1) * 8; },
        [&](int j, int e) { return k0 + j * 8 + tig * 2 + (e & 1); });
    mma_acc<NT, DMAX, LDS>(dq, dp, Ks, lane);  // dQ += ds k
  }
  store_frag_rows<DMAX>(a.dq, b, h, q0 + warp * 16, mk.sq, a.d, dq, 1.f, 1.f, lane);
}

// ------------------------------------------------------------------- host

enum Kind { kFwd = 0, kDkdv = 1, kDq = 2 };

// The tensor-core kernels take bf16 with D <= 128; f32 and larger heads
// take the fp32 CUDA-core kernels.
bool use_mma(int bf16, int d) { return bf16 && d <= 128; }

int dmax_of(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

template <int DMAX> int smem_bytes(int kind) {
  constexpr int BQ = Tiles<DMAX>::BQ, BK = Tiles<DMAX>::BK, LD = Tiles<DMAX>::LD;
  if (kind == kFwd) return 4 * ((BQ + 2 * BK) * LD + BQ * (BK + 4));
  if (kind == kDkdv) return 4 * ((2 * BQ + 2 * BK) * LD + 2 * BK * (BQ + 4) + 2 * BQ);
  return 4 * ((2 * BQ + 2 * BK) * LD + BQ * (BK + 4) + 2 * BQ);
}

template <int DMAX> int smem_bytes_mma(int kind) {
  using M = MmaTiles<DMAX>;
  if (kind == kFwd) return 2 * (M::BQ + 2 * M::BK) * M::LDS;
  if (kind == kDkdv) return 2 * (2 * M::BK + 2 * M::BQB) * M::LDS + 8 * M::BQB;
  return 2 * (2 * M::BQ + 2 * M::BK) * M::LDS + 8 * M::BQ;
}

int smem_for(int kind, int d, int bf16) {
  if (use_mma(bf16, d)) return d <= 64 ? smem_bytes_mma<64>(kind) : smem_bytes_mma<128>(kind);
  switch (dmax_of(d)) {
    case 64: return smem_bytes<64>(kind);
    case 128: return smem_bytes<128>(kind);
    default: return smem_bytes<256>(kind);
  }
}

template <typename K>
int launch_one(K kernel, dim3 grid, int threads, int smem, const Args& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int launch(int kind, const Args& a, int batch, cudaStream_t st) {
  constexpr int BQ = Tiles<DMAX>::BQ, BK = Tiles<DMAX>::BK;
  const int smem = smem_bytes<DMAX>(kind);
  const int nq = (a.mask.sq + BQ - 1) / BQ, nk = (a.mask.sk + BK - 1) / BK;
  if (kind == kFwd)
    return launch_one(flash_fwd_kernel<T, DMAX>, dim3(nq, a.hq, batch), kThreads, smem, a, st);
  if (kind == kDkdv)
    return launch_one(flash_bwd_dkdv_kernel<T, DMAX>, dim3(nk, a.hkv, batch), kThreads, smem, a,
                      st);
  return launch_one(flash_bwd_dq_kernel<T, DMAX>, dim3(nq, a.hq, batch), kThreads, smem, a, st);
}

template <int DMAX>
int launch_mma(int kind, const Args& a, int batch, cudaStream_t st) {
  using M = MmaTiles<DMAX>;
  const int smem = smem_bytes_mma<DMAX>(kind);
  const int nq = (a.mask.sq + M::BQ - 1) / M::BQ, nk = (a.mask.sk + M::BK - 1) / M::BK;
  if (kind == kFwd)
    return launch_one(flash_fwd_mma_kernel<DMAX>, dim3(nq, a.hq, batch), kMmaThreads, smem, a, st);
  if (kind == kDkdv)
    return launch_one(flash_bwd_dkdv_mma_kernel<DMAX>, dim3(nk, a.hkv, batch), kMmaThreads, smem,
                      a, st);
  return launch_one(flash_bwd_dq_mma_kernel<DMAX>, dim3(nq, a.hq, batch), kMmaThreads, smem, a,
                    st);
}

int launch_f32(int kind, const Args& a, int batch, cudaStream_t st) {
  switch (dmax_of(a.d)) {
    case 64: return launch<float, 64>(kind, a, batch, st);
    case 128: return launch<float, 128>(kind, a, batch, st);
    default: return launch<float, 256>(kind, a, batch, st);
  }
}

Tensor4 tensor4(const void* p, const long long* st) { return Tensor4{p, st[0], st[1], st[2]}; }

}  // namespace

// Shared memory of one block of kernel `kind` (0 forward, 1 dK/dV, 2 dQ)
// at head dim d, for bf16 (1) or f32 (0) inputs.
extern "C" int flash_attention_smem_bytes(int kind, int d, int bf16) {
  return smem_for(kind, d, bf16);
}

// ptrs: q, k, v, out, g, dq, dk, dv, lse, delta (unused ones may be null);
// strides: (batch, seq, head) in elements for the first eight, 24 values;
// shape: B, Hq, Hkv, Sq, Sk, D; mask: causal, window, chunk, prefix_len,
// q_offset.  kind 0 launches the forward (writes out and lse), kind 1 the
// dK/dV kernel and kind 2 the dQ kernel (both read lse and delta).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_launch(int kind, void* const* ptrs, const long long* strides,
                                      const int* shape, const int* mask, int bf16, float scale,
                                      void* stream) {
  Args a;
  a.q = tensor4(ptrs[0], strides + 0);
  a.k = tensor4(ptrs[1], strides + 3);
  a.v = tensor4(ptrs[2], strides + 6);
  a.o = tensor4(ptrs[3], strides + 9);
  a.g = tensor4(ptrs[4], strides + 12);
  a.dq = tensor4(ptrs[5], strides + 15);
  a.dk = tensor4(ptrs[6], strides + 18);
  a.dv = tensor4(ptrs[7], strides + 21);
  a.lse = static_cast<float*>(ptrs[8]);
  a.delta = static_cast<const float*>(ptrs[9]);
  a.hq = shape[1];
  a.hkv = shape[2];
  a.d = shape[5];
  a.scale = scale;
  a.mask = Mask{shape[3], shape[4], mask[0], mask[1], mask[2], mask[3], mask[4]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_mma(bf16, a.d))
    return a.d <= 64 ? launch_mma<64>(kind, a, shape[0], st) : launch_mma<128>(kind, a, shape[0], st);
  if (bf16) return launch<__nv_bfloat16, 256>(kind, a, shape[0], st);  // 128 < D <= 256
  return launch_f32(kind, a, shape[0], st);
}
