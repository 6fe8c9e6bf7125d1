// Flash-decode for Hopper (sm_90a): one query token per sequence against a
// (B, S, Hkv, D) KV cache, GQA with rep = Hq / Hkv query heads per KV head.
//
// Replaces the Pallas TPU kernel `decode_attention_pallas` in
// src/repro/kernels/decode_attention/decode_attention.py (body
// `_decode_kernel`), and computes the same function: fp32 online-softmax
// state (m, l, acc), keys at or past `lengths[b]` skipped, output in q's type.
//
// Bound: device-memory bytes.  Each step reads the live part of the cache,
// 2 * B * L * Hkv * D * sizeof(cache type) bytes, and does about
// 4 * Hq * D flops per key position -- 12 flops per byte at StarCoder2's
// rep = 12 in bf16, far below the ~295 flops per byte where the tensor cores
// would become the limit.  So the design spends its effort on reading each
// K/V byte once and keeping many reads in flight:
//   * one block owns one (batch, kv head, key split); the rep query heads of
//     that KV head live in shared memory and share every K/V tile the block
//     loads, so each K/V byte crosses from device memory once per KV head;
//   * tiles of kTileK keys are copied with cp.async, 16 bytes a thread,
//     neighbouring threads on neighbouring addresses, only up to
//     min(length, S), into two buffers: the next tile is in flight while the
//     block computes on the current one;
//   * the TPU kernel walks key blocks in order on one core; here blocks run
//     in parallel, so a loop inside the block walks the tiles of its split,
//     and the key axis is split across blocks (split-K) so that B * Hkv
//     (16 blocks for StarCoder2 at B = 8) becomes enough blocks to fill the
//     card.  A second small kernel merges the splits' (m, l, acc).
// All arithmetic is fp32 on the CUDA cores, so f32 inputs match the plain
// version to rounding; the kernel allocates nothing and launches on the
// caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileK = 32;   // keys per tile: one lane per key in the softmax pass
constexpr int kRepTile = 4;  // query heads per thread in the score pass
constexpr int kQUnroll = 4;  // q loads in flight per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of a cache row (N elements) and 4 elements, widened to fp32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ __forceinline__ static float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

// Copy 16 bytes global -> shared without staging in registers; with
// valid == false nothing is read and the 16 bytes become zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of one block: fp32 q, acc (rep x D), probabilities
// (rep x kTileK) and m, l, alpha (rep), then two K and two V tiles in the
// cache's type, K rows padded by 16 bytes against bank conflicts.
__host__ __device__ inline int float_words(int rep, int d) {
  return (2 * rep * d + rep * kTileK + 3 * rep + 3) / 4 * 4;
}
__host__ __device__ inline int smem_bytes(int rep, int d, int kv_bytes) {
  const int vec = 16 / kv_bytes;
  return 4 * float_words(rep, d) + 2 * kTileK * (2 * d + vec) * kv_bytes;
}

// grid (n_split, Hkv, B).  With n_split == 1 the block writes the output;
// otherwise it writes its split's (acc, m, l) to part[B, Hq, n_split, D + 2].
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
    const int* __restrict__ lengths, TQ* __restrict__ out, float* __restrict__ part,
    int S, int D, int rep, int chunk, float scale, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh) {
  constexpr int VEC = Vec<TKV>::N;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, hq = gridDim.y * rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kstride = D + VEC;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int k_begin = split * chunk;
  const int k_end = min(k_begin + chunk, len);
  const long long row0 = (long long)b * hq + g * rep;  // first query head of the block

  if (k_begin >= k_end) {  // no live key in this split
    if (n_split == 1) {
      for (int i = tid; i < rep * D; i += kThreads) out[row0 * D + i] = from_f32<TQ>(0.f);
      return;
    }
    for (int i = tid; i < rep * (D + 2); i += kThreads) {
      const int r = i / (D + 2), c = i - r * (D + 2);
      part[((row0 + r) * n_split + split) * (D + 2) + c] = c == D ? kNegInf : 0.f;
    }
    return;
  }

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // rep x D, pre-scaled
  float* acc = qs + rep * D;                    // rep x D
  float* ps = acc + rep * D;                    // rep x kTileK
  float* ms = ps + rep * kTileK;                // rep
  float* ls = ms + rep;                         // rep
  float* as = ls + rep;                         // rep
  TKV* kbuf = reinterpret_cast<TKV*>(qs + float_words(rep, D));  // 2 x kTileK x kstride
  TKV* vbuf = kbuf + 2 * kTileK * kstride;                        // 2 x kTileK x D

  const TKV* kb = k + b * k_sb + g * k_sh;
  const TKV* vb = v + b * v_sb + g * v_sh;
  const int vec_per_row = D / VEC;
  auto issue = [&](int t0, int buf) {
    TKV* kd = kbuf + buf * kTileK * kstride;
    TKV* vd = vbuf + buf * kTileK * D;
    for (int i = tid; i < kTileK * vec_per_row; i += kThreads) {
      const int t = i / vec_per_row, c = (i - t * vec_per_row) * VEC;
      const bool live = t0 + t < k_end;
      const long long key = live ? t0 + t : k_begin;  // a valid address when nothing is read
      cp_async16(kd + t * kstride + c, kb + key * k_ss + c, live);
      cp_async16(vd + t * D + c, vb + key * v_ss + c, live);
    }
    cp_async_commit();
  };
  issue(k_begin, 0);

  const TQ* qb = q + b * q_sb + (long long)(g * rep) * q_sh;
  for (int i0 = tid; i0 < rep * D; i0 += kQUnroll * kThreads) {
    float val[kQUnroll];
#pragma unroll
    for (int u = 0; u < kQUnroll; ++u) {
      const int i = i0 + u * kThreads;
      val[u] = i < rep * D ? to_f32(qb[(i / D) * q_sh + i % D]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kQUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < rep * D) {
        qs[i] = val[u] * scale;
        acc[i] = 0.f;
      }
    }
  }
  for (int r = tid; r < rep; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }

  const int rgroups = (rep + kRepTile - 1) / kRepTile;
  const int dvec = D / 4;
  int buf = 0;
  for (int t0 = k_begin; t0 < k_end; t0 += kTileK, buf ^= 1) {
    if (t0 + kTileK < k_end) {
      issue(t0 + kTileK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const TKV* ks = kbuf + buf * kTileK * kstride;
    const TKV* vs = vbuf + buf * kTileK * D;

    // 1. scores: a warp owns kRepTile query heads, a lane one key.
    for (int i = tid; i < kTileK * rgroups; i += kThreads) {
      const int t = i % kTileK, r0 = (i / kTileK) * kRepTile;
      const TKV* kr = ks + t * kstride;
      const float* qr[kRepTile];
#pragma unroll
      for (int j = 0; j < kRepTile; ++j) qr[j] = qs + min(r0 + j, rep - 1) * D;
      float s[kRepTile];
#pragma unroll
      for (int j = 0; j < kRepTile; ++j) s[j] = 0.f;
      for (int d = 0; d < D; d += VEC) {
        float kk[VEC];
        Vec<TKV>::load(kr + d, kk);
#pragma unroll
        for (int j = 0; j < kRepTile; ++j) {
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(qr[j] + d + e);
            s[j] += qq.x * kk[e] + qq.y * kk[e + 1] + qq.z * kk[e + 2] + qq.w * kk[e + 3];
          }
        }
      }
      const bool live = t0 + t < k_end;
#pragma unroll
      for (int j = 0; j < kRepTile; ++j)
        if (r0 + j < rep) ps[(r0 + j) * kTileK + t] = live ? s[j] : kNegInf;
    }
    __syncthreads();

    // 2. online softmax: one warp per query head, one lane per key.
    for (int r = warp; r < rep; r += kThreads / 32) {
      const float s = ps[r * kTileK + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      ps[r * kTileK + lane] = p;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        ls[r] = ls[r] * alpha + sum;
        as[r] = alpha;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + p @ V: a thread owns 4 columns of one head.
    for (int i = tid; i < rep * dvec; i += kThreads) {
      const int r = i / dvec, c = (i - r * dvec) * 4;
      float4 a = *reinterpret_cast<float4*>(acc + r * D + c);
      const float alpha = as[r];
      a.x *= alpha; a.y *= alpha; a.z *= alpha; a.w *= alpha;
      const float* pr = ps + r * kTileK;
#pragma unroll 8
      for (int t = 0; t < kTileK; ++t) {
        const float p = pr[t];
        const float4 vv = Vec<TKV>::load4(vs + t * D + c);
        a.x += p * vv.x; a.y += p * vv.y; a.z += p * vv.z; a.w += p * vv.w;
      }
      *reinterpret_cast<float4*>(acc + r * D + c) = a;
    }
    __syncthreads();
  }

  if (n_split == 1) {
    for (int i = tid; i < rep * D; i += kThreads)
      out[row0 * D + i] = from_f32<TQ>(acc[i] / fmaxf(ls[i / D], 1e-30f));
    return;
  }
  for (int i = tid; i < rep * (D + 2); i += kThreads) {
    const int r = i / (D + 2), c = i - r * (D + 2);
    part[((row0 + r) * n_split + split) * (D + 2) + c] =
        c < D ? acc[r * D + c] : (c == D ? ms[r] : ls[r]);
  }
}

// Block-wide reduction of one value per thread (sum, or max when kMax).
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = scratch[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) x = kMax ? fmaxf(x, scratch[w]) : x + scratch[w];
  __syncthreads();
  return x;
}

// grid (Hq, B): merge the splits' (acc, m, l) of one query head.  The
// splits' weights exp(m_s - m) go to shared memory (n_split floats), so each
// output column is a dot product whose loads are all independent.
template <typename TO>
__global__ void __launch_bounds__(kThreads) decode_attention_combine(
    const float* __restrict__ part, TO* __restrict__ out, int n_split, int D) {
  extern __shared__ float w[];  // n_split
  __shared__ float scratch[kThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, hq = gridDim.x, tid = threadIdx.x;
  const long long row = (long long)b * hq + h;
  const float* pp = part + row * n_split * (D + 2);
  float m = kNegInf;
  for (int s = tid; s < n_split; s += kThreads) m = fmaxf(m, pp[s * (D + 2) + D]);
  m = block_reduce<true>(m, scratch);
  float l = 0.f;
  for (int s = tid; s < n_split; s += kThreads) {
    const float e = expf(pp[s * (D + 2) + D] - m);
    w[s] = e;
    l += pp[s * (D + 2) + D + 1] * e;
  }
  l = fmaxf(block_reduce<false>(l, scratch), 1e-30f);  // its barriers publish w
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) o += pp[s * (D + 2) + d] * w[s];
    out[row * D + d] = from_f32<TO>(o / l);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           void* part, int B, int Hq, int Hkv, int S, int D, int n_split, int chunk,
           long long q_sb, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh, float scale, cudaStream_t stream) {
  const int rep = Hq / Hkv;
  const int smem = smem_bytes(rep, D, (int)sizeof(TKV));
  auto kernel = decode_attention_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(n_split, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), static_cast<float*>(part), S, D,
      rep, chunk, scale, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  decode_attention_combine<TQ><<<dim3(Hq, B), kThreads, sizeof(float) * n_split, stream>>>(
      static_cast<const float*>(part), static_cast<TQ*>(out), n_split, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_smem_bytes(int rep, int d, int kv_bytes) {
  return smem_bytes(rep, d, kv_bytes);
}

// Strides are in elements; the last dimension of q, k and v is contiguous.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths, void* out, void* part,
    int B, int Hq, int Hkv, int S, int D, int n_split, int chunk, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int q_bf16, int kv_bf16, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TQ, TKV)                                                               \
  return launch<TQ, TKV>(q, k, v, lengths, out, part, B, Hq, Hkv, S, D, n_split, chunk, q_sb, \
                         q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, st)
  if (q_bf16 && kv_bf16) REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_bf16) REPRO_LAUNCH(__nv_bfloat16, float);
  if (kv_bf16) REPRO_LAUNCH(float, __nv_bfloat16);
  REPRO_LAUNCH(float, float);
#undef REPRO_LAUNCH
}
