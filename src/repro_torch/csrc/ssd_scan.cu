// Mamba-2 chunked SSD scan for Hopper (sm_90a): the forward pass and its
// gradient, for x (Bt, S, H, P), dt (Bt, S, H) fp32, A (H,) fp32 and one
// B/C group (Bt, S, N) broadcast over the H heads.
//
// Replaces the Pallas TPU kernel `ssd_scan_pallas` in
// src/repro/kernels/ssd_scan/ssd_scan.py (body `_ssd_kernel`) and computes
// the same function, the inner chunk scan of `ssd_chunked` in
// src/repro/models/ssm.py without the D term.  Per (batch, head, chunk) of
// Q rows, with a_t = dt_t * A and cs the within-chunk cumsum of a:
//     y_i  = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//          + exp(cs_i) C_i^T S_prev
//     S    = exp(cs_last) S_prev + sum_j exp(cs_last - cs_j) B_j (dt_j x_j)^T
// with the (N, P) state S in fp32 and S_prev = 0 at chunk 0.  Decays are
// masked by index (j <= i) before exp, never after: exp(cs_i - cs_j) for
// j > i overflows.  JAX differentiates `ssd_chunked` with XLA; the backward
// here is hand-written too.
//
// Design.  float32 inputs run the three phases that `ssd_chunked` spells
// out, each parallel over every (batch, chunk, head); bf16 inputs (the
// training path) run a forward of two kernels on the tensor cores:
//   forward, float32
//             1. ssd_state_kernel: each chunk's own state contribution U_c
//                 and its total decay T_c = cs_last;
//             2. ssd_scan_kernel: S_prev of every chunk by a short scan over
//                 the chunks, one thread per (batch, head, state entry), in
//                 place over U;
//             3. ssd_out_kernel: y from C B^T, the decays and S_prev;
//   forward, bf16
//             1. ssd_fwd_states_kernel: a block per (batch, head) walks the
//                 chunks in order, as the Pallas grid (bt, h, nc) does, with
//                 the (N, P) state S in registers: per chunk it forms
//                 U_c = (w dt B)^T x on the tensor cores, writes S as that
//                 chunk's S_prev (and T_c) and sets S <- exp(T_c) S + U_c,
//                 the scan's own update.  The next chunk's B, x and dt tiles
//                 load by cp.async into a second buffer while this chunk
//                 computes.  U never reaches device memory;
//             2. ssd_fwd_out_kernel: a block per (batch, chunk, group of
//                 heads) forms the raw C B^T once, keeps it in registers and
//                 walks its heads: each head's decays, causal mask and dt
//                 turn it straight into bf16 A fragments of M (dt x) (the
//                 m16n8 accumulator layout is the m16k16 A layout, so M
//                 never goes through shared memory), plus exp(cs) (C S_prev),
//                 skipping the 16-wide fragments above the diagonal.  Four
//                 producer warps load the next head's x, dt and S_prev by
//                 cp.async and prepare its bf16 S_prev and cs while eight
//                 warps compute this one;
//   backward  4. ssd_state_kernel / ssd_state_mma_kernel:
//                 V_c = sum_i exp(cs_i) C_i dy_i^T;
//             5. ssd_scan_kernel in reverse: G_c, the gradient of the state
//                 at the end of chunk c (G_{c-1} = exp(T_c) G_c + V_c);
//             6. ssd_bwd_heads_kernel (bf16): a block per (batch, chunk,
//                 group of heads) walks its heads in order: dx, ddt, the
//                 per-chunk dA, and dB and dC summed over the group in
//                 registers; ssd_bwd_kernel (float32): a block per head,
//                 each head its own group;
//             7. ssd_reduce_kernel: dB and dC summed over head groups (when
//                 there are several) and dA over batch and chunks, in a
//                 fixed order.
// No atomics anywhere: every sum runs in one order, so results repeat bit
// for bit.  At Mamba2-780m's training shape (Bt 4, S 4096, H 48, P 64,
// N 128, Q 128) the bf16 state pass runs 192 blocks, two an SM, all
// resident at once; the output kernel and phase 6 run one group of 48
// heads per (batch, chunk), 128 blocks, one wave.
//
// Bound: at that shape a forward call needs 45 GFLOP (the causal half of
// C B^T and of the intra-chunk product, the inter-chunk output and the
// chunk states) on 314 MB of input and output, ~144 flops per byte: below
// the ~295 where the H100's bf16 tensor cores stop being fed by device
// memory, so the bound is bytes (~94 us; ~154 us with the 201 MB of fp32
// S_prev that the backward reads); the backward likewise (~127 us).
// What the design does about it:
//   * the bf16 forward moves x once into each kernel, S_prev out once and
//     back once, and y out once (~0.8 GB at that shape, from ~1.2 GB when
//     U went through device memory three times), and forms C B^T once per
//     (batch, chunk) instead of once per head (2.1 of the 5.2 M
//     multiply-adds of a (batch, chunk, head)).  Each of its two kernels
//     is then held by its own device-memory traffic, not by the tensor
//     cores: the state pass by the S_prev writes that all its blocks issue
//     at the same point of every chunk, the output kernel by reading x and
//     S_prev and writing y (PERF.md has the card's measurements);
//   * bf16 inputs run every per-chunk product on the tensor cores
//     (mma.sync, see the tensor-core section below).  The forward stays on
//     mma.sync: it is bound by bytes, and each warp forms M for its own 16
//     rows in registers, which mma.sync takes as they are and wgmma's
//     64-row warpgroup tiles do not;
//   * float32 runs fp32 kernels on the CUDA cores (67 TFLOP/s): f32 must
//     match the plain version to 1e-4, which bf16 or TF32 products cannot.
//     Each product runs as a 256-thread block over tiles in shared memory,
//     a thread owning an 8 x 8 (or 8 x 4) strided patch of the output, with
//     the contraction dimension staged through 32-deep slabs;
//   * the chunk scan streams the states once each way with float4 loads
//     issued a chunk ahead;
//   * the bf16 backward keeps dB and dC in registers over a group of heads
//     (no per-head partials in device memory) and skips the 16-wide
//     fragments of each (Q, Q) product that the causal mask zeroes.
// The backward still forms C B^T once per head (ssd_bwd_heads_kernel says
// why) and stages each head's tiles before it computes.  Nothing is
// allocated here; launches go on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid: ty = tid / 16, tx = tid % 16
constexpr int QM = 128;         // largest chunk
constexpr int NM = 128;         // largest state size
constexpr int PM = 64;          // largest head dim
constexpr int KS = 32;          // depth of a staged slab
constexpr int LDR = KS + 1;     // (rows, KS) slab: odd stride, no bank conflicts
constexpr int LDK = 132;        // (KS, cols) slab
constexpr int SLAB = 128 * LDR; // floats of one slab buffer (also >= KS * LDK)
constexpr int LDM = QM + 1;     // (Q, Q) matrices
constexpr float kLog2e = 1.4426950408889634f;
static_assert(KS * LDK <= SLAB, "slab buffer too small");
static_assert(NM <= 128 && PM <= 128 && QM <= 128, "16 x 8 rows per block");

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Args {
  const void* x;          // (Bt, S, H, P)
  const float* dt;        // (Bt, S, H)
  const float* A;         // (H,)
  const void* B;          // (Bt, S, N)
  const void* C;          // (Bt, S, N)
  void* y;                // forward: y out; backward: dy in (Bt, S, H, P)
  float* states;          // (Bt, nc, H, N, P): U, then S_prev of every chunk
  float* T;               // (Bt, nc, H): cs_last of every chunk
  float* G;               // (Bt, nc, H, N, P): V, then G of every chunk
  void* dx;               // (Bt, S, H, P) like x
  float* ddt;             // (Bt, S, H) contiguous
  float* dBp;             // (groups, Bt, S, N) partials of each head group
  float* dCp;             //   (groups == 1: none, dB and dC are written directly)
  float* dAp;             // (Bt, nc, H) per-chunk partials
  void* dB;               // (Bt, S, N) contiguous, B's type
  void* dC;
  float* dA;              // (H,)
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, B_sb, B_ss, C_sb, C_ss;
  long long y_sb, y_ss, y_sh, dx_sb, dx_ss, dx_sh;
  int bt, s, h, p, n, q, nc;
  int groups, hg;         // backward: head groups, heads of a group
};

// dst[r * ld + c] = src[(r0 + r) * rs + c0 + c] * rscale[r0 + r] for r < NR,
// c < NC; zero where r0 + r >= rlim or c0 + c >= clim.
template <int NR, int NC>
__device__ __forceinline__ void load_block(float* dst, int ld, const float* src, long long rs,
                                           int r0, int rlim, int c0, int clim,
                                           const float* rscale) {
  for (int idx = threadIdx.x; idx < NR * NC; idx += kThreads) {
    const int r = idx / NC, c = idx - r * NC;
    float v = 0.f;
    if (r0 + r < rlim && c0 + c < clim) {
      v = src[(r0 + r) * rs + c0 + c];
      if (rscale) v *= rscale[r0 + r];
    }
    dst[r * ld + c] = v;
  }
}

// acc[a][b] += sum_{k < KS} X(ty + 16 a, k) * Y(tx + 16 b, k), where
// X(r, k) = X[k * ldx + r] if XK else X[r * ldx + k], and Y likewise.
template <int MA, int MB, bool XK, bool YK>
__device__ __forceinline__ void mac(float (&acc)[MA][MB], const float* X, int ldx,
                                    const float* Y, int ldy, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < KS; ++k) {
    float xv[MA], yv[MB];
#pragma unroll
    for (int a = 0; a < MA; ++a) xv[a] = XK ? X[k * ldx + ty + 16 * a] : X[(ty + 16 * a) * ldx + k];
#pragma unroll
    for (int b = 0; b < MB; ++b) yv[b] = YK ? Y[k * ldy + tx + 16 * b] : Y[(tx + 16 * b) * ldy + k];
#pragma unroll
    for (int a = 0; a < MA; ++a)
#pragma unroll
      for (int b = 0; b < MB; ++b) acc[a][b] = fmaf(xv[a], yv[b], acc[a][b]);
  }
}

template <int MA, int MB>
__device__ __forceinline__ void zero(float (&acc)[MA][MB]) {
#pragma unroll
  for (int a = 0; a < MA; ++a)
#pragma unroll
    for (int b = 0; b < MB; ++b) acc[a][b] = 0.f;
}

// Sum over the 16 threads of a row (tx = 0..15 share a half-warp).
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dt of the chunk's rows into s_dt (0 past q) and the inclusive cumsum of
// dt * A into s_cs, by warp 0 in one fixed order (every kernel that needs cs
// computes it with this function, so they agree bit for bit).
__device__ __forceinline__ void chunk_cumsum(const float* s_dt, float* s_cs, float A);

__device__ __forceinline__ void chunk_prologue(float* s_dt, float* s_cs, const float* dt,
                                               long long dt_ss, int q, float A) {
  for (int i = threadIdx.x; i < QM; i += kThreads) s_dt[i] = i < q ? dt[i * dt_ss] : 0.f;
  __syncthreads();
  chunk_cumsum(s_dt, s_cs, A);
}

// One warp's inclusive cumsum of s_dt * A, in one fixed order: lane l gets
// rows l * QM/32 .. (l + 1) * QM/32 - 1 in v.  Every kernel that needs cs
// computes it with this function, so they agree bit for bit.
__device__ __forceinline__ void cumsum_warp(const float* s_dt, float A, float (&v)[QM / 32]) {
  const int lane = threadIdx.x & 31;
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < QM / 32; ++k) {
    run += s_dt[lane * (QM / 32) + k] * A;
    v[k] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < QM / 32; ++k) v[k] += excl;
}

// s_cs = the inclusive cumsum of s_dt * A, by warp 0; the block's barrier
// after it publishes s_cs.
__device__ __forceinline__ void chunk_cumsum(const float* s_dt, float* s_cs, float A) {
  if (threadIdx.x < 32) {
    float v[QM / 32];
    cumsum_warp(s_dt, A, v);
#pragma unroll
    for (int k = 0; k < QM / 32; ++k) s_cs[threadIdx.x * (QM / 32) + k] = v[k];
  }
  __syncthreads();
}

struct Chunk {               // where the work of one (batch, chunk, head) reads and writes
  int b, c, hh, q, t0;
  long long blk;             // (b * nc + c) * H + hh
  __device__ Chunk(const Args& a, int b_, int c_, int hh_)
      : b(b_), c(c_), hh(hh_), q(a.q), t0(c_ * a.q), blk(((long long)b_ * a.nc + c_) * a.h + hh_) {}
  __device__ explicit Chunk(const Args& a) : Chunk(a, blockIdx.z, blockIdx.x, blockIdx.y) {}
};

// ---------------------------------------------------------------- phase 1/4
// MODE 0: U[n][p] = sum_t exp(T - cs_t) B[t][n] * dt_t x[t][p]; writes T.
// MODE 1: V[n][p] = sum_t exp(cs_t) C[t][n] * dy[t][p].
template <int MODE>
__global__ void __launch_bounds__(kThreads) ssd_state_kernel(const Args a) {
  __shared__ float s_dt[QM], s_cs[QM], s_sc[QM];
  __shared__ float sX[KS * LDK], sY[KS * LDK];
  const Chunk k(a);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float A = a.A[k.hh];
  chunk_prologue(s_dt, s_cs, a.dt + k.b * a.dt_sb + k.t0 * a.dt_ss + k.hh * a.dt_sh, a.dt_ss,
                 k.q, A);
  const float T = s_cs[k.q - 1];
  for (int i = threadIdx.x; i < QM; i += kThreads)
    s_sc[i] = i < k.q ? (MODE == 0 ? expf(T - s_cs[i]) : expf(s_cs[i])) : 0.f;
  if (MODE == 0 && threadIdx.x == 0) a.T[k.blk] = T;
  __syncthreads();

  const float* xs = MODE == 0
      ? static_cast<const float*>(a.B) + k.b * a.B_sb + k.t0 * a.B_ss
      : static_cast<const float*>(a.C) + k.b * a.C_sb + k.t0 * a.C_ss;
  const long long xrs = MODE == 0 ? a.B_ss : a.C_ss;
  const float* ys = MODE == 0
      ? static_cast<const float*>(a.x) + k.b * a.x_sb + k.t0 * a.x_ss + k.hh * a.x_sh
      : static_cast<const float*>(a.y) + k.b * a.y_sb + k.t0 * a.y_ss + k.hh * a.y_sh;
  const long long yrs = MODE == 0 ? a.x_ss : a.y_ss;
  float acc[NM / 16][PM / 16];
  zero(acc);
  for (int r0 = 0; r0 < k.q; r0 += KS) {
    load_block<KS, NM>(sX, LDK, xs, xrs, r0, k.q, 0, a.n, s_sc);
    load_block<KS, PM>(sY, LDK, ys, yrs, r0, k.q, 0, a.p, MODE == 0 ? s_dt : nullptr);
    __syncthreads();
    mac<NM / 16, PM / 16, true, true>(acc, sX, LDK, sY, LDK, ty, tx);
    __syncthreads();
  }
  float* out = (MODE == 0 ? a.states : a.G) + k.blk * a.n * a.p;
#pragma unroll
  for (int i = 0; i < NM / 16; ++i)
#pragma unroll
    for (int j = 0; j < PM / 16; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (r < a.n && c < a.p) out[r * a.p + c] = acc[i][j];
    }
}

// ---------------------------------------------------------------- phase 2/5
// In place over buf (Bt, nc, H, N*P): entry c becomes the running value
// before chunk c (run = run * exp(T_c) + buf_c), walking the chunks forward
// (states: S_prev) or backward (G).  A thread carries kScanVec float4 lanes
// (N*P % 4 == 0) and issues the next chunk's loads before it stores the
// current one, so each thread keeps several loads in flight: the scan is a
// pure stream over 2 x Bt*nc*H*N*P*4 bytes.
constexpr int kScanVec = 2;

__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(float* __restrict__ buf,
                                                            const float* __restrict__ T, int nc,
                                                            int h, int np, int reverse) {
  const int bh = blockIdx.y;      // b * h + hh
  const int b = bh / h, hh = bh - b * h;
  const int e0 = (blockIdx.x * kThreads + threadIdx.x) * kScanVec * 4;
  float4 run[kScanVec], u[kScanVec], nx[kScanVec];
  auto at = [&](int i) {          // the i-th chunk in walking order
    const int c = reverse ? nc - 1 - i : i;
    return ((long long)b * nc + c) * h + hh;
  };
  auto load = [&](float4 (&v)[kScanVec], long long blk) {
#pragma unroll
    for (int g = 0; g < kScanVec; ++g) {
      const int e = e0 + 4 * g;
      v[g] = e < np ? *reinterpret_cast<const float4*>(buf + blk * np + e)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
#pragma unroll
  for (int g = 0; g < kScanVec; ++g) run[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  long long blk = at(0);
  load(u, blk);
  float t = T[blk];
  for (int i = 0; i < nc; ++i) {
    const long long nblk = i + 1 < nc ? at(i + 1) : blk;
    load(nx, nblk);
    const float tn = T[nblk];
    const float d = expf(t);
#pragma unroll
    for (int g = 0; g < kScanVec; ++g) {
      const int e = e0 + 4 * g;
      if (e < np) *reinterpret_cast<float4*>(buf + blk * np + e) = run[g];
      run[g] = make_float4(fmaf(run[g].x, d, u[g].x), fmaf(run[g].y, d, u[g].y),
                           fmaf(run[g].z, d, u[g].z), fmaf(run[g].w, d, u[g].w));
      u[g] = nx[g];
    }
    blk = nblk;
    t = tn;
  }
}

void launch_scan(float* buf, const float* T, const Args& a, int reverse, cudaStream_t st) {
  const int np = a.n * a.p;
  const int per_block = kThreads * kScanVec * 4;
  const dim3 grid((np + per_block - 1) / per_block, a.bt * a.h);
  ssd_scan_kernel<<<grid, kThreads, 0, st>>>(buf, T, a.nc, a.h, np, reverse);
}

// scores = C B^T over the chunk, masked and decayed into sM:
// sM[i][j] = (C_i . B_j) exp(cs_i - cs_j) for j <= i < q, else 0.
__device__ __forceinline__ void masked_scores(float* sM, float* sX, float* sY, const float* s_cs,
                                              const float* Cc, long long C_ss, const float* Bc,
                                              long long B_ss, int q, int n, int ty, int tx) {
  float acc[QM / 16][QM / 16];
  zero(acc);
  for (int n0 = 0; n0 < n; n0 += KS) {
    load_block<QM, KS>(sX, LDR, Cc, C_ss, 0, q, n0, n, (const float*)nullptr);
    load_block<QM, KS>(sY, LDR, Bc, B_ss, 0, q, n0, n, (const float*)nullptr);
    __syncthreads();
    mac<QM / 16, QM / 16, false, false>(acc, sX, LDR, sY, LDR, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < QM / 16; ++i)
#pragma unroll
    for (int j = 0; j < QM / 16; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      sM[r * LDM + c] = (c <= r && r < q) ? acc[i][j] * expf(s_cs[r] - s_cs[c]) : 0.f;
    }
  __syncthreads();
}

// ---------------------------------------------------------------- phase 3
__global__ void __launch_bounds__(kThreads, 2) ssd_out_kernel(const Args a) {
  extern __shared__ float smem[];
  float* s_dt = smem;
  float* s_cs = s_dt + QM;
  float* s_e = s_cs + QM;
  float* sM = s_e + QM;
  float* sX = sM + QM * LDM;
  float* sY = sX + SLAB;
  const Chunk k(a);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  chunk_prologue(s_dt, s_cs, a.dt + k.b * a.dt_sb + k.t0 * a.dt_ss + k.hh * a.dt_sh, a.dt_ss,
                 k.q, a.A[k.hh]);
  for (int i = threadIdx.x; i < QM; i += kThreads) s_e[i] = i < k.q ? expf(s_cs[i]) : 0.f;
  const float* Cc = static_cast<const float*>(a.C) + k.b * a.C_sb + k.t0 * a.C_ss;
  const float* Bc = static_cast<const float*>(a.B) + k.b * a.B_sb + k.t0 * a.B_ss;
  const float* xc = static_cast<const float*>(a.x) + k.b * a.x_sb + k.t0 * a.x_ss + k.hh * a.x_sh;
  const float* Sp = a.states + k.blk * a.n * a.p;
  masked_scores(sM, sX, sY, s_cs, Cc, a.C_ss, Bc, a.B_ss, k.q, a.n, ty, tx);

  float acc[QM / 16][PM / 16];
  zero(acc);
  // inter-chunk: (exp(cs) * C) S_prev
  for (int n0 = 0; n0 < a.n; n0 += KS) {
    load_block<QM, KS>(sX, LDR, Cc, a.C_ss, 0, k.q, n0, a.n, s_e);
    load_block<KS, PM>(sY, LDK, Sp, (long long)a.p, n0, a.n, 0, a.p, (const float*)nullptr);
    __syncthreads();
    mac<QM / 16, PM / 16, false, true>(acc, sX, LDR, sY, LDK, ty, tx);
    __syncthreads();
  }
  // intra-chunk: sM (dt * x)
  for (int j0 = 0; j0 < k.q; j0 += KS) {
    load_block<KS, PM>(sY, LDK, xc, a.x_ss, j0, k.q, 0, a.p, s_dt);
    __syncthreads();
    mac<QM / 16, PM / 16, false, true>(acc, sM + j0, LDM, sY, LDK, ty, tx);
    __syncthreads();
  }
  float* yc = static_cast<float*>(a.y) + k.b * a.y_sb + k.t0 * a.y_ss + k.hh * a.y_sh;
#pragma unroll
  for (int i = 0; i < QM / 16; ++i)
#pragma unroll
    for (int j = 0; j < PM / 16; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (r < k.q && c < a.p) yc[r * a.y_ss + c] = acc[i][j];
    }
}

// dT = sum_j w_j dw_j + exp(T) <G, S_prev>  (terms 2 and 4), added to dcs
// at the chunk's last row (T = cs_last); then d(dt A) = the reverse cumsum
// of dcs gives ddt_t = x_t . d(dt x)_t + A d(dt A)_t and this chunk's dA.
// The sums run in one fixed order: warp 0, QM / 32 rows a lane, shuffles.
// Rows at or past q hold zeros in s_dt, s_dcs, s_ddt and s_wdw.
// `part` is this thread's share of <G, S_prev>.
__device__ __forceinline__ void finish_dcs(const Args& a, const Chunk& k, float part, float T,
                                           float A, const float* s_dt, const float* s_dcs,
                                           const float* s_ddt, const float* s_wdw,
                                           float* s_red) {
  constexpr int R = QM / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (threadIdx.x % 32 == 0) s_red[threadIdx.x / 32] = part;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, r0 = lane * R;
  float gs = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) gs += s_red[w];
  float wsum = 0.f, v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    wsum += s_wdw[r0 + i];
    v[i] = s_dcs[r0 + i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
  const float dT = fmaf(expf(T), gs, wsum);
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (r0 + i == k.q - 1) v[i] += dT;
  // reverse inclusive cumsum: within the lane, then across lanes from the top
#pragma unroll
  for (int i = R - 2; i >= 0; --i) v[i] += v[i + 1];
  float tail = v[0];               // this lane's total
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, tail, off);
    if (lane + off < 32) tail += o;
  }
  float above = __shfl_down_sync(0xffffffffu, tail, 1);   // lanes past this one
  if (lane == 31) above = 0.f;
  float* ddt = a.ddt + ((long long)k.b * a.s + k.t0) * a.h + k.hh;
  float dA = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = r0 + i;
    const float da = v[i] + above;
    if (t < k.q) ddt[(long long)t * a.h] = fmaf(A, da, s_ddt[t]);
    dA = fmaf(da, s_dt[t], dA);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dA += __shfl_xor_sync(0xffffffffu, dA, off);
  if (lane == 0) a.dAp[k.blk] = dA;
}

// ---------------------------------------------------------------- phase 6
// float32: one block per (chunk, head, batch): dx, ddt, this head's dB and
// dC (its head's partials), and this chunk's share of dA.  dcs, the gradient of the within-chunk cumsum,
// gathers five terms (see the comments) and turns into d(dt * A) by a
// reverse cumsum.
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel(const Args a) {
  extern __shared__ float smem[];
  float* s_dt = smem;
  float* s_cs = s_dt + QM;
  float* s_e = s_cs + QM;
  float* s_w = s_e + QM;
  float* s_dcs = s_w + QM;
  float* s_ddt = s_dcs + QM;
  float* s_wdw = s_ddt + QM;
  float* s_red = s_wdw + QM;      // kThreads / 32 partial sums
  float* sM = s_red + 32;
  float* sD = sM + QM * LDM;
  float* sX = sD + QM * LDM;
  float* sY = sX + SLAB;
  const Chunk k(a);
  const int q = k.q;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float A = a.A[k.hh];
  chunk_prologue(s_dt, s_cs, a.dt + k.b * a.dt_sb + k.t0 * a.dt_ss + k.hh * a.dt_sh, a.dt_ss,
                 q, A);
  const float T = s_cs[q - 1];
  for (int i = threadIdx.x; i < QM; i += kThreads) {
    s_e[i] = i < q ? expf(s_cs[i]) : 0.f;
    s_w[i] = i < q ? expf(T - s_cs[i]) : 0.f;
  }
  const float* Cc = static_cast<const float*>(a.C) + k.b * a.C_sb + k.t0 * a.C_ss;
  const float* Bc = static_cast<const float*>(a.B) + k.b * a.B_sb + k.t0 * a.B_ss;
  const float* xc = static_cast<const float*>(a.x) + k.b * a.x_sb + k.t0 * a.x_ss + k.hh * a.x_sh;
  const float* gc = static_cast<const float*>(a.y) + k.b * a.y_sb + k.t0 * a.y_ss + k.hh * a.y_sh;
  const float* Sp = a.states + k.blk * a.n * a.p;
  const float* Gc = a.G + k.blk * a.n * a.p;
  masked_scores(sM, sX, sY, s_cs, Cc, a.C_ss, Bc, a.B_ss, q, a.n, ty, tx);

  // dM = dy (dt x)^T; ds = dM * L into sD; R = dM * M: dcs_i += sum_j R_ij,
  // dcs_j -= sum_i R_ij  (term 1: the decays of the intra-chunk part)
  {
    float acc[QM / 16][QM / 16];
    zero(acc);
    for (int p0 = 0; p0 < a.p; p0 += KS) {
      load_block<QM, KS>(sX, LDR, gc, a.y_ss, 0, q, p0, a.p, (const float*)nullptr);
      load_block<QM, KS>(sY, LDR, xc, a.x_ss, 0, q, p0, a.p, s_dt);
      __syncthreads();
      mac<QM / 16, QM / 16, false, false>(acc, sX, LDR, sY, LDR, ty, tx);
      __syncthreads();
    }
    float colsum[QM / 16];
#pragma unroll
    for (int j = 0; j < QM / 16; ++j) colsum[j] = 0.f;
#pragma unroll
    for (int i = 0; i < QM / 16; ++i) {
      const int r = ty + 16 * i;
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < QM / 16; ++j) {
        const int c = tx + 16 * j;
        const bool live = c <= r && r < q;
        const float R = acc[i][j] * sM[r * LDM + c];
        sD[r * LDM + c] = live ? acc[i][j] * expf(s_cs[r] - s_cs[c]) : 0.f;
        rowsum += R;
        colsum[j] += R;
      }
      rowsum = row_sum16(rowsum);
      if (tx == 0) s_dcs[r] = rowsum;
    }
    // column sums over the 16 thread rows: stage in sX (free now), then sum in order
#pragma unroll
    for (int j = 0; j < QM / 16; ++j) sX[ty * QM + tx + 16 * j] = colsum[j];
    __syncthreads();
    for (int c = threadIdx.x; c < QM; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s += sX[r * QM + c];
      s_dcs[c] -= s;
    }
    __syncthreads();
  }

  // d(dt x) = w * (B G) + M^T dy; dw_j = sum_p (dt x)_jp (B G)_jp gives
  // dcs_j -= w_j dw_j and dT += w_j dw_j  (term 2: the state's decays)
  {
    float acc[QM / 16][PM / 16];
    zero(acc);
    for (int n0 = 0; n0 < a.n; n0 += KS) {
      load_block<QM, KS>(sX, LDR, Bc, a.B_ss, 0, q, n0, a.n, (const float*)nullptr);
      load_block<KS, PM>(sY, LDK, Gc, (long long)a.p, n0, a.n, 0, a.p, (const float*)nullptr);
      __syncthreads();
      mac<QM / 16, PM / 16, false, true>(acc, sX, LDR, sY, LDK, ty, tx);
      __syncthreads();
    }
    float xv[QM / 16][PM / 16];
#pragma unroll
    for (int i = 0; i < QM / 16; ++i) {
      const int r = ty + 16 * i;
      float dw = 0.f;
#pragma unroll
      for (int j = 0; j < PM / 16; ++j) {
        const int c = tx + 16 * j;
        xv[i][j] = (r < q && c < a.p) ? (xc[r * a.x_ss + c]) : 0.f;
        dw += xv[i][j] * acc[i][j];
        acc[i][j] *= s_w[r];
      }
      dw = row_sum16(dw) * s_dt[r];
      if (tx == 0) {
        s_wdw[r] = s_w[r] * dw;
        s_dcs[r] -= s_w[r] * dw;
      }
    }
    for (int i0 = 0; i0 < q; i0 += KS) {
      load_block<KS, PM>(sY, LDK, gc, a.y_ss, i0, q, 0, a.p, (const float*)nullptr);
      __syncthreads();
      mac<QM / 16, PM / 16, true, true>(acc, sM + i0 * LDM, LDM, sY, LDK, ty, tx);
      __syncthreads();
    }
    // dx = dt * d(dt x); ddt gets x . d(dt x)
    float* dxc = static_cast<float*>(a.dx) + k.b * a.dx_sb + k.t0 * a.dx_ss + k.hh * a.dx_sh;
#pragma unroll
    for (int i = 0; i < QM / 16; ++i) {
      const int r = ty + 16 * i;
      float dd = 0.f;
#pragma unroll
      for (int j = 0; j < PM / 16; ++j) {
        const int c = tx + 16 * j;
        dd += xv[i][j] * acc[i][j];
        if (r < q && c < a.p) dxc[r * a.dx_ss + c] = s_dt[r] * acc[i][j];
      }
      dd = row_sum16(dd);
      if (tx == 0) s_ddt[r] = dd;
    }
  }

  // dC = exp(cs) * (dy S_prev^T) + ds B; dcs_i += exp(cs_i) sum_n C_in (dy
  // S_prev^T)_in  (term 3: the inter-chunk output's decay)
  {
    float acc[QM / 16][NM / 16];
    zero(acc);
    for (int p0 = 0; p0 < a.p; p0 += KS) {
      load_block<QM, KS>(sX, LDR, gc, a.y_ss, 0, q, p0, a.p, (const float*)nullptr);
      load_block<NM, KS>(sY, LDR, Sp, (long long)a.p, 0, a.n, p0, a.p, (const float*)nullptr);
      __syncthreads();
      mac<QM / 16, NM / 16, false, false>(acc, sX, LDR, sY, LDR, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < QM / 16; ++i) {
      const int r = ty + 16 * i;
      float dc = 0.f;
#pragma unroll
      for (int j = 0; j < NM / 16; ++j) {
        const int c = tx + 16 * j;
        if (r < q && c < a.n) dc += (Cc[r * a.C_ss + c]) * acc[i][j];
        acc[i][j] *= s_e[r];
      }
      dc = row_sum16(dc);
      if (tx == 0) s_dcs[r] += s_e[r] * dc;
    }
    for (int j0 = 0; j0 < q; j0 += KS) {
      load_block<KS, NM>(sY, LDK, Bc, a.B_ss, j0, q, 0, a.n, (const float*)nullptr);
      __syncthreads();
      mac<QM / 16, NM / 16, false, true>(acc, sD + j0, LDM, sY, LDK, ty, tx);
      __syncthreads();
    }
    float* out = a.dCp + ((long long)k.hh * a.bt + k.b) * a.s * a.n + (long long)k.t0 * a.n;
#pragma unroll
    for (int i = 0; i < QM / 16; ++i)
#pragma unroll
      for (int j = 0; j < NM / 16; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        if (r < q && c < a.n) out[r * a.n + c] = acc[i][j];
      }
  }

  // dB = w * ((dt x) G^T) + ds^T C
  {
    float acc[QM / 16][NM / 16];
    zero(acc);
    for (int p0 = 0; p0 < a.p; p0 += KS) {
      load_block<QM, KS>(sX, LDR, xc, a.x_ss, 0, q, p0, a.p, s_dt);
      load_block<NM, KS>(sY, LDR, Gc, (long long)a.p, 0, a.n, p0, a.p, (const float*)nullptr);
      __syncthreads();
      mac<QM / 16, NM / 16, false, false>(acc, sX, LDR, sY, LDR, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < QM / 16; ++i)
#pragma unroll
      for (int j = 0; j < NM / 16; ++j) acc[i][j] *= s_w[ty + 16 * i];
    for (int i0 = 0; i0 < q; i0 += KS) {
      load_block<KS, NM>(sY, LDK, Cc, a.C_ss, i0, q, 0, a.n, (const float*)nullptr);
      __syncthreads();
      mac<QM / 16, NM / 16, true, true>(acc, sD + i0 * LDM, LDM, sY, LDK, ty, tx);
      __syncthreads();
    }
    float* out = a.dBp + ((long long)k.hh * a.bt + k.b) * a.s * a.n + (long long)k.t0 * a.n;
#pragma unroll
    for (int i = 0; i < QM / 16; ++i)
#pragma unroll
      for (int j = 0; j < NM / 16; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        if (r < q && c < a.n) out[r * a.n + c] = acc[i][j];
      }
  }

  float part = 0.f;
  for (int e = threadIdx.x; e < a.n * a.p; e += kThreads) part = fmaf(Gc[e], Sp[e], part);
  finish_dcs(a, k, part, T, A, s_dt, s_dcs, s_ddt, s_wdw, s_red);
}

// ---------------------------------------------------------------- phase 7
// dB and dC, when phase 6 wrote partials (several head groups, or float32):
// sums of the groups' partials in group order; dA: sums of the per-chunk
// partials in (batch, chunk) order.  Without partials (dB and dC written
// already) every block does dA; otherwise blocks past the dB/dC ones do.
template <typename TX>
__global__ void __launch_bounds__(kThreads) ssd_reduce_kernel(const Args a) {
  const long long m = a.dBp ? (long long)a.bt * a.s * a.n : 0;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e < 2 * m) {
    const bool isC = e >= m;
    const long long i = isC ? e - m : e;
    const float* src = (isC ? a.dCp : a.dBp) + i;
    float s = 0.f;
    for (int g = 0; g < a.groups; ++g) s += src[g * m];
    static_cast<TX*>(isC ? a.dC : a.dB)[i] = from_f<TX>(s);
    return;
  }
  const long long hh = e - 2 * m;
  if (hh >= a.h) return;
  float s = 0.f;
  for (long long bc = 0; bc < (long long)a.bt * a.nc; ++bc) s += a.dAp[bc * a.h + hh];
  a.dA[hh] = s;
}

// ================================================================ tensor cores
// bf16 inputs run every product of the per-chunk kernels on the tensor
// cores: mma.sync m16n8k16 bf16 -> fp32.  Operands are staged as bf16 tiles
// in shared memory (rows padded by 16 bytes, so ldmatrix reads 8 rows
// without bank conflicts).  x, B, C are bf16 already; the fp32 operands
// (dy, S_prev, G) and the masked decay matrices are rounded to bf16, as
// `ssd_chunked` rounds its scores and carried states to x's type (the
// forward rounds w dt B and M = (C B^T) L dt in registers and keeps x
// exact).  The exception is the backward's
// dM = dy (dt x)^T and M, whose row and column sums cancel into the
// gradient of the decays: there M stays fp32, x is staged unscaled (exact)
// and an fp32 dy is split into two bf16 parts.  Each of the 8 warps owns 16
// whole rows of a 128-row output; its accumulator fragments stay in
// registers through the epilogues (decays, masks, the dcs sums), which walk
// the fragment layout.  The CUDA-core kernels above serve float32, which
// must match the plain version to 1e-4.

using bf16 = __nv_bfloat16;
constexpr int LDQ = QM + 8;     // bf16 (rows, 128) tiles
constexpr int LDP = PM + 8;     // bf16 (rows, 64) tiles
static_assert(NM == QM, "the (Q, N) and (Q, Q) tiles share a stride");

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

// acc (the warp's rows 16 w.., NT n-tiles of 8 columns) += A B over K.
// A is stored (M rows, K columns), or (K rows, M columns) if AT; B is
// stored (N rows, K columns), or (K rows, N columns) if BT.
template <int NT, int K, bool AT, bool BT>
__device__ __forceinline__ void mma_block(float (&acc)[NT][4], const bf16* A, int lda,
                                          const bf16* B, int ldb, int warp, int lane) {
  const int m0 = 16 * warp;
#pragma unroll 2
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    if (AT)
      ldsm_x4_t(a, A + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * lda + m0 +
                       ((lane >> 3) & 1) * 8);
    else
      ldsm_x4(a, A + (m0 + (lane & 15)) * lda + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t b[4];
      if (BT)
        ldsm_x4_t(b, B + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + jj * 16 +
                         (lane >> 4) * 8);
      else
        ldsm_x4(b, B + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldb + kk * 16 +
                       ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * jj], a, b[0], b[1]);
      mma16816(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_frag(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// Row and column of fragment element e of n-tile j for this lane.
__device__ __forceinline__ int frag_row(int warp, int lane, int e) {
  return 16 * warp + (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int lane, int j, int e) {
  return 8 * j + 2 * (lane & 3) + (e & 1);
}

// Sum over the 4 lanes that share a fragment row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Eight values of a row into a bf16 tile, from bf16 (one 16-byte load) or
// fp32 (two), times an optional scale.
__device__ __forceinline__ void load8(float (&v)[8], const bf16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// dst (R rows, CC columns, stride ld) = src rows r < rlim, columns c < clim
// (clim a multiple of 8) times rscale[r]; zeros elsewhere.
template <int R, int CC, typename T>
__device__ __forceinline__ void stage_bf16(bf16* dst, int ld, const T* src, long long rs,
                                           int rlim, int clim, const float* rscale) {
  constexpr int VPR = CC / 8;
  for (int idx = threadIdx.x; idx < R * VPR; idx += kThreads) {
    const int r = idx / VPR, c = (idx - r * VPR) * 8;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < rlim && c < clim) {
      load8(v, src + r * rs + c);
      if (rscale) {
        const float sc = rscale[r];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] *= sc;
      }
    }
    uint4 out;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = out;
  }
}

// acc (the warp's rows 16 w.., NT n-tiles of 8 columns) += A B over the
// k-steps [k0, k1) of 16, skipping the pairs of n-tiles at or past npairs:
// mma_block with the ranges that the causal mask (or a short chunk, N or P)
// leaves live.
template <int NT, bool AT, bool BT>
__device__ __forceinline__ void mma_range(float (&acc)[NT][4], const bf16* A, int lda,
                                          const bf16* B, int ldb, int warp, int lane, int k0,
                                          int k1, int npairs = NT / 2) {
  const int m0 = 16 * warp;
#pragma unroll 2
  for (int kk = k0; kk < k1; ++kk) {
    uint32_t a[4];
    if (AT)
      ldsm_x4_t(a, A + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * lda + m0 +
                       ((lane >> 3) & 1) * 8);
    else
      ldsm_x4(a, A + (m0 + (lane & 15)) * lda + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      if (jj < npairs) {
        uint32_t b[4];
        if (BT)
          ldsm_x4_t(b, B + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + jj * 16 +
                           (lane >> 4) * 8);
        else
          ldsm_x4(b, B + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldb + kk * 16 +
                         ((lane >> 3) & 1) * 8);
        mma16816(acc[2 * jj], a, b[0], b[1]);
        mma16816(acc[2 * jj + 1], a, b[2], b[3]);
      }
    }
  }
}

// V = (e * C)^T dy, rows n, cols p: the backward's chunk dstates.
template <typename TY>
__global__ void __launch_bounds__(kThreads) ssd_state_mma_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* s_dt = reinterpret_cast<float*>(smem4);
  float* s_cs = s_dt + QM;
  float* s_sc = s_cs + QM;
  bf16* Xb = reinterpret_cast<bf16*>(s_sc + QM);     // (Q, N): C, scaled
  bf16* Yb = Xb + QM * LDQ;                          // (Q, P): dy
  const Chunk k(a);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  chunk_prologue(s_dt, s_cs, a.dt + k.b * a.dt_sb + k.t0 * a.dt_ss + k.hh * a.dt_sh, a.dt_ss,
                 k.q, a.A[k.hh]);
  for (int i = threadIdx.x; i < QM; i += kThreads) s_sc[i] = i < k.q ? expf(s_cs[i]) : 0.f;
  __syncthreads();
  stage_bf16<QM, NM>(Xb, LDQ, static_cast<const bf16*>(a.C) + k.b * a.C_sb + k.t0 * a.C_ss,
                     a.C_ss, k.q, a.n, s_sc);
  stage_bf16<QM, PM>(Yb, LDP, static_cast<const TY*>(a.y) + k.b * a.y_sb + k.t0 * a.y_ss +
                     k.hh * a.y_sh, a.y_ss, k.q, a.p, (const float*)nullptr);
  __syncthreads();
  float acc[PM / 8][4];
  zero_frag(acc);
  mma_block<PM / 8, QM, true, true>(acc, Xb, LDQ, Yb, LDP, warp, lane);
  float* out = a.G + k.blk * a.n * a.p;
#pragma unroll
  for (int j = 0; j < PM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = frag_row(warp, lane, e), c = frag_col(lane, j, e);
      if (r < a.n && c < a.p) out[r * a.p + c] = acc[j][e];
    }
}

// cp.async: 16 (or 4) bytes from device memory into shared memory, or zeros
// where !ok (the source is then not read).  A block waits for its copies
// with cp_async_wait_all and a barrier.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dst (R rows, CC columns, stride ld) <- src rows r < rlim, columns
// c < clim (a multiple of 16 bytes' worth), zeros elsewhere, by cp.async.
// Thread tid of nthreads takes every nthreads-th vector.
template <int R, int CC, typename T>
__device__ __forceinline__ void async_tile(T* dst, int ld, const T* src, long long rs, int rlim,
                                           int clim, int tid = threadIdx.x,
                                           int nthreads = kThreads) {
  constexpr int EPV = 16 / sizeof(T), VPR = CC / EPV;
  for (int idx = tid; idx < R * VPR; idx += nthreads) {
    const int r = idx / VPR, c = (idx - r * VPR) * EPV;
    const bool ok = r < rlim && c < clim;
    cp_async16(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
  }
}

// The q rows of dt (row stride rs) into dst by cp.async, zeros past q;
// thread t of the caller's first QM threads takes row t.
__device__ __forceinline__ void async_dt(float* dst, const float* src, long long rs, int q,
                                         int t = threadIdx.x) {
  if (t < QM) cp_async4(dst + t, t < q ? src + t * rs : src, t < q);
}

// Named barriers (id 0 is __syncthreads): bar_sync waits until n threads
// have arrived, bar_arrive arrives without waiting.  Shared-memory writes
// before either are visible to the threads that pass the barrier.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// A bf16 pair times (s.x, s.y), rounded to bf16.
__device__ __forceinline__ uint32_t scale_bf16(uint32_t v, float2 s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return pack_bf16(f.x * s.x, f.y * s.y);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// fp32 (rows, PM) tiles staged for 16-byte stores: the fragment pairs that
// a half-warp writes (4 rows x 4 column pairs) land on distinct banks
constexpr int LDF = PM + 8;
constexpr int kFwdBuf = QM * LDQ + QM * LDP;         // bf16 of a state-pass buffer: B, x
static_assert(NM * LDF * 4 <= kFwdBuf * 2, "S_prev staging fits in a spent buffer");

// Forward, bf16, 1: a block per (head, batch) walks the chunks in order
// with the (N, P) state S in registers (warp w: rows n = 16 w..16 w + 15,
// all P columns).  Per chunk it forms U = B^T diag(w dt) x with w_t =
// exp(T - cs_t) (B's A fragments scaled in registers, x as loaded), writes
// S as the chunk's S_prev (staged in the chunk's spent buffer, then whole
// rows of 16-byte stores) and T, and sets S <- exp(T) S + U,
// ssd_scan_kernel's update.  The next chunk's B, x and dt load by cp.async
// into the other buffer while this chunk computes; two blocks share an SM.
__global__ void __launch_bounds__(kThreads, 2) ssd_fwd_states_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* s_dt = reinterpret_cast<float*>(smem4);     // 2 x QM: dt, by buffer
  float* s_cs = s_dt + 2 * QM;
  float* s_w = s_cs + QM;                            // w * dt
  bf16* tiles = reinterpret_cast<bf16*>(s_w + QM);   // 2 x kFwdBuf: B (Q, N), x (Q, P)
  const int hh = blockIdx.x, b = blockIdx.y;
  const int q = a.q, n = a.n, p = a.p;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float A = a.A[hh];
  const bf16* Bs = static_cast<const bf16*>(a.B) + b * a.B_sb;
  const bf16* xs = static_cast<const bf16*>(a.x) + b * a.x_sb + hh * a.x_sh;
  const float* dts = a.dt + b * a.dt_sb + hh * a.dt_sh;
  auto load = [&](int c, int buf) {
    const long long t0 = (long long)c * q;
    async_tile<QM, NM>(tiles + buf * kFwdBuf, LDQ, Bs + t0 * a.B_ss, a.B_ss, q, n);
    async_tile<QM, PM>(tiles + buf * kFwdBuf + QM * LDQ, LDP, xs + t0 * a.x_ss, a.x_ss, q, p);
    async_dt(s_dt + buf * QM, dts + t0 * a.dt_ss, a.dt_ss, q);
    cp_async_commit();
  };
  const int ksteps = (q + 15) / 16, npairs = (p + 15) / 16;
  const bool live = 16 * warp < n;                   // this warp holds rows of S
  float S[PM / 8][4], U[PM / 8][4];
  zero_frag(S);
  load(0, 0);
#pragma unroll 1
  for (int c = 0; c < a.nc; ++c) {
    const int buf = c & 1;
    cp_async_wait_all();
    __syncthreads();                 // chunk c's tiles are in; every warp is done with c - 1
    if (c + 1 < a.nc) load(c + 1, buf ^ 1);
    const float* dtc = s_dt + buf * QM;
    if (warp == 0) {
      float v[QM / 32];
      cumsum_warp(dtc, A, v);
#pragma unroll
      for (int k = 0; k < QM / 32; ++k) s_cs[lane * (QM / 32) + k] = v[k];
      __syncwarp();
      const float T = s_cs[q - 1];
#pragma unroll
      for (int k = 0; k < QM / 32; ++k) {
        const int i = lane * (QM / 32) + k;
        s_w[i] = expf(T - v[k]) * dtc[i];          // rows past q: dt 0
      }
    }
    __syncthreads();
    const float T = s_cs[q - 1];
    const long long blk = ((long long)b * a.nc + c) * a.h + hh;
    if (threadIdx.x == 0) a.T[blk] = T;
    const bf16* Bt = tiles + buf * kFwdBuf;
    const bf16* xt = Bt + QM * LDQ;
    zero_frag(U);
    if (live) {
#pragma unroll 2
      for (int kk = 0; kk < ksteps; ++kk) {
        // B^T's A fragment (rows n, k = t), columns t scaled by w dt
        uint32_t af[4];
        ldsm_x4_t(af, Bt + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LDQ + 16 * warp +
                          ((lane >> 3) & 1) * 8);
        const int k0 = 16 * kk + 2 * (lane & 3);
        const float2 w0 = *reinterpret_cast<const float2*>(s_w + k0);
        const float2 w1 = *reinterpret_cast<const float2*>(s_w + k0 + 8);
        af[0] = scale_bf16(af[0], w0);
        af[1] = scale_bf16(af[1], w0);
        af[2] = scale_bf16(af[2], w1);
        af[3] = scale_bf16(af[3], w1);
#pragma unroll
        for (int jj = 0; jj < PM / 16; ++jj) {
          if (jj < npairs) {
            uint32_t bf[4];
            ldsm_x4_t(bf, xt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP + jj * 16 +
                              (lane >> 4) * 8);
            mma16816(U[2 * jj], af, bf[0], bf[1]);
            mma16816(U[2 * jj + 1], af, bf[2], bf[3]);
          }
        }
      }
    }
    // S_prev: fragments into the spent buffer, then rows out
    __syncthreads();                 // every warp is done with this buffer's tiles
    float* stg = reinterpret_cast<float*>(tiles + buf * kFwdBuf);
    if (live) {
#pragma unroll
      for (int j = 0; j < PM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          store2(stg + frag_row(warp, lane, e) * LDF + frag_col(lane, j, e), S[j][e], S[j][e + 1]);
    }
    __syncthreads();
    float* out = a.states + blk * n * p;
    for (int idx = threadIdx.x; idx < NM * (PM / 4); idx += kThreads) {
      const int r = idx / (PM / 4), cc = (idx - r * (PM / 4)) * 4;
      if (r < n && cc < p)
        *reinterpret_cast<float4*>(out + r * p + cc) =
            *reinterpret_cast<const float4*>(stg + r * LDF + cc);
    }
    const float d = expf(T);
#pragma unroll
    for (int j = 0; j < PM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[j][e] = fmaf(S[j][e], d, U[j][e]);
  }
}

// Forward, bf16, 2: a block per (chunk, head group, batch), warp
// specialized.  Eight compute warps form the raw scores G = C B^T once and
// keep them in registers for all the group's heads (warp w: rows 16 w..,
// the 16-wide column blocks at or left of the diagonal).  Per head they
// compute y = exp(cs) (C S_prev) + M (dt x), where M's bf16 A fragments are
// formed from G, the decays (masked in the exponent on the diagonal block)
// and dt in registers.  Four producer warps run up to kOutStages heads
// ahead through a ring of buffers: x, dt and fp32 S_prev by cp.async,
// S_prev turned into a bf16 tile, cs and exp(cs).  Named barriers hand a
// buffer over (full) and back (empty).
constexpr int kOutCompute = 256, kOutProducers = 128, kOutThreads = kOutCompute + kOutProducers;
constexpr int kOutStages = 2;
enum { kBarFull = 1, kBarEmpty = 1 + kOutStages, kBarProducers = 1 + 2 * kOutStages,
       kBarCompute = 2 + 2 * kOutStages };            // barrier ids (full, empty: by buffer)

template <typename TY>
__global__ void __launch_bounds__(kOutThreads, 1) ssd_fwd_out_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* s_dt = reinterpret_cast<float*>(smem4);     // kOutStages x QM each, by buffer
  float* s_cs = s_dt + kOutStages * QM;
  float* s_e = s_cs + kOutStages * QM;               // exp(cs)
  float* Sf = s_e + kOutStages * QM;                 // (N, PM) fp32: S_prev as loaded
  bf16* Cb = reinterpret_cast<bf16*>(Sf + NM * PM);  // (Q, N): C
  bf16* Bb = Cb + QM * LDQ;                          // (Q, N): B
  bf16* Sb = Bb + QM * LDQ;                          // kOutStages x (N, P): S_prev
  bf16* xb = Sb + kOutStages * NM * LDP;             // kOutStages x (Q, P): x
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int h0 = grp * a.hg, nh = min(a.h, h0 + a.hg) - h0;
  const int q = a.q, n = a.n, p = a.p;
  const long long t0 = (long long)c * q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x >= kOutCompute) {  // ---- producers
    const int pt = threadIdx.x - kOutCompute;
    const bf16* xs = static_cast<const bf16*>(a.x) + b * a.x_sb + t0 * a.x_ss;
    const float* dts = a.dt + b * a.dt_sb + t0 * a.dt_ss;
#pragma unroll 1
    for (int i = 0; i < nh; ++i) {
      const int buf = i % kOutStages, hh = h0 + i;
      if (i >= kOutStages) bar_sync(kBarEmpty + buf, kOutThreads);   // its last head is done
      async_tile<QM, PM>(xb + buf * QM * LDP, LDP, xs + hh * a.x_sh, a.x_ss, q, p, pt,
                         kOutProducers);
      async_dt(s_dt + buf * QM, dts + hh * a.dt_sh, a.dt_ss, q, pt);
      async_tile<NM, PM>(Sf, PM, a.states + (((long long)b * a.nc + c) * a.h + hh) * n * p,
                         (long long)p, n, p, pt, kOutProducers);
      cp_async_commit();
      cp_async_wait_all();
      bar_sync(kBarProducers, kOutProducers);               // the copies are in
      bf16* St = Sb + buf * NM * LDP;
      for (int idx = pt; idx < NM * PM / 4; idx += kOutProducers) {
        const int r = idx / (PM / 4), cc = (idx - r * (PM / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(Sf + r * PM + cc);
        *reinterpret_cast<uint2*>(St + r * LDP + cc) =
            make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      }
      if (pt < 32) {
        float v[QM / 32];
        cumsum_warp(s_dt + buf * QM, a.A[hh], v);
#pragma unroll
        for (int k = 0; k < QM / 32; ++k) {
          const int r = lane * (QM / 32) + k;
          s_cs[buf * QM + r] = v[k];
          s_e[buf * QM + r] = r < q ? expf(v[k]) : 0.f;
        }
      }
      bar_sync(kBarProducers, kOutProducers);               // Sf is read
      bar_arrive(kBarFull + buf, kOutThreads);
    }
    return;
  }

  // ---- compute warps
  const int live = warp + 1;         // 16-wide column blocks at or left of the diagonal
  const bool rows = 16 * warp < q;   // this warp has rows of the chunk
  const int nsteps = (n + 15) / 16, npairs = (p + 15) / 16;
  stage_bf16<QM, NM>(Cb, LDQ, static_cast<const bf16*>(a.C) + b * a.C_sb + t0 * a.C_ss, a.C_ss,
                     q, n, (const float*)nullptr);
  stage_bf16<QM, NM>(Bb, LDQ, static_cast<const bf16*>(a.B) + b * a.B_sb + t0 * a.B_ss, a.B_ss,
                     q, n, (const float*)nullptr);
  bar_sync(kBarCompute, kOutCompute);
  float g[QM / 8][4];
  zero_frag(g);
  if (rows) mma_range<QM / 8, false, false>(g, Cb, LDQ, Bb, LDQ, warp, lane, 0, nsteps, live);
  const int r0 = frag_row(warp, lane, 0), r1 = r0 + 8;

#pragma unroll 1
  for (int i = 0; i < nh; ++i) {
    const int buf = i % kOutStages, hh = h0 + i;
    bar_sync(kBarFull + buf, kOutThreads);                  // head i's tiles are in
    if (rows) {
      const float* dtc = s_dt + buf * QM;
      const float* csc = s_cs + buf * QM;
      float acc[PM / 8][4];
      zero_frag(acc);
      mma_range<PM / 8, false, true>(acc, Cb, LDQ, Sb + buf * NM * LDP, LDP, warp, lane, 0,
                                     nsteps, npairs);
      const float e0 = s_e[buf * QM + r0], e1 = s_e[buf * QM + r1];
      const float cs0 = csc[r0], cs1 = csc[r1];
#pragma unroll
      for (int j = 0; j < PM / 8; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
      // M's entry (r, col..col+1) from G: g exp(cs_r - cs_col) dt_col, the
      // exponent masked to -inf right of the diagonal
      auto mpair = [&](float g0, float g1, float csr, int r, int col, bool diag) {
        const float2 cc = *reinterpret_cast<const float2*>(csc + col);
        const float2 dd = *reinterpret_cast<const float2*>(dtc + col);
        const float l0 = diag && col > r ? -INFINITY : (csr - cc.x) * kLog2e;
        const float l1 = diag && col + 1 > r ? -INFINITY : (csr - cc.y) * kLog2e;
        return pack_bf16(g0 * exp2f(l0) * dd.x, g1 * exp2f(l1) * dd.y);
      };
      const bf16* xt = xb + buf * QM * LDP;
#pragma unroll
      for (int kk = 0; kk < QM / 16; ++kk) {
        if (kk < live && 16 * kk < q) {
          const bool diag = kk == warp;
          const int k0 = 16 * kk + 2 * (lane & 3);
          uint32_t af[4];
          af[0] = mpair(g[2 * kk][0], g[2 * kk][1], cs0, r0, k0, diag);
          af[1] = mpair(g[2 * kk][2], g[2 * kk][3], cs1, r1, k0, diag);
          af[2] = mpair(g[2 * kk + 1][0], g[2 * kk + 1][1], cs0, r0, k0 + 8, diag);
          af[3] = mpair(g[2 * kk + 1][2], g[2 * kk + 1][3], cs1, r1, k0 + 8, diag);
#pragma unroll
          for (int jj = 0; jj < PM / 16; ++jj) {
            if (jj < npairs) {
              uint32_t bf[4];
              ldsm_x4_t(bf, xt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP + jj * 16 +
                                (lane >> 4) * 8);
              mma16816(acc[2 * jj], af, bf[0], bf[1]);
              mma16816(acc[2 * jj + 1], af, bf[2], bf[3]);
            }
          }
        }
      }
      TY* yc = static_cast<TY*>(a.y) + b * a.y_sb + t0 * a.y_ss + hh * a.y_sh;
#pragma unroll
      for (int j = 0; j < PM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = frag_row(warp, lane, e), cc = frag_col(lane, j, e);
          if (r < q && cc < p) store2(yc + r * a.y_ss + cc, acc[j][e], acc[j][e + 1]);
        }
    }
    if (i + kOutStages < nh) bar_arrive(kBarEmpty + buf, kOutThreads);   // to be refilled
  }
}

// stage_bf16 with every load of a thread issued before any store (a block
// that stages, then computes, waits one load latency, not one per row):
// dst = src * rscale (rows r < rlim, columns c < clim, else zeros); with
// lo, an fp32 source goes in as hi (dst) + lo, its rounding error.
template <int R, int CC, typename T>
__device__ __forceinline__ void stage_tile(bf16* dst, bf16* lo, int ld, const T* src,
                                           long long rs, int rlim, int clim,
                                           const float* rscale) {
  constexpr int VPR = CC / 8, NV = R * VPR, IT = (NV + kThreads - 1) / kThreads;
  float v[IT][8];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int idx = threadIdx.x + it * kThreads, r = idx / VPR, c = (idx - r * VPR) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) v[it][i] = 0.f;
    if (idx < NV && r < rlim && c < clim) load8(v[it], src + r * rs + c);
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int idx = threadIdx.x + it * kThreads, r = idx / VPR, c = (idx - r * VPR) * 8;
    if (idx >= NV) continue;
    if (rscale && r < rlim) {
      const float sc = rscale[r];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[it][i] *= sc;
    }
    uint4 oh, ol;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&oh);
    __nv_bfloat162* l = reinterpret_cast<__nv_bfloat162*>(&ol);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[it][2 * i], v[it][2 * i + 1]);
      const float2 back = __bfloat1622float2(h[i]);
      l[i] = __floats2bfloat162_rn(v[it][2 * i] - back.x, v[it][2 * i + 1] - back.y);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = oh;
    if (lo) *reinterpret_cast<uint4*>(lo + r * ld + c) = ol;
  }
}

// Rows r of an (R, CC) bf16 tile (stride LDP) times s1[r] (times s2[r]), in
// place.
template <int R, int CC>
__device__ __forceinline__ void scale_rows(bf16* t, const float* s1, const float* s2) {
  constexpr int VPR = CC / 8;
  for (int idx = threadIdx.x; idx < R * VPR; idx += kThreads) {
    const int r = idx / VPR, c = (idx - r * VPR) * 8;
    const float sc = s2 ? s1[r] * s2[r] : s1[r];
    uint4 raw = *reinterpret_cast<const uint4*>(t + r * LDP + c);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      h[i] = __floats2bfloat162_rn(f.x * sc, f.y * sc);
    }
    *reinterpret_cast<uint4*>(t + r * LDP + c) = raw;
  }
}

// S_prev and G (N, P) fp32 into Sb and Gb, loads first; returns this
// thread's share of <G, S_prev> in fp32.
__device__ __forceinline__ float stage_states(bf16* Sb, bf16* Gb, const float* Sp,
                                              const float* Gc, int n, int p) {
  constexpr int VPR = PM / 8, NV = NM * VPR, IT = NV / kThreads, HALF = IT / 2;
  static_assert(NV % kThreads == 0 && IT % 2 == 0, "whole rounds of the block");
  float part = 0.f;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {      // two rounds of HALF: 32 loads in flight a thread
    float vs[HALF][8], vg[HALF][8];
#pragma unroll
    for (int it = 0; it < HALF; ++it) {
      const int idx = threadIdx.x + (h2 * HALF + it) * kThreads, r = idx / VPR,
                c = (idx - r * VPR) * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) vs[it][i] = vg[it][i] = 0.f;
      if (r < n && c < p) {
        load8(vs[it], Sp + r * p + c);
        load8(vg[it], Gc + r * p + c);
      }
    }
#pragma unroll
    for (int it = 0; it < HALF; ++it) {
      const int idx = threadIdx.x + (h2 * HALF + it) * kThreads, r = idx / VPR,
                c = (idx - r * VPR) * 8;
      uint4 os, og;
      __nv_bfloat162* hs = reinterpret_cast<__nv_bfloat162*>(&os);
      __nv_bfloat162* hg = reinterpret_cast<__nv_bfloat162*>(&og);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hs[i] = __floats2bfloat162_rn(vs[it][2 * i], vs[it][2 * i + 1]);
        hg[i] = __floats2bfloat162_rn(vg[it][2 * i], vg[it][2 * i + 1]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) part = fmaf(vg[it][i], vs[it][i], part);
      *reinterpret_cast<uint4*>(Sb + r * LDP + c) = os;
      *reinterpret_cast<uint4*>(Gb + r * LDP + c) = og;
    }
  }
  return part;
}

// The backward of one (batch, chunk) for a group of heads on the tensor
// cores: the terms of ssd_bwd_kernel for each head in turn, in head order.
// C and B are staged once for all the heads.  dC and dB stay in registers
// across the heads, the per-head parts added in head order:
//     dC = sum_h [ (e dy) S_prev^T + ds B ],
//     dB = sum_h [ (w dt x) G^T + ds^T C ],
// with e dy and w dt x scaled in place as bf16 A operands, so no per-head
// tile is kept; one head group writes dC and dB in B's type, several write fp32
// partials that ssd_reduce_kernel sums in group order.  Term 3's share of
// dcs is e_i dy_i . (C S_prev)_i.  Products skip the 16-row (or 16-column)
// fragments that lie wholly above the diagonal of the causal (Q, Q) tiles.
// C B^T is formed again for each head, its causal part only.  One copy
// kept across heads was not attempted: its causal 16 x 16 fragments take
// 18 KB of shared memory as bf16 (11 KB are free beside the 221 KB of
// tiles) or 32 registers a thread beside the ~250 in use, and the product
// is ~12% of a head's tensor-core work (1.18 of 9.5 M multiply-adds).
template <typename TY>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_heads_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* s_dt = reinterpret_cast<float*>(smem4);
  float* s_cs = s_dt + QM;
  float* s_e = s_cs + QM;
  float* s_w = s_e + QM;
  float* s_dcs = s_w + QM;
  float* s_ddt = s_dcs + QM;
  float* s_wdw = s_ddt + QM;
  float* s_red = s_wdw + QM;                         // 32
  float* s_col = s_red + 32;                         // (8 warps, Q) column partials
  bf16* Cb = reinterpret_cast<bf16*>(s_col + 8 * QM);
  bf16* Bb = Cb + QM * LDQ;
  bf16* Mb = Bb + QM * LDQ;                          // masked scores M
  bf16* Db = Mb + QM * LDQ;                          // ds = dM * L
  bf16* gb = Db + QM * LDQ;                          // dy, then e * dy
  bf16* xb = gb + QM * LDP;                          // x, then w * dt * x
  bf16* Sb = xb + QM * LDP;                          // S_prev (N, P); first dy's lo part
  bf16* Gb = Sb + NM * LDP;                          // G (N, P)
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int h_end = min(a.h, (grp + 1) * a.hg);
  const int q = a.q, t0 = c * a.q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int live = warp + 1;   // 16-wide blocks at or left of this warp's diagonal block
  const bf16* Cc = static_cast<const bf16*>(a.C) + b * a.C_sb + t0 * a.C_ss;
  const bf16* Bc = static_cast<const bf16*>(a.B) + b * a.B_sb + t0 * a.B_ss;
  const float* none = nullptr;
  // x, B, C and a bf16 dy are exact in bf16; an fp32 dy is split into hi +
  // lo (lo in Sb until term 1 is done), so that dM, whose row and column
  // sums cancel into dcs, keeps ~16 bits
  constexpr bool split = sizeof(TY) == 4;
  stage_bf16<QM, NM>(Cb, LDQ, Cc, a.C_ss, q, a.n, none);
  stage_bf16<QM, NM>(Bb, LDQ, Bc, a.B_ss, q, a.n, none);
  float accC[NM / 8][4], accB[NM / 8][4];
  zero_frag(accC);
  zero_frag(accB);

  // each head's dt is loaded while the head before it computes
  const float* dtc = a.dt + b * a.dt_sb + t0 * a.dt_ss;
  const int row = threadIdx.x;
  float dt_next = row < q ? dtc[row * a.dt_ss + grp * a.hg * a.dt_sh] : 0.f;
#pragma unroll 1
  for (int hh = grp * a.hg; hh < h_end; ++hh) {
    const Chunk k(a, b, c, hh);
    const float A = a.A[hh];
    if (row < QM) s_dt[row] = dt_next;
    dt_next = row < q && hh + 1 < h_end ? dtc[row * a.dt_ss + (hh + 1) * a.dt_sh] : 0.f;
    __syncthreads();
    chunk_cumsum(s_dt, s_cs, A);
    const float T = s_cs[q - 1];
    for (int i = threadIdx.x; i < QM; i += kThreads) {
      s_e[i] = i < q ? expf(s_cs[i]) : 0.f;
      s_w[i] = i < q ? expf(T - s_cs[i]) : 0.f;
    }
    const bf16* xc = static_cast<const bf16*>(a.x) + b * a.x_sb + t0 * a.x_ss + hh * a.x_sh;
    const TY* gc = static_cast<const TY*>(a.y) + b * a.y_sb + t0 * a.y_ss + hh * a.y_sh;
    const float* Sp = a.states + k.blk * a.n * a.p;
    const float* Gc = a.G + k.blk * a.n * a.p;
    stage_tile<QM, PM>(gb, split ? Sb : nullptr, LDP, gc, a.y_ss, q, a.p, none);
    stage_tile<QM, PM>(xb, nullptr, LDP, xc, a.x_ss, q, a.p, none);
    __syncthreads();

    // term 1, by quarters of 32 columns: M = (C B^T) * L in fp32 (into Mb
    // as bf16), dM = dy (dt x)^T, ds = dM * L into Db, R = dM * M row and
    // column sums; quarters right of the diagonal block are zeros
    {
      float rs[2] = {0.f, 0.f};
#pragma unroll 1
      for (int qc = 0; qc < QM / 32; ++qc) {
        float sc[4][4], dm[4][4], cs2[4][2];
        zero_frag(sc);
        zero_frag(dm);
        const int pairs = min(2, live - 2 * qc);
        if (pairs > 0) {
          mma_range<4, false, false>(sc, Cb, LDQ, Bb + qc * 32 * LDQ, LDQ, warp, lane, 0,
                                     NM / 16, pairs);
          mma_range<4, false, false>(dm, gb, LDP, xb + qc * 32 * LDP, LDP, warp, lane, 0,
                                     PM / 16, pairs);
          if (split)
            mma_range<4, false, false>(dm, Sb, LDP, xb + qc * 32 * LDP, LDP, warp, lane, 0,
                                       PM / 16, pairs);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cs2[j][0] = cs2[j][1] = 0.f;
          const bool tile_on = 2 * qc + (j >> 1) < live;    // else above the diagonal
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int r = frag_row(warp, lane, e), cc = 32 * qc + frag_col(lane, j, e);
            float m[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
#pragma unroll
            for (int t = 0; t < 2 && tile_on; ++t) {
              const bool on = cc + t <= r && r < q;
              const float L = on ? exp2f((s_cs[r] - s_cs[cc + t]) * kLog2e) : 0.f;
              const float g = dm[j][e + t] * s_dt[cc + t];
              m[t] = sc[j][e + t] * L;
              d[t] = g * L;
              const float R = g * m[t];
              rs[e >> 1] += R;
              cs2[j][t] += R;
            }
            *reinterpret_cast<__nv_bfloat162*>(Mb + r * LDQ + cc) =
                __floats2bfloat162_rn(m[0], m[1]);
            *reinterpret_cast<__nv_bfloat162*>(Db + r * LDQ + cc) =
                __floats2bfloat162_rn(d[0], d[1]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            float v = cs2[j][t];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if ((lane >> 2) == 0) s_col[warp * QM + 32 * qc + frag_col(lane, j, t)] = v;
          }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float v = quad_sum(rs[hf]);
        if ((lane & 3) == 0) s_dcs[frag_row(warp, lane, 2 * hf)] = v;
      }
      __syncthreads();
      for (int cc = threadIdx.x; cc < QM; cc += kThreads) {
        float v = 0.f;
        for (int w = 0; w < kThreads / 32; ++w) v += s_col[w * QM + cc];
        s_dcs[cc] -= v;
      }
      __syncthreads();                               // Sb's lo part is read
    }
    const float gs_part = stage_states(Sb, Gb, Sp, Gc, a.n, a.p);
    __syncthreads();

    // term 2: d(dt x) = w * (B G) + M^T dy; dw; dx and ddt's x . d(dt x)
    {
      float acc[PM / 8][4];
      zero_frag(acc);
      mma_range<PM / 8, false, true>(acc, Bb, LDQ, Gb, LDP, warp, lane, 0, NM / 16);
      float dw[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < PM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = frag_row(warp, lane, e), cc = frag_col(lane, j, e);
          dw[e >> 1] += __bfloat162float(xb[r * LDP + cc]) * acc[j][e];
          acc[j][e] *= s_w[r];
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = frag_row(warp, lane, 2 * hf);
        const float v = quad_sum(dw[hf]) * s_dt[r];
        if ((lane & 3) == 0) {
          s_wdw[r] = s_w[r] * v;
          s_dcs[r] -= s_w[r] * v;
        }
      }
      // M^T: row j takes the rows i >= j of M
      mma_range<PM / 8, true, true>(acc, Mb, LDQ, gb, LDP, warp, lane, warp, QM / 16);
      bf16* dxc = static_cast<bf16*>(a.dx) + b * a.dx_sb + t0 * a.dx_ss + hh * a.dx_sh;
      float dd[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < PM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = frag_row(warp, lane, e), cc = frag_col(lane, j, e);
          const float2 xx = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xb + r * LDP + cc));
          dd[e >> 1] += xx.x * acc[j][e] + xx.y * acc[j][e + 1];
          if (r < q && cc < a.p)
            *reinterpret_cast<__nv_bfloat162*>(dxc + r * a.dx_ss + cc) =
                __floats2bfloat162_rn(s_dt[r] * acc[j][e], s_dt[r] * acc[j][e + 1]);
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float v = quad_sum(dd[hf]);
        if ((lane & 3) == 0) s_ddt[frag_row(warp, lane, 2 * hf)] = v;
      }
    }
    __syncthreads();
    // the A operands of this head's share of dC and dB, in place: e * dy
    // (dy's bf16 part) and w * dt * x
    scale_rows<QM, PM>(gb, s_e, nullptr);
    scale_rows<QM, PM>(xb, s_w, s_dt);

    // term 3: dcs_i += e_i dy_i . (C S_prev)_i; dC += (e dy) S_prev^T + ds B
    {
      float acc[PM / 8][4];
      zero_frag(acc);
      mma_range<PM / 8, false, true>(acc, Cb, LDQ, Sb, LDP, warp, lane, 0, NM / 16);
      float dc[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < PM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = frag_row(warp, lane, e), cc = frag_col(lane, j, e);
          if (r < q && cc < a.p) {
            const float2 g = load2(gc + r * a.y_ss + cc);
            dc[e >> 1] += g.x * acc[j][e] + g.y * acc[j][e + 1];
          }
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = frag_row(warp, lane, 2 * hf);
        const float v = quad_sum(dc[hf]);
        if ((lane & 3) == 0) s_dcs[r] += s_e[r] * v;
      }
    }
    __syncthreads();                                 // gb and xb are scaled
    mma_range<NM / 8, false, false>(accC, gb, LDP, Sb, LDP, warp, lane, 0, PM / 16);
    mma_range<NM / 8, false, true>(accC, Db, LDQ, Bb, LDQ, warp, lane, 0, live);
    // dB += (w dt x) G^T + ds^T C; ds^T's row j takes the rows i >= j of ds
    mma_range<NM / 8, false, false>(accB, xb, LDP, Gb, LDP, warp, lane, 0, PM / 16);
    mma_range<NM / 8, true, true>(accB, Db, LDQ, Cb, LDQ, warp, lane, warp, QM / 16);
    finish_dcs(a, k, gs_part, T, A, s_dt, s_dcs, s_ddt, s_wdw, s_red);
    __syncthreads();                                 // before the next head restages
  }

  // one group: dC and dB in B's type; several: fp32 partials of this group
  const long long row0 = (long long)b * a.s + t0;
#pragma unroll
  for (int j = 0; j < NM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = frag_row(warp, lane, e), cc = frag_col(lane, j, e);
      if (r >= q || cc >= a.n) continue;
      const long long off = (row0 + r) * a.n + cc;
      if (!a.dCp) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dC) + off) =
            __floats2bfloat162_rn(accC[j][e], accC[j][e + 1]);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dB) + off) =
            __floats2bfloat162_rn(accB[j][e], accB[j][e + 1]);
      } else {
        const long long goff = (long long)grp * a.bt * a.s * a.n + off;
        *reinterpret_cast<float2*>(a.dCp + goff) = make_float2(accC[j][e], accC[j][e + 1]);
        *reinterpret_cast<float2*>(a.dBp + goff) = make_float2(accB[j][e], accB[j][e + 1]);
      }
    }
}

constexpr int kOutSmem = (3 * QM + QM * LDM + 2 * SLAB) * 4;
constexpr int kBwdSmem = (7 * QM + 32 + 2 * QM * LDM + 2 * SLAB) * 4;
constexpr int kStateMmaSmem = 3 * QM * 4 + (QM * LDQ + QM * LDP) * 2;
constexpr int kFwdStatesSmem = 4 * QM * 4 + 2 * kFwdBuf * 2;
constexpr int kFwdOutSmem = (3 * kOutStages * QM + NM * PM) * 4 +
                            (2 * QM * LDQ + kOutStages * (NM * LDP + QM * LDP)) * 2;
static_assert(2 * (kFwdStatesSmem + 1024) <= 233472, "two state-pass blocks an SM");
static_assert(kFwdOutSmem <= 232448, "shared memory of a block");
constexpr int kBwdHeadsSmem = (7 * QM + 32 + 8 * QM) * 4 + (4 * QM * LDQ + 2 * QM * LDP +
                                                            2 * NM * LDP) * 2;
static_assert(kBwdHeadsSmem <= 232448, "shared memory of a block on Hopper");

template <typename K>
int launch(K kernel, dim3 grid, int smem, const Args& a, cudaStream_t st,
           int threads = kThreads) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// float32 runs the CUDA-core kernels, bf16 inputs the tensor-core ones
// (TY: the type of y and dy).
int launch_fwd_f32(const Args& a, cudaStream_t st) {
  const dim3 grid(a.nc, a.h, a.bt);
  int err = launch(ssd_state_kernel<0>, grid, 0, a, st);
  if (err) return err;
  launch_scan(a.states, a.T, a, 0, st);
  err = (int)cudaGetLastError();
  return err ? err : launch(ssd_out_kernel, grid, kOutSmem, a, st);
}

// bf16: the state pass on a (head, batch) grid, two blocks an SM (all the
// shared memory an SM has goes to them), then the outputs on a (chunk,
// head group, batch) grid.
template <typename TY>
int launch_fwd_mma(const Args& a, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_states_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const int err = launch(ssd_fwd_states_kernel, dim3(a.h, a.bt), kFwdStatesSmem, a, st);
  return err ? err
             : launch(ssd_fwd_out_kernel<TY>, dim3(a.nc, a.groups, a.bt), kFwdOutSmem, a, st,
                      kOutThreads);
}

// The backward's four phases; `bwd` runs on a (chunk, head group, batch) grid.
template <typename TX, typename K1, typename K6>
int launch_bwd(K1 state, int state_smem, K6 bwd, int bwd_smem, const Args& a,
               cudaStream_t st) {
  int err = launch(state, dim3(a.nc, a.h, a.bt), state_smem, a, st);
  if (err) return err;
  launch_scan(a.G, a.T, a, 1, st);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = launch(bwd, dim3(a.nc, a.groups, a.bt), bwd_smem, a, st);
  if (err) return err;
  const long long work = (a.dBp ? 2LL * a.bt * a.s * a.n : 0) + a.h;
  ssd_reduce_kernel<TX><<<(unsigned)((work + kThreads - 1) / kThreads), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(void* const* ptrs, const long long* st, const int* dims, bool bwd) {
  Args a;
  a.x = ptrs[0];
  a.dt = static_cast<const float*>(ptrs[1]);
  a.A = static_cast<const float*>(ptrs[2]);
  a.B = ptrs[3];
  a.C = ptrs[4];
  a.y = ptrs[5];
  a.states = static_cast<float*>(ptrs[6]);
  a.T = static_cast<float*>(ptrs[7]);
  a.G = bwd ? static_cast<float*>(ptrs[8]) : nullptr;
  a.dx = bwd ? ptrs[9] : nullptr;
  a.ddt = bwd ? static_cast<float*>(ptrs[10]) : nullptr;
  a.dBp = bwd ? static_cast<float*>(ptrs[11]) : nullptr;
  a.dCp = bwd ? static_cast<float*>(ptrs[12]) : nullptr;
  a.dAp = bwd ? static_cast<float*>(ptrs[13]) : nullptr;
  a.dB = bwd ? ptrs[14] : nullptr;
  a.dC = bwd ? ptrs[15] : nullptr;
  a.dA = bwd ? static_cast<float*>(ptrs[16]) : nullptr;
  a.x_sb = st[0]; a.x_ss = st[1]; a.x_sh = st[2];
  a.dt_sb = st[3]; a.dt_ss = st[4]; a.dt_sh = st[5];
  a.B_sb = st[6]; a.B_ss = st[7];
  a.C_sb = st[8]; a.C_ss = st[9];
  a.y_sb = st[10]; a.y_ss = st[11]; a.y_sh = st[12];
  a.dx_sb = st[13]; a.dx_ss = st[14]; a.dx_sh = st[15];
  a.bt = dims[0]; a.s = dims[1]; a.h = dims[2]; a.p = dims[3]; a.n = dims[4]; a.q = dims[5];
  a.nc = a.s / a.q;
  a.groups = dims[6];
  a.hg = (a.h + a.groups - 1) / a.groups;
  return a;
}

}  // namespace

extern "C" {

// Largest sizes the kernels take: chunk, state size N, head dim P.
int ssd_scan_limits(int which) { return which == 0 ? QM : which == 1 ? NM : PM; }

// kind 0: forward (ptrs x, dt, A, B, C, y, states, T); kind 1: backward
// (ptrs x, dt, A, B, C, dy, states, T, G, dx, ddt, dBp, dCp, dAp, dB, dC, dA).
// strides: x, dt (b, s, h); B, C (b, s); y or dy (b, s, h); dx (b, s, h).
// dims: Bt, S, H, P, N, chunk, head groups.  Forward: 1 to H for bf16
// inputs (the output kernel's), 1 for float32.  Backward: 1 to H for bf16
// inputs (dBp and dCp (groups, Bt, S, N) when more than 1, else null), H
// for float32 (one head a block, dBp and dCp (H, Bt, S, N)).  x_bf16: x, B, C (and dx, dB, dC) are bf16;
// y_bf16: y (dy) is bf16.  Returns 0 or a CUDA error code; -1 for sizes or
// types the kernels do not take.
int ssd_scan_launch(int kind, void* const* ptrs, const long long* strides, const int* dims,
                    int x_bf16, int y_bf16, void* stream) {
  const Args a = make_args(ptrs, strides, dims, kind == 1);
  if (a.q < 1 || a.q > QM || a.s % a.q || a.n < 1 || a.n > NM || a.p < 1 || a.p > PM ||
      a.n * a.p % 4)
    return -1;
  if (a.groups < 1 || a.groups > a.h || (long long)(a.groups - 1) * a.hg >= a.h) return -1;
  if (kind == 0 && !x_bf16 && a.groups != 1) return -1;
  if (kind == 1 && ((!x_bf16 && a.groups != a.h) ||
                    ((a.groups > 1 || !x_bf16) != (a.dBp && a.dCp))))
    return -1;
  if (a.h > 65535 || a.bt > 65535 || (long long)a.bt * a.h > 65535) return -1;
  if (!x_bf16 && y_bf16) return -1;
  if (x_bf16 && (a.n % 8 || a.p % 8)) return -1;     // 16-byte rows of the bf16 tiles
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (kind == 0) {
    if (!x_bf16) return launch_fwd_f32(a, st);
    return y_bf16 ? launch_fwd_mma<bf>(a, st) : launch_fwd_mma<float>(a, st);
  }
  if (kind == 1) {
    if (!x_bf16)
      return launch_bwd<float>(ssd_state_kernel<1>, 0, ssd_bwd_kernel, kBwdSmem, a, st);
    if (y_bf16)
      return launch_bwd<bf>(ssd_state_mma_kernel<bf>, kStateMmaSmem,
                            ssd_bwd_heads_kernel<bf>, kBwdHeadsSmem, a, st);
    return launch_bwd<bf>(ssd_state_mma_kernel<float>, kStateMmaSmem,
                          ssd_bwd_heads_kernel<float>, kBwdHeadsSmem, a, st);
  }
  return -1;
}

}  // extern "C"
