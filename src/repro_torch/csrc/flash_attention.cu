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
//   * bf16 (the training path, D up to 256) runs on Hopper's own units (see
//     the Hopper section below): TMA loads into a shared-memory ring fed by a
//     producer warp, every product on wgmma in two consumer warpgroups that
//     take turns; base-2 softmax; the element mask only on tiles that it
//     cuts; at D > 128 smaller streamed tiles and fewer stages, so that each
//     warpgroup's one 64 x 256 accumulator and the ring fit;
//   * the dK/dV grid has a block per (64-key tile, query head), heaviest
//     key tiles first (1536 blocks at the training shape instead of 128);
//     its two warpgroups split the work, one summing dV and the other dK,
//     so each holds one accumulator; each block writes fp32 partials that
//     a second pass sums over the group's query heads in a fixed order: no
//     atomics, deterministic; dQ has its own kernel, and delta =
//     rowsum(dO * out) a pre-pass kernel;
//   * the forward and dQ grids launch the last (under causal, heaviest) q
//     tiles first;
//   * float32 runs on the tensor cores too, as 3xTF32 mma.sync products
//     (see the float32 section below): each operand split into two TF32
//     halves and three products summed, which keeps float32's accuracy;
//     cp.async loads into a 2-stage ring, softmax in registers;
//   * tiles that the mask cannot reach are skipped at block level, with a
//     rule at least as tight as the Pallas one (prefix-LM keeps the causal
//     skip for keys past the prefix, the chunk rule compares chunk ranges).
// Nothing is allocated here; launches go on the caller's stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

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

  // Is every (query, key) pair of the tile valid, so that no element needs
  // the mask?  Rows past Sq are not asked about: the forward drops them and
  // the backward gives them p = 0.
  __device__ __forceinline__ bool full(int q0, int nq, int k0, int nk) const {
    if (k0 + nk > sk) return false;
    const int qlo = q_offset + q0, qhi = qlo + nq - 1, khi = k0 + nk - 1;
    if (causal && khi > qlo && khi >= prefix_len) return false;
    if (window && qhi - k0 >= window) return false;
    if (chunk && (k0 / chunk != khi / chunk || qlo / chunk != qhi / chunk ||
                  qlo / chunk != k0 / chunk))
      return false;
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
  float* delta;                        // (B, Hq, Sq): sum over D of dO * out
  float* dk_part;                      // (B, Sk, Hq, D) fp32: dK of each query head
  float* dv_part;                      // (B, Sk, Hq, D) fp32: dV of each query head
  int batch, hq, hkv, d;
  float scale;
  Mask mask;
};

// ------------------------------------------------- bf16 Hopper kernels
// For bf16 inputs, D up to 256 (the DMAX 64, 128 and 256 instances; tiles
// and ring depth in FwdTile, DkdvTile, DqTile).  Warpgroups 0 and 1
// compute, warp 8 is the producer (one lane issues TMA loads into a
// shared-memory ring, each stage signalled by a "full" and an "empty"
// mbarrier).  Every product runs on wgmma (m64nNk16, bf16 -> fp32), 64 rows
// a warpgroup.  A block of 288 threads is given registers as if it were
// whole warpgroups (384 threads): 168 a thread, enough up to DMAX 128.  At
// DMAX 256 that spills and serializes wgmma (C7512) beside the 64 x 256
// accumulator, so a block runs 384 threads and the producer's warpgroup
// (warp 8 and three idle warps) hands registers to the consumers with
// setmaxnreg: 40 against 232 a thread.  Tiles are loaded as
// boxes of 64 columns (128 bytes) with the 128-byte swizzle, the layout
// the wgmma shared-memory descriptors read: a K-major operand (rows x D)
// for the score products, the same tile as an MN-major operand (K = rows)
// for the products that sum over rows.  Score fragments stay in registers and are repacked as the
// bf16 A operand of the next product.  The two warpgroups take turns to
// issue their score products (named barriers), so that one's products run
// while the other does its elementwise work.  Softmax runs in base 2 with
// scale * log2(e) folded into the scores; the element mask runs only on
// tiles that it cuts, and tiles it empties are skipped.

// Threads of a block: two consumer warpgroups, then the producer warp 8,
// alone up to DMAX 128, in a whole warpgroup at DMAX 256 (see above).
template <int DMAX> constexpr int wg_threads() { return DMAX <= 128 ? 288 : 384; }
template <int DMAX> __device__ __forceinline__ void producer_regs() {
  if constexpr (DMAX > 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
template <int DMAX> __device__ __forceinline__ void consumer_regs() {  // 128 x 40 + 256 x 232 <= 384 x 168
  if constexpr (DMAX > 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}
constexpr int kStages = 3;  // shared-memory ring depth of the streamed tiles (see FwdTile)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;  // a masked score in base 2

struct Maps {  // TMA descriptors of q, k, v and dO (the forward leaves g unset)
  CUtensorMap q, k, v, g;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}
// 2^x by the special-function unit (2 ulp); -inf and -1e30 * log2(e) give 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// mbarriers: a stage's "full" barrier completes when its loads have landed,
// its "empty" barrier when every consumer warp has finished reading it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// One arrival per warp, once all its lanes are done with what the barrier guards.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// A wait that never ends (a wrong parity or byte count) faults after 2^28
// polls, so that the launch fails instead of hanging the card.  It faults
// by a store to address 0, not by __trap(): ptxas drops a kernel's
// setmaxnreg register handover (DMAX 256) when the kernel can trap.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) asm volatile("st.global.u32 [%0], %1;\n" ::"l"(0ull), "r"(0u) : "memory");
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One TMA box (64 columns x rows of one head) into shared memory, dims
// {D, H, S, B} innermost first; rows past S and columns past D read as 0.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                        int head, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(head), "r"(row),
      "r"(b)
      : "memory");
}
// Rows [row, row + R) x DMAX columns: DMAX / 64 boxes, each a (R, 128 B) region.
template <int R, int DMAX>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int head, int b) {
#pragma unroll
  for (int r = 0; r < DMAX / 64; ++r) tma_box(dst + r * R * 128, map, bar, 64 * r, head, row, b);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed product groups are
// still running (groups finish in order).
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of registers that wgmma owns
// across the asynchronous region.
template <int R> __device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (in 16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand: rows row0.. of a tile of R rows, k step kk (16 columns):
// region kk / 4, 32 bytes per step inside its 128-byte rows, 8-row groups
// 1024 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int row0, int kk) {
  return sw128_desc(tile + (kk >> 2) * R * 128 + row0 * 128 + (kk & 3) * 32, 16, 1024);
}
// MN-major B operand (K = the tile's rows, N = its columns): k step kk is
// rows 16 kk.. (two 8-row groups, 1024 bytes apart); column regions of 64
// lie R * 128 bytes apart.
template <int R> __device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 2048, R * 128, 1024);
}

// wgmma m64nNk16 bf16 -> fp32.  The accumulator of a 64 x N tile holds
// N / 2 floats a thread: d[4 j + 2 h + c] sits at row 16 warp + lane / 4 +
// 8 h, column 8 j + 2 (lane % 4) + c (warp and lane within the warpgroup).
// _ss reads A and B from shared memory (both K-major); _rs takes A from
// registers (the mma.sync m16n8k16 A fragment of each warp's 16 rows) and
// B MN-major, _rk A from registers and B K-major.  Each adds to d, or
// overwrites it when `accumulate` is 0.  Instantiated for the N the
// kernels use: score tiles of 32 (dQ at DMAX 256), 64 and 128 keys or
// rows, accumulators of 64, 128 and 256 columns.
template <int N> __device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int accumulate);
template <int N>
__device__ void wgmma_rk(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int accumulate);

template <> __device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
template <> __device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
template <> __device__ __forceinline__ void wgmma_rk<64>(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
template <> __device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}
template <> __device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
template <> __device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}
template <> __device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// acc (64 x N) = rows a_row0.. of an (RA, DMAX) tile times the N rows of an
// (N, DMAX) tile, transposed: a sum over DMAX columns.
template <int N, int DMAX, int RA>
__device__ __forceinline__ void mma_ss(float (&acc)[N / 2], uint32_t a_tile, int a_row0,
                                       uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    wgmma_ss<N>(acc, kmajor_desc<RA>(a_tile, a_row0, kk), kmajor_desc<N>(b_tile, 0, kk), kk > 0);
}
// acc (64 x DMAX) += P (64 x K as bf16 A fragments) times a (K, DMAX) tile.
template <int K, int DMAX>
__device__ __forceinline__ void mma_rs(float (&acc)[DMAX / 2], const uint32_t (&p)[K / 16][4],
                                       uint32_t y_tile) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) wgmma_rs<DMAX>(acc, p[kk], mnmajor_desc<K>(y_tile, kk), 1);
}
// acc (64 x N) = A (64 x DMAX as bf16 A fragments) times the N rows of an
// (N, DMAX) tile, transposed (K-major B).
template <int N, int DMAX>
__device__ __forceinline__ void mma_rk(float (&acc)[N / 2], const uint32_t (&a)[DMAX / 16][4],
                                       uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    wgmma_rk<N>(acc, a[kk], kmajor_desc<N>(b_tile, 0, kk), kk > 0);
}
// The bf16 A fragments of rows row0 + 16 (warp % 4) .. of an (R, DMAX)
// tile in the swizzled layout TMA wrote, by ldmatrix: 16-byte chunk c of
// row r sits at chunk c ^ (r % 8) of its 128-byte row.
template <int R, int DMAX>
__device__ __forceinline__ void load_afrags(uint32_t (&f)[DMAX / 16][4], uint32_t tile, int row0,
                                            int warp4, int lane) {
  const int row = row0 + warp4 * 16 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    const int c = 2 * kk + (lane >> 4);
    const uint32_t addr = tile + (c >> 3) * R * 128 + row * 128 + (((c & 7) ^ (row & 7)) << 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(f[kk][0]), "=r"(f[kk][1]), "=r"(f[kk][2]), "=r"(f[kk][3])
                 : "r"(addr));
  }
}
// Keep the compiler from defining A-fragment registers between the wgmma
// instructions that read them.
template <int K> __device__ __forceinline__ void frag_fence(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}
// The bf16 A fragments of k steps 16 kk.. of an fp32 accumulator (64 x 8 R/4).
template <int R>
__device__ __forceinline__ void to_frags(uint32_t (&a)[R / 8][4], const float (&s)[R]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Store a 64 x DMAX accumulator of one warpgroup (rows row_lo and row_lo +
// 8 of this thread, columns < d, rows < rows_valid) times s_lo / s_hi.
template <int DMAX, typename T>
__device__ __forceinline__ void store_acc(T* base, long long s_stride, int row_lo, int rows_valid,
                                          int d, const float (&acc)[DMAX / 2], float s_lo,
                                          float s_hi, int tig) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    if (row >= rows_valid) continue;
    const float sc = half ? s_hi : s_lo;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      const int col = n * 8 + tig * 2;
      if (col >= d) continue;
      const float x = acc[4 * n + 2 * half] * sc, y = acc[4 * n + 2 * half + 1] * sc;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<__nv_bfloat162*>(base + row * s_stride + col) = __floats2bfloat162_rn(x, y);
      else
        *reinterpret_cast<float2*>(base + row * s_stride + col) = make_float2(x, y);
    }
  }
}

// Shared memory of the three kernels: a resident tile (q, or k and v) and
// ST stages of the streamed tiles, then mbarriers, plus 1024 bytes to align
// the base for the swizzle.  Up to DMAX 128 the ring holds kStages stages.
// At DMAX 256 those tiles would need 448 KB (forward) and 320 KB (dQ), so
// the streamed tiles shrink and the ring holds fewer stages: the forward
// streams 64-key tiles in 2 stages (193 KB), dK/dV keeps 64 x 64 tiles in
// 2 stages (210 KB), dQ streams 32-key tiles in 3 stages (225 KB).  Each
// warpgroup then holds one 64 x 256 fp32 accumulator (128 registers a
// thread) beside a score tile of at most 64 x 64.
template <int DMAX> struct FwdTile {    // 128 q rows (64 a warpgroup)
  static constexpr int BQ = 128, BK = DMAX <= 128 ? 128 : 64, ST = DMAX <= 128 ? kStages : 2;
  static constexpr int Q_BYTES = BQ * DMAX * 2, KV_BYTES = BK * DMAX * 2;
  static constexpr int BARS = Q_BYTES + 2 * ST * KV_BYTES;
  static constexpr int SMEM = BARS + 8 * (2 * ST + 1) + 1024;
};
template <int DMAX> struct DkdvTile {   // 64 keys; q/dO tiles of 64; p handed over in smem
  static constexpr int BK = 64, BQ = 64, ST = DMAX <= 128 ? kStages : 2;
  static constexpr int KV_BYTES = BK * DMAX * 2, Q_BYTES = BQ * DMAX * 2;
  static constexpr int P_OFF = 2 * KV_BYTES + 2 * ST * Q_BYTES;  // fp32 p, fragment order
  static constexpr int ROWS = P_OFF + BK * BQ * 4;                // lse, delta of each stage
  static constexpr int BARS = ROWS + 2 * ST * BQ * 4;
  static constexpr int SMEM = BARS + 8 * (2 * ST + 3) + 1024;
};
template <int DMAX> struct DqTile {     // 128 q rows (64 a warpgroup)
  static constexpr int BQ = 128, BK = DMAX <= 128 ? 64 : 32, ST = kStages;
  static constexpr int Q_BYTES = BQ * DMAX * 2, KV_BYTES = BK * DMAX * 2;
  static constexpr int BARS = 2 * Q_BYTES + 2 * ST * KV_BYTES;
  static constexpr int SMEM = BARS + 8 * (2 * ST + 1) + 1024;
};

// The warp's index, broadcast from lane 0 so that the compiler knows it
// is the same across the warp: values derived from it (the warpgroup and
// the wgmma descriptors) then live in uniform registers.
__device__ __forceinline__ int warp_index() { return __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0); }

// Block index -> (tile, head, batch) with the tile slowest, so that all
// heads' tiles of one kind are launched together; `reverse` launches the
// last tile first (under the causal mask the last q tile is the heaviest).
struct BlockPos {
  int t, h, b;
};
__device__ __forceinline__ BlockPos block_pos(int hq, int batch, int ntiles, bool reverse) {
  const int i = blockIdx.x, per = hq * batch;
  const int t = i / per;
  return BlockPos{reverse ? ntiles - 1 - t : t, i % hq, (i % per) / hq};
}

template <int ST>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, uint64_t* once,
                                          uint32_t full_count) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], full_count);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Named barriers 1 and 2 order the two consumer warpgroups' product
// batches (ping-pong): a warpgroup issues its batch in its turn, then hands
// the turn over, so that one warpgroup's products run while the other does
// its elementwise work.  Warpgroup 1 gives warpgroup 0 the first turn.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}
// Before the loop warpgroup 1 passes the first turn; after it warpgroup 0
// takes the turn that warpgroup 1 passed last, so both barriers end even.
__device__ __forceinline__ void turns_begin(int wg) {
  if (wg == 1) turn_pass(1);
}
__device__ __forceinline__ void turns_end(int wg) {
  if (wg == 0) turn_wait(0);
}

// The first k tile at or after k0 that the mask leaves live for q rows
// [q0, q0 + nq), or a value >= Sk.
__device__ __forceinline__ int next_live(const Mask& mk, int q0, int nq, int k0, int nk) {
  while (k0 < mk.sk && !mk.live(q0, nq, k0, nk)) k0 += nk;
  return k0;
}
// The first q tile at or after q0 that sees keys [k0, k0 + nk).
__device__ __forceinline__ int next_live_q(const Mask& mk, int q0, int nq, int k0, int nk) {
  while (q0 < mk.sq && !mk.live(q0, nq, k0, nk)) q0 += nq;
  return q0;
}

// One tile of the forward's online softmax in base 2: scores sc (this
// thread's two rows r_lo, r_lo + 8) scaled, masked unless the tile is
// full, turned into p in place; m, l updated, alpha the old sums' factor.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], const Mask& mk, bool full_tile,
                                               int r_lo, int k0, int tig, float sl2) {
  float mx[2] = {kNegInf2, kNegInf2}, sum[2] = {0.f, 0.f};
  if (full_tile) {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      sc[e] *= sl2;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int qi = r_lo + ((e >> 1) & 1) * 8, kj = k0 + (e >> 2) * 8 + tig * 2 + (e & 1);
      sc[e] = mk.ok(qi, kj) ? sc[e] * sl2 : kNegInf2;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    sc[e] = fast_exp2(sc[e] - m[(e >> 1) & 1]);
    sum[(e >> 1) & 1] += sc[e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];  // this thread's columns
}

// ------------------------------------------------------------ forward
// 1-D grid of ceil(Sq / 128) x Hq x B blocks, last q tile first.
template <int DMAX>
__global__ void __launch_bounds__(wg_threads<DMAX>(), 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ Maps maps, const Args a) {
  using TL = FwdTile<DMAX>;
  constexpr int BQ = TL::BQ, BK = TL::BK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + TL::Q_BYTES;                 // stage s at Ks + s * KV_BYTES
  uint8_t* Vs = Ks + TL::ST * TL::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TL::BARS);
  uint64_t* empty = full + TL::ST;
  uint64_t* qbar = empty + TL::ST;

  const Mask& mk = a.mask;
  const BlockPos bp = block_pos(a.hq, a.batch, (mk.sq + BQ - 1) / BQ, true);
  const int q0 = bp.t * BQ, h = bp.h, b = bp.b, g = h / (a.hq / a.hkv);
  const int warp = warp_index(), lane = threadIdx.x & 31;
  init_ring<TL::ST>(full, empty, qbar, 1);

  if (warp >= 8) {  // producer
    producer_regs<DMAX>();
    if (warp == 8 && lane == 0) {
      mbar_arrive_tx(qbar, TL::Q_BYTES);
      tma_tile<BQ, DMAX>(Qs, &maps.q, qbar, q0, h, b);
      int i = 0;
      for (int k0 = 0; k0 < mk.sk; k0 += BK) {
        if (!mk.live(q0, BQ, k0, BK)) continue;
        const int s = i % TL::ST;
        mbar_wait(&empty[s], ((i / TL::ST) & 1) ^ 1);
        mbar_arrive_tx(&full[s], 2 * TL::KV_BYTES);
        tma_tile<BK, DMAX>(Ks + s * TL::KV_BYTES, &maps.k, &full[s], k0, g, b);
        tma_tile<BK, DMAX>(Vs + s * TL::KV_BYTES, &maps.v, &full[s], k0, g, b);
        ++i;
      }
    }
  } else {  // consumers: warpgroup wg owns q rows q0 + 64 wg ..
    consumer_regs<DMAX>();
    const int wg = warp / 4, gid = lane >> 2, tig = lane & 3;
    const int r_lo = q0 + wg * 64 + (warp & 3) * 16 + gid;
    const float sl2 = a.scale * kLog2e;
    const uint32_t qs = smem_addr(Qs), ks = smem_addr(Ks), vs = smem_addr(Vs);
    float o[DMAX / 2], m[2] = {kNegInf2, kNegInf2}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < DMAX / 2; ++n) o[n] = 0.f;
    mbar_wait(qbar, 0);
    turns_begin(wg);
    int i = 0;
    for (int k0 = next_live(mk, q0, BQ, 0, BK); k0 < mk.sk;
         k0 = next_live(mk, q0, BQ, k0 + BK, BK), ++i) {
      const int s = i % TL::ST;
      float sc[BK / 2], alpha[2];
      uint32_t p[BK / 16][4];
      mbar_wait(&full[s], (i / TL::ST) & 1);
      turn_wait(wg);
      wg_fence();
      mma_ss<BK, DMAX, BQ>(sc, qs, wg * 64, ks + s * TL::KV_BYTES);  // S = q k^T
      wg_commit();
      turn_pass(wg);
      wg_wait<0>();
      reg_fence(sc);
      online_softmax<BK>(sc, m, l, alpha, mk, mk.full(q0 + wg * 64, 64, k0, BK), r_lo, k0, tig, sl2);
#pragma unroll
      for (int e = 0; e < DMAX / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
      to_frags(p, sc);
      frag_fence(p);
      reg_fence(o);
      wg_fence();
      mma_rs<BK, DMAX>(o, p, vs + s * TL::KV_BYTES);  // O += P V
      wg_commit();
      wg_wait<0>();
      reg_fence(o);
      release(&empty[s], lane);
    }
    turns_end(wg);
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float lmax = fmaxf(l[r], 1e-30f);
      inv[r] = 1.f / lmax;
      const int row = r_lo + 8 * r;
      // a row that no key reached keeps lse = -1e30 + log(l), as the plain version
      if (tig == 0 && row < mk.sq)
        a.lse[((long long)b * a.hq + h) * mk.sq + row] =
            (m[r] == kNegInf2 ? kNegInf : m[r] * kLn2) + logf(lmax);
    }
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(const_cast<void*>(a.o.p)) + b * a.o.sb + h * a.o.sh;
    store_acc<DMAX>(ob, a.o.ss, r_lo, mk.sq, a.d, o, inv[0], inv[1], tig);
  }
}

// The elementwise half of a dK/dV step, in place of the score tile sc
// (keys key_lo, key_lo + 8 of this thread x BQ q columns): warpgroup 0
// turns s^T into p = exp2(s^T scale log2(e) - lse log2(e)) (masked unless
// the tile is full) and hands p to warpgroup 1 through pbuf; warpgroup 1
// turns dp^T into ds = p (dp - delta) scale.  s is the ring stage, pparity
// the handover's phase.
template <int BQ>
__device__ __forceinline__ void dkdv_scores(float (&sc)[BQ / 2], int wg, int s, uint32_t pparity,
                                            int q0, int k0, int key_lo, int tw, int lane, int tig,
                                            const Mask& mk, float sl2, float scale,
                                            const float* lse_s, const float* del_s, float4* pbuf,
                                            uint64_t* pfull, uint64_t* pempty) {
  if (wg == 0) {
    const bool full_tile = mk.full(q0, BQ, k0, 64);
    const float* ls = lse_s + s * BQ;
    if (full_tile) {  // two loops, so that a full tile runs no mask arithmetic at all
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) sc[e] *= sl2;
    } else {
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e)
        sc[e] = mk.ok(q0 + (e >> 2) * 8 + 2 * tig + (e & 1), key_lo + ((e >> 1) & 1) * 8)
                    ? sc[e] * sl2
                    : kNegInf2;
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[4 * j + e] = fast_exp2(sc[4 * j + e] - ((e & 1) ? l2.y : l2.x));
    }
    mbar_wait(pempty, pparity ^ 1);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
      pbuf[j * 128 + tw] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
    release(pfull, lane);
  } else {
    const float* dl = del_s + s * BQ;
    mbar_wait(pfull, pparity);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float4 p = pbuf[j * 128 + tw];
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * tig);
      sc[4 * j + 0] = p.x * (sc[4 * j + 0] - d2.x) * scale;
      sc[4 * j + 1] = p.y * (sc[4 * j + 1] - d2.y) * scale;
      sc[4 * j + 2] = p.z * (sc[4 * j + 2] - d2.x) * scale;
      sc[4 * j + 3] = p.w * (sc[4 * j + 3] - d2.y) * scale;
    }
    release(pempty, lane);
  }
}

// ------------------------------------------------------------ backward dK/dV
// 1-D grid of ceil(Sk / 64) x Hq x B blocks, first key tile first: one
// block per (key tile, query head), so the grid holds Hq / Hkv times more
// blocks than one per KV head.  Both consumer warpgroups own the block's 64
// keys and hold one accumulator each: warpgroup 0 forms p = exp2(s^T - lse)
// from s^T = k q^T and sums dV += p^T dO; warpgroup 1 forms dp^T = v dO^T,
// takes p through shared memory, and sums dK += ds^T q.  k and v are fixed
// for the block; at DMAX 128 they sit in registers as the A operands of the
// score products.
// The block writes its head's fp32 dK/dV to (B, Sk, Hq, D)
// scratch; flash_bwd_reduce_kernel sums the group's heads.
template <int DMAX>
__global__ void __launch_bounds__(wg_threads<DMAX>(), 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ Maps maps, const Args a) {
  using TL = DkdvTile<DMAX>;
  constexpr int BQ = TL::BQ, BK = TL::BK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + TL::KV_BYTES;
  uint8_t* Qs = Vs + TL::KV_BYTES;                // stage s at Qs + s * Q_BYTES
  uint8_t* Gs = Qs + TL::ST * TL::Q_BYTES;
  float4* pbuf = reinterpret_cast<float4*>(smem + TL::P_OFF);  // [BQ / 8][128]
  float* lse_s = reinterpret_cast<float*>(smem + TL::ROWS);    // (ST, BQ): lse * log2(e)
  float* del_s = lse_s + TL::ST * BQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TL::BARS);
  uint64_t* empty = full + TL::ST;
  uint64_t* kvbar = empty + TL::ST;
  uint64_t* pfull = kvbar + 1;   // p of the step is in pbuf
  uint64_t* pempty = pfull + 1;  // warpgroup 1 has read it

  const Mask& mk = a.mask;
  const BlockPos bp = block_pos(a.hq, a.batch, (mk.sk + BK - 1) / BK, false);
  const int k0 = bp.t * BK, h = bp.h, b = bp.b, g = h / (a.hq / a.hkv);
  const int warp = warp_index(), lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(pfull, 4);
    mbar_init(pempty, 4);
  }
  init_ring<TL::ST>(full, empty, kvbar, 32);  // a stage is full once the producer warp's 32 lanes arrived

  if (warp >= 8) {  // producer
    producer_regs<DMAX>();
    if (warp == 8) {
      if (lane == 0) {
        mbar_arrive_tx(kvbar, 2 * TL::KV_BYTES);
        tma_tile<BK, DMAX>(Ks, &maps.k, kvbar, k0, g, b);
        tma_tile<BK, DMAX>(Vs, &maps.v, kvbar, k0, g, b);
      }
      const long long rows = ((long long)b * a.hq + h) * mk.sq;
      int i = 0;
      for (int q0 = 0; q0 < mk.sq; q0 += BQ) {
        if (!mk.live(q0, BQ, k0, BK)) continue;
        const int s = i % TL::ST;
        mbar_wait(&empty[s], ((i / TL::ST) & 1) ^ 1);
        ++i;
        if (lane == 0) {  // the tiles first, so that their latency covers the row loads
          mbar_expect_tx(&full[s], 2 * TL::Q_BYTES);
          tma_tile<BQ, DMAX>(Qs + s * TL::Q_BYTES, &maps.q, &full[s], q0, h, b);
          tma_tile<BQ, DMAX>(Gs + s * TL::Q_BYTES, &maps.g, &full[s], q0, h, b);
        }
        for (int r = lane; r < BQ; r += 32) {  // rows past Sq: p = exp2(-inf) = 0
          const bool in = q0 + r < mk.sq;
          lse_s[s * BQ + r] = in ? a.lse[rows + q0 + r] * kLog2e : __int_as_float(0x7f800000);
          del_s[s * BQ + r] = in ? a.delta[rows + q0 + r] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {  // consumers: both own keys k0 ..; wg 0 sums dV, wg 1 dK
    consumer_regs<DMAX>();
    const int wg = warp / 4, tw = threadIdx.x & 127, gid = lane >> 2, tig = lane & 3;
    const int key_lo = k0 + (warp & 3) * 16 + gid;
    const float sl2 = a.scale * kLog2e;
    const uint32_t qs = smem_addr(Qs), gs = smem_addr(Gs);
    float acc[DMAX / 2];
#pragma unroll
    for (int n = 0; n < DMAX / 2; ++n) acc[n] = 0.f;
    mbar_wait(kvbar, 0);
    // k (wg 0) or v (wg 1), the score product's A operand: held in registers
    // at DMAX 128 (it halves the product's shared-memory reads); read from
    // shared memory at DMAX 64, where the register form gave wrong sums on
    // the card, and at DMAX 256, where it would take 64 registers a thread
    const uint32_t score_a = smem_addr(wg == 0 ? Ks : Vs);
    uint32_t af[DMAX / 16][4];
    if constexpr (DMAX == 128) {
      load_afrags<BK, DMAX>(af, score_a, 0, warp & 3, lane);
      frag_fence(af);
    }
    // the score product reads q (wg 0) or dO (wg 1); the sum reads the other
    const uint32_t score_b = wg == 0 ? qs : gs, sum_b = wg == 0 ? gs : qs;
    turns_begin(wg);
    int i = 0;
    for (int q0 = next_live_q(mk, 0, BQ, k0, BK); q0 < mk.sq;
         q0 = next_live_q(mk, q0 + BQ, BQ, k0, BK), ++i) {
      const int s = i % TL::ST;
      float sc[BQ / 2];  // wg 0: s^T then p; wg 1: dp^T then ds
      uint32_t fr[BQ / 16][4];
      mbar_wait(&full[s], (i / TL::ST) & 1);
      turn_wait(wg);
      wg_fence();
      if constexpr (DMAX == 128)
        mma_rk<BQ, DMAX>(sc, af, score_b + s * TL::Q_BYTES);
      else
        mma_ss<BQ, DMAX, BK>(sc, score_a, 0, score_b + s * TL::Q_BYTES);
      wg_commit();
      turn_pass(wg);
      wg_wait<0>();
      reg_fence(sc);
      dkdv_scores<BQ>(sc, wg, s, i & 1, q0, k0, key_lo, tw, lane, tig, mk, sl2, a.scale, lse_s,
                      del_s, pbuf, pfull, pempty);
      to_frags(fr, sc);
      frag_fence(fr);
      reg_fence(acc);
      wg_fence();
      mma_rs<BQ, DMAX>(acc, fr, sum_b + s * TL::Q_BYTES);  // dV += p^T dO; dK += ds^T q
      wg_commit();
      wg_wait<0>();
      reg_fence(acc);
      release(&empty[s], lane);
    }
    turns_end(wg);
    const long long off = ((long long)b * mk.sk * a.hq + h) * a.d;
    store_acc<DMAX>((wg == 0 ? a.dv_part : a.dk_part) + off, (long long)a.hq * a.d, key_lo, mk.sk,
                    a.d, acc, 1.f, 1.f, tig);
  }
}

// dS of one (q rows, key tile) pair of the dQ kernel, in place of dp:
// p = exp2(s scale log2(e) - lse log2(e)) (masked unless the tile is full),
// ds = p (dp - delta) scale; rows r_lo, r_lo + 8 of this thread.
template <int BK>
__device__ __forceinline__ void scores_to_ds(const float (&sc)[BK / 2], float (&dp)[BK / 2],
                                             const Mask& mk, bool full_tile, int r_lo, int k0,
                                             int tig, float sl2, const float (&lse2)[2],
                                             const float (&del)[2], float scale) {
  float x[BK / 2];
  if (full_tile) {  // two loops, so that a full tile runs no mask arithmetic at all
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) x[e] = sc[e] * sl2;
  } else {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e)
      x[e] = mk.ok(r_lo + 8 * ((e >> 1) & 1), k0 + (e >> 2) * 8 + tig * 2 + (e & 1)) ? sc[e] * sl2
                                                                                  : kNegInf2;
  }
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int r = (e >> 1) & 1;
    dp[e] = fast_exp2(x[e] - lse2[r]) * (dp[e] - del[r]) * scale;
  }
}

// ------------------------------------------------------------ backward dQ
// 1-D grid of ceil(Sq / 128) x Hq x B blocks, last q tile first.
template <int DMAX>
__global__ void __launch_bounds__(wg_threads<DMAX>(), 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ Maps maps, const Args a) {
  using TL = DqTile<DMAX>;
  constexpr int BQ = TL::BQ, BK = TL::BK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* Gs = Qs + TL::Q_BYTES;
  uint8_t* Ks = Gs + TL::Q_BYTES;                 // stage s at Ks + s * KV_BYTES
  uint8_t* Vs = Ks + TL::ST * TL::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TL::BARS);
  uint64_t* empty = full + TL::ST;
  uint64_t* qbar = empty + TL::ST;

  const Mask& mk = a.mask;
  const BlockPos bp = block_pos(a.hq, a.batch, (mk.sq + BQ - 1) / BQ, true);
  const int q0 = bp.t * BQ, h = bp.h, b = bp.b, g = h / (a.hq / a.hkv);
  const int warp = warp_index(), lane = threadIdx.x & 31;
  init_ring<TL::ST>(full, empty, qbar, 1);

  if (warp >= 8) {  // producer
    producer_regs<DMAX>();
    if (warp == 8 && lane == 0) {
      mbar_arrive_tx(qbar, 2 * TL::Q_BYTES);
      tma_tile<BQ, DMAX>(Qs, &maps.q, qbar, q0, h, b);
      tma_tile<BQ, DMAX>(Gs, &maps.g, qbar, q0, h, b);
      int i = 0;
      for (int k0 = 0; k0 < mk.sk; k0 += BK) {
        if (!mk.live(q0, BQ, k0, BK)) continue;
        const int s = i % TL::ST;
        mbar_wait(&empty[s], ((i / TL::ST) & 1) ^ 1);
        mbar_arrive_tx(&full[s], 2 * TL::KV_BYTES);
        tma_tile<BK, DMAX>(Ks + s * TL::KV_BYTES, &maps.k, &full[s], k0, g, b);
        tma_tile<BK, DMAX>(Vs + s * TL::KV_BYTES, &maps.v, &full[s], k0, g, b);
        ++i;
      }
    }
  } else {  // consumers: warpgroup wg owns q rows q0 + 64 wg ..
    consumer_regs<DMAX>();
    const int wg = warp / 4, gid = lane >> 2, tig = lane & 3;
    const int r_lo = q0 + wg * 64 + (warp & 3) * 16 + gid;
    const float sl2 = a.scale * kLog2e;
    const uint32_t qs = smem_addr(Qs), gs = smem_addr(Gs), ks = smem_addr(Ks), vs = smem_addr(Vs);
    float lse2[2], del[2];
    const long long rows = ((long long)b * a.hq + h) * mk.sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows past Sq: p = exp2(-inf) = 0
      const int row = r_lo + 8 * r;
      lse2[r] = row < mk.sq ? a.lse[rows + row] * kLog2e : __int_as_float(0x7f800000);
      del[r] = row < mk.sq ? a.delta[rows + row] : 0.f;
    }
    float dq[DMAX / 2];
#pragma unroll
    for (int n = 0; n < DMAX / 2; ++n) dq[n] = 0.f;
    mbar_wait(qbar, 0);
    turns_begin(wg);
    int i = 0;
    for (int k0 = next_live(mk, q0, BQ, 0, BK); k0 < mk.sk;
         k0 = next_live(mk, q0, BQ, k0 + BK, BK), ++i) {
      const int s = i % TL::ST;
      const uint32_t ks_s = ks + s * TL::KV_BYTES;
      float sc[BK / 2], dp[BK / 2];
      uint32_t df[BK / 16][4];
      mbar_wait(&full[s], (i / TL::ST) & 1);
      turn_wait(wg);
      wg_fence();
      mma_ss<BK, DMAX, BQ>(sc, qs, wg * 64, ks_s);                   // S = q k^T
      mma_ss<BK, DMAX, BQ>(dp, gs, wg * 64, vs + s * TL::KV_BYTES);  // dP = dO v^T
      wg_commit();
      turn_pass(wg);
      wg_wait<0>();
      reg_fence(sc);
      reg_fence(dp);
      scores_to_ds<BK>(sc, dp, mk, mk.full(q0 + wg * 64, 64, k0, BK), r_lo, k0, tig, sl2, lse2, del,
                       a.scale);
      to_frags(df, dp);
      frag_fence(df);
      reg_fence(dq);
      wg_fence();
      mma_rs<BK, DMAX>(dq, df, ks_s);  // dQ += ds k
      wg_commit();
      wg_wait<0>();
      reg_fence(dq);
      release(&empty[s], lane);
    }
    turns_end(wg);
    __nv_bfloat16* qb = static_cast<__nv_bfloat16*>(const_cast<void*>(a.dq.p)) + b * a.dq.sb + h * a.dq.sh;
    store_acc<DMAX>(qb, a.dq.ss, r_lo, mk.sq, a.d, dq, 1.f, 1.f, tig);
  }
}

// ------------------------------------------------- float32 kernels (3xTF32)
// For float32 inputs, D a multiple of 8 up to 256 (the DMAX 64, 128 and
// 256 instances).  Every product runs on the tensor cores as mma.sync
// m16n8k8 with TF32 operands and keeps float32's accuracy by the 3xTF32
// split: each float32 operand x becomes hi = tf32(x) and lo = tf32(x - hi),
// rounded to nearest with ties away from zero (cvt.rna's rounding), and a
// product sums lo.hi + hi.lo + hi.hi in fp32; lo.lo lies below float32's
// rounding and is dropped.  One TF32 product alone misses the float32
// tolerance sevenfold.
//   * mma.sync, not wgmma: wgmma reads TF32 operands from shared memory
//     only K-major, so the products that sum over rows (P V, p^T dO,
//     ds^T q, ds k) would need transposed copies of v, dO, q and k, and
//     every B operand a split copy; mma.sync reads every fragment from a
//     plain row-major float32 tile, at a lower peak rate than wgmma's.
//   * The split runs in registers as each fragment is loaded (four integer
//     and float instructions a value), so a tile is kept once, in float32,
//     and serves both products that read it.  These splits, not the
//     products, take most of the issue slots.
//   * A score accumulator is the A operand of the next product as it
//     stands: its n8 tile j holds columns 8 j + 2 t and 8 j + 2 t + 1 of
//     rows g and g + 8 (lane = 4 g + t), the A fragment of k step j once
//     the step's k index is permuted (slot t is column 2 t, slot t + 4
//     column 2 t + 1); the B fragment reads rows 2 t and 2 t + 1 to match.
//     No shuffles and no round trip through shared memory.
//   * The tensor cores' fp32 accumulation truncates.  Each tile's product
//     is summed there from zero and added to the running sum in fp32, so
//     that sums over thousands of keys or queries stay within float32's
//     tolerance.
//   * cp.async (16 bytes a thread, rows and columns past the end
//     zero-filled) into a 2-stage ring: the next tile lands while this one
//     computes.  It reads through pointers, so strided views, packed QKV
//     and broadcast (stride-0) KV heads are taken as they are.
//   * Softmax in registers, in base 2 (online_softmax, scores_to_ds); the
//     element mask only on tiles that it cuts.
//   * A block writes 64 output columns: at D > 64 ceil(D / 64) blocks share
//     a tile, each recomputing its scores, so that an accumulator takes 32
//     registers a thread beside the score tiles.
//   * The backward keeps the delta pre-pass, a dK/dV kernel per (key tile,
//     KV head) that walks the group's query heads in order, and a dQ kernel
//     per q tile: no atomics, the same inputs give the same bits.

constexpr int kCols = 64;  // output columns of one float32 block

// Tiles of the float32 kernels, 16 rows a warp, 32 rows a streamed tile
// in a 2-stage ring.  A tile read down its columns (the B operand of p v,
// p^T dO, ds^T q, ds k) has a row stride of DMAX + 4 floats, 4 mod 32
// banks; a tile read only along its rows (q and k in the forward, dO and v
// in dQ) DMAX + 16, 16 mod 32, where each thread reads four columns at
// once without bank conflicts.  At DMAX 64 (Whisper) three blocks fit an
// SM: 58-76 KB of shared memory and at most 168 registers a thread.  At
// DMAX 256 the resident tiles of the backward halve so that they fit.
template <int DMAX> struct F32Tile {
  static constexpr int LD = DMAX + 4, LDR = DMAX + 16, LDC = kCols + 4;
  static constexpr int MINB = DMAX == 64 ? 3 : 1;  // blocks an SM
};
template <int DMAX> struct F32Fwd {  // q resident; k and the block's 64 columns of v streamed
  static constexpr int BQ = 64, BK = 32, THREADS = 128, LDQ = F32Tile<DMAX>::LDR;
  static constexpr int K_F = BK * LDQ, V_F = BK * F32Tile<DMAX>::LDC;
  static constexpr int SMEM = 4 * (BQ * LDQ + 2 * (K_F + V_F));
};
template <int DMAX> struct F32Dq {  // q, dO resident; k, v streamed
  static constexpr int BQ = DMAX <= 128 ? 64 : 32, BK = 32, THREADS = 2 * BQ;
  static constexpr int LD = F32Tile<DMAX>::LD, LDR = F32Tile<DMAX>::LDR;
  static constexpr int K_F = BK * LD, V_F = BK * LDR;
  static constexpr int SMEM = 4 * (BQ * (LD + LDR) + 2 * (K_F + V_F));
};
template <int DMAX> struct F32Dkdv {  // k, v resident; q, dO, lse, delta streamed
  static constexpr int BK = DMAX <= 128 ? 64 : 32, BQ = 32, THREADS = 2 * BK;
  static constexpr int LD = F32Tile<DMAX>::LD, Q_F = BQ * LD;
  static constexpr int SMEM = 4 * (2 * BK * LD + 2 * (2 * Q_F + 2 * BQ));
};

// cp.async of 16 (4) bytes; when `in` is false nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most N of this thread's committed copy groups are pending.
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + R) x C columns of a float32 matrix at src (row stride
// ss elements) into a shared tile of row stride ld, by the block's NT
// threads; rows at or past `rows` and columns at or past `cols` are
// zero-filled, so that the products run over all C columns unguarded.
template <int R, int C, int NT>
__device__ __forceinline__ void cp_tile(float* dst, int ld, const float* src, long long ss, int row0,
                                        int rows, int cols) {
  static_assert(R * C / 4 % NT == 0, "whole 16-byte chunks a thread");
#pragma unroll
  for (int k = 0; k < R * C / 4 / NT; ++k) {
    const int i = threadIdx.x + k * NT, r = i / (C / 4), c = i % (C / 4) * 4;
    const bool in = row0 + r < rows && c < cols;
    cp_async16(dst + r * ld + c, in ? src + (row0 + r) * ss + c : src, in);
  }
}

// blockIdx.z -> the batch and the block's output columns [c0, c0 + cols).
struct Chunk {
  int b, c0, cols;
};
__device__ __forceinline__ Chunk chunk_of(int d) {
  const int nc = (d + kCols - 1) / kCols, c0 = static_cast<int>(blockIdx.z % nc) * kCols;
  return Chunk{static_cast<int>(blockIdx.z / nc), c0, min(kCols, d - c0)};
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the bits cvt.rna.tf32.f32 gives for finite x, in two integer
// instructions (ptxas expands the cvt itself into about five, with checks
// for NaN and infinity that no finite score or operand needs).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
struct Split4 {  // an A fragment, split
  uint32_t hi[4], lo[4];
};
struct Split2 {  // a B fragment, split
  uint32_t hi[2], lo[2];
};
// x = hi + lo, each a TF32 value, to ~2^-22 of x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// A fragment of rows g, g + 8 and columns t, t + 4 of a row-major tile.
__device__ __forceinline__ Split4 frag_a(const float* x, int ld, int gid, int tig) {
  const float* p = x + gid * ld + tig;
  Split4 f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8 * ld], f.hi[1], f.lo[1]);
  split_tf32(p[4], f.hi[2], f.lo[2]);
  split_tf32(p[8 * ld + 4], f.hi[3], f.lo[3]);
  return f;
}
// B fragment of a transposed row-major tile Y (k = Y's columns, n = its
// rows): Y[g][t], Y[g][t + 4].
__device__ __forceinline__ Split2 frag_bt(const float* y, int ld, int gid, int tig) {
  const float* p = y + gid * ld + tig;
  Split2 f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[4], f.hi[1], f.lo[1]);
  return f;
}
// B fragment of a row-major tile Y (k = its rows, n = its columns) in the
// permuted k order of frag_acc: Y[2 t][g], Y[2 t + 1][g].
__device__ __forceinline__ Split2 frag_bp(const float* y, int ld, int gid, int tig) {
  const float* p = y + 2 * tig * ld + gid;
  Split2 f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[ld], f.hi[1], f.lo[1]);
  return f;
}
// The A fragment of k step j from n8 tile j of a score accumulator (s[0..3]
// of that tile), k permuted: slot t is column 2 t, slot t + 4 column 2 t + 1.
__device__ __forceinline__ Split4 frag_acc(const float* s) {
  Split4 f;
  split_tf32(s[0], f.hi[0], f.lo[0]);
  split_tf32(s[2], f.hi[1], f.lo[1]);
  split_tf32(s[1], f.hi[2], f.lo[2]);
  split_tf32(s[3], f.hi[3], f.lo[3]);
  return f;
}

// c (N / 8 m16n8 tiles) += a b[j] for each tile j to float32's accuracy:
// the two cross terms of every tile, then hi.hi, so that consecutive
// products go to different accumulators.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[N / 2], const Split4& a,
                                           const Split2 (&b)[N / 8]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) mma_tf32(&c[4 * j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) mma_tf32(&c[4 * j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) mma_tf32(&c[4 * j], a.hi, b[j].hi);
}

// s (16 x N, in N / 8 m16n8 tiles, the layout of online_softmax) = the 16
// rows of x times the N rows of y, transposed: a sum over DMAX columns
// (zero past D).  With VEC each thread reads four columns at once (16
// bytes; row strides 16 mod 32 banks) and the two k steps of every 16
// columns take them in a permuted order that x and y share.
template <int N, int DMAX, bool VEC>
__device__ __forceinline__ void scores_tf32(float (&s)[N / 2], const float* x, int ldx,
                                            const float* y, int ldy, int gid, int tig) {
#pragma unroll
  for (int e = 0; e < N / 2; ++e) s[e] = 0.f;
  if constexpr (VEC) {
#pragma unroll
    for (int c = 0; c < DMAX; c += 16) {
      const float4 lo = *reinterpret_cast<const float4*>(x + gid * ldx + c + 4 * tig);
      const float4 hi = *reinterpret_cast<const float4*>(x + (gid + 8) * ldx + c + 4 * tig);
      Split4 a0, a1;  // k step 2 c / 16 takes columns c + 4 t, + 1; the next one + 2, + 3
      split_tf32(lo.x, a0.hi[0], a0.lo[0]);
      split_tf32(hi.x, a0.hi[1], a0.lo[1]);
      split_tf32(lo.y, a0.hi[2], a0.lo[2]);
      split_tf32(hi.y, a0.hi[3], a0.lo[3]);
      split_tf32(lo.z, a1.hi[0], a1.lo[0]);
      split_tf32(hi.z, a1.hi[1], a1.lo[1]);
      split_tf32(lo.w, a1.hi[2], a1.lo[2]);
      split_tf32(hi.w, a1.hi[3], a1.lo[3]);
      Split2 b0[N / 8], b1[N / 8];
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(y + (8 * j + gid) * ldy + c + 4 * tig);
        split_tf32(v.x, b0[j].hi[0], b0[j].lo[0]);
        split_tf32(v.y, b0[j].hi[1], b0[j].lo[1]);
        split_tf32(v.z, b1[j].hi[0], b1[j].lo[0]);
        split_tf32(v.w, b1[j].hi[1], b1[j].lo[1]);
      }
      mma_3xtf32<N>(s, a0, b0);
      mma_3xtf32<N>(s, a1, b1);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < DMAX / 8; ++kk) {
      const Split4 a = frag_a(x + 8 * kk, ldx, gid, tig);
      Split2 b[N / 8];
#pragma unroll
      for (int j = 0; j < N / 8; ++j) b[j] = frag_bt(y + 8 * j * ldy + 8 * kk, ldy, gid, tig);
      mma_3xtf32<N>(s, a, b);
    }
  }
}
// acc (16 x 64) = acc * keep (per row) + p (16 x K, a score accumulator)
// times the K rows of y (64 columns, zero past D).  The tile's product is
// summed on the tensor cores from zero and added to acc in fp32: their
// accumulation truncates, and summed there over every tile of a long row
// (1500 keys, or Sq x rep queries for dK/dV) the drift grows to ~1e-4 of
// the sum.
template <int K>
__device__ __forceinline__ void acc_tf32(float (&acc)[kCols / 2], const float (&keep)[2],
                                         const float (&p)[K / 2], const float* y, int ldy, int gid,
                                         int tig) {
  float t[kCols / 2];
#pragma unroll
  for (int e = 0; e < kCols / 2; ++e) t[e] = 0.f;
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const Split4 a = frag_acc(&p[4 * j]);
    Split2 b[kCols / 8];
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) b[n] = frag_bp(y + 8 * j * ldy + 8 * n, ldy, gid, tig);
    mma_3xtf32<kCols>(t, a, b);
  }
#pragma unroll
  for (int e = 0; e < kCols / 2; ++e) acc[e] = fmaf(acc[e], keep[(e >> 1) & 1], t[e]);
}

// The streamed tiles of the float32 kernels go through a 2-stage ring:
// step i reads stage i & 1 while the next tile is copied into the other.
// `ring_wait` waits for step i's tile (every copy group but the newest)
// and for every warp.
__device__ __forceinline__ void ring_wait() {
  cp_commit();
  cp_wait<1>();
  __syncthreads();
}

// ------------------------------------------------------- float32 forward
// grid (ceil(Sq / 64), Hq, B x 64-column chunks), last q tile first; a
// warp owns 16 q rows.
template <int DMAX>
__global__ void __launch_bounds__(F32Fwd<DMAX>::THREADS, F32Tile<DMAX>::MINB)
    flash_fwd_tf32x3_kernel(const Args a) {
  using TL = F32Fwd<DMAX>;
  constexpr int BQ = TL::BQ, BK = TL::BK, NT = TL::THREADS;
  constexpr int LDQ = TL::LDQ, LDC = F32Tile<DMAX>::LDC;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LDQ;      // stage s at Ks + s * K_F
  float* Vs = Ks + 2 * TL::K_F;  // stage s at Vs + s * V_F
  const Mask& mk = a.mask;
  const Chunk ch = chunk_of(a.d);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = ch.b, g = h / (a.hq / a.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const float* kb = static_cast<const float*>(a.k.p) + b * a.k.sb + g * a.k.sh;
  const float* vb = static_cast<const float*>(a.v.p) + b * a.v.sb + g * a.v.sh + ch.c0;
  auto load_kv = [&](int k0, int s) {
    cp_tile<BK, DMAX, NT>(Ks + s * TL::K_F, LDQ, kb, a.k.ss, k0, mk.sk, a.d);
    cp_tile<BK, kCols, NT>(Vs + s * TL::V_F, LDC, vb, a.v.ss, k0, mk.sk, ch.cols);
  };
  cp_tile<BQ, DMAX, NT>(Qs, LDQ, static_cast<const float*>(a.q.p) + b * a.q.sb + h * a.q.sh, a.q.ss,
                        q0, mk.sq, a.d);
  int k0 = next_live(mk, q0, BQ, 0, BK);
  if (k0 < mk.sk) load_kv(k0, 0);
  cp_commit();

  const int r_lo = q0 + warp * 16 + gid;
  const float sl2 = a.scale * kLog2e;
  float o[kCols / 2], m[2] = {kNegInf2, kNegInf2}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < kCols / 2; ++e) o[e] = 0.f;
  for (int i = 0; k0 < mk.sk; ++i) {
    const int s = i & 1, kn = next_live(mk, q0, BQ, k0 + BK, BK);
    if (kn < mk.sk) load_kv(kn, s ^ 1);  // lands while this tile computes
    ring_wait();
    float sc[BK / 2], alpha[2];
    scores_tf32<BK, DMAX, true>(sc, Qs + warp * 16 * LDQ, LDQ, Ks + s * TL::K_F, LDQ, gid,
                                tig);  // S = q k^T
    online_softmax<BK>(sc, m, l, alpha, mk, mk.full(q0 + warp * 16, 16, k0, BK), r_lo, k0, tig, sl2);
    acc_tf32<BK>(o, alpha, sc, Vs + s * TL::V_F, LDC, gid, tig);  // O = O alpha + P V
    __syncthreads();  // every warp is done with stage s before it is refilled
    k0 = kn;
  }
  cp_wait<0>();
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float lmax = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / lmax;
    const int row = r_lo + 8 * r;
    // a row that no key reached keeps lse = -1e30 + log(l), as the plain version
    if (ch.c0 == 0 && tig == 0 && row < mk.sq)
      a.lse[((long long)b * a.hq + h) * mk.sq + row] =
          (m[r] == kNegInf2 ? kNegInf : m[r] * kLn2) + logf(lmax);
  }
  float* ob = static_cast<float*>(const_cast<void*>(a.o.p)) + b * a.o.sb + h * a.o.sh + ch.c0;
  store_acc<kCols>(ob, a.o.ss, r_lo, mk.sq, ch.cols, o, inv[0], inv[1], tig);
}

// ------------------------------------------------------ float32 backward dQ
// grid (ceil(Sq / BQ), Hq, B x 64-column chunks), last q tile first; a
// warp owns 16 q rows.
template <int DMAX>
__global__ void __launch_bounds__(F32Dq<DMAX>::THREADS, F32Tile<DMAX>::MINB)
    flash_bwd_dq_tf32x3_kernel(const Args a) {
  using TL = F32Dq<DMAX>;
  constexpr int BQ = TL::BQ, BK = TL::BK, NT = TL::THREADS;
  constexpr int LD = TL::LD, LDR = TL::LDR;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + BQ * LD;
  float* Ks = Gs + BQ * LDR;     // stage s at Ks + s * K_F
  float* Vs = Ks + 2 * TL::K_F;  // stage s at Vs + s * V_F
  const Mask& mk = a.mask;
  const Chunk ch = chunk_of(a.d);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = ch.b, g = h / (a.hq / a.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const float* kb = static_cast<const float*>(a.k.p) + b * a.k.sb + g * a.k.sh;
  const float* vb = static_cast<const float*>(a.v.p) + b * a.v.sb + g * a.v.sh;
  auto load_kv = [&](int k0, int s) {
    cp_tile<BK, DMAX, NT>(Ks + s * TL::K_F, LD, kb, a.k.ss, k0, mk.sk, a.d);
    cp_tile<BK, DMAX, NT>(Vs + s * TL::V_F, LDR, vb, a.v.ss, k0, mk.sk, a.d);
  };
  cp_tile<BQ, DMAX, NT>(Qs, LD, static_cast<const float*>(a.q.p) + b * a.q.sb + h * a.q.sh, a.q.ss,
                        q0, mk.sq, a.d);
  cp_tile<BQ, DMAX, NT>(Gs, LDR, static_cast<const float*>(a.g.p) + b * a.g.sb + h * a.g.sh, a.g.ss,
                        q0, mk.sq, a.d);
  int k0 = next_live(mk, q0, BQ, 0, BK);
  if (k0 < mk.sk) load_kv(k0, 0);
  cp_commit();

  const int r_lo = q0 + warp * 16 + gid;
  const float sl2 = a.scale * kLog2e, one[2] = {1.f, 1.f};
  float lse2[2], del[2];
  const long long rows = ((long long)b * a.hq + h) * mk.sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // rows past Sq: p = exp2(-inf) = 0
    const int row = r_lo + 8 * r;
    lse2[r] = row < mk.sq ? a.lse[rows + row] * kLog2e : __int_as_float(0x7f800000);
    del[r] = row < mk.sq ? a.delta[rows + row] : 0.f;
  }
  float dq[kCols / 2];
#pragma unroll
  for (int e = 0; e < kCols / 2; ++e) dq[e] = 0.f;
  for (int i = 0; k0 < mk.sk; ++i) {
    const int s = i & 1, kn = next_live(mk, q0, BQ, k0 + BK, BK);
    if (kn < mk.sk) load_kv(kn, s ^ 1);
    ring_wait();
    const float* ks = Ks + s * TL::K_F;
    float sc[BK / 2], dp[BK / 2];
    scores_tf32<BK, DMAX, false>(sc, Qs + warp * 16 * LD, LD, ks, LD, gid, tig);  // S = q k^T
    scores_tf32<BK, DMAX, true>(dp, Gs + warp * 16 * LDR, LDR, Vs + s * TL::V_F, LDR, gid,
                                tig);  // dP = dO v^T
    scores_to_ds<BK>(sc, dp, mk, mk.full(q0 + warp * 16, 16, k0, BK), r_lo, k0, tig, sl2, lse2, del,
                     a.scale);
    acc_tf32<BK>(dq, one, dp, ks + ch.c0, LD, gid, tig);  // dQ += ds k
    __syncthreads();
    k0 = kn;
  }
  cp_wait<0>();
  float* qb = static_cast<float*>(const_cast<void*>(a.dq.p)) + b * a.dq.sb + h * a.dq.sh + ch.c0;
  store_acc<kCols>(qb, a.dq.ss, r_lo, mk.sq, ch.cols, dq, 1.f, 1.f, tig);
}

// The first (query head, q tile) pair at or after `it` (it = head * nqt +
// tile, n pairs) whose q tile sees keys [k0, k0 + nk), or n.
__device__ __forceinline__ int next_pair(const Mask& mk, int it, int n, int nqt, int nq, int k0,
                                         int nk) {
  while (it < n && !mk.live((it % nqt) * nq, nq, k0, nk)) ++it;
  return it;
}

// ---------------------------------------------------- float32 backward dK/dV
// grid (ceil(Sk / BK), Hkv, B x 64-column chunks); a warp owns 16 keys and
// walks the q tiles of each query head of the group, in order.
template <int DMAX>
__global__ void __launch_bounds__(F32Dkdv<DMAX>::THREADS, F32Tile<DMAX>::MINB)
    flash_bwd_dkdv_tf32x3_kernel(const Args a) {
  using TL = F32Dkdv<DMAX>;
  constexpr int BQ = TL::BQ, BK = TL::BK, NT = TL::THREADS;
  constexpr int LD = TL::LD, F = TL::Q_F;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;      // stage s at Qs + s * F
  float* Gs = Qs + 2 * F;        // stage s at Gs + s * F
  float* lse_s = Gs + 2 * F;     // stage s at lse_s + s * BQ
  float* del_s = lse_s + 2 * BQ;
  const Mask& mk = a.mask;
  const Chunk ch = chunk_of(a.d);
  const int k0 = blockIdx.x * BK, grp = blockIdx.y, b = ch.b, rep = a.hq / a.hkv;
  const int nqt = (mk.sq + BQ - 1) / BQ, n = rep * nqt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const float* qb = static_cast<const float*>(a.q.p) + b * a.q.sb;
  const float* gb = static_cast<const float*>(a.g.p) + b * a.g.sb;
  const long long rows_b = (long long)b * a.hq * mk.sq;  // lse / delta rows of batch b
  // q, dO, lse and delta of pair `it` into stage s; rows past Sq read zero
  auto load_q_side = [&](int it, int s) {
    const int h = grp * rep + it / nqt, q0 = (it % nqt) * BQ;
    cp_tile<BQ, DMAX, NT>(Qs + s * F, LD, qb + h * a.q.sh, a.q.ss, q0, mk.sq, a.d);
    cp_tile<BQ, DMAX, NT>(Gs + s * F, LD, gb + h * a.g.sh, a.g.ss, q0, mk.sq, a.d);
    const long long row = rows_b + (long long)h * mk.sq + q0;
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool in = q0 + r < mk.sq;
      cp_async4(lse_s + s * BQ + r, a.lse + (in ? row + r : 0), in);
      cp_async4(del_s + s * BQ + r, a.delta + (in ? row + r : 0), in);
    }
  };
  cp_tile<BK, DMAX, NT>(Ks, LD, static_cast<const float*>(a.k.p) + b * a.k.sb + grp * a.k.sh, a.k.ss,
                        k0, mk.sk, a.d);
  cp_tile<BK, DMAX, NT>(Vs, LD, static_cast<const float*>(a.v.p) + b * a.v.sb + grp * a.v.sh, a.v.ss,
                        k0, mk.sk, a.d);
  int it = next_pair(mk, 0, n, nqt, BQ, k0, BK);
  if (it < n) load_q_side(it, 0);
  cp_commit();

  const int key_lo = k0 + warp * 16 + gid;
  const float sl2 = a.scale * kLog2e, one[2] = {1.f, 1.f};
  float dk[kCols / 2], dv[kCols / 2];
#pragma unroll
  for (int e = 0; e < kCols / 2; ++e) dk[e] = dv[e] = 0.f;
  for (int i = 0; it < n; ++i) {
    const int s = i & 1, itn = next_pair(mk, it + 1, n, nqt, BQ, k0, BK);
    if (itn < n) load_q_side(itn, s ^ 1);
    ring_wait();
    const int q0 = (it % nqt) * BQ;
    const float* qs = Qs + s * F;
    const float* gs = Gs + s * F;
    const float* ls = lse_s + s * BQ;
    const float* dl = del_s + s * BQ;
    float sc[BQ / 2], dp[BQ / 2];  // s^T then p^T; dp^T then ds^T
    scores_tf32<BQ, DMAX, false>(sc, Ks + warp * 16 * LD, LD, qs, LD, gid, tig);  // s^T = k q^T
    // q columns past Sq are masked: their p is exp2(-1e30 log2(e) - 0) = 0
    if (q0 + BQ <= mk.sq && mk.full(q0, BQ, k0 + warp * 16, 16)) {
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) sc[e] *= sl2;
    } else {
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int qi = q0 + (e >> 2) * 8 + 2 * tig + (e & 1);
        sc[e] = qi < mk.sq && mk.ok(qi, key_lo + ((e >> 1) & 1) * 8) ? sc[e] * sl2 : kNegInf2;
      }
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] = fast_exp2(sc[4 * j + e] - ((e & 1) ? l2.y : l2.x) * kLog2e);
    }
    acc_tf32<BQ>(dv, one, sc, gs + ch.c0, LD, gid, tig);                        // dV += p^T dO
    scores_tf32<BQ, DMAX, false>(dp, Vs + warp * 16 * LD, LD, gs, LD, gid, tig);  // dp^T = v dO^T
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * a.scale;
    }
    acc_tf32<BQ>(dk, one, dp, qs + ch.c0, LD, gid, tig);  // dK += ds^T q
    __syncthreads();
    it = itn;
  }
  cp_wait<0>();
  float* dkb = static_cast<float*>(const_cast<void*>(a.dk.p)) + b * a.dk.sb + grp * a.dk.sh;
  float* dvb = static_cast<float*>(const_cast<void*>(a.dv.p)) + b * a.dv.sb + grp * a.dv.sh;
  store_acc<kCols>(dkb + ch.c0, a.dk.ss, key_lo, mk.sk, ch.cols, dk, 1.f, 1.f, tig);
  store_acc<kCols>(dvb + ch.c0, a.dv.ss, key_lo, mk.sk, ch.cols, dv, 1.f, 1.f, tig);
}

// ------------------------------------------------- backward pre- and post-pass
// delta (B, Hq, Sq) = sum over D of dO * out, fp32 sums of T inputs: a warp
// per row, rows in delta's order.
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const Args a) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, sq = a.mask.sq;
  if (row >= (long long)a.batch * a.hq * sq) return;
  const int i = static_cast<int>(row % sq), h = static_cast<int>((row / sq) % a.hq);
  const int b = static_cast<int>(row / ((long long)sq * a.hq));
  const T* g = static_cast<const T*>(a.g.p) + b * a.g.sb + i * a.g.ss + h * a.g.sh;
  const T* o = static_cast<const T*>(a.o.p) + b * a.o.sb + i * a.o.ss + h * a.o.sh;
  float acc = 0.f;
  for (int c = lane * 4; c < a.d; c += 128) {
    const float4 x = V4<T>::load(g + c), y = V4<T>::load(o + c);
    acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

// dK, dV (B, Sk, Hkv, D) = the sums over each group's rep query heads of
// the fp32 partials (B, Sk, Hq, D), in head order, cast to bf16.  A
// thread per 4 columns of one (b, key, KV head) row.
__global__ void __launch_bounds__(256) flash_bwd_reduce_kernel(const Args a) {
  const int vpr = a.d / 4, rep = a.hq / a.hkv, sk = a.mask.sk;
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (long long)a.batch * sk * a.hkv * vpr) return;
  const int c = static_cast<int>(idx % vpr) * 4;
  const long long r = idx / vpr;
  const int g = static_cast<int>(r % a.hkv), s = static_cast<int>((r / a.hkv) % sk);
  const int b = static_cast<int>(r / ((long long)a.hkv * sk));
  const long long off = (((long long)b * sk + s) * a.hq + g * rep) * a.d + c;
  float4 k4 = make_float4(0.f, 0.f, 0.f, 0.f), v4 = k4;
  for (int j = 0; j < rep; ++j) {
    const float4 x = V4<float>::load(a.dk_part + off + j * a.d);
    const float4 y = V4<float>::load(a.dv_part + off + j * a.d);
    k4.x += x.x; k4.y += x.y; k4.z += x.z; k4.w += x.w;
    v4.x += y.x; v4.y += y.y; v4.z += y.z; v4.w += y.w;
  }
  using bf = __nv_bfloat16;
  V4<bf>::store(static_cast<bf*>(const_cast<void*>(a.dk.p)) + b * a.dk.sb + s * a.dk.ss + g * a.dk.sh + c, k4);
  V4<bf>::store(static_cast<bf*>(const_cast<void*>(a.dv.p)) + b * a.dv.sb + s * a.dv.ss + g * a.dv.sh + c, v4);
}

// ------------------------------------------------------------------- host

enum Kind { kFwd = 0, kDkdv = 1, kDq = 2, kDelta = 3 };

// Tile width of head dim d (at most 256, which the wrapper checks).  bf16
// takes the TMA and wgmma kernels at every width, float32 the 3xTF32
// mma.sync ones.
int dmax_of(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

template <int DMAX> int smem_bytes_f32(int kind) {
  if (kind == kFwd) return F32Fwd<DMAX>::SMEM;
  if (kind == kDkdv) return F32Dkdv<DMAX>::SMEM;
  return F32Dq<DMAX>::SMEM;
}

template <int DMAX> int smem_bytes_wgmma(int kind) {
  if (kind == kFwd) return FwdTile<DMAX>::SMEM;
  if (kind == kDkdv) return DkdvTile<DMAX>::SMEM;
  return DqTile<DMAX>::SMEM;
}

int smem_for(int kind, int d, int bf16) {
  if (kind == kDelta) return 0;
  switch (dmax_of(d)) {
    case 64: return bf16 ? smem_bytes_wgmma<64>(kind) : smem_bytes_f32<64>(kind);
    case 128: return bf16 ? smem_bytes_wgmma<128>(kind) : smem_bytes_f32<128>(kind);
    default: return bf16 ? smem_bytes_wgmma<256>(kind) : smem_bytes_f32<256>(kind);
  }
}

template <typename K>
int launch_one(K kernel, dim3 grid, int threads, int smem, const Args& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The float32 kernels: a block per 64 output columns of each tile, so
// the grid's z holds the batch times ceil(D / 64).
template <int DMAX>
int launch_f32(int kind, const Args& a, cudaStream_t st) {
  const int z = a.batch * ((a.d + kCols - 1) / kCols);
  if (kind == kFwd) {
    using TL = F32Fwd<DMAX>;
    return launch_one(flash_fwd_tf32x3_kernel<DMAX>, dim3((a.mask.sq + TL::BQ - 1) / TL::BQ, a.hq, z),
                      TL::THREADS, TL::SMEM, a, st);
  }
  if (kind == kDkdv) {
    using TL = F32Dkdv<DMAX>;
    return launch_one(flash_bwd_dkdv_tf32x3_kernel<DMAX>,
                      dim3((a.mask.sk + TL::BK - 1) / TL::BK, a.hkv, z), TL::THREADS, TL::SMEM, a, st);
  }
  using TL = F32Dq<DMAX>;
  return launch_one(flash_bwd_dq_tf32x3_kernel<DMAX>, dim3((a.mask.sq + TL::BQ - 1) / TL::BQ, a.hq, z),
                    TL::THREADS, TL::SMEM, a, st);
}

// Errors of the host side of the Hopper path, above CUDA's own codes.
constexpr int kErrNoEncoder = 1001;   // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrEncode = 1002;      // cuTensorMapEncodeTiled refused a tensor map
constexpr int kErrPlan = 1003;        // a map's box does not match the kernel's tile

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, fetched through the runtime so that the
// library links cudart only.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// One bf16 tensor map from its plan (kMapSpec values, see
// flash_attention_launch): dims {D, H, S, B}, byte strides of H, S and B,
// box {64, 1, rows, 1}; 128-byte swizzle, zeros past the edges.
constexpr int kMapSpec = 11;
int encode(CUtensorMap* map, const void* ptr, const long long* spec, int rows) {
  if (spec[7] != 64 || spec[8] != 1 || spec[9] != rows || spec[10] != 1) return kErrPlan;
  const EncodeTiled fn = encoder();
  if (!fn) return kErrNoEncoder;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = static_cast<cuuint64_t>(spec[i]);
    box[i] = static_cast<cuuint32_t>(spec[7 + i]);
  }
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(spec[4 + i]);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <typename K>
int launch_tma(K kernel, int blocks, int threads, int smem, const Maps& maps, const Args& a,
               cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, st>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v (and dO for the backward) tensor maps, q-side boxes of q_rows
// and k-side boxes of k_rows.
int encode_maps(Maps* m, const Args& a, const long long* specs, int q_rows, int k_rows, bool g) {
  int err = encode(&m->q, a.q.p, specs, q_rows);
  if (!err) err = encode(&m->k, a.k.p, specs + kMapSpec, k_rows);
  if (!err) err = encode(&m->v, a.v.p, specs + 2 * kMapSpec, k_rows);
  if (!err && g) err = encode(&m->g, a.g.p, specs + 3 * kMapSpec, q_rows);
  return err;
}

template <int DMAX>
int launch_wgmma(int kind, const Args& a, const long long* specs, cudaStream_t st) {
  if (!specs) return kErrPlan;
  Maps maps;
  const int heads = a.hq * a.batch;
  if (kind == kFwd) {
    using TL = FwdTile<DMAX>;
    int err = encode_maps(&maps, a, specs, TL::BQ, TL::BK, false);
    if (err) return err;
    return launch_tma(flash_fwd_wgmma_kernel<DMAX>, heads * ((a.mask.sq + TL::BQ - 1) / TL::BQ),
                      wg_threads<DMAX>(), TL::SMEM, maps, a, st);
  }
  if (kind == kDkdv) {
    using TL = DkdvTile<DMAX>;
    const auto kernel = flash_bwd_dkdv_wgmma_kernel<DMAX>;
    int err = encode_maps(&maps, a, specs, TL::BQ, TL::BK, true);
    if (err) return err;
    err = launch_tma(kernel, heads * ((a.mask.sk + TL::BK - 1) / TL::BK), wg_threads<DMAX>(),
                     TL::SMEM, maps, a, st);
    if (err) return err;
    const long long n = (long long)a.batch * a.mask.sk * a.hkv * (a.d / 4);
    flash_bwd_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  using TL = DqTile<DMAX>;
  int err = encode_maps(&maps, a, specs, TL::BQ, TL::BK, true);
  if (err) return err;
  return launch_tma(flash_bwd_dq_wgmma_kernel<DMAX>, heads * ((a.mask.sq + TL::BQ - 1) / TL::BQ),
                    wg_threads<DMAX>(), TL::SMEM, maps, a, st);
}

template <typename T> int launch_delta(const Args& a, cudaStream_t st) {
  const long long rows = (long long)a.batch * a.hq * a.mask.sq;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Tensor4 tensor4(const void* p, const long long* st) { return Tensor4{p, st[0], st[1], st[2]}; }

}  // namespace

// Shared memory of one block of kernel `kind` (0 forward, 1 dK/dV, 2 dQ,
// 3 delta) at head dim d, for bf16 (1) or f32 (0) inputs.
extern "C" int flash_attention_smem_bytes(int kind, int d, int bf16) {
  return smem_for(kind, d, bf16);
}

// ptrs: q, k, v, out, g, dq, dk, dv, lse, delta, dk_part, dv_part (unused
// ones may be null); strides: (batch, seq, head) in elements for the first
// eight, 24 values; shape: B, Hq, Hkv, Sq, Sk, D; mask: causal, window,
// chunk, prefix_len, q_offset; maps: for bf16, the tensor-map plans of q,
// k, v and g, 11 values each (dims D, H, S, B; byte strides of
// H, S, B; box 64, 1, rows, 1), else null.  kind 0 launches the forward
// (writes out and lse); kind 3 the delta pre-pass (reads g and out, writes
// delta); kind 1 the dK/dV kernel (on the bf16 path into dk_part/dv_part,
// fp32 (B, Sk, Hq, D), then the reduction into dk/dv) and kind 2 the dQ
// kernel (both read lse and delta).  Returns the CUDA error code of the
// launch (0 on success), or 1001-1003 when a tensor map cannot be made.
extern "C" int flash_attention_launch(int kind, void* const* ptrs, const long long* strides,
                                      const int* shape, const int* mask, int bf16, float scale,
                                      const long long* maps, void* stream) {
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
  a.delta = static_cast<float*>(ptrs[9]);
  a.dk_part = static_cast<float*>(ptrs[10]);
  a.dv_part = static_cast<float*>(ptrs[11]);
  a.batch = shape[0];
  a.hq = shape[1];
  a.hkv = shape[2];
  a.d = shape[5];
  a.scale = scale;
  a.mask = Mask{shape[3], shape[4], mask[0], mask[1], mask[2], mask[3], mask[4]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == kDelta) return bf16 ? launch_delta<__nv_bfloat16>(a, st) : launch_delta<float>(a, st);
  switch (dmax_of(a.d)) {
    case 64: return bf16 ? launch_wgmma<64>(kind, a, maps, st) : launch_f32<64>(kind, a, st);
    case 128: return bf16 ? launch_wgmma<128>(kind, a, maps, st) : launch_f32<128>(kind, a, st);
    default: return bf16 ? launch_wgmma<256>(kind, a, maps, st) : launch_f32<256>(kind, a, st);
  }
}
