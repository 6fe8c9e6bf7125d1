// Flash-decode for Hopper (sm_90a): one query token per sequence against a
// (B, S, Hkv, D) KV cache, GQA with rep = Hq / Hkv query heads per KV head.
//
// Replaces the Pallas TPU kernel `decode_attention_pallas` in
// src/repro/kernels/decode_attention/decode_attention.py (body
// `_decode_kernel`), and computes the same function: fp32 online-softmax
// state (m, l, acc), output in q's type.  One kernel takes two masks:
//   mode 0 (lengths): keys at or past lengths[b] are skipped, as in Pallas;
//   mode 1 (slots):   the ring-buffer mask of `decode_attention_cache_xla`
//                     (src/repro/models/layers.py): slot j counts when
//                     0 <= pos[b, j] <= q_pos[b], within `window` positions
//                     of q_pos and in its chunk of `chunk` positions.
//
// Bound: device-memory bytes.  A step reads the live part of the cache,
// 2 * B * L * Hkv * D * sizeof(cache type) bytes, and does 4 * Hq * D flops
// per key -- 12 flops per byte at StarCoder2's rep = 12 in bf16, far below
// the ~295 where the tensor cores would limit.  What the design does:
//   * a block owns one (batch, KV head, group of up to 16 query heads, key
//     split): the heads share every K/V tile it loads, so each K/V byte
//     crosses from device memory once per KV head (rep <= 16);
//   * before loading anything a block marks the valid keys of its split in
//     shared memory (one ballot per 32 keys) and lists the tiles holding
//     one: tiles with none are never read, so an unwrapped ring cache costs
//     only its live part, as the lengths mask does.  A split longer than
//     kPassKeys keys is marked and streamed in passes of kPassKeys, the
//     online softmax carried across them, so the cache length is not capped
//     (instances of their own: shorter splits run without the pass loop);
//   * splits are whole tiles of at least a few hundred keys (chosen in the
//     wrapper from shapes alone), streamed through a 3-stage cp.async ring
//     (16 bytes a thread, invalid keys zero-filled); at D = 128 two blocks
//     fit on an SM;
//   * bf16 caches with D % 16 == 0 run the products on the tensor cores
//     (mma.sync m16n8k16, fp32 accumulators): the query heads are the 16
//     rows of M (rep 12 pads to 16), each warp takes 16 keys of a 64-key
//     tile and keeps its own online softmax, in fp32 and base 2, and its
//     own accumulator in registers; P goes from the score fragments to the
//     A operand of P V without shared memory.  wgmma's 64-row minimum
//     would leave 3/4 of each product idle at rep <= 16, hence mma.sync.
//     An fp32 q enters as two bf16 parts (hi + lo), and so does P in P V,
//     so both products keep ~16 bits of them;
//   * other shapes (f32 caches, D % 16 != 0) run the CUDA-core kernel: fp32
//     arithmetic, a lane per key, held to 2e-5 in f32;
//   * one launch, and a row's splits merge in split order, so results
//     repeat bit for bit whichever block ends first.  Two merges:
//     - a row of at most 8 splits (kMaxSplits; the wrapper's rule where the
//       rows alone give most SMs a block) is one thread-block cluster.
//       Every block first learns which splits of its row hold a valid key
//       (from the length, or by testing the row's slots); a row with one
//       live split writes its output from that block, the others leaving
//       at once.  Otherwise the blocks merge their (acc, m, l) in shared
//       memory: each reads the others' through distributed shared memory
//       and sums its share of the outputs, and no partial goes to device
//       memory;
//     - a row of more splits (few rows: a long cache at small batch, where
//       8 splits a row would leave most SMs idle) merges through device
//       memory.  A block tests only its own split's keys (the lengths form
//       knows from the length alone), and a split with none writes an
//       empty partial (m = -inf, l = 0) and does nothing more.  Each block
//       writes its float32 partial (acc, m, l) to the wrapper's workspace
//       and takes a ticket (a barrier, then one thread's acquire-release
//       atomicAdd on its group's int32 counter).  The last block of a
//       group of splits merges the group's partials in split order
//       (brought into shared memory by bulk copies of the copy engine);
//       with more than one group it writes the group's partial and takes
//       the row's ticket, and the last group merges the groups in order.
//       The merge is a function of its own, kept out of the key loop's
//       registers, in kernel instances of their own, so the cluster's
//       instances compile as they did before it.  Its time is a chain of
//       latencies (one block, 4 warps), so the wrapper merges up to 16
//       splits in one step and more in two steps of about sqrt(n) each.
//       The counters are a buffer of the wrapper's, one per card,
//       zeroed once; the block that takes a counter's last ticket sets it
//       back to 0, so a launch leaves every counter at 0 and the next
//       launch on the stream, or a CUDA graph's replay, finds them so.
//       Two launches at once on two streams of one card would share them.
// Rows with no valid key give zeros.  The log-sum-exp form (a non-null
// `lse`, kernel instances of its own) also writes each row's natural
// log-sum-exp of its scaled logits, (m + log2 l) ln 2 from the base-2
// state, -inf for a row with no valid key, and the output in float32, so
// that a caller merging partial rows across ranks rounds once.  Nothing is
// allocated here; launches go on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 16;                       // query heads of a block
constexpr int kPassKeys = 16384;                 // keys a block marks and streams at once
constexpr int kMaxWords = kPassKeys / 32;        // validity words of a pass
constexpr int kMaxSplits = 8;                    // a row's splits merged in one portable cluster
constexpr int kMaxMerge = 64;                    // partials one merge through memory takes
// the merge through memory's (m, l) of kMaxMerge partials and its weights,
// at the start of the dynamic shared memory; its acc rounds come after them
constexpr int kMergeFloats = 3 * kHeads * kMaxMerge;
constexpr int kTcTile = 64;                      // keys per tile, tensor cores: 16 a warp
constexpr int kCcTile = 32;                      // keys per tile, CUDA cores: one a lane
constexpr int kStages = 3;                       // cp.async ring of the tensor-core kernel
constexpr int kRepTile = 4;                      // query heads per thread, CUDA-core scores
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

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
template <> struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const bf16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float4 load4(const bf16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

struct Params {
  const void* q;               // (B, Hq, D), rows q_sh apart
  const void* k;               // (B, S, Hkv, D) strided
  const void* v;
  const int* lengths;          // mode 0: (B,)
  const int* slot_pos;         // mode 1: (B, S), rows sp_sb apart
  const int* q_pos;            // mode 1: (B,)
  void* out;                   // (B, Hq, D) contiguous, q's type (float32 with lse)
  float* lse;                  // (B, Hq) or null: each row's natural log-sum-exp
  float* ws;                   // null: a row is one cluster; else the partials (MergeJob)
  int* tickets;                // with ws: a counter a (unit, group) and a unit, at 0
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, sp_sb;
  int mode, B, Hq, Hkv, S, D, n_split, chunk, window, attn_chunk, rep, mgroups;
  int group;                   // with ws: splits a group of the merge, <= kMaxMerge
  int smem;                    // bytes of dynamic shared memory
  float scale;
};

// Phase stamps (the globaltimer, ns) of each block's thread 0, compiled in
// only with -DDECODE_ATTENTION_STAMPS (tools/decode_attention_phases.py):
// 0 start, 1 keys marked, 2 first tiles' loads issued, 3 first tile landed,
// 4 keys streamed, 5 partial ready, 6 first ticket taken, 7 group merged,
// 8 output written; inside a merge through memory (the last one of the
// block's) 9 the partials' (m, l) landed, 10 their acc landed and the
// weights taken, 11 columns summed.
#ifdef DECODE_ATTENTION_STAMPS
constexpr int kStamps = 12;
__device__ unsigned long long* g_stamps;
__device__ long long g_stamp_blocks;
__device__ __forceinline__ void stamp(int k) {
  const long long blk = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && g_stamps && blk < g_stamp_blocks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[blk * kStamps + k] = t;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

// The natural log-sum-exp of a row's scaled logits from its base-2 state:
// m is the largest of them times log2 e, l the sum of exp2(. - m).
__device__ __forceinline__ float natural_lse(float m, float l) {
  return (m + log2f(l)) * kLn2;
}

// Where a block works: grid (n_split, Hkv * mgroups, B), clusters of the
// n_split blocks of a row.
struct Block {
  int split, b, g, h0, nh, k0, k1;
  __device__ explicit Block(const Params& p) {
    split = blockIdx.x;
    b = blockIdx.z;
    g = blockIdx.y / p.mgroups;
    const int mg = blockIdx.y - g * p.mgroups;
    h0 = g * p.rep + mg * kHeads;
    nh = min(kHeads, p.rep - mg * kHeads);
    k0 = split * p.chunk;
    k1 = min(k0 + p.chunk, p.S);
  }
};

// Whether key j of batch row b counts, under either mask.
struct Mask {
  const int* sp;
  int mode, len, qp, window, chunk;
  __device__ Mask(const Params& p, int b)
      : sp(nullptr), mode(p.mode), len(0), qp(0), window(p.window), chunk(p.attn_chunk) {
    if (mode == 0) {
      len = p.lengths[b];
      len = len < 0 ? 0 : min(len, p.S);
    } else {
      sp = p.slot_pos + b * p.sp_sb;
      qp = p.q_pos[b];
    }
  }
  __device__ __forceinline__ bool operator()(int j) const {
    if (mode == 0) return j < len;
    const int s = sp[j];
    return s >= 0 && s <= qp && (window == 0 || qp - s < window) &&
           (chunk == 0 || s / chunk == qp / chunk);
  }
};

struct Shared {
  uint32_t vm[kMaxWords];          // valid keys of the pass, bit per key
  short live[kPassKeys / kCcTile];
  int n_live;
  unsigned splits;                 // bit s: split s of the row holds a valid key
  float wm[kWarps][kHeads], wl[kWarps][kHeads];
  float m[kHeads], l[kHeads];      // this split's (m, l), read by the cluster
  float wt[kHeads][kMaxSplits], lt[kHeads][kMaxSplits];   // the splits' m (then weights), l
  float norm[kHeads];
  int last;                        // merge through memory: this block took the last ticket
  unsigned long long bar[2];       // merge through memory: its (m, l) and acc copies landed
};

__device__ __forceinline__ bool key_bit(const Shared& sh, int rel) {
  return (sh.vm[rel >> 5] >> (rel & 31)) & 1u;
}

// Which splits of the block's row hold a valid key (sh.splits): the
// lengths mask knows it from the length; the slot mask tests every slot of
// the row, U loads a thread in flight, and keeps the validity words of the
// first pass of the block's own split, [k0, min(k1, k0 + kPassKeys)), in
// sh.vm as it goes.  Returns their number.
__device__ int census(Shared& sh, const Params& p, const Mask& mk, int k0, int k1) {
  if (threadIdx.x == 0) {
    const int n = p.mode == 0 ? (mk.len + p.chunk - 1) / p.chunk : 0;
    sh.splits = (1u << n) - 1u;      // n <= kMaxSplits < 32
  }
  if (p.mode == 1) {
    __syncthreads();
    constexpr int U = 8;
    const int lane = threadIdx.x & 31;
    unsigned bits = 0;
    // a warp tests 32 consecutive slots at a time: one validity word
    for (int base = threadIdx.x & ~31; base < p.S; base += U * kThreads) {
      bool v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = base + u * kThreads + lane;
        v[u] = j < p.S && mk(j);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int w0 = base + u * kThreads;      // the word's first slot
        if (v[u]) bits |= 1u << ((w0 + lane) / p.chunk);
        const unsigned word = __ballot_sync(0xffffffffu, v[u]);
        if (lane == 0 && w0 >= k0 && w0 < k1 && w0 - k0 < kPassKeys)
          sh.vm[(w0 - k0) / 32] = word;
      }
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0 && bits) atomicOr(&sh.splits, bits);
  }
  __syncthreads();
  return __popc(sh.splits);
}

// Mark the valid keys of the pass [k0, k1), at most kPassKeys keys (when
// `marked`, the slot mask's census marked them already: only the words past
// k1 are cleared), and list the tiles of TK keys that hold one, in order;
// returns their number.  Callers leave sh.vm and sh.live unread first.
template <int TK>
__device__ int find_live(Shared& sh, const Mask& mk, int k0, int k1, bool marked) {
  constexpr int WPT = TK / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int U = 8;             // words a warp tests at once
  const int ntiles = (k1 - k0 + TK - 1) / TK, nw = ntiles * WPT;
  if (marked)
    for (int w = threadIdx.x; w < nw; w += kThreads)
      if (k0 + 32 * w >= k1) sh.vm[w] = 0u;
  for (int w0 = warp; !marked && w0 < nw; w0 += U * kWarps) {
    bool v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = k0 + (w0 + u * kWarps) * 32 + lane;
      v[u] = w0 + u * kWarps < nw && j < k1 && mk(j);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned bits = __ballot_sync(0xffffffffu, v[u]);
      if (lane == 0 && w0 + u * kWarps < nw) sh.vm[w0 + u * kWarps] = bits;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int base = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int t = t0 + lane;
      bool live = false;
      if (t < ntiles) {
#pragma unroll
        for (int i = 0; i < WPT; ++i) live |= sh.vm[t * WPT + i] != 0u;
      }
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) sh.live[base + __popc(m & ((1u << lane) - 1u))] = static_cast<short>(t);
      base += __popc(m);
    }
    if (lane == 0) sh.n_live = base;
  }
  __syncthreads();
  return sh.n_live;
}

// The block's split is done: acc (nh x D, unnormalised, base-2 m in sh.m,
// l in sh.l).  When it is the row's only live split the block writes the
// output.  Otherwise the row's blocks, one cluster, merge in shared memory:
// after a cluster barrier each block reads every split's (m, l), and the
// splits' acc for its share of the outputs (distributed shared memory),
// sums them in split order; a second barrier keeps each block's partial
// alive until all have read it.  acc's rows are ld floats apart (ld % 4 == 0).
// TO is the output's type: q's, or float32 in the log-sum-exp form (kLse),
// which also writes each row's lse.
template <typename TO, bool kLse>
__device__ void finish(const Params& p, const Block& bk, Shared& sh, const float* acc, int ld,
                       int live_splits) {
  const int D = p.D, tid = threadIdx.x, nh = bk.nh, ns = p.n_split;
  const long long row0 = (long long)bk.b * p.Hq + bk.h0;
  TO* out = static_cast<TO*>(p.out) + row0 * D;
  if (live_splits == 1) {
    for (int i = tid; i < nh * D; i += kThreads) {
      const int r = i / D;
      out[i] = from_f32<TO>(acc[r * ld + i - r * D] / fmaxf(sh.l[r], 1e-30f));
    }
    if constexpr (kLse)
      for (int r = tid; r < nh; r += kThreads) p.lse[row0 + r] = natural_lse(sh.m[r], sh.l[r]);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int i = tid; i < nh * ns; i += kThreads) {
    const int r = i / ns, s = i - r * ns;
    const Shared* rs = cluster.map_shared_rank(&sh, s);
    sh.wt[r][s] = rs->m[r];
    sh.lt[r][s] = rs->l[r];
  }
  __syncthreads();
  // split weights exp2(m_s - M) per head (0 for empty splits) and the sum l
  for (int r = tid; r < nh; r += kThreads) {
    float M = kNegInf;
    for (int s = 0; s < ns; ++s) M = fmaxf(M, sh.wt[r][s]);
    float L = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float m = sh.wt[r][s];
      const float w = m > kNegInf ? exp2f(m - M) : 0.f;
      sh.wt[r][s] = w;
      L = fmaf(sh.lt[r][s], w, L);
    }
    sh.norm[r] = fmaxf(L, 1e-30f);
    if (kLse && bk.split == 0) p.lse[row0 + r] = natural_lse(M, L);
  }
  __syncthreads();
  // this block's share: groups of four outputs split, split + ns, ...
  for (int v = bk.split * kThreads + tid; v < nh * D / 4; v += ns * kThreads) {
    const int r = 4 * v / D, a4 = (r * ld + 4 * v - r * D) / 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s >= ns) break;
      const float w = sh.wt[r][s];
      const float4 x = cluster.map_shared_rank(reinterpret_cast<const float4*>(acc), s)[a4];
      o.x = fmaf(x.x, w, o.x);
      o.y = fmaf(x.y, w, o.y);
      o.z = fmaf(x.z, w, o.z);
      o.w = fmaf(x.w, w, o.w);
    }
    const float l = sh.norm[r];
    out[4 * v] = from_f32<TO>(o.x / l);
    out[4 * v + 1] = from_f32<TO>(o.y / l);
    out[4 * v + 2] = from_f32<TO>(o.z / l);
    out[4 * v + 3] = from_f32<TO>(o.w / l);
  }
  cluster.sync();
}

// A block whose split holds no valid key: with at most one live split in
// the row it leaves at once (split 0 writing zeros, and a log-sum-exp of
// -inf, when there is none); otherwise it joins the cluster's merge with an
// empty (m, l) and zero acc.  Returns true when the caller is done.
template <typename TO, bool kLse>
__device__ bool empty_split(const Params& p, const Block& bk, Shared& sh, float* acc, int ld,
                            int live_splits) {
  if ((sh.splits >> bk.split) & 1u) return false;
  if (live_splits > 1) {
    for (int r = threadIdx.x; r < kHeads; r += kThreads) {
      sh.m[r] = kNegInf;
      sh.l[r] = 0.f;
    }
    for (int i = threadIdx.x; i < bk.nh * p.D; i += kThreads)
      acc[(i / p.D) * ld + i % p.D] = 0.f;
    finish<TO, kLse>(p, bk, sh, acc, ld, live_splits);
  } else if (live_splits == 0 && bk.split == 0) {
    const long long row0 = (long long)bk.b * p.Hq + bk.h0;
    TO* out = static_cast<TO*>(p.out) + row0 * p.D;
    for (int i = threadIdx.x; i < bk.nh * p.D; i += kThreads) out[i] = from_f32<TO>(0.f);
    if constexpr (kLse)
      for (int r = threadIdx.x; r < bk.nh; r += kThreads) p.lse[row0 + r] = -__int_as_float(0x7f800000);
  }
  return true;
}

// ------------------------------------------------ merge through device memory
// A unit is one row of the merge, a (batch, KV head, head group).  The
// workspace holds every unit's partials, its splits' and then its groups':
// first all their acc (hs x D floats each, unnormalised), then all their
// (m, l) (ml_floats(hs) each: m (hs), l (hs), padded to 16 bytes), so that
// a run of a unit's partials is two runs of memory; hs = min(rep, kHeads)
// (a unit's last head group may use fewer rows).
__host__ __device__ inline int ml_floats(int hs) { return (2 * hs + 3) & ~3; }
__host__ __device__ inline int merge_groups(int n_split, int group) {
  return (n_split + group - 1) / group;
}

// What the merge through memory reads of the launch and of the block, by
// value: the merge is a function of its own (merge_through_memory), kept
// out of the kernels' key loops and their registers.
struct MergeJob {
  float* ws;
  int* tickets;
  void* out;
  float* lse;
  int n_split, group, D, hs, Hq, smem, b, h0, nh, split;
  bool out_bf16;               // the output is bf16 (q's type); else float32
  __device__ MergeJob(const Params& p, const Block& bk, bool q_bf16)
      : ws(p.ws), tickets(p.tickets), out(p.out), lse(p.lse), n_split(p.n_split),
        group(p.group), D(p.D), hs(min(p.rep, kHeads)), Hq(p.Hq), smem(p.smem), b(bk.b),
        h0(bk.h0), nh(bk.nh), split(bk.split), out_bf16(q_bf16 && !p.lse) {}
  __device__ long long unit() const { return (long long)blockIdx.z * gridDim.y + blockIdx.y; }
  __device__ long long per_unit() const { return n_split + merge_groups(n_split, group); }
  // the unit's partial i (splits 0 .. n_split - 1, then the groups): its acc
  __device__ float* acc(int i) const { return ws + (unit() * per_unit() + i) * hs * D; }
  // and its (m, l)
  __device__ float* ml(int i) const {
    const long long units = (long long)gridDim.z * gridDim.y;
    return ws + units * per_unit() * hs * D + (unit() * per_unit() + i) * ml_floats(hs);
  }
};

// mbarriers of the merge's bulk copies.  A wait that never ends (a wrong
// parity or byte count) faults after 2^28 polls instead of hanging the card.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, uint32_t parity) {
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
// One thread: `bytes` (a multiple of 16) from global src into shared dst by
// the copy engine, counted on bar, after a proxy fence that puts this
// block's and (acquired) other blocks' earlier plain accesses first.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile("fence.proxy.async;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Take a ticket of counter c once the block's writes are done: true for
// the block that takes the last of `arrivals`, which sets the counter back
// to 0 and may then read what the others wrote, through L2.  One thread
// takes the ticket with an acquire-release atomic: the barrier before it
// puts every thread's writes before its release, the barrier after it puts
// every thread's reads after its acquire of the others' writes.
__device__ bool last_arrival(Shared& sh, int* c, int arrivals) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int t;
    asm volatile("atom.acq_rel.gpu.add.s32 %0, [%1], 1;" : "=r"(t) : "l"(c) : "memory");
    sh.last = t == arrivals - 1;
    if (sh.last) *c = 0;
  }
  __syncthreads();
  return sh.last;
}

// Merge the unit's partials first .. first + count - 1 (count <= kMaxMerge)
// in order.  Their (m, l) and acc come into shared memory by two bulk
// copies of the copy engine, issued at once (acc in rounds of as many
// partials as the shared memory holds past the merge's kMergeFloats), and
// the weights are taken from the (m, l) while the acc still lands.  One
// block does the whole merge, so its time is a chain of latencies.  A warp
// per head takes the largest m (M) and the weights exp2(m_s - M), 0 for a
// partial with no valid key (whose acc is never written, so never used);
// its lane 0 sums L = sum of l_s w_s in partial order.  Each thread then
// sums its output columns over the partials in partial order, a column at
// a time, four partials' loads issued together.  The result goes to the
// unit's partial `to` (acc unnormalised, M, L) or, with to < 0, to the
// row's output: acc / L (zeros for a row with no valid key) and, in the
// log-sum-exp form, its lse (-inf then).  `uses` counts the block's waits
// on each of sh.bar, for their parities.
__device__ void merge(const MergeJob& job, Shared& sh, float* smem, int first, int count,
                      int to, int (&uses)[2]) {
  const int D = job.D, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nh = job.nh;
  const int hs = job.hs, d4 = D / 4, row4 = nh * d4, hsd4 = hs * d4, ml = ml_floats(hs);
  const float* mls = smem;                                   // [kMaxMerge][ml]: m, l
  float* wt = smem + kMergeFloats - kHeads * kMaxMerge;      // [kHeads][kMaxMerge]: weights
  float4* stage = reinterpret_cast<float4*>(smem + kMergeFloats);
  constexpr int kCols = kHeads * 256 / 4 / kThreads;   // float4 columns a thread owns, at most
  const int per = (job.smem / 16 - kMergeFloats / 4) / hsd4;   // partials a round (>= 1)
  if (tid == 0) {
    bulk_copy(smem, job.ml(first), count * ml * 4, &sh.bar[0]);
    bulk_copy(stage, job.acc(first), min(per, count) * hsd4 * 16, &sh.bar[1]);
  }
  mbar_wait(&sh.bar[0], uses[0]++ & 1);   // the (m, l): the weights while the acc lands
  stamp(9);
  for (int r = warp; r < nh; r += kWarps) {
    float m[kMaxMerge / 32];
    float M = kNegInf;
#pragma unroll
    for (int q = 0; q < kMaxMerge / 32; ++q) {
      const int s = lane + 32 * q;
      m[q] = s < count ? mls[s * ml + r] : kNegInf;
      M = fmaxf(M, m[q]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
#pragma unroll
    for (int q = 0; q < kMaxMerge / 32; ++q)
      if (lane + 32 * q < count)
        wt[r * kMaxMerge + lane + 32 * q] = m[q] > kNegInf ? exp2f(m[q] - M) : 0.f;
    __syncwarp();
    if (lane == 0) {
      float L = 0.f;
#pragma unroll 8
      for (int s = 0; s < count; ++s) L = fmaf(mls[s * ml + hs + r], wt[r * kMaxMerge + s], L);
      sh.m[r] = M;
      sh.norm[r] = L;
    }
  }
  mbar_wait(&sh.bar[1], uses[1]++ & 1);
  __syncthreads();                   // the weights
  stamp(10);
  float4 o[kCols];
  const float* w[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    o[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    w[j] = wt + min((tid + j * kThreads) / d4, kHeads - 1) * kMaxMerge;
  }
  for (int s0 = 0; s0 < count; s0 += per) {
    const int n = min(per, count - s0);
    if (s0 > 0) {                    // a further round: the stage is free again
      __syncthreads();
      if (tid == 0) bulk_copy(stage, job.acc(first + s0), n * hsd4 * 16, &sh.bar[1]);
      mbar_wait(&sh.bar[1], uses[1]++ & 1);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int v = tid + j * kThreads;
      if (v < row4)
#pragma unroll 4
        for (int s = 0; s < n; ++s) {
          const float ws = w[j][s0 + s];
          if (ws != 0.f) {   // 0: no valid key, or a weight below float range
            const float4 x = stage[s * hsd4 + v];
            o[j].x = fmaf(x.x, ws, o[j].x);
            o[j].y = fmaf(x.y, ws, o[j].y);
            o[j].z = fmaf(x.z, ws, o[j].z);
            o[j].w = fmaf(x.w, ws, o[j].w);
          }
        }
    }
  }
  stamp(11);
  const long long row0 = (long long)job.b * job.Hq + job.h0;
  float* dst = to >= 0 ? job.acc(to) : static_cast<float*>(job.out) + row0 * D;
  bf16* out = static_cast<bf16*>(job.out) + row0 * D;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int v = tid + j * kThreads;
    if (v < row4) {
      float4 x = o[j];
      if (to < 0) {
        const float il = 1.f / fmaxf(sh.norm[v / d4], 1e-30f);
        x = make_float4(x.x * il, x.y * il, x.z * il, x.w * il);
      }
      if (to < 0 && job.out_bf16) {
        reinterpret_cast<__nv_bfloat162*>(out + 4 * v)[0] = __floats2bfloat162_rn(x.x, x.y);
        reinterpret_cast<__nv_bfloat162*>(out + 4 * v)[1] = __floats2bfloat162_rn(x.z, x.w);
      } else {
        reinterpret_cast<float4*>(dst)[v] = x;
      }
    }
  }
  for (int r = tid; r < nh; r += kThreads) {
    if (to >= 0) {
      job.ml(to)[r] = sh.m[r];
      job.ml(to)[hs + r] = sh.norm[r];
    } else if (job.lse) {
      job.lse[row0 + r] = sh.norm[r] > 0.f ? natural_lse(sh.m[r], sh.norm[r])
                                           : -__int_as_float(0x7f800000);
    }
  }
}

// The block's split is done and its partial written: take its group's
// ticket.  The group's last block merges the group; with more than one
// group it writes the group's partial and takes the unit's ticket, and the
// unit's last group merges the groups.
__device__ __noinline__ void merge_through_memory(const MergeJob job, Shared& sh, float* smem) {
  const int n = job.n_split, G = job.group, ng = merge_groups(n, G), g = job.split / G;
  int* tickets = job.tickets + job.unit() * (ng + 1);
  const int count = min(G, n - g * G);
  const bool last = last_arrival(sh, tickets + g, count);
  stamp(6);
  if (!last) return;
  if (threadIdx.x == 0) {
    mbar_init(&sh.bar[0]);
    mbar_init(&sh.bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int uses[2] = {0, 0};
  merge(job, sh, smem, g * G, count, ng > 1 ? n + g : -1, uses);
  if (ng > 1) {
    stamp(7);
    if (!last_arrival(sh, tickets + ng, ng)) return;
    merge(job, sh, smem, n, ng, -1, uses);
  }
  stamp(8);
}

// A split with no valid key: an empty partial (m = -inf, l = 0; acc is not
// written, its weight being 0), then the merge.
template <typename TQ>
__device__ void empty_partial(const Params& p, const Block& bk, Shared& sh, float* smem) {
  const MergeJob job(p, bk, std::is_same_v<TQ, bf16>);
  float* ml = job.ml(bk.split);
  for (int r = threadIdx.x; r < bk.nh; r += kThreads) {
    ml[r] = kNegInf;
    ml[job.hs + r] = 0.f;
  }
  stamp(5);
  merge_through_memory(job, sh, smem);
}

// The block's partial from its (m, l) in sh and acc (nh x D, rows ld floats
// apart, ld % 4 == 0, summed over kParts copies kHeads * ld floats apart in
// order: the tensor-core kernel's warps), then the merge.
template <typename TQ, int kParts>
__device__ void split_partial(const Params& p, const Block& bk, Shared& sh, const float* acc,
                              int ld, float* smem) {
  const MergeJob job(p, bk, std::is_same_v<TQ, bf16>);
  float* part = job.acc(bk.split);
  float* ml = job.ml(bk.split);
  const int D = p.D, d4 = D / 4, hs = job.hs;
#pragma unroll 4
  for (int v = threadIdx.x; v < bk.nh * d4; v += kThreads) {
    const int r = v / d4, at = r * ld + 4 * (v - r * d4);
    float4 s = *reinterpret_cast<const float4*>(acc + at);
#pragma unroll
    for (int w = 1; w < kParts; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(acc + w * kHeads * ld + at);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    reinterpret_cast<float4*>(part)[v] = s;
  }
  for (int r = threadIdx.x; r < bk.nh; r += kThreads) {
    ml[r] = sh.m[r];
    ml[hs + r] = sh.l[r];
  }
  stamp(5);
  merge_through_memory(job, sh, smem);
}

// The block's q rows h0 .. h0 + nh, 16 bytes a load (rows 16-byte aligned,
// which the wrapper ensures), rows up to kHeads zero.  load() issues every
// load of the thread at once; put() hands each piece of EP values over as
// put(row, column, values).  Loaded before the K/V copies are issued, q does
// not queue behind them.
template <typename TQ, int DMAX>
struct QRows {
  static constexpr int EP = 16 / sizeof(TQ);
  static constexpr int QV = kHeads * DMAX / EP / kThreads;
  uint4 raw[QV];
  __device__ void load(const Params& p, const Block& bk) {
    const int qpr = p.D / EP;
    const TQ* qb = static_cast<const TQ*>(p.q) + bk.b * p.q_sb + (long long)bk.h0 * p.q_sh;
#pragma unroll
    for (int j = 0; j < QV; ++j) {
      const int idx = threadIdx.x + j * kThreads, r = idx / qpr;
      raw[j] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < kHeads * qpr && r < bk.nh)
        raw[j] = *reinterpret_cast<const uint4*>(qb + r * p.q_sh + (idx - r * qpr) * EP);
    }
  }
  template <typename Put>
  __device__ void put(int D, Put f) const {
    const int qpr = D / EP;
#pragma unroll
    for (int j = 0; j < QV; ++j) {
      const int idx = threadIdx.x + j * kThreads, r = idx / qpr;
      if (idx >= kHeads * qpr) break;
      f(r, (idx - r * qpr) * EP, reinterpret_cast<const TQ*>(&raw[j]));
    }
  }
};

// ================================================================ CUDA cores
// fp32 arithmetic, any D % 8 == 0.  Shared memory: fp32 q (pre-scaled by
// scale * log2 e) and acc (kHeads x D), probabilities (kHeads x kCcTile)
// and alpha (kHeads), then two K and two V tiles in the cache's type, K rows
// padded by 16 bytes against bank conflicts.
__host__ __device__ inline int cc_float_words(int d) {
  return 2 * kHeads * d + kHeads * kCcTile + kHeads;
}
__host__ __device__ inline int cc_smem_bytes(int d, int kv_bytes) {
  const int vec = 16 / kv_bytes;
  return 4 * cc_float_words(d) + 2 * kCcTile * (2 * d + vec) * kv_bytes;
}

template <typename TQ, typename TKV, bool kLse, bool kPasses, bool kMemory>
__global__ void __launch_bounds__(kThreads) decode_cc_kernel(const Params p) {
  using TO = std::conditional_t<kLse, float, TQ>;
  constexpr int VEC = Vec<TKV>::N;
  __shared__ Shared sh;
  extern __shared__ float4 smem4[];
  const Block bk(p);
  const Mask mk(p, bk.b);
  const int D = p.D, nh = bk.nh, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kstride = D + VEC;
  float* qs = reinterpret_cast<float*>(smem4);   // kHeads x D
  float* acc = qs + kHeads * D;                  // kHeads x D
  float* ps = acc + kHeads * D;                  // kHeads x kCcTile
  float* as = ps + kHeads * kCcTile;             // kHeads
  TKV* kbuf = reinterpret_cast<TKV*>(qs + cc_float_words(D));  // 2 x kCcTile x kstride
  TKV* vbuf = kbuf + 2 * kCcTile * kstride;                    // 2 x kCcTile x D

  stamp(0);
  int live_splits = 0, n_live;
  int pk0 = bk.k0, pk1 = min(bk.k1, bk.k0 + kPassKeys);   // the pass
  QRows<TQ, 256> qrows;
  if constexpr (kMemory) {   // the block's own split only; the lengths form needs no load for it
    if (p.mode == 0 && bk.k0 >= mk.len) return empty_partial<TQ>(p, bk, sh, qs);
    qrows.load(p, bk);       // in flight while the split's keys are marked
    n_live = find_live<kCcTile>(sh, mk, pk0, pk1, false);
    if (n_live == 0 && pk1 >= bk.k1) return empty_partial<TQ>(p, bk, sh, qs);
  } else {
    live_splits = census(sh, p, mk, bk.k0, bk.k1);
    if (empty_split<TO, kLse>(p, bk, sh, acc, D, live_splits)) return;
    n_live = find_live<kCcTile>(sh, mk, pk0, pk1, p.mode == 1);
  }
  stamp(1);
  const TKV* kb = static_cast<const TKV*>(p.k) + bk.b * p.k_sb + bk.g * p.k_sh;
  const TKV* vb = static_cast<const TKV*>(p.v) + bk.b * p.v_sb + bk.g * p.v_sh;
  const int vec_per_row = D / VEC;
  auto issue = [&](int i, int buf) {
    const int t = sh.live[i];
    TKV* kd = kbuf + buf * kCcTile * kstride;
    TKV* vd = vbuf + buf * kCcTile * D;
    for (int idx = tid; idx < kCcTile * vec_per_row; idx += kThreads) {
      const int r = idx / vec_per_row, c = (idx - r * vec_per_row) * VEC;
      const bool valid = (sh.vm[t] >> r) & 1u;
      const long long key = pk0 + (valid ? t * kCcTile + r : 0);
      cp_async16(kd + r * kstride + c, kb + key * p.k_ss + c, valid);
      cp_async16(vd + r * D + c, vb + key * p.v_ss + c, valid);
    }
    cp_async_commit();
  };
  if constexpr (!kMemory) qrows.load(p, bk);
  if (n_live) issue(0, 0);
  stamp(2);
  const float qscale = p.scale * kLog2e;
  qrows.put(D, [&](int r, int c, const TQ* v) {
#pragma unroll
    for (int e = 0; e < QRows<TQ, 256>::EP; ++e) {
      qs[r * D + c + e] = to_f32(v[e]) * qscale;
      acc[r * D + c + e] = 0.f;
    }
  });
  for (int r = tid; r < nh; r += kThreads) {
    sh.m[r] = kNegInf;
    sh.l[r] = 0.f;
  }

  const int rgroups = (nh + kRepTile - 1) / kRepTile;
  const int dvec = D / 4;
  for (;;) {
    int buf = 0;
    for (int i = 0; i < n_live; ++i, buf ^= 1) {
      if (i + 1 < n_live) {
        issue(i + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (i == 0) stamp(3);
      const unsigned bits = sh.vm[sh.live[i]];
      const TKV* ks = kbuf + buf * kCcTile * kstride;
      const TKV* vs = vbuf + buf * kCcTile * D;

      // 1. scores: a thread owns kRepTile query heads and one key.
      for (int idx = tid; idx < kCcTile * rgroups; idx += kThreads) {
        const int t = idx % kCcTile, r0 = (idx / kCcTile) * kRepTile;
        const TKV* kr = ks + t * kstride;
        const float* qr[kRepTile];
#pragma unroll
        for (int j = 0; j < kRepTile; ++j) qr[j] = qs + min(r0 + j, nh - 1) * D;
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
        const bool valid = (bits >> t) & 1u;
#pragma unroll
        for (int j = 0; j < kRepTile; ++j)
          if (r0 + j < nh) ps[(r0 + j) * kCcTile + t] = valid ? s[j] : kNegInf;
      }
      __syncthreads();

      // 2. online softmax in base 2: one warp per query head, one lane per key.
      for (int r = warp; r < nh; r += kWarps) {
        const float s = ps[r * kCcTile + lane];
        float mx = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = sh.m[r];
        const float m_new = fmaxf(m_prev, mx);   // finite: a listed tile holds a valid key
        const float pr = ((bits >> lane) & 1u) ? exp2f(s - m_new) : 0.f;
        ps[r * kCcTile + lane] = pr;
        float sum = pr;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float alpha = exp2f(m_prev - m_new);
          sh.l[r] = sh.l[r] * alpha + sum;
          as[r] = alpha;
          sh.m[r] = m_new;
        }
      }
      __syncthreads();

      // 3. acc = acc * alpha + p @ V: a thread owns 4 columns of one head.
      for (int idx = tid; idx < nh * dvec; idx += kThreads) {
        const int r = idx / dvec, c = (idx - r * dvec) * 4;
        float4 a = *reinterpret_cast<float4*>(acc + r * D + c);
        const float alpha = as[r];
        a.x *= alpha; a.y *= alpha; a.z *= alpha; a.w *= alpha;
        const float* pr = ps + r * kCcTile;
#pragma unroll 8
        for (int t = 0; t < kCcTile; ++t) {
          const float pv = pr[t];
          const float4 vv = Vec<TKV>::load4(vs + t * D + c);
          a.x += pv * vv.x; a.y += pv * vv.y; a.z += pv * vv.z; a.w += pv * vv.w;
        }
        *reinterpret_cast<float4*>(acc + r * D + c) = a;
      }
      __syncthreads();
    }
    if (!kPasses || pk1 >= bk.k1) break;
    pk0 = pk1;                       // the next pass: every tile of this one is done
    pk1 = min(bk.k1, pk0 + kPassKeys);
    n_live = find_live<kCcTile>(sh, mk, pk0, pk1, false);
    if (n_live) issue(0, 0);
  }
  stamp(4);
  if constexpr (kMemory) {
    split_partial<TQ, 1>(p, bk, sh, acc, D, qs);
  } else {
    stamp(5);
    finish<TO, kLse>(p, bk, sh, acc, D, live_splits);
    stamp(8);
  }
}

// ================================================================ tensor cores
// bf16 cache, D % 16 == 0, DMAX >= D.  Shared memory: q as bf16 (kHeads x
// (D + 8); an fp32 q also its rounding error), then kStages K and V tiles
// of kTcTile rows, rows padded by 16 bytes so ldmatrix reads 8 rows without
// bank conflicts.
__host__ __device__ inline int tc_smem_bytes(int d, bool split_q) {
  return ((split_q ? 2 : 1) * kHeads + 2 * kStages * kTcTile) * (d + 8) * 2;
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
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <typename TQ, int DMAX, bool kLse, bool kPasses, bool kMemory>
__global__ void __launch_bounds__(kThreads) decode_tc_kernel(const Params p) {
  using TO = std::conditional_t<kLse, float, TQ>;
  constexpr bool kSplitQ = sizeof(TQ) == 4;
  constexpr int NT = DMAX / 8;                 // n-tiles of the output
  __shared__ Shared sh;
  extern __shared__ float4 smem4[];
  const Block bk(p);
  const Mask mk(p, bk.b);
  const int D = p.D, LD = D + 8, nh = bk.nh, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  bf16* Qh = reinterpret_cast<bf16*>(smem4);
  bf16* Ql = Qh + kHeads * LD;
  bf16* Ks = Ql + (kSplitQ ? kHeads * LD : 0);
  bf16* Vs = Ks + kStages * kTcTile * LD;

  // the end's kWarps x kHeads rows of the warps' sums, LDR floats apart:
  // 8 floats of padding keep float2 stores of 8 rows free of bank conflicts
  float* red = reinterpret_cast<float*>(Ks);
  const int LDR = D + 8;
  float* smem = reinterpret_cast<float*>(smem4);
  stamp(0);
  int live_splits = 0, n_live;
  int pk0 = bk.k0, pk1 = min(bk.k1, bk.k0 + kPassKeys);   // the pass
  QRows<TQ, DMAX> qrows;
  if constexpr (kMemory) {   // the block's own split only; the lengths form needs no load for it
    if (p.mode == 0 && bk.k0 >= mk.len) return empty_partial<TQ>(p, bk, sh, smem);
    qrows.load(p, bk);       // in flight while the split's keys are marked
    n_live = find_live<kTcTile>(sh, mk, pk0, pk1, false);
    if (n_live == 0 && pk1 >= bk.k1) return empty_partial<TQ>(p, bk, sh, smem);
  } else {
    live_splits = census(sh, p, mk, bk.k0, bk.k1);
    if (empty_split<TO, kLse>(p, bk, sh, red, LDR, live_splits)) return;
    n_live = find_live<kTcTile>(sh, mk, pk0, pk1, p.mode == 1);
  }
  stamp(1);
  const bf16* kb = static_cast<const bf16*>(p.k) + bk.b * p.k_sb + bk.g * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + bk.b * p.v_sb + bk.g * p.v_sh;
  // this thread's 16-byte pieces of a tile: row << 9 | column, the same for
  // every tile (D % 16 == 0, so a tile is vpr / 2 rounds of the block)
  const int vpr = D / 8;
  int piece[DMAX / 16];
#pragma unroll
  for (int j = 0; j < DMAX / 16; ++j) {
    const int idx = tid + j * kThreads, r = idx / vpr;
    piece[j] = r << 9 | (idx - r * vpr) * 8;
  }
  auto issue = [&](int i) {
    if (i < n_live) {
      const int t = sh.live[i], st = i % kStages;
      bf16* kd = Ks + st * kTcTile * LD;
      bf16* vd = Vs + st * kTcTile * LD;
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) {
        if (2 * j >= vpr) break;
        const int r = piece[j] >> 9, c = piece[j] & 511;
        const int rel = t * kTcTile + r;
        const bool valid = key_bit(sh, rel);
        const long long key = pk0 + (valid ? rel : 0);
        cp_async16(kd + r * LD + c, kb + key * p.k_ss + c, valid);
        cp_async16(vd + r * LD + c, vb + key * p.v_ss + c, valid);
      }
    }
    cp_async_commit();   // possibly empty, so every step waits on the same count
  };
  if constexpr (!kMemory) qrows.load(p, bk);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  stamp(2);
  // q into shared memory as bf16 (an fp32 q as hi and lo parts)
  qrows.put(D, [&](int r, int c, const TQ* v) {
#pragma unroll
    for (int e = 0; e < QRows<TQ, DMAX>::EP; ++e) {
      const float x = to_f32(v[e]);
      const bf16 h = __float2bfloat16_rn(x);
      Qh[r * LD + c + e] = h;
      if (kSplitQ) Ql[r * LD + c + e] = __float2bfloat16_rn(x - __bfloat162float(h));
    }
  });

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const float sl2 = p.scale * kLog2e;
  const int ksteps = D / 16;
  const int qoff = (lane & 15) * LD + (lane >> 4) * 8;                         // A: q
  const int koff = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;  // B: K
  const int voff = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;     // B: V

  for (;;) {
    for (int i = 0; i < n_live; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();               // tile i landed; every warp is done with tile i - 1
      if (i == 0) stamp(3);
      issue(i + kStages - 1);        // into tile i - 1's stage
      const int t = sh.live[i], st = i % kStages;
      const bf16* kt = Ks + (st * kTcTile + warp * 16) * LD;   // this warp's 16 keys
      const bf16* vt = Vs + (st * kTcTile + warp * 16) * LD;

      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks) {
        if (ks >= ksteps) break;
        uint32_t a[4], b[4];
        ldsm_x4(b, kt + koff + ks * 16);
        ldsm_x4(a, Qh + qoff + ks * 16);
        mma16816(sc[0], a, b[0], b[1]);
        mma16816(sc[1], a, b[2], b[3]);
        if (kSplitQ) {
          ldsm_x4(a, Ql + qoff + ks * 16);
          mma16816(sc[0], a, b[0], b[1]);
          mma16816(sc[1], a, b[2], b[3]);
        }
      }
      // this warp's 16 keys: bits of word t * 2 + warp / 2, half warp % 2
      const unsigned bits = (sh.vm[t * 2 + (warp >> 1)] >> ((warp & 1) * 16)) & 0xffffu;
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = (bits >> (8 * j + 2 * (lane & 3) + (e & 1))) & 1u;
          const float s = valid ? sc[j][e] * sl2 : kNegInf;
          sc[j][e] = s;
          mx[e >> 1] = fmaxf(mx[e >> 1], s);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = exp2f(m_run[h] - mx[h]);
        m_run[h] = mx[h];
        l_run[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = (bits >> (8 * j + 2 * (lane & 3) + (e & 1))) & 1u;
          const float pr = valid ? exp2f(sc[j][e] - m_run[e >> 1]) : 0.f;
          sc[j][e] = pr;
          l_run[e >> 1] += pr;
        }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      // the score fragments are P's A fragment (rows g, g + 8; keys 0-7, 8-15);
      // with an fp32 q, P's rounding error goes in as a second product
      uint32_t pa[4], pl[4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x0 = sc[j][2 * h], x1 = sc[j][2 * h + 1];
          pa[2 * j + h] = pack_bf16(x0, x1);
          if (kSplitQ) {
            const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(&pa[2 * j + h]);
            pl[2 * j + h] = pack_bf16(x0 - __low2float(r), x1 - __high2float(r));
          }
        }
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        if (jj < ksteps) {
          uint32_t b[4];
          ldsm_x4_t(b, vt + voff + jj * 16);
          mma16816(acc[2 * jj], pa, b[0], b[1]);
          mma16816(acc[2 * jj + 1], pa, b[2], b[3]);
          if (kSplitQ) {
            mma16816(acc[2 * jj], pl, b[0], b[1]);
            mma16816(acc[2 * jj + 1], pl, b[2], b[3]);
          }
        }
      }
    }
    if (!kPasses || pk1 >= bk.k1) break;
    pk0 = pk1;
    pk1 = min(bk.k1, pk0 + kPassKeys);
    cp_async_wait<0>();
    __syncthreads();                 // every warp is done with this pass's words and tiles
    n_live = find_live<kTcTile>(sh, mk, pk0, pk1, false);
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) issue(i);
  }
  cp_async_wait<0>();
  __syncthreads();                 // the stage buffers are free from here
  stamp(4);

  // merge the four warps' (m, l, acc) in warp order; red reuses the K tiles
  const int g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    if ((lane & 3) == 0) {
      sh.wm[warp][g + 8 * h] = m_run[h];
      sh.wl[warp][g + 8 * h] = l_run[h];
    }
  }
  __syncthreads();
  float sc2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float M = sh.wm[0][g + 8 * h];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, sh.wm[w][g + 8 * h]);
    sc2[h] = exp2f(m_run[h] - M);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int row = g + 8 * (e >> 1), col = 8 * n + 2 * (lane & 3);
      if (n < 2 * ksteps)
        *reinterpret_cast<float2*>(red + (warp * kHeads + row) * LDR + col) =
            make_float2(acc[n][e] * sc2[e >> 1], acc[n][e + 1] * sc2[e >> 1]);
    }
  if (tid < kHeads) {
    float M = sh.wm[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, sh.wm[w][tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) L += sh.wl[w][tid] * exp2f(sh.wm[w][tid] - M);
    sh.m[tid] = M;
    sh.l[tid] = L;
  }
  __syncthreads();
  // the warps' sums in warp order: straight to the workspace, or in place
  // over warp 0's rows
  if constexpr (kMemory) {
    split_partial<TQ, kWarps>(p, bk, sh, red, LDR, smem);
    return;
  }
  for (int i = tid; i < nh * D; i += kThreads) {
    const int at = (i / D) * LDR + i % D;
    float s = red[at];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * kHeads * LDR + at];
    red[at] = s;
  }
  __syncthreads();
  stamp(5);
  finish<TO, kLse>(p, bk, sh, red, LDR, live_splits);
  stamp(8);
}

// The row's n_split blocks (grid.x) form one cluster, unless they merge
// through device memory: then the merge's weights and a partial must fit
// the dynamic shared memory.
template <typename K>
int launch(K kernel, dim3 grid, int smem, const Params& p, cudaStream_t st) {
  Params lp = p;
  const int merge_smem = 4 * kMergeFloats + 4 * kHeads * p.D;
  if (p.ws && smem < merge_smem) smem = merge_smem;
  lp.smem = smem;
  if (smem + (int)sizeof(Shared) > 48 * 1024) {   // past 48 KB with the static part: opt in
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.ws ? 0 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, lp);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// kPasses: splits longer than kPassKeys, streamed in passes (the loop over
// passes is compiled out of the instances that shorter splits take).
template <typename TQ, bool kLse, bool kPasses, bool kMemory = false>
int launch_q(const Params& p, bool kv_bf16, dim3 grid, cudaStream_t st) {
  const bool split_q = sizeof(TQ) == 4;
  if (kv_bf16 && p.D % 16 == 0) {
    const int smem = tc_smem_bytes(p.D, split_q);
    if (p.D <= 64)
      return launch(decode_tc_kernel<TQ, 64, kLse, kPasses, kMemory>, grid, smem, p, st);
    if (p.D <= 128)
      return launch(decode_tc_kernel<TQ, 128, kLse, kPasses, kMemory>, grid, smem, p, st);
    return launch(decode_tc_kernel<TQ, 256, kLse, kPasses, kMemory>, grid, smem, p, st);
  }
  if (kv_bf16)
    return launch(decode_cc_kernel<TQ, bf16, kLse, kPasses, kMemory>, grid, cc_smem_bytes(p.D, 2),
                  p, st);
  return launch(decode_cc_kernel<TQ, float, kLse, kPasses, kMemory>, grid, cc_smem_bytes(p.D, 4),
                p, st);
}

// One family of instances: q's type picks bf16 or float.
template <bool kLse, bool kPasses, bool kMemory>
int launch_family(const void* params, int q_bf16, int kv_bf16, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  const dim3 grid(p.n_split, p.Hkv * p.mgroups, p.B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return q_bf16 ? launch_q<bf16, kLse, kPasses, kMemory>(p, kv_bf16 != 0, grid, st)
                : launch_q<float, kLse, kPasses, kMemory>(p, kv_bf16 != 0, grid, st);
}

}  // namespace

// The instances come in four families: short splits, splits streamed in
// passes, the log-sum-exp form and the merge through memory.  The merge
// through memory (a non-null ws) and the log-sum-exp form (a non-null lse)
// have instances of their own, so the others compile as they did before
// them; their splits of any length take the instances with the loop over
// passes (a short split runs it once), and the merge through memory's
// instances write the lse form's outputs when the launch asks for them.
// Built whole (DECODE_ATTENTION_PART undefined) the source is one
// translation unit; built in parts, part k (0-3) compiles family k alone,
// part 0 with the entry point, so that nvcc compiles the four at once and
// the parts link into one library.  A family's launcher takes the Params
// by address, since each translation unit has its own anonymous namespace.
#ifndef DECODE_ATTENTION_PART
#define DECODE_ATTENTION_PART -1
#endif
#define DECODE_ATTENTION_FAMILY(k) (DECODE_ATTENTION_PART < 0 || DECODE_ATTENTION_PART == (k))

extern "C" {
int decode_attention_short(const void* p, int q_bf16, int kv_bf16, void* st);
int decode_attention_passes(const void* p, int q_bf16, int kv_bf16, void* st);
int decode_attention_lse(const void* p, int q_bf16, int kv_bf16, void* st);
int decode_attention_memory(const void* p, int q_bf16, int kv_bf16, void* st);

#if DECODE_ATTENTION_FAMILY(0)
int decode_attention_short(const void* p, int q_bf16, int kv_bf16, void* st) {
  return launch_family<false, false, false>(p, q_bf16, kv_bf16, st);
}
#endif
#if DECODE_ATTENTION_FAMILY(1)
int decode_attention_passes(const void* p, int q_bf16, int kv_bf16, void* st) {
  return launch_family<false, true, false>(p, q_bf16, kv_bf16, st);
}
#endif
#if DECODE_ATTENTION_FAMILY(2)
int decode_attention_lse(const void* p, int q_bf16, int kv_bf16, void* st) {
  return launch_family<true, true, false>(p, q_bf16, kv_bf16, st);
}
#endif
#if DECODE_ATTENTION_FAMILY(3)
int decode_attention_memory(const void* p, int q_bf16, int kv_bf16, void* st) {
  return launch_family<false, true, true>(p, q_bf16, kv_bf16, st);
}
#endif
}  // extern "C"

#if DECODE_ATTENTION_FAMILY(0)
// ptrs: q, k, v, lengths, slot_pos, q_pos, out, lse (null: no lse), and
// the merge through device memory's workspace and int32 counters at 0 (both
// null: a row's splits, at most kMaxSplits, are one cluster).
// strides (elements): q (b, h), k (b, s, h), v (b, s, h), slot_pos (b);
// the last dimension of q, k, v and slot_pos is contiguous.
// With lse, out is float32 whatever q's type.
// dims: mode, B, Hq, Hkv, S, D, n_split, split keys, window, chunk, q_bf16,
// kv_bf16, and the splits a group of the merge through memory (the wrapper
// sizes the workspace: units x (n_split + groups) partials of hs x D +
// ml_floats(hs) floats, and the counters: units x (groups + 1)).  Returns
// 0, a CUDA error code, or -1 for sizes not taken.
extern "C" int decode_attention_launch(void* const* ptrs, const long long* strides,
                                       const int* dims, float scale, void* stream) {
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.lengths = static_cast<const int*>(ptrs[3]);
  p.slot_pos = static_cast<const int*>(ptrs[4]);
  p.q_pos = static_cast<const int*>(ptrs[5]);
  p.out = ptrs[6];
  p.lse = static_cast<float*>(ptrs[7]);
  p.ws = static_cast<float*>(ptrs[8]);
  p.tickets = static_cast<int*>(ptrs[9]);
  p.q_sb = strides[0]; p.q_sh = strides[1];
  p.k_sb = strides[2]; p.k_ss = strides[3]; p.k_sh = strides[4];
  p.v_sb = strides[5]; p.v_ss = strides[6]; p.v_sh = strides[7];
  p.sp_sb = strides[8];
  p.mode = dims[0]; p.B = dims[1]; p.Hq = dims[2]; p.Hkv = dims[3]; p.S = dims[4];
  p.D = dims[5]; p.n_split = dims[6]; p.chunk = dims[7]; p.window = dims[8];
  p.attn_chunk = dims[9];
  p.group = dims[12];
  p.smem = 0;
  const bool q_bf16 = dims[10] != 0, kv_bf16 = dims[11] != 0;
  p.scale = scale;
  if (p.Hkv < 1 || p.Hq % p.Hkv || p.D % 8 || p.D < 8 || p.D > 256 || p.S < 1) return -1;
  p.rep = p.Hq / p.Hkv;
  p.mgroups = (p.rep + kHeads - 1) / kHeads;
  if (p.n_split < 1 || p.chunk % kTcTile || (long long)p.n_split * p.chunk < p.S ||
      (long long)(p.n_split - 1) * p.chunk >= p.S)
    return -1;
  if (p.ws ? !p.tickets || p.group < 1 || p.group > kMaxMerge ||
                 merge_groups(p.n_split, p.group) > kMaxMerge
           : p.n_split > kMaxSplits)
    return -1;
  if (p.B > 65535 || (long long)p.Hkv * p.mgroups > 65535) return -1;
  if ((p.mode == 0 && !p.lengths) || (p.mode == 1 && (!p.slot_pos || !p.q_pos))) return -1;
  const int qb = q_bf16, kb = kv_bf16;
  if (p.ws) return decode_attention_memory(&p, qb, kb, stream);
  if (p.lse) return decode_attention_lse(&p, qb, kb, stream);
  if (p.chunk > kPassKeys) return decode_attention_passes(&p, qb, kb, stream);
  return decode_attention_short(&p, qb, kb, stream);
}

#ifdef DECODE_ATTENTION_STAMPS
// Where the kernel's phase stamps go: kStamps a block, blocks numbered
// (z * gridDim.y + y) * gridDim.x + x, up to `blocks` of them (null: none).
extern "C" int decode_attention_stamps(void* buf, long long blocks) {
  unsigned long long* b = static_cast<unsigned long long*>(buf);
  cudaError_t err = cudaMemcpyToSymbol(g_stamps, &b, sizeof(b));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_stamp_blocks, &blocks, sizeof(blocks));
  return (int)err;
}
#endif
#endif  // DECODE_ATTENTION_FAMILY(0)
