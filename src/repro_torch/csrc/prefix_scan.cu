// Inclusive int32 prefix sum along the last axis, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `prefix_scan_pallas` in
// src/repro/kernels/prefix_scan/prefix_scan.py (body `_scan_kernel`) and
// computes the same function: y[r, j] = sum of x[r, 0..j], in int32, for a
// (rows, length) array of bool/uint8 or int32 values.  The TPU kernel forms
// each (8, 128) tile's sums as a float32 MXU product against a triangular
// ones matrix, exact only below 2^24; this kernel adds integers directly, so
// it is exact for every length (int32 wraps as torch.cumsum's int32 does).
//
// Bound: device-memory bytes.  A call reads each input element once (1 byte
// for a mask) and writes 4 bytes of int32 per element, and does one add per
// element: the sweep's (65536, 10000) bool blocks move 3.28 GB (0.98 ms at
// 3.35 TB/s), the DCN tier carve's 131,072 rows of 64 entries 41.9 MB
// (12.5 us).  Rows are independent, so the design fills the card with rows
// and keeps loads in flight.  The route (which kernel, how many lanes a row,
// vector or element access, the grid) is chosen by the wrapper's
// `scan_route` and passed in; this file adds no heuristic of its own.
//
//   * warp route: a row belongs to a team of LANES lanes (a power of two up
//     to 32) inside one warp, so a warp holds 32 / LANES rows at once (16
//     rows of 64 entries in a block of 256 threads) and scans them with
//     __shfl_up_sync of width LANES: no shared memory, no barrier.  A team
//     walks its row in tiles of 4 * LANES elements with the carry in a
//     register.  The grid is persistent: each warp takes every W-th group of
//     rows, and its (group, tile) items stream U at a time, the next U
//     items' loads sent before the current ones are scanned;
//   * block route, for long rows too few to give every SM its warps: a block
//     of 256 threads owns a row at a time and walks it in tiles of 1024
//     elements, U tiles a step, the next step's loads in flight while the
//     current one is scanned: a warp-shuffle scan of each thread's total,
//     then the warps' totals of all U tiles through shared memory (double
//     buffered: one __syncthreads a step);
//   * thread t holds 4 neighbouring elements of a tile: one 4-byte (uchar4)
//     or 16-byte (int4) load and one 16-byte (int4) store, neighbouring
//     threads on neighbouring addresses, so a warp reads 128 contiguous
//     bytes of a mask and writes 512 contiguous bytes of sums;
//   * rows that cannot take vector access (a length that is not a multiple
//     of 4, or a base pointer off the vector's alignment) take the same
//     routes with element loads and stores under bounds checks (VEC false).
// A few very long rows (fewer rows than SMs, each of 2^16 elements or more)
// run on the block route, one block a row: correct, but it leaves most SMs
// idle; no main path launches that shape.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                     // elements per thread per tile
constexpr unsigned kFull = 0xffffffffu;

// Loads of 4 neighbouring elements; a 1-byte element's four travel packed in
// one word.  `live` false loads zeros.
template <typename T, bool VEC>
struct Io;

template <bool VEC>
struct Io<uint8_t, VEC> {
  using Raw = unsigned;
  static constexpr int kSteps = 8;            // items in flight per step
  static __device__ __forceinline__ Raw load(const uint8_t* __restrict__ row, long long col,
                                             long long len, bool live) {
    if (!live) return 0u;
    if constexpr (VEC) return *reinterpret_cast<const unsigned*>(row + col);
    unsigned r = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (col + j < len) r |= unsigned(row[col + j]) << (8 * j);
    return r;
  }
  static __device__ __forceinline__ void unpack(Raw r, unsigned (&v)[kItems]) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = (r >> (8 * j)) & 0xffu;
  }
};

template <bool VEC>
struct Io<int32_t, VEC> {
  using Raw = uint4;
  static constexpr int kSteps = 4;
  static __device__ __forceinline__ Raw load(const int32_t* __restrict__ row, long long col,
                                             long long len, bool live) {
    if (!live) return make_uint4(0u, 0u, 0u, 0u);
    if constexpr (VEC) return *reinterpret_cast<const uint4*>(row + col);
    unsigned v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = col + j < len ? unsigned(row[col + j]) : 0u;
    return make_uint4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ void unpack(Raw r, unsigned (&v)[kItems]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
};

template <bool VEC>
__device__ __forceinline__ void store_items(int32_t* __restrict__ row, long long col,
                                            long long len, const unsigned (&v)[kItems]) {
  if constexpr (VEC) {
    *reinterpret_cast<int4*>(row + col) = make_int4(int(v[0]), int(v[1]), int(v[2]), int(v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (col + j < len) row[col + j] = int(v[j]);
  }
}

// The thread's 4 elements scanned in place; returns their total.
__device__ __forceinline__ unsigned scan_items(unsigned (&v)[kItems]) {
#pragma unroll
  for (int j = 1; j < kItems; ++j) v[j] += v[j - 1];
  return v[kItems - 1];
}

// Sums are kept as unsigned so that overflow wraps (defined) as int32 would.
// Both kernels stream their items through two register buffers of U items,
// a and b: while the items of a are scanned the loads of b are in flight,
// and the reverse, so two steps' loads are outstanding at every wait.
template <typename T, int LANES, bool VEC>
__global__ void __launch_bounds__(kThreads)
    prefix_scan_warp_kernel(const T* __restrict__ x, int32_t* __restrict__ y, long long rows,
                            long long len) {
  using IO = Io<T, VEC>;
  using Raw = typename IO::Raw;
  constexpr int U = IO::kSteps;
  constexpr int kRows = 32 / LANES;           // rows a warp holds at once
  constexpr int kTile = LANES * kItems;       // elements of a row a tile
  const int lane = threadIdx.x & 31;
  const int sub = lane / LANES;               // the warp's row this lane serves
  const int tl = lane % LANES;                // the lane's place in its team
  const long long warp = (blockIdx.x * (long long)kThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  const long long ntiles = (len + kTile - 1) / kTile;
  const long long groups = (rows + kRows - 1) / kRows;
  // this warp's items: (group, tile) for its groups warp, warp + warps, ...
  // and each group's tiles in order; the same count on every lane
  const long long items = warp < groups ? ((groups - 1 - warp) / warps + 1) * ntiles : 0;
  const long long col0 = (long long)tl * kItems;

  long long lg = warp, lk = 0;                // next item to load: group, tile
  long long sg = warp, sk = 0;                // next item to scan
  unsigned carry = 0;
  auto fetch = [&](Raw (&buf)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = lg * kRows + sub, c = lk * kTile + col0;
      buf[u] = IO::load(x + r * len, c, len, r < rows && c < len);
      if (++lk == ntiles) { lk = 0; lg += warps; }
    }
  };
  auto consume = [&](const Raw (&buf)[U], long long i0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u >= items) break;             // uniform across the warp
      unsigned v[kItems];
      IO::unpack(buf[u], v);
      const unsigned own = scan_items(v);
      unsigned incl = own;                    // inclusive scan of the team's lane totals
#pragma unroll
      for (int o = 1; o < LANES; o <<= 1) {
        const unsigned n = __shfl_up_sync(kFull, incl, o, LANES);
        if (tl >= o) incl += n;
      }
      const unsigned total = __shfl_sync(kFull, incl, LANES - 1, LANES);
      if (sk == 0) carry = 0;
      const unsigned add = carry + incl - own;
#pragma unroll
      for (int j = 0; j < kItems; ++j) v[j] += add;
      const long long r = sg * kRows + sub, c = sk * kTile + col0;
      if (r < rows && c < len) store_items<VEC>(y + r * len, c, len, v);
      carry += total;
      if (++sk == ntiles) { sk = 0; sg += warps; }
    }
  };
  Raw a[U], b[U];
  if (items > 0) fetch(a);
  for (long long i0 = 0; i0 < items; i0 += 2 * U) {
    if (i0 + U < items) fetch(b);
    consume(a, i0);
    if (i0 + 2 * U < items) fetch(a);
    if (i0 + U < items) consume(b, i0 + U);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    prefix_scan_block_kernel(const T* __restrict__ x, int32_t* __restrict__ y, long long rows,
                             long long len) {
  using IO = Io<T, VEC>;
  using Raw = typename IO::Raw;
  constexpr int U = 4;                        // tiles a step
  constexpr int kTile = kThreads * kItems;
  __shared__ unsigned warp_total[2][U][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ntiles = (len + kTile - 1) / kTile;
  // this block's items: (row, tile) for its rows blockIdx.x + k * gridDim.x
  const long long items =
      blockIdx.x < rows ? ((rows - 1 - blockIdx.x) / gridDim.x + 1) * ntiles : 0;
  const long long col0 = (long long)threadIdx.x * kItems;

  long long lr = blockIdx.x, lk = 0;          // next tile to load: row, tile
  long long sr = blockIdx.x, sk = 0;          // next tile to scan
  unsigned carry = 0;
  int buf = 0;
  auto fetch = [&](Raw (&raw)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long c = lk * kTile + col0;
      raw[u] = IO::load(x + lr * len, c, len, lr < rows && c < len);
      if (++lk == ntiles) { lk = 0; lr += gridDim.x; }
    }
  };
  auto consume = [&](const Raw (&raw)[U], long long i0) {
    unsigned v[U][kItems], incl[U], own[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      IO::unpack(raw[u], v[u]);
      own[u] = scan_items(v[u]);
      incl[u] = own[u];
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const unsigned n = __shfl_up_sync(kFull, incl[u], o);
        if (lane >= o) incl[u] += n;
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int u = 0; u < U; ++u) warp_total[buf][u][warp] = incl[u];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u >= items) break;             // uniform across the block
      unsigned before = 0, tile = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const unsigned t = warp_total[buf][u][w];
        before += w < warp ? t : 0u;
        tile += t;
      }
      if (sk == 0) carry = 0;
      const unsigned add = carry + before + incl[u] - own[u];
#pragma unroll
      for (int j = 0; j < kItems; ++j) v[u][j] += add;
      const long long c = sk * kTile + col0;
      if (c < len) store_items<VEC>(y + sr * len, c, len, v[u]);
      carry += tile;
      if (++sk == ntiles) { sk = 0; sr += gridDim.x; }
    }
    buf ^= 1;   // the next step writes the other buffer: one barrier a step
  };
  Raw a[U], b[U];
  if (items > 0) fetch(a);
  for (long long i0 = 0; i0 < items; i0 += 2 * U) {
    if (i0 + U < items) fetch(b);
    consume(a, i0);
    if (i0 + 2 * U < items) fetch(a);
    if (i0 + U < items) consume(b, i0 + U);
  }
}

template <typename T, bool VEC>
int launch_warp(const T* x, int32_t* y, long long rows, long long len, int lanes, int grid,
                cudaStream_t st) {
  switch (lanes) {
    case 1: prefix_scan_warp_kernel<T, 1, VEC><<<grid, kThreads, 0, st>>>(x, y, rows, len); break;
    case 2: prefix_scan_warp_kernel<T, 2, VEC><<<grid, kThreads, 0, st>>>(x, y, rows, len); break;
    case 4: prefix_scan_warp_kernel<T, 4, VEC><<<grid, kThreads, 0, st>>>(x, y, rows, len); break;
    case 8: prefix_scan_warp_kernel<T, 8, VEC><<<grid, kThreads, 0, st>>>(x, y, rows, len); break;
    case 16: prefix_scan_warp_kernel<T, 16, VEC><<<grid, kThreads, 0, st>>>(x, y, rows, len); break;
    case 32: prefix_scan_warp_kernel<T, 32, VEC><<<grid, kThreads, 0, st>>>(x, y, rows, len); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

template <typename T, bool VEC>
int launch(const T* x, int32_t* y, long long rows, long long len, int route, int lanes,
           int grid, cudaStream_t st) {
  if (route == 0) return launch_warp<T, VEC>(x, y, rows, len, lanes, grid, st);
  if (route != 1) return int(cudaErrorInvalidValue);
  prefix_scan_block_kernel<T, VEC><<<grid, kThreads, 0, st>>>(x, y, rows, len);
  return int(cudaGetLastError());
}

template <typename T>
int launch_kind(const void* x, void* y, long long rows, long long len, int route, int lanes,
                int vec, int grid, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  int32_t* yt = static_cast<int32_t*>(y);
  return vec ? launch<T, true>(xt, yt, rows, len, route, lanes, grid, st)
             : launch<T, false>(xt, yt, rows, len, route, lanes, grid, st);
}

}  // namespace

// x: (rows, len) contiguous, kind 0 = 1-byte elements (bool, uint8), 1 = int32;
// y: (rows, len) int32 contiguous.  route 0 = warp (lanes a row: 1, 2, 4, 8,
// 16 or 32), 1 = block.  vec: every row of x starts on a 4-byte (uint8) or
// 16-byte (int32) boundary, every row of y on a 16-byte one, and len is a
// multiple of 4.  grid: blocks of 256 threads.  Returns the CUDA error code
// of the launch (0 on success).
extern "C" int prefix_scan_launch(const void* x, void* y, long long rows, long long len, int kind,
                                  int route, int lanes, int vec, int grid, void* stream) {
  if (rows <= 0 || len <= 0) return 0;
  if (grid <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) return launch_kind<uint8_t>(x, y, rows, len, route, lanes, vec, grid, st);
  if (kind == 1) return launch_kind<int32_t>(x, y, rows, len, route, lanes, vec, grid, st);
  return int(cudaErrorInvalidValue);
}
