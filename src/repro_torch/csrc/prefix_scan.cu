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
// element: on the sweep's (65536, 10000) bool blocks that is 655 MB read and
// 2621 MB written, 0.98 ms at 3.35 TB/s.  So the design only has to keep
// enough loads in flight and every access coalesced:
//   * one block of 256 threads owns one row at a time (a grid-stride loop
//     over rows) and walks it in tiles of 1024 elements; the TPU kernel's
//     sequential column grid with a VMEM carry becomes this loop with the
//     running carry in a register;
//   * thread t holds elements 4t .. 4t+3 of a tile: one 4-byte (uchar4) or
//     16-byte (int4) load and one 16-byte (int4) store, neighbouring threads
//     on neighbouring addresses, so a warp reads 128 contiguous bytes of a
//     mask and writes 512 contiguous bytes of sums;
//   * the next tile's load is issued before the current tile is scanned;
//   * a tile's scan is the thread's own 4 items, a warp-shuffle scan of the
//     thread totals, and the 8 warp totals through shared memory (double
//     buffered, so one __syncthreads per tile);
//   * rows whose start is not vector-aligned (a length that is not a multiple
//     of 4, or an offset base pointer) and the ragged last tile take scalar
//     loads and stores with bounds checks.
// Many rows of moderate length (the sweep) fill the card with one block per
// row; one very long row runs on one block, which is correct but slow -- a
// multi-block decoupled look-back scan is later work.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                     // elements per thread per tile
constexpr int kTile = kThreads * kItems;      // elements per tile
constexpr long long kMaxGrid = 1 << 20;

__device__ __forceinline__ void load_items(const uint8_t* __restrict__ row, long long col,
                                           long long len, bool vec, unsigned (&v)[kItems]) {
  if (vec && col + kItems <= len) {
    const uchar4 q = *reinterpret_cast<const uchar4*>(row + col);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = col + j < len ? unsigned(row[col + j]) : 0u;
  }
}

__device__ __forceinline__ void load_items(const int32_t* __restrict__ row, long long col,
                                           long long len, bool vec, unsigned (&v)[kItems]) {
  if (vec && col + kItems <= len) {
    const int4 q = *reinterpret_cast<const int4*>(row + col);
    v[0] = unsigned(q.x); v[1] = unsigned(q.y); v[2] = unsigned(q.z); v[3] = unsigned(q.w);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = col + j < len ? unsigned(row[col + j]) : 0u;
  }
}

__device__ __forceinline__ void store_items(int32_t* __restrict__ row, long long col,
                                            long long len, bool vec,
                                            const unsigned (&v)[kItems]) {
  if (vec && col + kItems <= len) {
    *reinterpret_cast<int4*>(row + col) = make_int4(int(v[0]), int(v[1]), int(v[2]), int(v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (col + j < len) row[col + j] = int(v[j]);
  }
}

// Sums are kept as unsigned so that overflow wraps (defined) as int32 would.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    prefix_scan_kernel(const T* __restrict__ x, int32_t* __restrict__ y, long long rows,
                       long long len, int in_vec, int out_vec) {
  __shared__ unsigned warp_total[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long offset = (long long)threadIdx.x * kItems;
  int buf = 0;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * len;
    int32_t* yr = y + r * len;
    unsigned carry = 0;
    unsigned next[kItems];
    load_items(xr, offset, len, in_vec, next);
    for (long long c0 = 0; c0 < len; c0 += kTile) {
      unsigned v[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) v[j] = next[j];
      if (c0 + kTile < len) load_items(xr, c0 + kTile + offset, len, in_vec, next);
#pragma unroll
      for (int j = 1; j < kItems; ++j) v[j] += v[j - 1];
      const unsigned total = v[kItems - 1];
      unsigned incl = total;                   // inclusive scan of thread totals in the warp
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned n = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += n;
      }
      if (lane == 31) warp_total[buf][warp] = incl;
      __syncthreads();
      unsigned before = 0, tile = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const unsigned t = warp_total[buf][w];
        before += w < warp ? t : 0u;
        tile += t;
      }
      buf ^= 1;   // the next tile writes the other buffer: one barrier per tile
      const unsigned add = carry + before + incl - total;
#pragma unroll
      for (int j = 0; j < kItems; ++j) v[j] += add;
      store_items(yr, c0 + offset, len, out_vec, v);
      carry += tile;
    }
  }
}

}  // namespace

// x: (rows, len) contiguous, kind 0 = 1-byte elements (bool, uint8), 1 = int32;
// y: (rows, len) int32 contiguous.  in_vec / out_vec: every row of x / y
// starts on a 4-byte (uint8) or 16-byte (int32, y) boundary and len is a
// multiple of 4.  Returns the CUDA error code of the launch (0 on success).
extern "C" int prefix_scan_launch(const void* x, void* y, long long rows, long long len, int kind,
                                  int in_vec, int out_vec, void* stream) {
  if (rows <= 0 || len <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = unsigned(rows < kMaxGrid ? rows : kMaxGrid);
  if (kind == 0)
    prefix_scan_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(x), static_cast<int32_t*>(y), rows, len, in_vec, out_vec);
  else
    prefix_scan_kernel<int32_t><<<grid, kThreads, 0, st>>>(
        static_cast<const int32_t*>(x), static_cast<int32_t*>(y), rows, len, in_vec, out_vec);
  return int(cudaGetLastError());
}
