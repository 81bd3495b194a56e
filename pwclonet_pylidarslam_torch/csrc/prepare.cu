// The deep odometry's scan preparation on Hopper (sm_90a), a chunk of scans
// at a time: of each scan the rows away from the origin listed in order (the
// keep kernel), then, once the host has drawn from each scan's count of kept
// rows, the drawn rows copied out (the take kernel).
//
// Replaces no TPU kernel: the reference prepares each scan in numpy on the
// host (pwclonet_pylidarslam_tpu/slam/deep_odometry.py::
// PWCLONetOdometry._prepare), and so did the port until the preparation of
// whole sweeps (~114k rows each) paced the odometry: the origin test and the
// boolean row copy were ~85 % of the host's work. The draw stays numpy's, on
// the host: it depends on the count alone.
//
// The chunk's scans lie in one rows buffer (R, 3), float32 or float64 as the
// scans came, scan b at rows offsets[b] .. offsets[b + 1] (int64, T + 1
// entries).
//
// What bounds it: bytes. The keep kernel reads the rows once (12 bytes a
// float32 row, ~43 MB for 32 sweeps) and writes an int a kept row; the take
// kernel reads T * n indices and rows and writes T * n float32 rows.
//
// Keep: one block a scan, as ordered compaction needs a running count. A
// tile of kThreads * kItems rows at a time; warp w tests rows w * kWarpRows
// + u * 32 + lane (u < kItems), so that its ballots, taken in u order, list
// its rows in order, and each load of a warp reads 32 neighbouring rows. The
// ballots give each kept row its rank in its warp; the block's warp totals,
// scanned by every warp with shuffles after the tile's one barrier (the
// totals double-buffered, so no second barrier), give the warp's start. The
// test is numpy's norm in the rows' dtype: each square rounded, summed left
// to right (numpy's reduction over a last axis of 3), a correctly rounded
// square root, compared > 1e-6 (1e-6f for float32 rows); the source is
// compiled with --fmad=false and writes each rounding out besides.
//
// Take: out[b, j] = rows[offsets[b] + keep[offsets[b] + idx[b, j]]], a thread
// a row. Float32 words are copied as they are, float64 ones rounded to the
// nearest float32 as numpy's astype rounds them: the result is bit-exact.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // 32: one warp scans the totals
constexpr int kItems = 8;
constexpr int kWarpRows = 32 * kItems;
constexpr int kTileRows = kThreads * kItems;
constexpr int kTakeThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ bool away_from_origin(const float* row) {
  const float x = row[0], y = row[1], z = row[2];
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  return __fsqrt_rn(s) > 1e-6f;
}

__device__ __forceinline__ bool away_from_origin(const double* row) {
  const double x = row[0], y = row[1], z = row[2];
  const double s = __dadd_rn(__dadd_rn(__dmul_rn(x, x), __dmul_rn(y, y)), __dmul_rn(z, z));
  return __dsqrt_rn(s) > 1e-6;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
keep_kernel(const T* __restrict__ rows, const int64_t* __restrict__ offsets,
            int* __restrict__ keep, int* __restrict__ counts) {
  __shared__ int totals[2][kWarps];
  const int b = blockIdx.x;
  const int64_t first = offsets[b];
  const int hits = static_cast<int>(offsets[b + 1] - first);
  const T* scan = rows + first * 3;
  int* out = keep + first;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int base = 0;  // rows kept before the tile
  int buf = 0;
  for (int tile = 0; tile < hits; tile += kTileRows) {
    const int r0 = tile + warp * kWarpRows + lane;
    bool kept[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      // every load issued, past the end from the last row: a load under a
      // branch would wait for the one before it
      const int r = r0 + u * 32;
      kept[u] = away_from_origin(scan + static_cast<int64_t>(min(r, hits - 1)) * 3) && r < hits;
    }
    unsigned ballot[kItems];
    int total = 0;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      ballot[u] = __ballot_sync(kAll, kept[u]);
      total += __popc(ballot[u]);
    }
    if (lane == 0) totals[buf][warp] = total;
    __syncthreads();
    const int mine = totals[buf][lane];
    int sum = mine;  // inclusive scan over the warps
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kAll, sum, d);
      if (lane >= d) sum += v;
    }
    int pos = base + __shfl_sync(kAll, sum - mine, warp);
    base += __shfl_sync(kAll, sum, 31);
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (kept[u]) out[pos + __popc(ballot[u] & below)] = r0 + u * 32;
      pos += __popc(ballot[u]);
    }
    buf ^= 1;
  }
  if (threadIdx.x == 0) counts[b] = base;
}

template <typename T>
__global__ void __launch_bounds__(kTakeThreads)
take_kernel(const T* __restrict__ rows, const int64_t* __restrict__ offsets,
            const int* __restrict__ keep, const int* __restrict__ idx, int t, int n,
            float* __restrict__ out) {
  const int j = blockIdx.x * kTakeThreads + threadIdx.x;
  if (j >= n) return;
  for (int b = blockIdx.y; b < t; b += gridDim.y) {
    const int64_t first = offsets[b];
    const int64_t at = static_cast<int64_t>(b) * n + j;
    const T* src = rows + (first + keep[first + idx[at]]) * 3;
    float* dst = out + at * 3;
    dst[0] = static_cast<float>(src[0]);  // round to nearest, even on a tie
    dst[1] = static_cast<float>(src[1]);
    dst[2] = static_cast<float>(src[2]);
  }
}

}  // namespace

// rows (R, 3) f32, or f64 where f64 is 1, offsets (T + 1) i64, keep (R) i32,
// counts (T) i32: scan b's k-th kept row (k < counts[b]) is row
// keep[offsets[b] + k] of the scan.
extern "C" int pwclo_prepare_keep(const void* rows, const void* offsets, int t, int f64,
                                  void* keep, void* counts, void* stream_ptr) {
  if (t == 0) return 0;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* first = static_cast<const int64_t*>(offsets);
  if (f64)
    keep_kernel<<<t, kThreads, 0, stream>>>(static_cast<const double*>(rows), first,
                                            static_cast<int*>(keep), static_cast<int*>(counts));
  else
    keep_kernel<<<t, kThreads, 0, stream>>>(static_cast<const float*>(rows), first,
                                            static_cast<int*>(keep), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// rows, offsets, keep, f64 as above, idx (T, n) i32 (each < its scan's
// count), out (T, n, 3) f32.
extern "C" int pwclo_prepare_take(const void* rows, const void* offsets, const void* keep,
                                  const void* idx, int t, int n, int f64, void* out,
                                  void* stream_ptr) {
  if (t == 0 || n == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kTakeThreads - 1) / kTakeThreads),
                  static_cast<unsigned>(t < kMaxGridY ? t : kMaxGridY));
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* first = static_cast<const int64_t*>(offsets);
  const auto* kept = static_cast<const int*>(keep);
  const auto* drawn = static_cast<const int*>(idx);
  if (f64)
    take_kernel<<<grid, kTakeThreads, 0, stream>>>(static_cast<const double*>(rows), first, kept,
                                                   drawn, t, n, static_cast<float*>(out));
  else
    take_kernel<<<grid, kTakeThreads, 0, stream>>>(static_cast<const float*>(rows), first, kept,
                                                   drawn, t, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
