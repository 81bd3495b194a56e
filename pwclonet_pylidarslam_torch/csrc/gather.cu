// Row gather on Hopper (sm_90a): out[b, m, :] = src[b, idx[b, m], :].
//
// Replaces: pwclonet_pylidarslam_tpu/ops/pallas/gather_kernel.py::_gather_kernel
// (entry points gather_rows / _gather_fwd_impl). Unlike the TPU kernel,
// which keeps the whole source slab in VMEM and falls back to XLA's gather
// when the slab is too large, this kernel takes every shape: the source
// stays in device memory and the 50 MB L2 holds it at the main path's sizes.
//
// What bounds it: bytes. It reads M indices and the indexed source rows and
// writes M*C floats, with no arithmetic; the train step's widest calls write
// 35-40 MB (B=8 M=16,384 C=67; B=16 M=32,768 C=19).
//
// Design: a block copies a tile of whole output rows of one sample (the
// sample is blockIdx.y) as one flat run of words, so every warp stores whole
// contiguous runs.
// - The tile's indices are read once, coalesced, into shared memory; each
//   word reads its row's index there.
// - Thread t copies floats t, t + kThreads, ... of the run. Its (row,
//   channel) starts at one 32-bit division and then steps by adding
//   (kThreads / C, kThreads % C) with a carry: no division in the loop, and
//   the only 64-bit arithmetic is the base of the sample, of the tile and of
//   each source row (one wide multiply-add).
// - Single floats: the path's widths (3, 19, 35, 67) are odd, so wider
//   words would not be legal on it.
// - kUnroll floats are loaded before any is stored, with no branch between
//   the loads, and the stores stream (st.global.cs), so the source rows stay
//   in L2 and the output passes by.
// Words are copied as they are, never computed on: the result is bit-exact.
// Indices are assumed in range, as in the reference.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// floats of a block's tile (at least one row): kThreads * kUnroll, so that
// each thread loads its floats at once; twice that from kWideFrom floats a
// call on, where the card still gets about eight blocks an SM and fewer,
// longer blocks move bytes faster; one float a thread below kNarrowTo
// floats, where the call is short and its latency is the time
constexpr int kTileWords = kThreads * kUnroll;
constexpr int kMaxTileWords = 2 * kTileWords;
constexpr int64_t kWideFrom = int64_t{2} << 20;
constexpr int64_t kNarrowTo = int64_t{1} << 15;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ src, const int* __restrict__ idx, int b_count, int n,
              int m, int w, int tile_rows, float* __restrict__ out) {
  // w: floats a row (C)
  __shared__ int rows[kMaxTileWords];  // tile_rows <= kMaxTileWords since w >= 1
  const int row0 = blockIdx.x * tile_rows;
  const int rows_here = min(tile_rows, m - row0);
  const int words = rows_here * w;  // <= max(kMaxTileWords, w)
  const int step_rows = kThreads / w, step_words = kThreads % w;
  const int r_first = threadIdx.x / w, c_first = threadIdx.x - r_first * w;
  for (int b = blockIdx.y; b < b_count; b += gridDim.y) {
    __syncthreads();  // the previous sample's indices are read
    const int* index = idx + static_cast<int64_t>(b) * m + row0;
    for (int i = threadIdx.x; i < rows_here; i += kThreads) rows[i] = index[i];
    __syncthreads();
    const float* s = src + static_cast<int64_t>(b) * n * w;
    float* o = out + (static_cast<int64_t>(b) * m + row0) * w;
    int r = r_first, c = c_first;
    for (int e = threadIdx.x; e < words; e += kThreads * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // every load issued, past the end from the last row: a load under
        // a branch would wait for the one before it
        v[u] = __ldg(s + static_cast<int64_t>(rows[min(r, rows_here - 1)]) * w + c);
        r += step_rows;
        c += step_words;
        if (c >= w) {
          c -= w;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (e + u * kThreads < words) __stcs(o + e + u * kThreads, v[u]);
      }
    }
  }
}

}  // namespace

// src (B, N, C) f32, idx (B, M) i32, out (B, M, C) f32.
extern "C" int pwclo_gather(const void* src, const void* idx, int b, int n, int m, int c,
                            void* out, void* stream_ptr) {
  const int64_t words = static_cast<int64_t>(b) * m * c;
  if (words == 0) return 0;
  const int tile = words >= kWideFrom ? kMaxTileWords : words < kNarrowTo ? kThreads : kTileWords;
  const int tile_rows = c >= tile ? 1 : tile / c;
  const dim3 grid(static_cast<unsigned>((m + tile_rows - 1) / tile_rows),
                  static_cast<unsigned>(b < kMaxGridY ? b : kMaxGridY));
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(src), static_cast<const int*>(idx), b, n, m, c, tile_rows,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
