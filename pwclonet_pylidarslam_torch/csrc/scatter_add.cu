// Deterministic row scatter-add on Hopper (sm_90a):
//   out[b, n, :] = sum over { m : idx[b, m] == n } of upd[b, m, :],
// each row starting at 0.0f and adding its updates in ascending m, one fp32
// add at a time: the order of a sequential loop over m (index_add_ on the
// CPU), to the bit.
//
// Replaces: pwclonet_pylidarslam_tpu/ops/pallas/gather_kernel.py::
// _scatter_add_kernel (entry point scatter_add_rows), the backward of the
// row gather. The TPU kernel walks the updates one by one over an output
// slab held in VMEM, which its sequential grid makes race-free, and falls
// back to XLA when the slab is too large or M is no multiple of 128. Blocks
// run in parallel here, so the work is turned around: every output row sums
// its own updates. No slab limit, no fallback, any M and N, no float atomics.
//
// What bounds it: bytes. It reads M indices and M*C updates and writes N*C
// sums, with one add per update element.
//
// Design: the index is inverted stably, so that each row's segment lists its
// updates already in ascending m, in three kernels and no memset; a fourth
// sums. No kernel ranks a segment by re-reading it, so a segment of L entries
// costs O(L) work, however skewed the index. The work is cut into tiles of
// `tile` consecutive entries of one sample (a power of two, at least 256 and
// at least N, picked by the wrapper: the tiles' counts then take at most
// M + tile ints, and a sample's tiles are few enough for the scan to walk):
//   1. scatter_rank_kernel: a block takes one tile; each of its 8 warps
//      walks its eighth of the tile in order, 32 entries a step (the rows of
//      kBatch steps loaded at once). Within a step, an entry's rank among its
//      row's entries is the count of lower lanes with the same row
//      (__match_any_sync, __popc); across steps a warp-private counter per
//      row in shared memory carries it. Then the
//      warps' counts are prefix-summed per row (warp order is m order), the
//      tile's count of each row goes to `offs`, and each entry's rank within
//      the tile is fixed up by its warp's prefix. Rows that do not fit in
//      shared memory at once are taken in passes of kKeyPass.
//   2. scatter_scan_kernel: per sample, offs[tile][row] becomes the first
//      slot of that (row, tile) piece: the rows' totals are scanned, and
//      each row's tiles follow in order.
//   3. scatter_fill_kernel: each entry writes its m at offs[its tile][its
//      row] + its rank: every segment now lists ascending m.
//   4. scatter_sum_kernel: one thread per (row, channel), the rows of a block
//      packed so that lanes do not idle at odd C. It reads its segment's m
//      kAhead at a time and issues their update loads before the adds,
//      which stay in order. A segment of L entries costs L adds, whatever L.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeyPass = 4096;  // rows a pass counts: 8 warps x 4096 x 4 B = 128 KB
constexpr int kBatch = 8;       // steps of 32 entries whose rows a warp loads at once
constexpr int kScanThreads = 1024;
constexpr int kSumThreads = 512;  // (row, channel) pairs a sum block aims at
constexpr int kAhead = 8;         // update loads in flight per thread
constexpr int kMaxGridY = 65535;
constexpr int kUnsupportedShape = -1;  // as kUnsupported in tf32x3.cuh

// counts: shared, [kWarps][rows of the pass]
__global__ void __launch_bounds__(kThreads)
scatter_rank_kernel(const int* __restrict__ idx, int b_count, int n, int m, int tile, int tiles,
                    int* __restrict__ rank, int* __restrict__ offs) {
  extern __shared__ int counts[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int span = tile / kWarps;  // a multiple of 32
  const int first = blockIdx.x * tile + warp * span;
  const int last = min(first + span, m);
  for (int b = blockIdx.y; b < b_count; b += gridDim.y) {
    const int* key = idx + static_cast<int64_t>(b) * m;
    int* rk = rank + static_cast<int64_t>(b) * m;
    int* tile_offs = offs + (static_cast<int64_t>(b) * tiles + blockIdx.x) * n;
    for (int k0 = 0; k0 < n; k0 += kKeyPass) {
      const int kc = min(kKeyPass, n - k0);
      int* mine = counts + warp * kc;
      __syncthreads();  // the previous pass has read the counts
      for (int i = threadIdx.x; i < kWarps * kc; i += kThreads) counts[i] = 0;
      __syncthreads();
      for (int e0 = first; e0 < last; e0 += 32 * kBatch) {  // bounds uniform over the warp
        int k[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int e = e0 + j * 32 + lane;
          k[j] = e < last ? key[e] - k0 : -1;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (e0 + j * 32 >= last) break;
          const bool in = k[j] >= 0 && k[j] < kc;
          const unsigned peers = __match_any_sync(0xffffffffu, in ? k[j] : -1);
          const int before = in ? mine[k[j]] : 0;
          __syncwarp();
          if (in) {
            rk[e0 + j * 32 + lane] = before + __popc(peers & lower);
            if ((peers & lower) == 0) mine[k[j]] = before + __popc(peers);
          }
          __syncwarp();
        }
      }
      __syncthreads();
      // prefix over the warps of each row: warp order is m order
      for (int k = threadIdx.x; k < kc; k += kThreads) {
        int run = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int c = counts[w * kc + k];
          counts[w * kc + k] = run;
          run += c;
        }
        tile_offs[k0 + k] = run;
      }
      __syncthreads();
      for (int e0 = first; e0 < last; e0 += 32 * kBatch) {
        int k[kBatch], r[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int e = e0 + j * 32 + lane;
          k[j] = e < last ? key[e] - k0 : -1;
          r[j] = k[j] >= 0 && k[j] < kc ? rk[e] : 0;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (k[j] >= 0 && k[j] < kc) rk[e0 + j * 32 + lane] = r[j] + mine[k[j]];
        }
      }
    }
  }
}

// One block per sample: offs[b, t, k] (the count of row k in tile t) becomes
// the slot where tile t's entries of row k begin in the sample's segments.
__global__ void __launch_bounds__(kScanThreads)
scatter_scan_kernel(int* __restrict__ offs, int b_count, int n, int tiles) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = blockIdx.x; b < b_count; b += gridDim.x) {
    int* o = offs + static_cast<int64_t>(b) * tiles * n;
    if (threadIdx.x == 0) carry = 0;
    for (int k0 = 0; k0 < n; k0 += kScanThreads) {
      const int k = k0 + threadIdx.x;
      int total = 0;
      if (k < n) {
#pragma unroll 8
        for (int t = 0; t < tiles; ++t) total += o[static_cast<int64_t>(t) * n + k];
      }
      int incl = total;
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      if (lane == 31) warp_sums[warp] = incl;
      __syncthreads();  // also: carry is written
      if (warp == 0) {
        int s = warp_sums[lane];
        for (int off = 1; off < 32; off <<= 1) {
          const int up = __shfl_up_sync(0xffffffffu, s, off);
          if (lane >= off) s += up;
        }
        warp_sums[lane] = s;  // inclusive over the warps
      }
      __syncthreads();
      int run = carry + (warp ? warp_sums[warp - 1] : 0) + incl - total;
      if (k < n) {
#pragma unroll 8
        for (int t = 0; t < tiles; ++t) {
          const int64_t i = static_cast<int64_t>(t) * n + k;
          const int c = o[i];
          o[i] = run;
          run += c;
        }
      }
      __syncthreads();  // every thread has read carry and warp_sums
      if (threadIdx.x == kScanThreads - 1) carry = run;
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_fill_kernel(const int* __restrict__ idx, const int* __restrict__ rank,
                    const int* __restrict__ offs, int b_count, int n, int m, int tile_shift,
                    int tiles, int* __restrict__ members) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= m) return;
  for (int b = blockIdx.y; b < b_count; b += gridDim.y) {
    const int64_t i = static_cast<int64_t>(b) * m + e;
    const int t = e >> tile_shift;
    const int slot = offs[(static_cast<int64_t>(b) * tiles + t) * n + idx[i]] + rank[i];
    members[static_cast<int64_t>(b) * m + slot] = e;
  }
}

// Block: tile_rows rows of one sample x C channels, one thread each (or one
// row whose channels the threads stride over, when C exceeds the block).
__global__ void __launch_bounds__(1024)
scatter_sum_kernel(const float* __restrict__ upd, const int* __restrict__ members,
                   const int* __restrict__ offs, int b_count, int n, int m, int c, int tiles,
                   int tile_rows, float* __restrict__ out) {
  const int r = threadIdx.x / c;
  const int k = blockIdx.x * tile_rows + r;
  if (r >= tile_rows || k >= n) return;
  const int ch0 = threadIdx.x - r * c;
  for (int b = blockIdx.y; b < b_count; b += gridDim.y) {
    const int* starts = offs + static_cast<int64_t>(b) * tiles * n;  // tile 0: the row starts
    const int s0 = starts[k];
    const int s1 = k + 1 < n ? starts[k + 1] : m;
    const int* mem = members + static_cast<int64_t>(b) * m;
    const float* u = upd + static_cast<int64_t>(b) * m * c;
    float* o = out + (static_cast<int64_t>(b) * n + k) * c;
    for (int ch = ch0; ch < c; ch += blockDim.x) {
      float acc = 0.0f;
      int s = s0;
      for (; s + kAhead <= s1; s += kAhead) {
        float v[kAhead];
#pragma unroll
        for (int j = 0; j < kAhead; ++j) v[j] = __ldg(u + static_cast<int64_t>(mem[s + j]) * c + ch);
#pragma unroll
        for (int j = 0; j < kAhead; ++j) acc += v[j];
      }
      for (; s < s1; ++s) acc += __ldg(u + static_cast<int64_t>(mem[s]) * c + ch);
      o[ch] = acc;
    }
  }
}

unsigned grid_y(int b) { return static_cast<unsigned>(b < kMaxGridY ? b : kMaxGridY); }

}  // namespace

// upd (B, M, C) f32, idx (B, M) i32 in [0, N), out (B, N, C) f32. tile: the
// entries of a rank tile, a power of two >= 256; scratch: scratch_ints ints
// that the caller allocates, at least 2*B*M + B*tiles*N with tiles =
// max(1, ceil(M / tile)) (ranks, members, then the tiles' offsets). Every row
// of out is written. Returns kUnsupportedShape for a tile or scratch it does
// not take.
extern "C" int pwclo_scatter_add(const void* upd, const void* idx, int b, int n, int m, int c,
                                 int tile, void* scratch, long long scratch_ints, void* out,
                                 void* stream_ptr) {
  if (static_cast<int64_t>(b) * n * c == 0) return 0;
  if (tile < kThreads || (tile & (tile - 1)) != 0) return kUnsupportedShape;
  const int tiles = m > 0 ? (m + tile - 1) / tile : 1;
  const int64_t need = 2 * static_cast<int64_t>(b) * m + static_cast<int64_t>(b) * tiles * n;
  if (scratch_ints < need) return kUnsupportedShape;
  int tile_shift = 0;
  while ((1 << tile_shift) < tile) ++tile_shift;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int* rank = static_cast<int*>(scratch);
  int* members = rank + static_cast<int64_t>(b) * m;
  int* offs = members + static_cast<int64_t>(b) * m;
  const int* index = static_cast<const int*>(idx);

  const int pass = n < kKeyPass ? n : kKeyPass;
  const size_t smem = sizeof(int) * kWarps * pass;
  cudaError_t err = cudaFuncSetAttribute(scatter_rank_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_rank_kernel<<<dim3(tiles, grid_y(b)), kThreads, smem, stream>>>(index, b, n, m, tile,
                                                                        tiles, rank, offs);
  scatter_scan_kernel<<<static_cast<unsigned>(b), kScanThreads, 0, stream>>>(offs, b, n, tiles);
  if (m > 0) {
    scatter_fill_kernel<<<dim3((m + kThreads - 1) / kThreads, grid_y(b)), kThreads, 0, stream>>>(
        index, rank, offs, b, n, m, tile_shift, tiles, members);
  }
  const int tile_rows = c >= kSumThreads ? 1 : kSumThreads / c;
  int threads = tile_rows * c;
  threads = threads > 1024 ? 1024 : (threads + 31) / 32 * 32;
  scatter_sum_kernel<<<dim3((n + tile_rows - 1) / tile_rows, grid_y(b)), threads, 0, stream>>>(
      static_cast<const float*>(upd), members, offs, b, n, m, c, tiles, tile_rows,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
