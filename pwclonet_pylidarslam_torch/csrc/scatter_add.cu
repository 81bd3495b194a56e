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
// Design: two entry points. A plan inverts an index once, stably, so that
// each row's segment lists its updates already in ascending m; a sum reads
// a plan and the updates and writes every row, in one launch. A caller that
// sums many update tensors over one index (the pose-graph back end, every
// Gauss-Newton and CG iteration of an optimization) builds one plan. No
// kernel ranks a segment by re-reading it, so a segment of L entries costs
// O(L) work, however skewed the index.
// The plan cuts the entries into tiles of `tile` consecutive entries of one
// sample (a power of two, at least 256 and at least N, picked by the
// wrapper: the tiles' counts then take at most M + tile ints, and a
// sample's tiles are few enough for the scan to walk), in three kernels and
// no memset (one block a sample doing all three in one launch took twice as
// long on a train step's calls, its walks over the entries serial):
//   1. scatter_rank_kernel: a block takes one tile; each of its 8 warps
//      walks its eighth of the tile in order, 32 entries a step (the rows of
//      kBatch steps loaded at once). Within a step, an entry's rank among its
//      row's entries is the count of lower lanes with the same row
//      (__match_any_sync, __popc); across steps a warp-private counter per
//      row in shared memory carries it. Then the warps' counts are
//      prefix-summed per row (warp order is m order), the tile's count of
//      each row goes to `offs`, and each entry's rank within the tile is
//      fixed up by its warp's prefix. Rows that do not fit in shared memory
//      at once are taken in passes of kKeyPass.
//   2. scatter_scan_kernel: per sample, offs[tile][row] becomes the first
//      slot of that (row, tile) piece: the rows' totals are scanned, and
//      each row's tiles follow in order. A row of more than kLongRow
//      entries is listed as long, with its first slot and length.
//   3. scatter_fill_kernel: each entry writes its m at offs[its tile][its
//      row] + its rank: every segment now lists ascending m.
// The sum is scatter_sum_kernel, one launch in which every block does two
// kinds of work:
//   - long rows first: the rows of more than kLongRow updates, split into
//     items of at most kGroup channels, item i to block i (mod the grid),
//     so that the first blocks, which start first, take them. A block
//     stages the segment's update rows in shared memory, kChunk elements a
//     stage, kStages - 1 stages in flight by cp.async, every thread copying;
//     the item's threads add a staged chunk's values in ascending m, each
//     channel its own chain, while the next chunks load. The member indices
//     of a chunk are copied kStages - 1 chunks before its updates, so no
//     thread waits on a global load but through the copies' group count.
//   - then its short rows: one thread per (row, channel), the rows of a
//     block packed so that lanes do not idle at odd C. It reads its
//     segment's m kAhead at a time and issues their update loads before the
//     adds, which stay in order. A row of L updates waits on about
//     2 L / kAhead loads in a row: a long row, on about
//     L * width / kChunk / (kStages - 1).
// No segment is ever split into partial sums: that would change the bits.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeyPass = 4096;  // rows a pass counts: 8 warps x 4096 x 4 B = 128 KB
constexpr int kBatch = 8;       // steps of 32 entries whose rows a warp loads at once
constexpr int kScanThreads = 1024;
constexpr int kSumThreads = 512;  // most (row, channel) pairs a sum block takes
constexpr int kAhead = 8;         // update loads in flight per short-row thread
constexpr int kMaxGridY = 65535;
constexpr int kUnsupportedShape = -1;  // as kUnsupported in tf32x3.cuh
// long rows
constexpr int kStages = 4;       // stages of updates: kStages - 1 in flight while one is added
constexpr int kChunk = 2048;     // update elements a stage holds (8 KB)
constexpr int kChunkRows = 256;  // most update rows a stage holds
constexpr int kRing = 2 * kStages;  // stages of member indices
constexpr int kLongBlocks = 4 * 132;  // blocks the long rows alone may ask for
// A row of more than kLongRow updates is summed from shared memory, by a
// block for each kGroup channels; a shorter one by a thread a channel.
// Chosen from copies of this file built with other values and timed at the
// calls of a train step on the KITTI-profile world and on random clouds and
// at a skewed row (tools/time_point_kernels.py --root build/<variant>).
// ops/gather.py::LONG_ROW sizes the plan's list of long rows by kLongRow.
constexpr int kLongRow = 128;
constexpr int kGroup = 16;

// counts: shared, [kWarps][rows of the pass]
__global__ void __launch_bounds__(kThreads)
scatter_rank_kernel(const int* __restrict__ idx, int b_count, int n, int m, int tile, int tiles,
                    int* __restrict__ rank, int* __restrict__ offs, int* __restrict__ long_count) {
  extern __shared__ int counts[];
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *long_count = 0;  // the scan lists
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
// A row of more than kLongRow entries goes on the list of long rows, as
// (b * n + k, its first slot, its length), in no particular order (each
// row's sum is its own).
__global__ void __launch_bounds__(kScanThreads)
scatter_scan_kernel(int* __restrict__ offs, int b_count, int n, int tiles,
                    int* __restrict__ long_rows, int* __restrict__ long_count) {
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
      if (k < n && total > kLongRow) {
        int* listed = long_rows + 3 * static_cast<int64_t>(atomicAdd(long_count, 1));
        listed[0] = b * n + k;
        listed[1] = run;  // the segment's first slot
        listed[2] = total;
      }
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

struct SumArgs {
  const float* upd;
  const int* members;
  const int* offs;       // (B, tiles, N): tile 0 of a sample holds its rows' first slots
  const int* long_rows;  // (b * n + k, first slot, length) of each long row
  const int* long_count;
  int n, m, c, tiles;
  int tile_rows, short_blocks;  // short rows: rows a block, and blocks, b * row_tiles
  int row_tiles;
  int groups, width, rows;  // a long row's channel groups, their width, update rows a stage
  float* out;
};

__device__ __forceinline__ void segment(const SumArgs& a, int b, int k, int* s0, int* s1) {
  const int* starts = a.offs + static_cast<int64_t>(b) * a.tiles * a.n;
  *s0 = starts[k];
  *s1 = k + 1 < a.n ? starts[k + 1] : a.m;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One (long row, channel group) item: the segment in chunks of a.rows
// update rows, a.width channels from c0. Commit group q holds the copies of
// chunk q's updates and of chunk q + kStages's member indices, so that a
// chunk's indices are in shared memory kStages - 1 chunks before its copies
// are issued: no thread waits on a global load but through the group
// count. kStages - 1 chunks are in flight while one is added. The indices of
// chunks q + kStages - 1 to q + 2 kStages - 1 are live at chunk q, and the
// first 2 kStages - 1 chunks' while the copies start: a ring of 2 kStages
// slots, so that no thread's copy overwrites indices that another thread
// has still to read.
__device__ void sum_long_item(const SumArgs& a, int listed, int g,
                              float (*stage)[kChunk], int (*ring)[kChunkRows]) {
  const int* at = a.long_rows + 3 * static_cast<int64_t>(listed);
  const int row = at[0], s0 = at[1], len = at[2];
  const int b = row / a.n, k = row - b * a.n;
  const int width = a.width, rows = a.rows;
  const int c0 = g * width;
  const int w = min(width, a.c - c0);
  const int chunks = (len + rows - 1) / rows;
  const int* mem = a.members + static_cast<int64_t>(b) * a.m + s0;
  const float* u = a.upd + static_cast<int64_t>(b) * a.m * a.c + c0;
  auto members_copy = [&](int q) {
    if (q >= chunks) return;
    const int j0 = q * rows, count = min(rows, len - j0);
    int* dst = ring[q % kRing];
    for (int j = threadIdx.x; j < count; j += blockDim.x) cp_async4(dst + j, mem + j0 + j);
  };
  auto updates_copy = [&](int q) {
    if (q >= chunks) return;
    const int count = min(rows, len - q * rows) * width;
    const int* mi = ring[q % kRing];
    float* dst = stage[q % kStages];
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      const int j = e / width, ch = e - j * width;
      if (ch < w) cp_async4(dst + e, u + static_cast<int64_t>(mi[j]) * a.c + ch);
    }
  };
  for (int q = 0; q < kStages; ++q) members_copy(q);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int q = 0; q < kStages - 1; ++q) {
    updates_copy(q);
    members_copy(q + kStages);
    cp_async_commit();
  }
  float acc = 0.0f;
  for (int q = 0; q < chunks; ++q) {
    cp_async_wait<kStages - 2>();  // group q: chunk q's updates have landed
    __syncthreads();  // ... for every thread; and chunk q - 1 is added
    updates_copy(q + kStages - 1);  // into the stage that chunk q - 1 held
    members_copy(q + 2 * kStages - 1);
    cp_async_commit();
    if (threadIdx.x < w) {  // kAhead values loaded, then added in order
      const float* src = stage[q % kStages] + threadIdx.x;
      const int nrows = min(rows, len - q * rows);
      int j = 0;
      for (; j + kAhead <= nrows; j += kAhead) {
        float v[kAhead];
#pragma unroll
        for (int i = 0; i < kAhead; ++i) v[i] = src[(j + i) * width];
#pragma unroll
        for (int i = 0; i < kAhead; ++i) acc += v[i];
      }
      for (; j < nrows; ++j) acc += src[j * width];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free for the next item
  if (threadIdx.x < w) a.out[(static_cast<int64_t>(b) * a.n + k) * a.c + c0 + threadIdx.x] = acc;
}

// Short rows: block q takes tile_rows rows of one sample x C channels, one
// thread each (or one row whose channels the threads stride over, when C
// exceeds the block), and leaves the long rows to their items. A thread
// reads its segment's m kAhead at a time and issues their update loads
// before the adds, which stay in order.
__device__ void sum_short_rows(const SumArgs& a, int q, int k, int s0, int s1) {
  const int b = q / a.row_tiles;
  const int c = a.c;
  const int ch0 = threadIdx.x - (threadIdx.x / c) * c;
  const int* __restrict__ mem = a.members + static_cast<int64_t>(b) * a.m;
  const float* __restrict__ u = a.upd + static_cast<int64_t>(b) * a.m * c;
  float* o = a.out + (static_cast<int64_t>(b) * a.n + k) * c;
  for (int ch = ch0; ch < c; ch += blockDim.x) {
    float acc = 0.0f;
    int s = s0;
    for (; s + kAhead <= s1; s += kAhead) {
      float v[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        v[j] = __ldg(u + static_cast<int64_t>(__ldg(mem + s + j)) * c + ch);
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) acc += v[j];
    }
    for (; s < s1; ++s) acc += __ldg(u + static_cast<int64_t>(__ldg(mem + s)) * c + ch);
    o[ch] = acc;
  }
}

// Every block first takes its long-row items (item i goes to block i mod
// the grid, so the first blocks, which start first, take them), then its
// short rows, if it has any.
// Three blocks of kSumThreads a multiprocessor: at most 42 registers a thread
// (the kernel takes 40). Measured against 64 registers (two blocks) and 32
// (four, with spills), it is the fastest of the three on the train steps'
// calls.
__global__ void __launch_bounds__(kSumThreads, 3) scatter_sum_kernel(SumArgs a) {
  __shared__ __align__(16) float stage[kStages][kChunk];
  __shared__ __align__(16) int ring[kRing][kChunkRows];
  const int q = blockIdx.x;
  const int r = threadIdx.x / a.c;
  const int k = (q - (q / a.row_tiles) * a.row_tiles) * a.tile_rows + r;
  const bool mine = q < a.short_blocks && r < a.tile_rows && k < a.n;
  int s0 = 0, s1 = 0;
  if (mine) segment(a, q / a.row_tiles, k, &s0, &s1);  // in flight with the count
  const int items = *a.long_count * a.groups;
  for (int item = q; item < items; item += gridDim.x) {
    const int listed = item / a.groups;
    sum_long_item(a, listed, item - listed * a.groups, stage, ring);
  }
  if (mine && s1 - s0 <= kLongRow) sum_short_rows(a, q, k, s0, s1);
}

unsigned grid_y(int b) { return static_cast<unsigned>(b < kMaxGridY ? b : kMaxGridY); }

// The plan's layout in `scratch`: ranks (B*M), members (B*M), the tiles'
// offsets (B*tiles*N, tile 0 the row starts), the long rows (3 ints each,
// room for B * (M / (kLongRow + 1)) of them: a long row takes more than
// kLongRow of its sample's entries), their count (1). Returns the ints it
// needs, or -1 for a shape it does not take.
int64_t plan_layout(int b, int n, int m, int tile, int* tiles, int64_t* long_capacity) {
  if (tile < kThreads || (tile & (tile - 1)) != 0) return -1;
  if (static_cast<int64_t>(b) * n > INT_MAX) return -1;  // long rows are listed as b * n + k
  *tiles = m > 0 ? (m + tile - 1) / tile : 1;
  *long_capacity = static_cast<int64_t>(b) * (m / (kLongRow + 1));
  return 2 * static_cast<int64_t>(b) * m + static_cast<int64_t>(b) * *tiles * n +
         3 * *long_capacity + 1;
}

}  // namespace

// Plans the sums over idx (B, M) i32 in [0, N): tile, the entries of a rank
// tile, a power of two >= 256; scratch: scratch_ints ints that the caller
// allocates and keeps for the sums, as plan_layout says. Returns
// kUnsupportedShape for a tile or scratch it does not take.
extern "C" int pwclo_scatter_plan(const void* idx, int b, int n, int m, int tile, void* scratch,
                                  long long scratch_ints, void* stream_ptr) {
  int tiles = 0;
  int64_t long_capacity = 0;
  const int64_t need = plan_layout(b, n, m, tile, &tiles, &long_capacity);
  if (need < 0 || scratch_ints < need) return kUnsupportedShape;
  if (static_cast<int64_t>(b) * n == 0) return 0;
  int tile_shift = 0;
  while ((1 << tile_shift) < tile) ++tile_shift;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int* rank = static_cast<int*>(scratch);
  int* members = rank + static_cast<int64_t>(b) * m;
  int* offs = members + static_cast<int64_t>(b) * m;
  int* long_rows = offs + static_cast<int64_t>(b) * tiles * n;
  int* long_count = long_rows + 3 * long_capacity;
  const int* index = static_cast<const int*>(idx);

  const int pass = n < kKeyPass ? n : kKeyPass;
  const size_t smem = sizeof(int) * kWarps * pass;
  cudaError_t err = cudaFuncSetAttribute(scatter_rank_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_rank_kernel<<<dim3(tiles, grid_y(b)), kThreads, smem, stream>>>(
      index, b, n, m, tile, tiles, rank, offs, long_count);
  scatter_scan_kernel<<<static_cast<unsigned>(b), kScanThreads, 0, stream>>>(
      offs, b, n, tiles, long_rows, long_count);
  if (m > 0) {
    scatter_fill_kernel<<<dim3((m + kThreads - 1) / kThreads, grid_y(b)), kThreads, 0, stream>>>(
        index, rank, offs, b, n, m, tile_shift, tiles, members);
  }
  return static_cast<int>(cudaGetLastError());
}

// upd (B, M, C) f32 summed into out (B, N, C) f32 by a plan that
// pwclo_scatter_plan built in `scratch` with the same b, n, m and tile. One
// launch; every row of out is written.
extern "C" int pwclo_scatter_sum(const void* upd, const void* scratch, long long scratch_ints,
                                 int b, int n, int m, int c, int tile, void* out,
                                 void* stream_ptr) {
  int tiles = 0;
  int64_t long_capacity = 0;
  const int64_t need = plan_layout(b, n, m, tile, &tiles, &long_capacity);
  if (need < 0 || scratch_ints < need || c < 0) return kUnsupportedShape;
  if (static_cast<int64_t>(b) * n * c == 0) return 0;
  SumArgs a;
  a.upd = static_cast<const float*>(upd);
  a.members = static_cast<const int*>(scratch) + static_cast<int64_t>(b) * m;
  a.offs = a.members + static_cast<int64_t>(b) * m;
  a.long_rows = a.offs + static_cast<int64_t>(b) * tiles * n;
  a.long_count = a.long_rows + 3 * long_capacity;
  a.n = n, a.m = m, a.c = c, a.tiles = tiles;
  a.tile_rows = c >= kSumThreads ? 1 : kSumThreads / c;
  a.row_tiles = (n + a.tile_rows - 1) / a.tile_rows;
  const int64_t short_blocks = static_cast<int64_t>(b) * a.row_tiles;
  if (short_blocks > INT_MAX) return kUnsupportedShape;
  a.short_blocks = static_cast<int>(short_blocks);
  a.groups = (c + kGroup - 1) / kGroup;
  a.width = (c + a.groups - 1) / a.groups;  // the last group may have fewer
  a.rows = kChunk / a.width < kChunkRows ? kChunk / a.width : kChunkRows;
  a.out = static_cast<float*>(out);
  // where the short rows take fewer blocks than the long rows' items could
  // fill, blocks of long rows alone
  const int64_t items = long_capacity * a.groups;
  const int64_t extra = items < kLongBlocks ? items : kLongBlocks;
  const int64_t blocks = short_blocks > extra ? short_blocks : extra;
  int threads = a.tile_rows * c;  // more than kSumThreads - c: at least 256 below c = 256
  threads = threads > kSumThreads ? kSumThreads : (threads + 31) / 32 * 32;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  scatter_sum_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
