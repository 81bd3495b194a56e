// Deterministic row scatter-add on Hopper (sm_90a):
//   out[b, n, :] = sum over { m : idx[b, m] == n } of upd[b, m, :].
//
// Replaces: pwclonet_pylidarslam_tpu/ops/pallas/gather_kernel.py::
// _scatter_add_kernel (entry point scatter_add_rows), the backward of the
// row gather. The TPU kernel walks the updates one by one over an output
// slab held in VMEM, which its sequential grid makes race-free, and falls
// back to XLA when the slab is too large or M is no multiple of 128. Blocks
// run in parallel here, so the work is turned around: every output row sums
// its own updates. No slab limit, no fallback, any M.
//
// What bounds it: bytes. It reads M indices and M*C updates and writes N*C
// sums, with one add per update element.
//
// Design: no floating-point atomics, and a fixed order of the adds, so that
// two launches on the same inputs agree to the bit. The index is inverted
// into segments (CSR) in four steps on the stream:
//   1. scatter_count_kernel counts the updates of each output row with
//      integer atomics (integer adds commute, so the counts do not depend on
//      the order the threads arrive in);
//   2. scatter_scan_kernel turns the counts of one sample into segment
//      starts (one block per sample) and zeroes the counts;
//   3. scatter_fill_kernel writes each m into its row's segment, at a slot
//      taken with an integer atomic: the slots' order is arbitrary;
//   4. scatter_sum_kernel gives one warp per output row. It first orders its
//      segment by m (each lane ranks its entries among all of the segment's,
//      the entries being distinct), then adds upd[b, m, :] in ascending m
//      with the lanes across the channels: the same order as a sequential
//      loop over m.
// Segments hold M/N entries on average (8 to 32 on the main path) but are
// skewed, a popular point being the neighbour of hundreds of queries: every
// loop runs over the segment's true length, nothing is capped. The ranking
// costs L*L/32 steps a warp for a segment of L entries, which is what a
// later version should replace for very long segments.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
scatter_count_kernel(const int* __restrict__ idx, int n, int m, int64_t total,
                     int* __restrict__ count) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t b = t / m;
    atomicAdd(&count[b * n + idx[t]], 1);
  }
}

// One block per sample: start[b, 0..n] = exclusive prefix sums of count[b, :],
// then count[b, :] = 0 (it serves as the fill cursor next).
__global__ void __launch_bounds__(kScanThreads)
scatter_scan_kernel(int* __restrict__ count, int n, int* __restrict__ start) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  int* cnt = count + static_cast<int64_t>(blockIdx.x) * n;
  int* st = start + static_cast<int64_t>(blockIdx.x) * (n + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n ? cnt[i] : 0;
    int incl = v;
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += up;
      }
      warp_sums[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    const int before = carry + (warp ? warp_sums[warp - 1] : 0) + incl - v;
    if (i < n) {
      st[i] = before;
      cnt[i] = 0;
    }
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) st[n] = carry;
}

__global__ void __launch_bounds__(kThreads)
scatter_fill_kernel(const int* __restrict__ idx, int n, int m, int64_t total,
                    const int* __restrict__ start, int* __restrict__ cursor,
                    int* __restrict__ members) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t b = t / m;
    const int j = idx[t];
    const int slot = atomicAdd(&cursor[b * n + j], 1);
    members[b * m + start[b * (n + 1) + j] + slot] = static_cast<int>(t - b * m);
  }
}

// One warp per output row (b, j).
__global__ void __launch_bounds__(kThreads)
scatter_sum_kernel(const float* __restrict__ upd, int n, int m, int c, int64_t rows,
                   const int* __restrict__ start, const int* __restrict__ members,
                   int* __restrict__ ordered, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int64_t b = row / n;
  const int j = static_cast<int>(row - b * n);
  const int s0 = start[b * (n + 1) + j];
  const int len = start[b * (n + 1) + j + 1] - s0;
  const int* mem = members + b * m + s0;
  int* ord = ordered + b * m + s0;
  // order the segment by m: the entries are distinct, so the ranks are a
  // permutation of 0..len-1
  for (int i = lane; i < len; i += 32) {
    const int mine = mem[i];
    int rank = 0;
    for (int k = 0; k < len; ++k) rank += mem[k] < mine;
    ord[rank] = mine;
  }
  __syncwarp();  // the lanes' writes to ord are visible to the whole warp
  const float* u = upd + b * m * c;
  float* o = out + row * c;
  for (int c0 = 0; c0 < c; c0 += 32) {
    const int ch = c0 + lane;
    if (ch < c) {
      float acc = 0.0f;
      for (int k = 0; k < len; ++k) acc += u[static_cast<int64_t>(ord[k]) * c + ch];
      o[ch] = acc;
    }
  }
}

unsigned blocks_for(int64_t total, int threads) {
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  return static_cast<unsigned>(blocks);
}

}  // namespace

// upd (B, M, C) f32, idx (B, M) i32 in [0, N), out (B, N, C) f32; scratch:
// B*N + B*(N+1) + 2*B*M ints that the caller allocates (counts, segment
// starts, members, ordered members). Every row of out is written.
extern "C" int pwclo_scatter_add(const void* upd, const void* idx, int b, int n, int m, int c,
                                 void* scratch, void* out, void* stream_ptr) {
  const int64_t rows = static_cast<int64_t>(b) * n;
  if (rows * c == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t total = static_cast<int64_t>(b) * m;
  int* count = static_cast<int*>(scratch);
  int* start = count + rows;
  int* members = start + static_cast<int64_t>(b) * (n + 1);
  int* ordered = members + total;
  const int* index = static_cast<const int*>(idx);
  cudaError_t err = cudaMemsetAsync(count, 0, rows * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total > 0) {
    scatter_count_kernel<<<blocks_for(total, kThreads), kThreads, 0, stream>>>(index, n, m,
                                                                               total, count);
  }
  scatter_scan_kernel<<<static_cast<unsigned>(b), kScanThreads, 0, stream>>>(count, n, start);
  if (total > 0) {
    scatter_fill_kernel<<<blocks_for(total, kThreads), kThreads, 0, stream>>>(
        index, n, m, total, start, count, members);
  }
  scatter_sum_kernel<<<blocks_for(rows * 32, kThreads), kThreads, 0, stream>>>(
      static_cast<const float*>(upd), n, m, c, rows, start, members, ordered,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
