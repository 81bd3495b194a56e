// Exact k-nearest neighbours on Hopper (sm_90a).
//
// Replaces: pwclonet_pylidarslam_tpu/ops/pallas/knn_kernel.py::_knn_kernel
// (entry point knn_approx_pallas). The TPU kernel is approximate above 512
// reference points (a strided bucket-min before its top-k); this one is
// exact, which is what the reference's CPU path computes, so the semantics
// of ops/knn.py::knn hold at every size: k neighbours sorted ascending by
// true squared distance max(|q|^2 + |r|^2 - 2 q.r, 0), ties to the lower
// reference index (as lax.top_k and a stable sort give).
//
// What bounds it: S*N distance evaluations of ~10 fp32 operations. The bytes
// (the clouds and the (S, k) outputs) are under a megabyte at the main
// path's shapes, so by the card's rates it is bound by operations; in fact
// it is bound by how many warps are in flight and by what a candidate that
// enters the list costs.
//
// Design: a warp per query, 4 or 8 queries a block, so that a launch of 2048
// queries has 256-512 blocks. The block streams the reference cloud through
// shared memory as (x, y, z, |r|^2) tiles; the lanes of a warp divide each
// tile among them. Every candidate is one 64-bit key, (bits(d) << 32) |
// index: d >= 0, so its bit pattern orders as the float does, and the key
// orders by distance with the lower index first whatever order the lanes
// meet the candidates in. The query's 32 best keys live one a lane, sorted
// across the warp; the k-th of them is the threshold, held in a register.
// Filter, then merge: a candidate whose key is below the threshold is
// compacted (__ballot_sync/__popc) into the warp's queue in shared memory,
// and when the queue holds 32 the warp sorts them (bitonic, across lanes)
// and merges them into the best list, which lowers the threshold. After the
// first tiles almost nothing passes the filter, and a warp votes once per
// 128 candidates. One list width serves every k <= 32.
//
// Arithmetic: products and sums are rounded one by one (--fmad=false): the
// cross term is (qx*rx + qy*ry) + qz*rz in full fp32, no tensor cores, as the
// plain PyTorch version computes it, so distances and indices equal the
// plain version's to the bit.

#include <cuda_runtime.h>

namespace {

using Key = unsigned long long;

constexpr int kTile = 2048;     // reference points per shared-memory tile
constexpr int kMaxWarps = 8;    // queries per block, at most
constexpr int kUnroll = 4;      // candidates per lane between two votes
constexpr int kQueue = 64;      // at most 31 waiting + 32 new
constexpr unsigned kFull = 0xffffffffu;
constexpr Key kNone = ~0ull;    // above every real key

__device__ __forceinline__ Key key_min(Key a, Key b) { return a < b ? a : b; }
__device__ __forceinline__ Key key_max(Key a, Key b) { return a < b ? b : a; }

// Bitonic sort of one key a lane, ascending by lane.
__device__ __forceinline__ Key sort_across_warp(Key key, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const Key other = __shfl_xor_sync(kFull, key, stride);
      const bool ascending = (lane & size) == 0;
      const bool lower = (lane & stride) == 0;
      key = (lower == ascending) ? key_min(key, other) : key_max(key, other);
    }
  }
  return key;
}

// best and cand both ascending by lane: the 32 smallest of the 64, ascending.
__device__ __forceinline__ Key merge_across_warp(Key best, Key cand, int lane) {
  // against the reversed candidates the minima form a bitonic sequence that
  // holds the 32 smallest keys
  Key key = key_min(best, __shfl_sync(kFull, cand, 31 - lane));
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const Key other = __shfl_xor_sync(kFull, key, stride);
    key = (lane & stride) == 0 ? key_min(key, other) : key_max(key, other);
  }
  return key;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
knn_kernel(const float* __restrict__ query, const float* __restrict__ ref, int s, int n,
           int k, float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float4 tile[kTile];
  __shared__ Key queue[kMaxWarps][kQueue];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b = blockIdx.y;
  const int q = blockIdx.x * nwarps + warp;
  const bool active = q < s;  // the same for every lane of a warp
  const float* rb = ref + static_cast<size_t>(b) * n * 3;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = query + (static_cast<size_t>(b) * s + q) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float q2 = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz));

  Key best = kNone;       // lane j: the j-th smallest key so far
  Key threshold = kNone;  // the k-th smallest so far
  int waiting = 0;        // keys in the queue
  Key* mine = queue[warp];

  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      const float* rp = rb + static_cast<size_t>(base + t) * 3;
      const float x = rp[0], y = rp[1], z = rp[2];
      tile[t] = make_float4(
          x, y, z, __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
    }
    __syncthreads();
    if (!active) continue;
    for (int t0 = 0; t0 < cnt; t0 += 32 * kUnroll) {
      Key key[kUnroll];
      bool some = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * 32 + lane;
        key[u] = kNone;
        if (t < cnt) {
          const float4 r = tile[t];
          const float cross =
              __fadd_rn(__fadd_rn(__fmul_rn(qx, r.x), __fmul_rn(qy, r.y)), __fmul_rn(qz, r.z));
          const float d = fmaxf(__fsub_rn(__fadd_rn(q2, r.w), __fmul_rn(2.f, cross)), 0.f);
          // d >= 0: the sign bit is masked so that a -0 orders as +0
          key[u] = (static_cast<Key>(__float_as_uint(d) & 0x7fffffffu) << 32) |
                   static_cast<unsigned>(base + t);
        }
        some |= key[u] < threshold;
      }
      if (!__any_sync(kFull, some)) continue;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // against the threshold as it stands now: a merge may have lowered it
        const bool pass = key[u] < threshold;
        const unsigned votes = __ballot_sync(kFull, pass);
        if (votes == 0u) continue;
        if (pass) mine[waiting + __popc(votes & ((1u << lane) - 1u))] = key[u];
        waiting += __popc(votes);
        if (waiting >= 32) {
          __syncwarp();
          const Key cand = mine[lane];
          const bool left = 32 + lane < waiting;
          const Key keep = left ? mine[32 + lane] : kNone;
          __syncwarp();
          if (left) mine[lane] = keep;
          waiting -= 32;
          best = merge_across_warp(best, sort_across_warp(cand, lane), lane);
          threshold = __shfl_sync(kFull, best, k - 1);
        }
      }
    }
  }

  if (!active) return;
  if (waiting > 0) {
    __syncwarp();
    const Key cand = lane < waiting ? mine[lane] : kNone;
    best = merge_across_warp(best, sort_across_warp(cand, lane), lane);
  }
  if (lane < k) {
    const size_t o = (static_cast<size_t>(b) * s + q) * k + lane;
    out_d[o] = __uint_as_float(static_cast<unsigned>(best >> 32));
    out_i[o] = static_cast<int>(static_cast<unsigned>(best & 0xffffffffull));
  }
}

}  // namespace

// query (B, S, 3) f32, ref (B, N, 3) f32, out_d (B, S, k) f32, out_i (B, S, k) i32.
// Takes 1 <= k <= min(N, 32); the caller pads k > N. `warps` is the number of
// queries a block serves, 1..8, or 0 for the kernel's own choice (the wrapper
// always passes 0; the other values are there to be timed against it).
extern "C" int pwclo_knn(const void* query, const void* ref, int b, int s, int n, int k,
                         void* out_d, void* out_i, int warps, void* stream) {
  if (k < 1 || k > 32 || k > n || warps < 0 || warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (warps == 0) {
    // 8 queries a block reuse each tile more and are faster from 1024 queries
    // on (measured); below that 4 give twice the blocks
    warps = (static_cast<long long>(s) * b >= 1024) ? 8 : 4;
  }
  const dim3 grid((s + warps - 1) / warps, b);
  knn_kernel<<<grid, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(ref), s, n, k,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
