// Furthest point sampling on Hopper (sm_90a).
//
// Replaces: pwclonet_pylidarslam_tpu/ops/pallas/fps_kernel.py::_fps_kernel_batched
// (entry point furthest_point_sample_pallas) and holds to the semantics of
// ops/fps.py::_furthest_point_sample_lax: the default mask is |p|^2 > 1e-3,
// sampling starts at the first valid point, the running distance starts at
// +1e10 for valid points and -1e10 for invalid ones, and each step takes the
// argmax with ties going to the lowest index.
//
// What bounds it: npoint dependent steps, each an O(N) distance update and a
// sample-wide argmax. At N = 8192 a step is ~74K flops and ~100 KB of points,
// both far below a microsecond of the card's rates, so the time is the
// latency of npoint chained reductions and barriers, plus what one SM needs
// to execute the update of its share of the points.
//
// Design: one block a sample up to 4096 points (4 points a thread); above
// that 1024 threads spread over the 8 blocks of a thread-block cluster, so
// that 8 SMs share the update (4 or 2 blocks when the card cannot hold a
// cluster of 8 for every sample at once). Thread g owns points g + j*threads
// (j < PER) and keeps their coordinates and running distances in registers
// for the whole loop. Each step:
//  - update the running distances against the last pick and take the
//    thread's own argmax;
//  - reduce keys, not records: the distance is mapped to an unsigned that
//    orders as the float does, the warp's maximum is one redux.sync
//    (__reduce_max_sync), and a second one (__reduce_min_sync over the
//    indices of the lanes that hold that maximum) gives the lowest index
//    among ties;
//  - one lane per warp writes (key, index) as one 64-bit word into the slot
//    of its warp; in a cluster, lane r writes it into block r's shared
//    memory (distributed shared memory), so every block gets every slot;
//  - wait: one __syncthreads() in a single block. In a cluster the word
//    carries the step's tag and every lane polls the slot of one warp in
//    its own block's shared memory until the tag is the step's: the word's
//    arrival is the signal, and no cluster barrier is passed (it costs
//    twice the flight of the word, measured);
//  - every warp reduces the at most 32 slots the same way, so every thread
//    knows the pick, and reads its coordinates by index from the copy of
//    the sample that each block staged in its shared memory at the start
//    (12 bytes a point: 96 KB at 8192 points, 192 KB at 16,384).
// The slots are double-buffered by step parity: a warp writes step s + 2
// only after it has read every warp's slot of step s + 1, which each warp
// wrote after it had read step s, so no slot is overwritten unread.
//
// Arithmetic: the squared distance is (dx*dx + dy*dy) + dz*dz with every
// product and sum rounded on its own (__fmul_rn/__fadd_rn, and the library is
// built with --fmad=false), as the plain PyTorch version and the reference
// compute it, so the picks are bit-identical to theirs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;  // per sample: at most 32 warps, one slot each
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIndexBits = 14;            // N <= 16 * 1024
constexpr unsigned long long kTags = (1ull << 18) - 1ull;  // a step's tag: 1..kTags, 18 bits

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// An unsigned that orders as the float does (-inf and -1e10 occur).
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The largest key among the lanes and, of the lanes that hold it, the lowest index.
__device__ __forceinline__ void warp_argmax(unsigned& key, unsigned& idx) {
  const unsigned top = __reduce_max_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == top ? idx : 0xffffffffu);
  key = top;
}

// SKELETON: the step's synchronisation alone (key reduction, slots, the wait,
// read of the pick's coordinates), with no distance update: its time is the
// floor of the chain of npoint dependent steps.
template <int PER, bool CLUSTER, bool SKELETON>
__global__ void __launch_bounds__(CLUSTER ? kMaxThreads / 2 : kMaxThreads)
fps_kernel(const float* __restrict__ points, const float* __restrict__ mask, int n,
           int npoint, int* __restrict__ out) {
  extern __shared__ float s_pts[];  // (n, 3): this block's copy of the sample
  __shared__ unsigned long long s_slot[2][32];

  int blocks = 1, rank = 0;
  if (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    blocks = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
  }
  const int b = blockIdx.x / blocks;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int threads = nt * blocks;  // of the sample
  const int g = rank * nt + tid;    // this thread among them
  const int lane = tid & 31;
  const int gwarp = g >> 5;
  const int nwarps = threads >> 5;
  const float* p = points + static_cast<size_t>(b) * n * 3;
  int* o = out + static_cast<size_t>(b) * npoint;

  for (int i = tid; i < 3 * n; i += nt) s_pts[i] = p[i];
  if (CLUSTER && tid < 64) (&s_slot[0][0])[tid] = 0ull;  // tag 0: no step has written
  __syncthreads();

  float px[PER], py[PER], pz[PER], dist[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = g + j * threads;
    if (i < n) {
      px[j] = s_pts[3 * i];
      py[j] = s_pts[3 * i + 1];
      pz[j] = s_pts[3 * i + 2];
      const bool valid = mask != nullptr
                             ? mask[static_cast<size_t>(b) * n + i] > 0.f
                             : sqnorm(px[j], py[j], pz[j]) > 1e-3f;
      dist[j] = valid ? 1e10f : -1e10f;
    } else {
      px[j] = py[j] = pz[j] = 0.f;
      dist[j] = -INFINITY;  // never wins: every real point is >= -1e10
    }
  }

  // lane r of every warp writes the warp's slot in block r of the cluster
  unsigned long long* slot_of_peer = nullptr;
  if (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    slot_of_peer = cluster.map_shared_rank(&s_slot[0][0], lane % blocks);
    cluster.sync();  // every block runs, its slots zeroed, before any peer writes to it
  }

  float lx = 0.f, ly = 0.f, lz = 0.f;
  int buf = 0;
  // Step 0 is the argmax of the initial distances: the first valid point,
  // or point 0 when none is valid.
  for (int s = 0; s < npoint; ++s) {
    if (!SKELETON && s > 0) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        // invalid (-1e10) and padding (-inf) slots stay below any d >= 0
        const float d = sqnorm(__fsub_rn(px[j], lx), __fsub_rn(py[j], ly), __fsub_rn(pz[j], lz));
        dist[j] = fminf(dist[j], d);
      }
    }
    float bv = dist[0];
    unsigned idx = g;
#pragma unroll
    for (int j = 1; j < PER; ++j) {
      if (dist[j] > bv) {  // strict: a later slot has a higher index
        bv = dist[j];
        idx = g + j * threads;
      }
    }
    unsigned key = ordered(bv);
    // the skeleton's key hangs on the last pick (a coordinate is never NaN
    // here), so that no step can be hoisted out of the chain
    if (SKELETON) key += lx != lx;
    warp_argmax(key, idx);
    unsigned long long slot = 0xffffffffull;  // key 0 is below every float's key
    if (CLUSTER) {
      const unsigned long long tag = static_cast<unsigned long long>(s % kTags + 1);
      if (lane < blocks) {
        *reinterpret_cast<volatile unsigned long long*>(slot_of_peer + buf * 32 + gwarp) =
            (static_cast<unsigned long long>(key) << 32) | (tag << kIndexBits) |
            (idx & ((1u << kIndexBits) - 1u));  // a warp of padding alone cannot touch the tag
      }
      if (lane < nwarps) {
        const volatile unsigned long long* src = &s_slot[buf][lane];
        do {
          slot = *src;
        } while (((slot >> kIndexBits) & kTags) != tag);
        slot = (slot & 0xffffffff00000000ull) | (slot & ((1ull << kIndexBits) - 1ull));
      }
      __syncwarp();
    } else {
      if (lane == 0) s_slot[buf][gwarp] = (static_cast<unsigned long long>(key) << 32) | idx;
      __syncthreads();
      if (lane < nwarps) slot = s_slot[buf][lane];
    }
    key = static_cast<unsigned>(slot >> 32);
    idx = static_cast<unsigned>(slot & 0xffffffffull);
    warp_argmax(key, idx);
    if (g == 0) o[s] = static_cast<int>(idx);
    lx = s_pts[3 * idx];
    ly = s_pts[3 * idx + 1];
    lz = s_pts[3 * idx + 2];
    buf ^= 1;
  }
}

// A launch of `clusters` samples, each `cluster` blocks of threads / cluster
// threads, every block with its copy of the n points in shared memory.
struct Launch {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attribute = {};

  Launch(int clusters, int cluster, int threads, int n, cudaStream_t stream) {
    config.gridDim = dim3(clusters * cluster);
    config.blockDim = dim3(threads / cluster);
    config.dynamicSmemBytes = static_cast<size_t>(n) * 3 * sizeof(float);
    config.stream = stream;
    attribute.id = cudaLaunchAttributeClusterDimension;
    attribute.val.clusterDim.x = cluster;
    attribute.val.clusterDim.y = 1;
    attribute.val.clusterDim.z = 1;
    config.attrs = &attribute;
    config.numAttrs = cluster > 1 ? 1 : 0;
  }
  Launch(const Launch&) = delete;  // config points into this object

  // Above 48 KB of shared memory in all, static (the slots) and dynamic (the
  // points: 48 KB at 4,096 of them), a kernel has to be allowed its dynamic
  // shared memory. The static size is queried once a kernel.
  template <int PER, bool CLUSTER, bool SKELETON>
  cudaError_t allow_shared_memory() const {
    auto kernel = fps_kernel<PER, CLUSTER, SKELETON>;
    static std::atomic<long long> static_bytes{-1};
    long long bytes = static_bytes.load(std::memory_order_relaxed);
    if (bytes < 0) {
      cudaFuncAttributes attributes = {};
      cudaError_t err = cudaFuncGetAttributes(&attributes, kernel);
      if (err != cudaSuccess) return err;
      bytes = static_cast<long long>(attributes.sharedSizeBytes);
      static_bytes.store(bytes, std::memory_order_relaxed);
    }
    if (static_cast<size_t>(bytes) + config.dynamicSmemBytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(config.dynamicSmemBytes));
  }
};

template <int PER, bool CLUSTER, bool SKELETON>
int launch_as(const float* points, const float* mask, int b, int n, int npoint, int* out,
              int cluster, int threads, cudaStream_t stream) {
  auto kernel = fps_kernel<PER, CLUSTER, SKELETON>;
  const Launch cfg(b, cluster, threads, n, stream);
  cudaError_t err = cfg.allow_shared_memory<PER, CLUSTER, SKELETON>();
  if (err == cudaSuccess) {
    err = cudaLaunchKernelEx(&cfg.config, kernel, points, mask, n, npoint, out);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// How many clusters of `cluster` blocks of this kernel the card holds at
// once. The last answer is kept (one word, so that two host threads cannot
// tear it): a network asks for the same few shapes over and over.
template <int PER>
int clusters_at_once(int n, int cluster, int threads) {
  static std::atomic<unsigned long long> last[4];  // by log2(cluster)
  int slot = 0;
  while ((1 << slot) < cluster) ++slot;
  const unsigned long long tag =
      (static_cast<unsigned long long>(n) << 40) | (static_cast<unsigned long long>(threads) << 20);
  const unsigned long long seen = last[slot].load(std::memory_order_relaxed);
  if (seen != 0 && (seen >> 20) == (tag >> 20)) return static_cast<int>(seen & 0xfffffu);

  auto kernel = fps_kernel<PER, true, false>;
  const Launch cfg(1, cluster, threads, n, nullptr);
  int count = 0;
  if (cfg.allow_shared_memory<PER, true, false>() != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&count, kernel, &cfg.config) != cudaSuccess) {
    cudaGetLastError();  // cleared: the card holds none, and one block a sample it is
    count = 0;
  }
  last[slot].store(tag | static_cast<unsigned>(count), std::memory_order_relaxed);
  return count;
}

// Measured on an H100 (PERF.md has the times): from 8 points a thread on, the
// update shared among 8 SMs saves more than the slots' flight between them
// costs; below that one block is faster, at 4 points a thread.
constexpr int kPointsPerThread = 4;
constexpr int kClusterAbovePoints = kPointsPerThread * kMaxThreads;

template <int PER>
int launch(const float* points, const float* mask, int b, int n, int npoint, int* out,
           int cluster, int threads, bool skeleton, cudaStream_t stream) {
  if (cluster == 0) {
    // halved until the sample's warps divide among the blocks and the card
    // holds all b clusters at once (a second wave would double the time)
    cluster = n > kClusterAbovePoints ? kMaxCluster : 1;
    while (cluster > 1 && (threads % (32 * cluster) != 0 ||
                           clusters_at_once<PER>(n, cluster, threads) < b)) {
      cluster >>= 1;
    }
  }
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 ||
      threads % (32 * cluster) != 0 || threads > kMaxThreads ||
      static_cast<long long>(threads) * PER < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define PWCLO_FPS_LAUNCH(CL, SK) \
  launch_as<PER, CL, SK>(points, mask, b, n, npoint, out, cluster, threads, stream)
  if (cluster == 1) return skeleton ? PWCLO_FPS_LAUNCH(false, true) : PWCLO_FPS_LAUNCH(false, false);
  return skeleton ? PWCLO_FPS_LAUNCH(true, true) : PWCLO_FPS_LAUNCH(true, false);
#undef PWCLO_FPS_LAUNCH
}

}  // namespace

// points (B, N, 3) f32, mask (B, N) f32 or null, out (B, npoint) i32.
// Takes 1 <= N <= 16 * 1024; the caller checks. `cluster` (blocks a sample:
// 1, 2, 4 or 8) and `threads` (a sample, a multiple of 32 * cluster, at most
// 1024 and at least N / 16) are 0 for the kernel's own choice, and `skeleton`
// is 0 for the full step, which is what the wrapper passes; other values are
// there to be timed against it.
extern "C" int pwclo_fps(const void* points, const void* mask, int b, int n, int npoint,
                         void* out, int cluster, int threads, int skeleton, void* stream) {
  const float* p = static_cast<const float*>(points);
  const float* m = static_cast<const float*>(mask);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sk = skeleton != 0;
  if (n < 1 || threads < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (threads == 0) {
    threads = n > kClusterAbovePoints
                  ? kMaxThreads
                  : ((n + kPointsPerThread - 1) / kPointsPerThread + 31) / 32 * 32;
  }
  const int per = (n + threads - 1) / threads;
  if (per <= 1) return launch<1>(p, m, b, n, npoint, o, cluster, threads, sk, st);
  if (per <= 2) return launch<2>(p, m, b, n, npoint, o, cluster, threads, sk, st);
  if (per <= 4) return launch<4>(p, m, b, n, npoint, o, cluster, threads, sk, st);
  if (per <= 8) return launch<8>(p, m, b, n, npoint, o, cluster, threads, sk, st);
  if (per <= 16) return launch<16>(p, m, b, n, npoint, o, cluster, threads, sk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
