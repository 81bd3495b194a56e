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
// block-wide argmax. At N = 8192 a step is ~74K flops and ~100 KB of points,
// both far below a microsecond of the card's rates, so the time is the
// latency of npoint chained block reductions and barriers.
//
// Design: one block per batch element. Thread t owns points t + j*blockDim
// (j < PER) and keeps their coordinates and running distances in registers
// for the whole loop, so the points are read from memory once. Each step:
// update the running distances against the last pick, take a thread-local
// argmax, reduce across the warp by butterfly shuffles that carry the
// winner's coordinates, write one slot per warp to shared memory, pass ONE
// barrier, and let every warp reduce the per-warp slots itself. Every thread
// then knows the next pick and its coordinates without a second barrier or a
// read of device memory. The per-warp slots are double-buffered by step
// parity, so the next step's writes never race this step's reads.
//
// Arithmetic: the squared distance is (dx*dx + dy*dy) + dz*dz with every
// product and sum rounded on its own (__fmul_rn/__fadd_rn, and the library is
// built with --fmad=false), as the plain PyTorch version and the reference
// compute it, so the picks are bit-identical to theirs.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Butterfly argmax over the warp: every lane ends with the warp's winner.
__device__ __forceinline__ void warp_argmax(float& v, int& i, float& x, float& y, float& z) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    const float ox = __shfl_xor_sync(0xffffffffu, x, off);
    const float oy = __shfl_xor_sync(0xffffffffu, y, off);
    const float oz = __shfl_xor_sync(0xffffffffu, z, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
      x = ox;
      y = oy;
      z = oz;
    }
  }
}

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

template <int PER>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ points, const float* __restrict__ mask, int n,
           int npoint, int* __restrict__ out) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const float* p = points + static_cast<size_t>(b) * n * 3;
  int* o = out + static_cast<size_t>(b) * npoint;

  __shared__ float s_v[2][32];
  __shared__ int s_i[2][32];
  __shared__ float s_x[2][32];
  __shared__ float s_y[2][32];
  __shared__ float s_z[2][32];

  float px[PER], py[PER], pz[PER], dist[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * nt;
    if (i < n) {
      px[j] = p[3 * i];
      py[j] = p[3 * i + 1];
      pz[j] = p[3 * i + 2];
      const bool valid = mask != nullptr
                             ? mask[static_cast<size_t>(b) * n + i] > 0.f
                             : sqnorm(px[j], py[j], pz[j]) > 1e-3f;
      dist[j] = valid ? 1e10f : -1e10f;
    } else {
      px[j] = py[j] = pz[j] = 0.f;
      dist[j] = -INFINITY;  // never wins: every real point is >= -1e10
    }
  }

  float lx = 0.f, ly = 0.f, lz = 0.f;
  int buf = 0;
  // Step 0 is the argmax of the initial distances: the first valid point,
  // or point 0 when none is valid.
  for (int s = 0; s < npoint; ++s) {
    if (s > 0) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        // invalid (-1e10) and padding (-inf) slots stay below any d >= 0
        const float d = sqnorm(__fsub_rn(px[j], lx), __fsub_rn(py[j], ly), __fsub_rn(pz[j], lz));
        dist[j] = fminf(dist[j], d);
      }
    }
    float bv = dist[0], bx = px[0], by = py[0], bz = pz[0];
    int bi = tid;
#pragma unroll
    for (int j = 1; j < PER; ++j) {
      if (dist[j] > bv) {  // strict: a later slot has a higher index
        bv = dist[j];
        bi = tid + j * nt;
        bx = px[j];
        by = py[j];
        bz = pz[j];
      }
    }
    warp_argmax(bv, bi, bx, by, bz);
    if (lane == 0) {
      s_v[buf][warp] = bv;
      s_i[buf][warp] = bi;
      s_x[buf][warp] = bx;
      s_y[buf][warp] = by;
      s_z[buf][warp] = bz;
    }
    __syncthreads();
    if (lane < nwarps) {
      bv = s_v[buf][lane];
      bi = s_i[buf][lane];
      bx = s_x[buf][lane];
      by = s_y[buf][lane];
      bz = s_z[buf][lane];
    } else {
      bv = -INFINITY;
      bi = INT_MAX;
    }
    warp_argmax(bv, bi, bx, by, bz);
    if (tid == 0) o[s] = bi;
    lx = bx;
    ly = by;
    lz = bz;
    buf ^= 1;
  }
}

template <int PER>
void launch(const float* points, const float* mask, int b, int n, int npoint, int* out,
            cudaStream_t stream) {
  int threads = (n + PER - 1) / PER;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  fps_kernel<PER><<<b, threads, 0, stream>>>(points, mask, n, npoint, out);
}

}  // namespace

// points (B, N, 3) f32, mask (B, N) f32 or null, out (B, npoint) i32.
// Takes 1 <= N <= 16 * 1024; the caller checks.
extern "C" int pwclo_fps(const void* points, const void* mask, int b, int n, int npoint,
                         void* out, void* stream) {
  const float* p = static_cast<const float*>(points);
  const float* m = static_cast<const float*>(mask);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = (n + kMaxThreads - 1) / kMaxThreads;
  if (per <= 1) {
    launch<1>(p, m, b, n, npoint, o, st);
  } else if (per <= 2) {
    launch<2>(p, m, b, n, npoint, o, st);
  } else if (per <= 4) {
    launch<4>(p, m, b, n, npoint, o, st);
  } else if (per <= 8) {
    launch<8>(p, m, b, n, npoint, o, st);
  } else if (per <= 16) {
    launch<16>(p, m, b, n, npoint, o, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
