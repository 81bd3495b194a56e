// Row gather on Hopper (sm_90a): out[b, m, :] = src[b, idx[b, m], :].
//
// Replaces: pwclonet_pylidarslam_tpu/ops/pallas/gather_kernel.py::_gather_kernel
// (entry points gather_rows / _gather_fwd_impl). Unlike the TPU kernel,
// which keeps the whole source slab in VMEM and falls back to XLA's gather
// when the slab is too large, this kernel takes every shape: the source
// stays in device memory and the 50 MB L2 holds it at the main path's sizes.
//
// What bounds it: bytes. It reads M indices and M*C source elements and
// writes M*C elements, with no arithmetic; at the main path's largest call
// (M = 65,536 rows of C = 67) that is ~35 MB of traffic.
//
// Design: one thread per output element, in output order, so the writes of a
// warp are one contiguous run. Threads of one row read the same index; the
// warp's index loads fall on one or two cache lines and are served by one
// transaction. Rows of C = 3..67 floats are not 16-byte aligned, so the
// copy is by 4-byte element, as raw 32-bit words: the result is bit-exact.
// Indices are assumed in range, as in the reference.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint32_t* __restrict__ src, const int* __restrict__ idx, int n, int m,
              int c, uint32_t* __restrict__ out, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t row = t / c;  // flat (b, m)
    const int ch = static_cast<int>(t - row * c);
    const int64_t b = row / m;
    const int64_t j = idx[row];
    out[t] = src[(b * n + j) * c + ch];
  }
}

}  // namespace

// src (B, N, C) f32, idx (B, M) i32, out (B, M, C) f32.
extern "C" int pwclo_gather(const void* src, const void* idx, int b, int n, int m, int c,
                            void* out, void* stream) {
  const int64_t total = static_cast<int64_t>(b) * m * c;
  if (total == 0) return 0;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<const int*>(idx), n, m, c,
      static_cast<uint32_t*>(out), total);
  return static_cast<int>(cudaGetLastError());
}
