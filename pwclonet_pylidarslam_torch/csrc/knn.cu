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
// What bounds it: S*N distance evaluations of ~9 fp32 operations and the
// sorted insertions they trigger. The bytes (the clouds and the (S, k)
// outputs) are under a megabyte at the main path's shapes, so by the card's
// rates it is bound by operations; at B=1 the S/64 blocks fill only part of
// the card, which this first version accepts.
//
// Design: one thread per query keeps its k best (distance, index) pairs as a
// sorted list in registers (KCAP >= k slots, fully unrolled so the list never
// leaves registers). The block streams the reference cloud through shared
// memory in index order, as (x, y, z, |r|^2) tiles, and every thread scans
// each tile. A candidate enters only if it is strictly closer than the
// current last slot, and bubbles up past strictly larger entries only, so of
// two equal distances the lower index (seen first) stays first.
//
// Arithmetic: products and sums are rounded one by one (--fmad=false): the
// cross term is (qx*rx + qy*ry) + qz*rz in full fp32, no tensor cores, as the
// plain PyTorch version computes it.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 1024;

template <int KCAP>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ query, const float* __restrict__ ref, int s, int n,
           int k, float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = q < s;
  const float* rb = ref + static_cast<size_t>(b) * n * 3;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = query + (static_cast<size_t>(b) * s + q) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float q2 = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz));

  float bd[KCAP];
  int bi[KCAP];
#pragma unroll
  for (int j = 0; j < KCAP; ++j) {
    bd[j] = INFINITY;
    bi[j] = 0;
  }

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
    for (int t = 0; t < cnt; ++t) {
      const float4 r = tile[t];
      const float cross =
          __fadd_rn(__fadd_rn(__fmul_rn(qx, r.x), __fmul_rn(qy, r.y)), __fmul_rn(qz, r.z));
      const float d = fmaxf(__fsub_rn(__fadd_rn(q2, r.w), __fmul_rn(2.f, cross)), 0.f);
      if (d < bd[KCAP - 1]) {
        bd[KCAP - 1] = d;
        bi[KCAP - 1] = base + t;
#pragma unroll
        for (int j = KCAP - 1; j > 0; --j) {
          if (bd[j] < bd[j - 1]) {
            const float td = bd[j];
            bd[j] = bd[j - 1];
            bd[j - 1] = td;
            const int ti = bi[j];
            bi[j] = bi[j - 1];
            bi[j - 1] = ti;
          }
        }
      }
    }
  }

  if (!active) return;
  float* od = out_d + (static_cast<size_t>(b) * s + q) * k;
  int* oi = out_i + (static_cast<size_t>(b) * s + q) * k;
#pragma unroll
  for (int j = 0; j < KCAP; ++j) {
    if (j < k) {
      od[j] = bd[j];
      oi[j] = bi[j];
    }
  }
}

template <int KCAP>
void launch(const float* query, const float* ref, int b, int s, int n, int k, float* out_d,
            int* out_i, cudaStream_t stream) {
  const dim3 grid((s + kThreads - 1) / kThreads, b);
  knn_kernel<KCAP><<<grid, kThreads, 0, stream>>>(query, ref, s, n, k, out_d, out_i);
}

}  // namespace

// query (B, S, 3) f32, ref (B, N, 3) f32, out_d (B, S, k) f32, out_i (B, S, k) i32.
// Takes 1 <= k <= min(N, 32); the caller pads k > N.
extern "C" int pwclo_knn(const void* query, const void* ref, int b, int s, int n, int k,
                         void* out_d, void* out_i, void* stream) {
  const float* q = static_cast<const float*>(query);
  const float* r = static_cast<const float*>(ref);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 4) {
    launch<4>(q, r, b, s, n, k, od, oi, st);
  } else if (k <= 8) {
    launch<8>(q, r, b, s, n, k, od, oi, st);
  } else if (k <= 16) {
    launch<16>(q, r, b, s, n, k, od, oi, st);
  } else if (k <= 32) {
    launch<32>(q, r, b, s, n, k, od, oi, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
