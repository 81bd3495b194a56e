// Fused shared MLP + max-pool over the neighbourhood on Hopper (sm_90a):
//   out[c, :] = max_k relu(... relu(x[c, k, :] . W0 + b0) ... . WL + bL)
// with eval-mode BatchNorm already folded into (W, b).
//
// Replaces: pwclonet_pylidarslam_tpu/ops/pallas/mlp_kernel.py::mlp_maxpool_pallas.
// Like the TPU kernel it reads the grouped tensor once, keeps every
// intermediate on chip and writes only the pooled (centres, Cout) result.
// Unlike it, nothing is padded to a tile and sliced back: the batch and
// centre axes are one flat axis of centres, a block takes the next
// tile_centres of them, and the last block takes what is left.
//
// What bounds it: operations at the main path's widths (2 * rows * sum of
// Cin * Cout in fp32 on the CUDA cores, the reference's full-f32 products:
// no TF32, no tensor cores), except the first pyramid level (6 -> 8 -> 8 ->
// 16), which is bound by reading x. Design: activations ping-pong between
// two shared-memory buffers of rows x ld floats; each layer is the register-
// tiled dense_relu of dense_tile.cuh; the last buffer is reduced by max over
// each centre's K rows. A tile is at most about kTargetRows rows, so that two
// buffers at width 128 take 66 KB and three blocks share an SM, and fewer
// rows where the call is small (tile_centres_for).

#include <cuda_runtime.h>

#include <cstdint>

#include "dense_tile.cuh"

namespace {

using namespace pwclo;

constexpr int kTargetRows = 64;

__global__ void __launch_bounds__(kThreads)
mlp_maxpool_kernel(const float* __restrict__ x, Stack st, int centres, int k, int tile_centres,
                   int rows_pad, int ld, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + static_cast<size_t>(rows_pad) * ld;

  const int c0 = blockIdx.x * tile_centres;
  const int nc = min(tile_centres, centres - c0);
  const int rows = nc * k;

  // the tile's rows are one contiguous run of x; rows past the end are zero
  const float* src = x + static_cast<size_t>(c0) * k * st.cin;
  for (int idx = threadIdx.x; idx < rows_pad * st.cin; idx += blockDim.x) {
    const int r = idx / st.cin;
    const int i = idx - r * st.cin;
    cur[r * ld + i] = r < rows ? src[idx] : 0.0f;
  }
  __syncthreads();

  const float* params = st.params;
  int cin = st.cin;
  for (int layer = 0; layer < st.n; ++layer) {
    const int cout = st.cout[layer];
    dense_relu(one_part(cur, ld, cin, rows_pad), params, params + cin * cout, cout, nxt, ld,
               rows_pad);
    __syncthreads();
    params += cin * cout + cout;
    cin = cout;
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // max over each centre's K rows; only (centres, Cout) leaves the chip
  for (int idx = threadIdx.x; idx < nc * cin; idx += blockDim.x) {
    const int c = idx / cin;
    const int j = idx - c * cin;
    const float* col = cur + static_cast<size_t>(c) * k * ld + j;
    float m = col[0];
    for (int kk = 1; kk < k; ++kk) m = fmaxf(m, col[kk * ld]);
    out[static_cast<size_t>(c0 + c) * cin + j] = m;
  }
}

}  // namespace

// x (centres, K, c0) f32; params = W0 (c0 x c1), b0 (c1), W1, b1, ... f32;
// out (centres, c_last) f32. n_layers in 1..3; widths past n_layers ignored.
extern "C" int pwclo_mlp_maxpool(const void* x, const void* params, int centres, int k,
                                 int n_layers, int c0, int c1, int c2, int c3, void* out,
                                 void* stream) {
  const Stack st = make_stack(params, n_layers, c0, c1, c2, c3);
  if (!stack_ok(st, 1) || k < 1 || centres < 0) return kUnsupportedShape;
  if (centres == 0) return 0;
  const int tile_centres = tile_centres_for(centres, k, kTargetRows);
  const int rows_pad = round_up(tile_centres * k, kRowTile);
  const int width = stack_max_width(st) > c0 ? stack_max_width(st) : c0;
  const int ld = lead_dim(width);
  const int64_t smem = static_cast<int64_t>(2) * rows_pad * ld * sizeof(float);
  if (smem > kMaxDynamicSmem) return kUnsupportedShape;
  const int err = allow_dynamic_smem(mlp_maxpool_kernel, static_cast<int>(smem));
  if (err != 0) return err;
  const int blocks = (centres + tile_centres - 1) / tile_centres;
  mlp_maxpool_kernel<<<blocks, kThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), st, centres, k, tile_centres, rows_pad, ld,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
