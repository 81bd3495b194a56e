// Shared device code of the fused MLP kernels (mlp_maxpool.cu,
// attentive_aggregate.cu): one dense layer relu(h . W + b) over a tile of
// rows that lives in shared memory, full fp32 on the CUDA cores.
//
// A block owns a tile of whole centres (rows = centres x K neighbours, padded
// up to a multiple of kRowTile with zero rows). A layer's input is one or
// more "parts", each a row-major shared-memory array read against its own
// row range of the weight, so a concatenated input is never built; a part
// with group = K holds one row per centre and is read by all K of its rows.
// Weights are BN-folded, row-major (Cin, Cout), and read through the
// read-only cache (__ldg): every block reads the same few hundred KB, which
// L2 and L1 serve.
//
// Thread tiling: a thread computes kRowTile rows x TC columns of the output.
// Its columns are col_groups apart, so the lanes of a warp read adjacent
// weights (one coalesced load) and, sharing their rows, read each input value
// as one shared-memory broadcast. Leading dimensions are odd, so row tiles
// that do share a warp (narrow layers) fall on different banks. TC is chosen
// per layer as the widest of 4, 2, 1 that still gives every thread an item.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace pwclo {

constexpr int kThreads = 256;
constexpr int kRowTile = 8;
constexpr int kMaxLayers = 3;
constexpr int kMaxParts = 3;
// what a block may ask for on sm_90 (227 KB), and what it gets without asking
constexpr int kMaxDynamicSmem = 232448;
constexpr int kDefaultDynamicSmem = 49152;
// returned by the C entry points for a shape the kernel does not take
constexpr int kUnsupportedShape = -1;

__host__ __device__ inline int lead_dim(int width) { return width | 1; }

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// One stack of at most kMaxLayers layers: params = W0, b0, W1, b1, ... packed.
struct Stack {
  const float* params;
  int n;
  int cin;
  int cout[kMaxLayers];
};

inline Stack make_stack(const void* params, int n, int cin, int c1, int c2, int c3) {
  Stack s;
  s.params = static_cast<const float*>(params);
  s.n = n;
  s.cin = cin;
  s.cout[0] = c1;
  s.cout[1] = c2;
  s.cout[2] = c3;
  return s;
}

inline bool stack_ok(const Stack& s, int min_layers) {
  if (s.n < min_layers || s.n > kMaxLayers || s.cin < 1) return false;
  for (int i = 0; i < s.n; ++i)
    if (s.cout[i] < 1) return false;
  return true;
}

inline int stack_out(const Stack& s) { return s.cout[s.n - 1]; }

inline int stack_max_width(const Stack& s) {
  int w = 0;
  for (int i = 0; i < s.n; ++i) w = s.cout[i] > w ? s.cout[i] : w;
  return w;
}

// Row r of the layer input reads rows[min(r / group, last) * ld + i], i < width.
struct Part {
  const float* rows;
  int ld;
  int width;
  int group;
  int last;
};

struct Parts {
  Part p[kMaxParts];
  int n;
};

__device__ inline Parts one_part(const float* rows, int ld, int width, int rows_pad) {
  Parts parts;
  parts.n = 1;
  parts.p[0] = Part{rows, ld, width, 1, rows_pad - 1};
  return parts;
}

template <int TC>
__device__ void dense_relu_tc(const Parts& parts, const float* __restrict__ w,
                              const float* __restrict__ b, int cout, float* out, int ld_out,
                              int rows_pad) {
  const int col_groups = (cout + TC - 1) / TC;
  const int items = (rows_pad / kRowTile) * col_groups;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int rb = item / col_groups;
    const int cg = item - rb * col_groups;
    const int row0 = rb * kRowTile;
    int col[TC];
    float acc[kRowTile][TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      col[c] = cg + c * col_groups;
      const float bias = col[c] < cout ? __ldg(b + col[c]) : 0.0f;
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) acc[r][c] = bias;
    }
    int w_row = 0;
#pragma unroll
    for (int p = 0; p < kMaxParts; ++p) {
      if (p < parts.n) {
        const Part part = parts.p[p];
        const float* rp[kRowTile];
#pragma unroll
        for (int r = 0; r < kRowTile; ++r)
          rp[r] = part.rows + static_cast<size_t>(min((row0 + r) / part.group, part.last)) * part.ld;
        for (int i = 0; i < part.width; ++i) {
          const float* wr = w + static_cast<size_t>(w_row + i) * cout;
          float wv[TC];
#pragma unroll
          for (int c = 0; c < TC; ++c) wv[c] = col[c] < cout ? __ldg(wr + col[c]) : 0.0f;
#pragma unroll
          for (int r = 0; r < kRowTile; ++r) {
            const float a = rp[r][i];
#pragma unroll
            for (int c = 0; c < TC; ++c) acc[r][c] = fmaf(a, wv[c], acc[r][c]);
          }
        }
        w_row += part.width;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowTile; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c)
        if (col[c] < cout) out[(row0 + r) * ld_out + col[c]] = fmaxf(acc[r][c], 0.0f);
  }
}

// out[r, :] = relu(concat(parts)[r, :] . W + b) for the tile's rows_pad rows.
// The caller puts a barrier between this and whatever reads `out`.
__device__ inline void dense_relu(const Parts& parts, const float* w, const float* b, int cout,
                                  float* out, int ld_out, int rows_pad) {
  const int row_tiles = rows_pad / kRowTile;
  const int threads = static_cast<int>(blockDim.x);
  if (row_tiles * ((cout + 3) / 4) >= threads)
    dense_relu_tc<4>(parts, w, b, cout, out, ld_out, rows_pad);
  else if (row_tiles * ((cout + 1) / 2) >= threads)
    dense_relu_tc<2>(parts, w, b, cout, out, ld_out, rows_pad);
  else
    dense_relu_tc<1>(parts, w, b, cout, out, ld_out, rows_pad);
}

// Centres per block: whole centres (K rows each), at most about max_rows rows.
// Where a call is too small to give every SM a block of that size, the tile
// shrinks (a block's time is a chain of dependent layers, so it pays to
// spread the rows over idle SMs), in steps of 8, 16, 32, ... rows so that the
// row tiles of a layer divide evenly among the threads.
inline int tile_centres_for(int centres, int k, int max_rows) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      sms < 1)
    sms = 1;
  const long long per_sm = static_cast<long long>(centres) * k / sms;
  int rows = kRowTile;
  while (rows * 2 <= max_rows && rows * 2 <= per_sm) rows *= 2;
  return rows / k > 0 ? rows / k : 1;
}

// Ask for `bytes` of dynamic shared memory for `kernel`; a CUDA error code.
template <typename Kernel>
inline int allow_dynamic_smem(Kernel kernel, int bytes) {
  if (bytes <= kDefaultDynamicSmem) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace pwclo
