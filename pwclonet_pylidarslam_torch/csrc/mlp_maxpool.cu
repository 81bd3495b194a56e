// Fused shared MLP + max-pool over the neighbourhood on Hopper (sm_90a):
//   out[c, :] = max_k relu(... relu(x[c, k, :] . W0 + b0) ... . WL + bL)
// with eval-mode BatchNorm already folded into (W, b).
//
// Replaces: pwclonet_pylidarslam_tpu/ops/pallas/mlp_kernel.py::mlp_maxpool_pallas.
// Like the TPU kernel it reads the grouped tensor once, keeps every
// intermediate on chip and writes only the pooled (centres, Cout) result.
// Unlike it, nothing is padded to a tile and sliced back: the batch and
// centre axes are one flat axis of centres, a block takes the next
// block_centres of them, and the last block takes what is left.
//
// What bounds it: operations. The reference computes every product at
// Precision.HIGHEST, so the fp32 bound is 2 x rows x (sum of Cin x Cout) over
// 67 TFLOP/s on the CUDA cores; the first pyramid level (6 -> 8 -> 8 -> 16)
// is bound by reading x. The layers run on the tensor cores in 3xTF32
// (tf32x3.cuh: mma.sync, each k-step's three products summed from zero and
// added to the fp32 accumulator), which keeps fp32's accuracy (within atol
// 3e-5 / rtol 1e-4 of the plain version in full fp32, also on raw grouped
// coordinates at KITTI's 80 m); the weights, packed by ops/tf32x3.py in mma
// fragment order, stream from L2 through a ring of shared-memory slabs by
// bulk asynchronous copies (TMA).
//
// Design: a block walks its rows in tiles of tile_rows (16 to 128, a
// multiple of the 16-row mma tile; the wrapper picks both numbers, and a
// layer wider than 64 columns allows at most 64 rows). Each tile: its rows
// of x staged into shared memory by cp.async (one contiguous run of x; the
// columns up to pad8(Cin) and the rows past the block's last centre zero, as
// zero weights times garbage may be NaN), the program of 1-3 layers run over
// it (outputs placed in an arena by liveness: at most two values live), then
// the max over each centre's rows of the last output. A pad row holds
// relu(bias) and is no neighbour, so it never enters the max. A centre whose
// K rows span tiles (K above the tile) is taken in passes: its first tile
// writes its max, a later one takes the max with what is there. The max
// splits a centre's rows among up to 32 lanes (combined by shuffles) where
// the tile has fewer (centre, channel) pairs than threads.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

using namespace pwclo_tc;

constexpr int kMaxStackLayers = 3;

struct Layout {  // offsets in floats into dynamic shared memory
  int bias, x, x_ld, h, h_ld;  // the bias area, the staged x, the last layer's output
  int tile_rows, cout;
};

// TILES: the most n-tiles a warp takes (tf32x3.cuh, run_program); a narrow
// stack's accumulators take fewer registers, so more blocks share an SM
template <int TILES, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
mlp_maxpool_kernel(const __grid_constant__ Program prog, const float* __restrict__ x,
                   int centres, int k, int cin, int block_centres, Layout lay,
                   float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ uint64_t full[kStages];
  const Ring ring{smem, full};
  init_ring(ring);

  const int c0 = blockIdx.x * block_centres;
  const int rows = min(block_centres, centres - c0) * k;
  const float* src = x + static_cast<size_t>(c0) * k * cin;  // the block's rows: one run of x
  float* dst = out + static_cast<size_t>(c0) * lay.cout;
  const float* h = smem + lay.h;
  int s = 0;  // slabs the ring has taken so far
  for (int r0 = 0; r0 < rows; r0 += lay.tile_rows) {
    const int n = min(lay.tile_rows, rows - r0);
    // the weights' first slabs (thread 0, which set up the ring) in flight
    // while x loads
    const SlabCursor next = prefetch_program(prog, ring, smem + lay.bias, s);
    stage_rows(smem + lay.x, lay.x_ld, src + static_cast<size_t>(r0) * cin, cin, n,
               lay.tile_rows);
    if (r0 == 0) __syncthreads();  // the ring's barriers set up for every thread
    s = run_program<TILES>(prog, next, smem, ring, smem + lay.bias, 0, s);

    // max over the rows of each centre in the tile, (centre, channel) pairs
    // split lanes apart; the loop is uniform across the block (shuffles)
    const int first = r0 / k;
    const int items = ((r0 + n - 1) / k - first + 1) * lay.cout;
    int split = 1;
    while (split < 32 && items * split * 2 <= kThreads && split * 2 <= min(k, n)) split *= 2;
    for (int base = 0; base < items * split; base += kThreads) {
      const int i = base + static_cast<int>(threadIdx.x);
      const int item = i / split, part = i - item * split;
      const int c = first + item / lay.cout, j = item - (item / lay.cout) * lay.cout;
      float m = -INFINITY;
      if (item < items) {
        const int hi = min(c * k + k, r0 + n) - r0;
        for (int r = max(c * k, r0) - r0 + part; r < hi; r += split)
          m = fmaxf(m, h[r * lay.h_ld + j]);
      }
      for (int off = split / 2; off > 0; off /= 2)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (item < items && part == 0) {
        float* o = dst + static_cast<size_t>(c) * lay.cout + j;
        *o = c * k >= r0 ? m : fmaxf(*o, m);  // the centre's first tile, or a later pass
      }
    }
    if (r0 + lay.tile_rows < rows) __syncthreads();  // the next tile's x may overwrite h
  }
}

}  // namespace

// x (centres, K, c0) f32; params: the stack's layers packed by
// ops/tf32x3.py::pack_fragments (parts (c0,)); out (centres, c_last) f32.
// n_layers in 1..3, widths past n_layers ignored, each at most kMaxWidth. A
// block takes block_centres centres and walks their rows tile_rows at a time
// (a multiple of 16, at most 128; at most 64 where a layer is wider than 64).
extern "C" int pwclo_mlp_maxpool(const void* x, const void* params, int centres, int k,
                                 int n_layers, int c0, int c1, int c2, int c3,
                                 int block_centres, int tile_rows, void* out, void* stream) {
  const int cout[kMaxStackLayers] = {c1, c2, c3};
  if (k < 1 || c0 < 1 || centres < 0 || block_centres < 1 || n_layers < 1 ||
      n_layers > kMaxStackLayers || tile_rows < kTileRows || tile_rows % kTileRows != 0 ||
      tile_rows > kWarps * kTileRows)
    return kUnsupported;
  for (int i = 0; i < n_layers; ++i)
    if (cout[i] < 1 || cout[i] > kMaxWidth) return kUnsupported;
  if (centres == 0) return 0;

  Program prog{};
  prog.mtiles = tile_rows / kTileRows;
  Layout lay{};
  lay.tile_rows = tile_rows;
  lay.cout = cout[n_layers - 1];
  // shared memory: the weight ring, every layer's bias, then the arena
  int bias_floats = 0;
  for (int i = 0; i < n_layers; ++i) bias_floats += pad8(cout[i]);
  lay.bias = kStages * kSlotFloats;
  const int base = lay.bias + bias_floats;
  Arena arena;
  auto value = [&](int width) {  // tile_rows x width floats in the arena
    const int at = arena.alloc(tile_rows * act_ld(width));
    return PartDesc{at < 0 ? at : base + at, act_ld(width), pad8(width) / 8, 0};
  };
  PartDesc in = value(c0);
  if (in.off < 0) return kUnsupported;
  lay.x = in.off;
  lay.x_ld = in.ld;
  const float* w = static_cast<const float*>(params);
  for (int i = 0; i < n_layers; ++i) {
    // placed before its input is released, so never on it
    const PartDesc o = value(cout[i]);
    const int used = o.off < 0 ? kUnsupported : add_layer(prog, w, &in, 1, cout[i], o.off, o.ld);
    if (used < 0) return kUnsupported;
    w += used;
    arena.release(in.off - base);
    in = o;
  }
  lay.h = in.off;
  lay.h_ld = in.ld;
  const int64_t smem = (int64_t{base} + arena.top) * static_cast<int64_t>(sizeof(float));
  const int64_t static_smem = kStages * static_cast<int64_t>(sizeof(uint64_t));
  if (smem + static_smem > kMaxDynamicSmem) return kUnsupported;

  const int tiles = max_warp_ntiles(prog);
  const auto kernel = tiles <= 2   ? &mlp_maxpool_kernel<2, 4>
                     : tiles <= 4 ? &mlp_maxpool_kernel<4, 3>
                                  : &mlp_maxpool_kernel<8, 2>;
  const int err = allow_dynamic_smem(kernel, static_cast<int>(smem));
  if (err != 0) return err;
  const int blocks = (centres + block_centres - 1) / block_centres;
  kernel<<<blocks, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      prog, static_cast<const float*>(x), centres, k, c0, block_centres, lay,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
