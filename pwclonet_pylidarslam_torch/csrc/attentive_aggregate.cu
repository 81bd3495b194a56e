// Fused attentive neighbourhood aggregate of the cost volume on Hopper (sm_90a):
//   enc = [p, q, q - p, |q - p|]                      (10-d, per neighbour)
//   emb = MLP_emb([enc, center_feat, grouped_feat])    or grouped_feat
//   att = MLP_att([MLP_enc(enc), (center_feat,) emb])
//   out = sum_k softmax_k(att) * emb                   (per centre and channel)
// with eval-mode BatchNorm folded into every (W, b).
//
// Replaces: pwclonet_pylidarslam_tpu/ops/pallas/costvolume_kernel.py::
// attentive_aggregate_pallas. As there, the encoding is computed on chip
// from the coordinates, no concatenation is built (a first layer reads its
// inputs part by part against row ranges of its weight, the centre features
// once per centre and not once per neighbour), both stacks, the attention
// and the softmax stay on chip, and only (centres, D) is written. A block
// takes the next tile_centres whole centres of the flat (batch x centre)
// axis, so neither the softmax nor the sum over K straddles blocks, and the
// last block takes what is left. K need not be a power of two (the main
// path has K = 4, 6, 32).
//
// What bounds it: operations. The reference computes every product at
// Precision.HIGHEST, so the fp32 bound is 2 x rows x (sum of Cin x Cout) over
// 67 TFLOP/s on the CUDA cores; 3xTF32 on the tensor cores does three TF32
// products for each, 6 x rows x (sum of Cin x Cout) over 495 TFLOP/s: 2.5x
// less. The layers run on the tensor cores in 3xTF32 (tf32x3.cuh), which
// keeps fp32's accuracy (within atol 5e-5 / rtol 1e-4 of the plain version in
// full fp32, also at KITTI's 80 m). Every block streams every layer's
// weights from L2 (0.11-0.23 MB a block at the path's widths) through a ring
// of shared-memory slabs by bulk asynchronous copies (TMA), the next slab
// loading while the current one is multiplied.
//
// Tile: 16 to 64 rows (one to four 16-row mma tiles, tile_centres whole
// centres; the wrapper takes the widest whose blocks still number at least
// half the SMs: a wider tile streams the weights for more rows); 8 warps,
// each a row tile and a share of the n-tiles of every layer. Shared memory
// holds the weight ring (24 KB), the biases and an arena for the encoding,
// the tile's centre and grouped features and the layers' outputs, placed by
// liveness: at most 102 KB at the path's shapes, so that two blocks
// share an SM (the kernel is bound by latency as much as by the tensor
// cores, and the second block hides it). Timed on the path's shapes and
// slower or no faster (PERF.md, PR 7): 16 warps a block, with 64- or
// 128-row tiles; tiles that give every SM two blocks; splitting a narrow
// tile's k-steps among its warps; weights split into TF32 planes before
// they reach shared memory (8 bytes a weight); per-thread cp.async for the
// weights; a fourth ring slot.
// The softmax subtracts the max over K, divides by the sum (a true
// division), then weights emb; expf, sqrtf and / at IEEE rounding.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "tf32x3.cuh"

namespace {

using namespace pwclo_tc;

constexpr int kEnc = 10;
constexpr int kEncLd = act_ld(kEnc);  // 20
constexpr int kMaxStackLayers = 3;

struct Layout {  // offsets in floats into dynamic shared memory
  int bias, enc, cfeat, gfeat;
  int ld_c, ld_g;
  int att, att_ld, emb, emb_ld;  // the last layer's output and the embedding
  int rows_pad;
};

__global__ void __launch_bounds__(kThreads, 2)
attentive_aggregate_kernel(const __grid_constant__ Program prog,
                           const float* __restrict__ cxyz, const float* __restrict__ gxyz,
                           const float* __restrict__ cfeat, const float* __restrict__ gfeat,
                           int centres, int k, int cc, int cg, int d, int tile_centres,
                           Layout lay, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ uint64_t full[kStages];
  const Ring ring{smem, full};
  init_ring(ring);

  const int c0 = blockIdx.x * tile_centres;
  const int nc = min(tile_centres, centres - c0);
  const int rows = nc * k;
  const size_t row0 = static_cast<size_t>(c0) * k;

  // centre features, one row per centre, and grouped features, one row per
  // pair, copied asynchronously (16 bytes at a time where rows allow);
  // columns past the width and the pad rows zero
  float* cf = smem + lay.cfeat;
  const float* cf_src = cfeat + static_cast<size_t>(c0) * cc;
  float* gf = smem + lay.gfeat;
  const float* gf_src = gfeat + row0 * cg;
  stage_rows(cf, lay.ld_c, cf_src, cc, nc, nc);
  stage_rows(gf, lay.ld_g, gf_src, cg, rows, lay.rows_pad);
  __syncthreads();  // the ring's barriers set up
  const SlabCursor next = prefetch_program(prog, ring, smem + lay.bias);

  // 10-d spatial encoding of every (centre, neighbour) pair; zero pad rows
  // and the columns up to 16
  float* enc = smem + lay.enc;
  for (int r = threadIdx.x; r < lay.rows_pad; r += blockDim.x) {
    float* e = enc + r * kEncLd;
    if (r < rows) {
      const float* p = cxyz + static_cast<size_t>(c0 + r / k) * 3;
      const float* q = gxyz + (row0 + r) * 3;
      const float px = p[0], py = p[1], pz = p[2];
      const float qx = q[0], qy = q[1], qz = q[2];
      const float dx = qx - px, dy = qy - py, dz = qz - pz;
      e[0] = px, e[1] = py, e[2] = pz;
      e[3] = qx, e[4] = qy, e[5] = qz;
      e[6] = dx, e[7] = dy, e[8] = dz;
      e[9] = sqrtf(dx * dx + dy * dy + dz * dz + 1e-20f);
    } else {
      for (int i = 0; i < kEnc; ++i) e[i] = 0.0f;
    }
    for (int i = kEnc; i < pad8(kEnc); ++i) e[i] = 0.0f;
  }

  run_program(prog, next, smem, ring, smem + lay.bias, nc - 1);

  // softmax over the K neighbours, then the weighted sum of emb; a thread
  // owns one (centre, channel) column of att and reuses it for the exps
  float* att = smem + lay.att;
  const float* emb = smem + lay.emb;
  for (int idx = threadIdx.x; idx < nc * d; idx += blockDim.x) {
    const int c = idx / d;
    const int j = idx - c * d;
    float* a = att + c * k * lay.att_ld + j;
    const float* v = emb + c * k * lay.emb_ld + j;
    float m = a[0];
#pragma unroll 4
    for (int kk = 1; kk < k; ++kk) m = fmaxf(m, a[kk * lay.att_ld]);
    float sum = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < k; ++kk) {
      const float ex = expf(a[kk * lay.att_ld] - m);
      a[kk * lay.att_ld] = ex;
      sum += ex;
    }
    float acc = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < k; ++kk) acc += (a[kk * lay.att_ld] / sum) * v[kk * lay.emb_ld];
    out[static_cast<size_t>(c0 + c) * d + j] = acc;
  }
}

struct StackArgs {
  const float* params;  // packed layers (pack_fragments)
  int n;
  int cout[kMaxStackLayers];
};

}  // namespace

// center_xyz (centres, 3), grouped_xyz (centres, K, 3), center_feat (centres, cc),
// grouped_feat (centres, K, cg), out (centres, D), all f32. Each stack's
// params are its layers packed by ops/tf32x3.py::pack_fragments, the first
// layer's rows padded part by part: enc [10]; emb [10, cc, cg]; att
// [enc_out, (cc,) D], with D = emb_out, or cg where n_emb = 0 (grouped_feat
// is the embedding). A block takes tile_centres centres (K x tile_centres
// rows, at most 8 x 16 after padding).
extern "C" int pwclo_attentive_aggregate(
    const void* center_xyz, const void* grouped_xyz, const void* center_feat,
    const void* grouped_feat, const void* enc_params, const void* emb_params,
    const void* att_params, int centres, int k, int cc, int cg, int n_enc, int e1, int e2,
    int e3, int n_emb, int m1, int m2, int m3, int n_att, int a1, int a2, int a3,
    int att_includes_center, int tile_centres, void* out, void* stream) {
  const StackArgs enc_st{static_cast<const float*>(enc_params), n_enc, {e1, e2, e3}};
  const StackArgs emb_st{static_cast<const float*>(emb_params), n_emb, {m1, m2, m3}};
  const StackArgs att_st{static_cast<const float*>(att_params), n_att, {a1, a2, a3}};
  if (k < 1 || cc < 1 || cg < 1 || centres < 0 || tile_centres < 1) return kUnsupported;
  if (n_enc < 1 || n_enc > kMaxStackLayers || n_emb < 0 || n_emb > kMaxStackLayers ||
      n_att < 1 || n_att > kMaxStackLayers)
    return kUnsupported;
  const int d = n_emb > 0 ? emb_st.cout[n_emb - 1] : cg;
  if (att_st.cout[n_att - 1] != d) return kUnsupported;
  if (centres == 0) return 0;

  Program prog{};
  Layout lay{};
  lay.rows_pad = (tile_centres * k + kTileRows - 1) / kTileRows * kTileRows;
  prog.mtiles = lay.rows_pad / kTileRows;
  if (prog.mtiles > kWarps) return kUnsupported;
  // shared memory: the weight ring, every layer's bias, then the arena
  int bias_floats = 0;
  for (const StackArgs* st : {&enc_st, &emb_st, &att_st})
    for (int i = 0; i < st->n; ++i) bias_floats += pad8(st->cout[i]);
  lay.bias = kStages * kSlotFloats;
  const int base = lay.bias + bias_floats;
  Arena arena;
  auto value = [&](int rows, int width) {  // rows x width floats in the arena
    const int at = arena.alloc(rows * act_ld(width));
    return PartDesc{at < 0 ? at : base + at, act_ld(width), pad8(width) / 8, 0};
  };
  PartDesc enc_part = value(lay.rows_pad, kEnc);
  PartDesc cf_part = value(tile_centres, cc);
  const PartDesc gf_part = value(lay.rows_pad, cg);
  cf_part.group = k;
  lay.enc = enc_part.off;
  lay.cfeat = cf_part.off;
  lay.gfeat = gf_part.off;
  lay.ld_c = cf_part.ld;
  lay.ld_g = gf_part.ld;
  // a layer's output is placed before its inputs are released, so never on them
  auto layer = [&](const float*& w, const PartDesc* in, int n_in, int cout, PartDesc& o) {
    o = value(lay.rows_pad, cout);
    const int used = o.off < 0 ? kUnsupported : add_layer(prog, w, in, n_in, cout, o.off, o.ld);
    w += used;
    return used >= 0;
  };

  // emb = MLP_emb([enc, center_feat, grouped_feat]), or grouped_feat itself;
  // grouped_feat is read by the first layer only
  PartDesc emb_part = gf_part;
  if (n_emb > 0) {
    const float* w = emb_st.params;
    PartDesc in[kMaxParts] = {enc_part, cf_part, gf_part};
    int n_in = 3;
    for (int i = 0; i < n_emb; ++i) {
      PartDesc o;
      if (!layer(w, in, n_in, emb_st.cout[i], o)) return kUnsupported;
      arena.release(i == 0 ? gf_part.off - base : in[0].off - base);
      in[0] = o, n_in = 1;
    }
    emb_part = in[0];
  }
  // e = MLP_enc(enc); the encoding is read by no later layer
  PartDesc e_part = enc_part;
  {
    const float* w = enc_st.params;
    for (int i = 0; i < n_enc; ++i) {
      PartDesc o;
      if (!layer(w, &e_part, 1, enc_st.cout[i], o)) return kUnsupported;
      arena.release(e_part.off - base);
      e_part = o;
    }
  }
  // att = MLP_att([e, (center_feat,) emb])
  {
    const float* w = att_st.params;
    PartDesc in[kMaxParts];
    int n_in = 0;
    in[n_in++] = e_part;
    if (att_includes_center) in[n_in++] = cf_part;
    in[n_in++] = emb_part;
    for (int i = 0; i < n_att; ++i) {
      PartDesc o;
      if (!layer(w, in, n_in, att_st.cout[i], o)) return kUnsupported;
      arena.release(in[0].off - base);
      in[0] = o, n_in = 1;
    }
    lay.att = in[0].off;
    lay.att_ld = in[0].ld;
  }
  lay.emb = emb_part.off;
  lay.emb_ld = emb_part.ld;
  const int64_t smem = (int64_t{base} + arena.top) * static_cast<int64_t>(sizeof(float));
  const int64_t static_smem = kStages * static_cast<int64_t>(sizeof(uint64_t));
  if (enc_part.off < 0 || cf_part.off < 0 || gf_part.off < 0 ||
      smem + static_smem > kMaxDynamicSmem)
    return kUnsupported;

  const int err = allow_dynamic_smem(attentive_aggregate_kernel, static_cast<int>(smem));
  if (err != 0) return err;
  const int blocks = (centres + tile_centres - 1) / tile_centres;
  attentive_aggregate_kernel<<<blocks, kThreads, static_cast<size_t>(smem),
                               static_cast<cudaStream_t>(stream)>>>(
      prog, static_cast<const float*>(center_xyz), static_cast<const float*>(grouped_xyz),
      static_cast<const float*>(center_feat), static_cast<const float*>(grouped_feat), centres,
      k, cc, cg, d, tile_centres, lay, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
