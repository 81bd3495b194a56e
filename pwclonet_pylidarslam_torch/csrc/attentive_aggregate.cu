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
// and the softmax stay on chip, and only (centres, D) is written. Unlike
// the TPU kernel nothing is padded and sliced back: a block takes the next
// tile_centres whole centres of the flat (batch x centre) axis, so neither
// the softmax nor the sum over K straddles blocks, and the last block takes
// what is left. K need not be a power of two (the main path has K = 4, 6, 32).
//
// What bounds it: operations (2 * rows * sum of Cin * Cout in fp32 on the
// CUDA cores: the reference's full-f32 products, no TF32, no tensor cores).
// Design: a tile of at most about kTargetRows rows (fewer where the call is
// small, tile_centres_for); shared memory holds the encoding, the tile's
// centre features, the grouped features and two or three work buffers of
// rows x ld floats: about 60 KB for a 32-row tile at the widest call and
// twice that for a 64-row one, so one to three
// blocks share an SM. Layers are the register-tiled dense_relu of
// dense_tile.cuh. The softmax subtracts the max over K, divides by the sum
// (a true division), then weights emb; expf, sqrtf and / at IEEE rounding.

#include <cuda_runtime.h>

#include <cstdint>

#include "dense_tile.cuh"

namespace {

using namespace pwclo;

constexpr int kTargetRows = 64;
constexpr int kEnc = 10;
constexpr int kEncLd = 11;

struct Layout {  // offsets in floats into dynamic shared memory
  int enc, cfeat, gfeat, work;
  int ld_c, ld_g, ld_w, n_work;
  int rows_pad, tile_centres;
};

// first work buffer that is neither a nor b (three buffers, or two when only
// one can be excluded)
__device__ inline float* pick(float* work, int stride, int n_work, const float* a,
                              const float* b) {
  for (int i = 0; i < n_work; ++i) {
    float* w = work + static_cast<size_t>(i) * stride;
    if (w != a && w != b) return w;
  }
  return nullptr;
}

__global__ void __launch_bounds__(kThreads)
attentive_aggregate_kernel(const float* __restrict__ cxyz, const float* __restrict__ gxyz,
                           const float* __restrict__ cfeat, const float* __restrict__ gfeat,
                           Stack enc_st, Stack emb_st, Stack att_st, int centres, int k, int cc,
                           int cg, int att_includes_center, Layout lay,
                           float* __restrict__ out) {
  extern __shared__ float smem[];
  float* enc = smem + lay.enc;
  float* cf = smem + lay.cfeat;
  float* gf = smem + lay.gfeat;
  float* work = smem + lay.work;
  const int rows_pad = lay.rows_pad;
  const int stride = rows_pad * lay.ld_w;

  const int c0 = blockIdx.x * lay.tile_centres;
  const int nc = min(lay.tile_centres, centres - c0);
  const int rows = nc * k;
  const size_t row0 = static_cast<size_t>(c0) * k;

  // 10-d spatial encoding of every (centre, neighbour) pair; zero pad rows
  for (int r = threadIdx.x; r < rows_pad; r += blockDim.x) {
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
  }
  // centre features, one row per centre; grouped features, one row per pair
  const float* cf_src = cfeat + static_cast<size_t>(c0) * cc;
  for (int idx = threadIdx.x; idx < nc * cc; idx += blockDim.x) {
    const int c = idx / cc;
    cf[c * lay.ld_c + (idx - c * cc)] = cf_src[idx];
  }
  const float* gf_src = gfeat + row0 * cg;
  for (int idx = threadIdx.x; idx < rows_pad * cg; idx += blockDim.x) {
    const int r = idx / cg;
    gf[r * lay.ld_g + (idx - r * cg)] = r < rows ? gf_src[idx] : 0.0f;
  }
  __syncthreads();

  const Part enc_part{enc, kEncLd, kEnc, 1, rows_pad - 1};
  const Part cf_part{cf, lay.ld_c, cc, k, nc - 1};

  // emb = MLP_emb([enc, center_feat, grouped_feat]), or grouped_feat itself
  const float* emb = gf;
  int ld_emb = lay.ld_g;
  int d = cg;
  if (emb_st.n > 0) {
    const float* params = emb_st.params;
    Parts parts;
    parts.n = 3;
    parts.p[0] = enc_part;
    parts.p[1] = cf_part;
    parts.p[2] = Part{gf, lay.ld_g, cg, 1, rows_pad - 1};
    int cin = emb_st.cin;
    const float* cur = nullptr;
    for (int layer = 0; layer < emb_st.n; ++layer) {
      const int cout = emb_st.cout[layer];
      float* dst = pick(work, stride, lay.n_work, cur, nullptr);
      dense_relu(parts, params, params + cin * cout, cout, dst, lay.ld_w, rows_pad);
      __syncthreads();
      params += cin * cout + cout;
      cin = cout;
      cur = dst;
      parts = one_part(cur, lay.ld_w, cin, rows_pad);
    }
    emb = cur;
    ld_emb = lay.ld_w;
    d = cin;
  }

  // e = MLP_enc(enc)
  const float* e_out = nullptr;
  int d_enc = kEnc;
  {
    const float* params = enc_st.params;
    Parts parts;
    parts.n = 1;
    parts.p[0] = enc_part;
    for (int layer = 0; layer < enc_st.n; ++layer) {
      const int cout = enc_st.cout[layer];
      float* dst = pick(work, stride, lay.n_work, e_out, emb);
      dense_relu(parts, params, params + d_enc * cout, cout, dst, lay.ld_w, rows_pad);
      __syncthreads();
      params += d_enc * cout + cout;
      d_enc = cout;
      e_out = dst;
      parts = one_part(e_out, lay.ld_w, d_enc, rows_pad);
    }
  }

  // att = MLP_att([e, (center_feat,) emb])
  float* att = nullptr;
  {
    const float* params = att_st.params;
    Parts parts;
    parts.n = 0;
    parts.p[parts.n++] = Part{e_out, lay.ld_w, d_enc, 1, rows_pad - 1};
    if (att_includes_center) parts.p[parts.n++] = cf_part;
    parts.p[parts.n++] = Part{emb, ld_emb, d, 1, rows_pad - 1};
    int cin = att_st.cin;
    for (int layer = 0; layer < att_st.n; ++layer) {
      const int cout = att_st.cout[layer];
      // the first layer still reads e; later layers may overwrite it
      float* dst = pick(work, stride, lay.n_work, layer == 0 ? e_out : att, emb);
      dense_relu(parts, params, params + cin * cout, cout, dst, lay.ld_w, rows_pad);
      __syncthreads();
      params += cin * cout + cout;
      cin = cout;
      att = dst;
      parts = one_part(att, lay.ld_w, cin, rows_pad);
    }
  }

  // softmax over the K neighbours, then the weighted sum of emb; a thread
  // owns one (centre, channel) column of att and reuses it for the exps
  for (int idx = threadIdx.x; idx < nc * d; idx += blockDim.x) {
    const int c = idx / d;
    const int j = idx - c * d;
    float* a = att + static_cast<size_t>(c) * k * lay.ld_w + j;
    const float* v = emb + static_cast<size_t>(c) * k * ld_emb + j;
    float m = a[0];
    for (int kk = 1; kk < k; ++kk) m = fmaxf(m, a[kk * lay.ld_w]);
    float sum = 0.0f;
    for (int kk = 0; kk < k; ++kk) {
      const float ex = expf(a[kk * lay.ld_w] - m);
      a[kk * lay.ld_w] = ex;
      sum += ex;
    }
    float acc = 0.0f;
    for (int kk = 0; kk < k; ++kk) acc += (a[kk * lay.ld_w] / sum) * v[kk * ld_emb];
    out[static_cast<size_t>(c0 + c) * d + j] = acc;
  }
}

}  // namespace

// center_xyz (centres, 3), grouped_xyz (centres, K, 3), center_feat (centres, cc),
// grouped_feat (centres, K, cg), out (centres, D), all f32. Each stack's params
// are W0, b0, W1, b1, ... packed; n_emb = 0 takes grouped_feat as the embedding.
// Input widths follow from the rest: enc 10; emb 10 + cc + cg; att
// enc_out + (cc if att_includes_center) + D, with D = emb_out or cg.
extern "C" int pwclo_attentive_aggregate(
    const void* center_xyz, const void* grouped_xyz, const void* center_feat,
    const void* grouped_feat, const void* enc_params, const void* emb_params,
    const void* att_params, int centres, int k, int cc, int cg, int n_enc, int e1, int e2,
    int e3, int n_emb, int m1, int m2, int m3, int n_att, int a1, int a2, int a3,
    int att_includes_center, void* out, void* stream) {
  if (k < 1 || cc < 1 || cg < 1 || centres < 0) return kUnsupportedShape;
  const Stack enc_st = make_stack(enc_params, n_enc, kEnc, e1, e2, e3);
  const Stack emb_st = make_stack(emb_params, n_emb, kEnc + cc + cg, m1, m2, m3);
  if (!stack_ok(enc_st, 1) || !stack_ok(emb_st, 0)) return kUnsupportedShape;
  const int d = n_emb > 0 ? stack_out(emb_st) : cg;
  const Stack att_st = make_stack(
      att_params, n_att, stack_out(enc_st) + (att_includes_center ? cc : 0) + d, a1, a2, a3);
  if (!stack_ok(att_st, 1) || stack_out(att_st) != d) return kUnsupportedShape;
  if (centres == 0) return 0;

  Layout lay;
  lay.tile_centres = tile_centres_for(centres, k, kTargetRows);
  lay.rows_pad = round_up(lay.tile_centres * k, kRowTile);
  int width = stack_max_width(enc_st);
  if (stack_max_width(att_st) > width) width = stack_max_width(att_st);
  if (n_emb > 0 && stack_max_width(emb_st) > width) width = stack_max_width(emb_st);
  lay.ld_c = lead_dim(cc);
  lay.ld_g = lead_dim(cg);
  lay.ld_w = lead_dim(width);
  lay.n_work = n_emb > 0 ? 3 : 2;
  lay.enc = 0;
  lay.cfeat = lay.enc + lay.rows_pad * kEncLd;
  lay.gfeat = lay.cfeat + lay.tile_centres * lay.ld_c;
  lay.work = lay.gfeat + lay.rows_pad * lay.ld_g;
  const int64_t total =
      static_cast<int64_t>(lay.work) + static_cast<int64_t>(lay.n_work) * lay.rows_pad * lay.ld_w;
  const int64_t smem = total * static_cast<int64_t>(sizeof(float));
  if (smem > kMaxDynamicSmem) return kUnsupportedShape;
  const int err = allow_dynamic_smem(attentive_aggregate_kernel, static_cast<int>(smem));
  if (err != 0) return err;
  const int blocks = (centres + lay.tile_centres - 1) / lay.tile_centres;
  attentive_aggregate_kernel<<<blocks, kThreads, static_cast<size_t>(smem),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(center_xyz), static_cast<const float*>(grouped_xyz),
      static_cast<const float*>(center_feat), static_cast<const float*>(grouped_feat), enc_st,
      emb_st, att_st, centres, k, cc, cg, att_includes_center, lay, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
