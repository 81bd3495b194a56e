// Dense layers relu(h . W + b) on Hopper's tensor cores at fp32 accuracy,
// over a tile of rows that lives in shared memory (sm_90a).
//
// Products: warp-level mma.sync.m16n8k8 with TF32 inputs and fp32
// accumulators, in the 3xTF32 scheme (CUTLASS's OpMultiplyAddFastF32): every
// operand x is split into big = tf32(x) and small = tf32(x - big) (rounded
// to nearest, ties away, on the float's bits: tf32_bits), and each product
// is taken as big.small' + small.big' + big.big' (small.small', below 2^-22
// of the product, is dropped). That keeps about 22 of fp32's 24 mantissa
// bits, where plain TF32 keeps 11. The tensor cores truncate as they
// accumulate, so a chain of 3 x K / 8 mma into one sum drifts (10x fp32's
// error at the path's K): a k-step's three products are summed from zero
// and added to the fp32 accumulator with a rounded add.
//
// Weights: the wrapper pads every layer to K and N multiples of 8 (zero rows
// and columns; an input made of several parts is padded part by part) and
// lays it out in fragment order (ops/tf32x3.py::pack_fragments):
//   for k-step s (8 rows), n-tile j (8 columns), lane (g = lane / 4, t = lane % 4):
//     float2 {w[8s+t][8j+g], w[8s+t+4][8j+g]}
// then the bias, padded to N. A lane reads its B fragment as one 8-byte
// shared-memory load (a warp's 32 are one contiguous 256-byte run: no bank
// conflict) and splits it in registers; stored unsplit, a weight costs 4
// bytes of L2 traffic, not 8, and every block streams every layer. The
// layers of a program stream through a ring of kStages slots of shared
// memory as slabs of whole k-steps, each one bulk asynchronous copy
// (cp.async.bulk, the TMA engine; one thread issues it) that completes its
// slot's mbarrier: slab s + kStages - 1 is in flight while slab s is
// multiplied, one block barrier a slab (it also frees the slot the next copy
// overwrites). All biases and the caller's inputs are copied once, up front,
// by per-thread cp.async.
//
// Activations: fp32 rows in shared memory, leading dimension pad8(width) + 4
// floats: ld / 4 is odd, so the eight rows g of an A fragment fall on eight
// distinct groups of four banks (conflict-free). Columns past the width are
// zero (the padded weights are zero too, but 0 x garbage may be NaN). A part
// with group = K holds one row per centre, read by all K of its rows. The
// host places each layer's output in an arena by liveness (Arena), so that
// a block's shared memory stays small enough for two blocks an SM.
//
// Work split: a block holds mtiles tiles of 16 rows (one mma M each). Warp w
// takes the row tile w % mtiles and, of a layer's N / 8 n-tiles, the
// contiguous share w / mtiles of kWarps / mtiles shares; it keeps up to
// kMaxWarpNTiles accumulator tiles (32 floats a thread). So every warp with a
// share has work in every layer of the path at 1, 2 and 4 row tiles, and an
// A fragment (split once) feeds up to 8 n-tiles.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace pwclo_tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 16;  // rows of one mma tile
constexpr int kMaxWarpNTiles = 8;
constexpr int kStages = 3;
constexpr int kSlotFloats = 2048;  // 8 KB a ring slot: two k-steps of a 128-wide layer
constexpr int kMaxProgramLayers = 9;
constexpr int kMaxParts = 3;
constexpr int kMaxWidth = 128;  // widest layer output: 16 n-tiles over two warps
// what a block may ask for on sm_90 (227 KB), and what it gets without asking
constexpr int kMaxDynamicSmem = 232448;
constexpr int kDefaultDynamicSmem = 49152;
// returned by the C entry points for a shape the kernel does not take
constexpr int kUnsupported = -1;

__host__ __device__ constexpr int pad8(int x) { return (x + 7) / 8 * 8; }
__host__ __device__ constexpr int act_ld(int width) { return pad8(width) + 4; }
// floats of one packed layer: kp x np fragments, then np of bias
__host__ __device__ constexpr int layer_floats(int kp, int np) { return kp * np + np; }

// Rows of a layer input in shared memory: row r reads
// smem[off + (group > 0 ? min(r / group, last) : r) * ld + c], c < 8 * ksteps:
// group 0 holds a row per row, group g >= 1 a row per g rows (a centre's).
struct PartDesc {
  int off;
  int ld;
  int ksteps;
  int group;
};

struct LayerDesc {
  const float* w;     // fragments in global memory, kp / 8 k-steps of ntiles x 64 floats
  const float* bias;  // 8 * ntiles floats
  PartDesc part[kMaxParts];
  int n_parts;
  int out;  // offset of the output rows in shared memory
  int out_ld;
  int ksteps;
  int ntiles;
  int ksteps_per_slab;
  int slabs;
  int bias_off;  // offset of the bias in the block's shared-memory bias area
};

struct Program {
  LayerDesc layer[kMaxProgramLayers];
  int n_layers;
  int bias_floats;  // the bias area: every layer's padded bias
  int mtiles;
};

// Host: first-fit placement of row blocks (rows x ld floats) in a shared-
// memory arena, by liveness: a value is allocated before the layer that
// writes it and released after the last layer that reads it, so an output
// never overlaps its inputs. Sizes are multiples of 4 floats (16 bytes).
struct Arena {
  static constexpr int kMaxLive = 12;
  int off[kMaxLive], size[kMaxLive];
  int n = 0, top = 0;

  int alloc(int floats) {  // offset, or kUnsupported
    if (n == kMaxLive) return kUnsupported;
    int at = 0;
    for (bool moved = true; moved;) {
      moved = false;
      for (int i = 0; i < n; ++i)
        if (at < off[i] + size[i] && off[i] < at + floats) at = off[i] + size[i], moved = true;
    }
    off[n] = at, size[n] = floats, ++n;
    top = at + floats > top ? at + floats : top;
    return at;
  }
  void release(int offset) {
    for (int i = 0; i < n; ++i)
      if (off[i] == offset) {
        off[i] = off[n - 1], size[i] = size[n - 1], --n;
        return;
      }
  }
};

// Host: append a layer reading `parts` (already padded, in the order of the
// weight's rows) and writing `cout` columns at out / out_ld; `w` points at
// the packed layer; p.mtiles set. Returns the floats the packed layer
// takes, or kUnsupported.
inline int add_layer(Program& p, const float* w, const PartDesc* parts, int n_parts, int cout,
                     int out, int out_ld) {
  if (p.n_layers >= kMaxProgramLayers || n_parts < 1 || n_parts > kMaxParts || cout < 1 ||
      cout > kMaxWidth || p.mtiles < 1 || p.mtiles > kWarps)
    return kUnsupported;
  LayerDesc& L = p.layer[p.n_layers];
  int ksteps = 0;
  for (int i = 0; i < n_parts; ++i) {
    L.part[i] = parts[i];
    ksteps += parts[i].ksteps;
  }
  const int np = pad8(cout);
  const int shares = kWarps / p.mtiles;
  if ((np / 8 + shares - 1) / shares > kMaxWarpNTiles) return kUnsupported;
  L.n_parts = n_parts;
  L.w = w;
  L.bias = w + (8 * ksteps) * np;
  L.out = out;
  L.out_ld = out_ld;
  L.ksteps = ksteps;
  L.ntiles = np / 8;
  L.ksteps_per_slab = kSlotFloats / (np * 8);
  L.slabs = (ksteps + L.ksteps_per_slab - 1) / L.ksteps_per_slab;
  L.bias_off = p.bias_floats;
  p.bias_floats += np;
  ++p.n_layers;
  return layer_floats(8 * ksteps, np);
}

// Host: the most n-tiles a warp takes in any layer of the program: what
// run_program's TILES must reach (rounded up to a power of two).
inline int max_warp_ntiles(const Program& p) {
  const int shares = kWarps / p.mtiles;
  int most = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const int per = (p.layer[l].ntiles + shares - 1) / shares;
    most = per > most ? per : most;
  }
  return most;
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 rounds: add half the unit of the 13 dropped bits to
// the magnitude, then clear them
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

// d += a . b (16 x 8 x 8, TF32 in, fp32 accumulated)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Wait for all of this thread's cp.async copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The weight ring's "full" barriers, one per slot: the bulk copy of a slab
// completes the phase of its slot's barrier; slab s is the (s / kStages)-th
// use of slot s % kStages.
struct Ring {
  float* slots;
  uint64_t* full;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Before any other thread uses the ring: thread 0 sets up its barriers; the
// caller's next __syncthreads() publishes them.
__device__ __forceinline__ void init_ring(const Ring& r) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(r.full + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

__device__ __forceinline__ void wait_slab(const Ring& r, int s) {
  const uint32_t bar = smem_addr(r.full + s % kStages), parity = (s / kStages) & 1;
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// The next slab to copy: its layer and where it starts, with the fields of
// its layer that the copy needs, kept in registers (read from the program
// once a layer). Only thread 0 copies, and holds it.
struct SlabCursor {
  int layer;
  const float* src;  // the slab's first float
  int left;          // floats of the layer from src on
  int slab_floats;   // floats of a whole slab of the layer
};

__device__ __forceinline__ void cursor_at(const Program& p, SlabCursor& c, int layer) {
  c.layer = layer;
  if (layer >= p.n_layers) return;
  const LayerDesc& L = p.layer[layer];
  c.src = L.w;
  c.left = L.ksteps * L.ntiles * 64;
  c.slab_floats = L.ksteps_per_slab * L.ntiles * 64;
}

// Thread 0: one bulk copy (the TMA engine moves it, no thread issues a load
// per word) of the cursor's slab into the ring slot of slab s, completing
// that slot's barrier; then advance the cursor. Nothing past the last layer.
// Every other thread of the block read the slot's previous slab before the
// barrier that precedes this call.
__device__ __forceinline__ void load_slab(const Program& p, SlabCursor& c, int s, const Ring& r) {
  if (threadIdx.x != 0 || c.layer >= p.n_layers) return;
  const int n = min(c.slab_floats, c.left);
  const uint32_t bar = smem_addr(r.full + s % kStages);
  const uint32_t bytes = static_cast<uint32_t>(n) * 4u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(r.slots + (s % kStages) * kSlotFloats)), "l"(c.src), "r"(bytes), "r"(bar)
      : "memory");
  c.src += n;
  c.left -= n;
  if (c.left == 0) cursor_at(p, c, c.layer + 1);
}

// Every layer's bias into shared memory (bias + L.bias_off; per-thread
// cp.async, joining the copies of the caller's inputs: run_program waits
// for them all) and the first kStages - 1 slabs in flight. After init_ring
// (only thread 0, which set up the ring, touches its barriers here; the
// barrier that shows the set-up to the other threads may follow). s0: the
// ring's slab count so far, 0 in a block's first program and what the last
// run_program returned in a later one (the slots' barriers go on counting
// phases). Returns the cursor run_program continues from.
__device__ __forceinline__ SlabCursor prefetch_program(const Program& p, const Ring& r,
                                                       float* bias, int s0 = 0) {
  for (int l = 0; l < p.n_layers; ++l) {
    const LayerDesc& L = p.layer[l];
    for (int i = threadIdx.x * 4; i < 8 * L.ntiles; i += kThreads * 4)
      cp_async16(bias + L.bias_off + i, L.bias + i);
  }
  SlabCursor c;
  cursor_at(p, c, 0);
  for (int s = s0; s < s0 + kStages - 1; ++s) load_slab(p, c, s, r);
  return c;
}

// dst[r * ld + j] = src[r * width + j] for r < rows, j < width, by cp.async
// (16 bytes at a time where rows allow; run_program waits for them); 0 for
// width <= j < pad8(width) and for rows <= r < rows_pad
__device__ inline void stage_rows(float* dst, int ld, const float* src, int width, int rows,
                                  int rows_pad) {
  const int padded = pad8(width);
  if (width % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int chunks = width / 4;
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int r = i / chunks, j = (i - r * chunks) * 4;
      cp_async16(dst + r * ld + j, src + static_cast<size_t>(r) * width + j);
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += kThreads) {
      const int r = i / width, j = i - r * width;
      cp_async4(dst + r * ld + j, src + static_cast<size_t>(r) * width + j);
    }
  }
  const int tail = padded - width;
  for (int i = threadIdx.x; i < rows * tail; i += kThreads) {
    const int r = i / tail;
    dst[r * ld + width + (i - r * tail)] = 0.0f;
  }
  for (int i = threadIdx.x; i < (rows_pad - rows) * padded; i += kThreads) {
    const int r = i / padded;
    dst[(rows + r) * ld + (i - r * padded)] = 0.0f;
  }
}

__device__ __forceinline__ const float* part_row(const float* smem, const PartDesc& part, int row,
                                                 int group_last) {
  const int r = part.group > 0 ? min(row / part.group, group_last) : row;
  return smem + part.off + r * part.ld;
}

// Where a warp is in a layer's input: the part, the k-step in it, the rows.
struct APos {
  const float* lo;
  const float* hi;
  int part, kk, part_ksteps;
};

// The k-steps of one slab for a warp's CNT n-tiles (CNT a power of two at
// least the warp's count of tiles; the tiles past that count multiply what
// lies beyond in shared memory, and their sums are never stored). For each
// k-step: the A fragment split once, the B fragments loaded and split, then
// each of the three products over all CNT tiles before the next (dependent
// mma CNT apart), then the k-step's sums added to the accumulators.
template <int CNT, int TILES>
__device__ __forceinline__ void slab_ksteps(const float2* wf, int n_ks, int ntiles, int t,
                                            APos& a, const LayerDesc& L, const float* smem,
                                            int row_lo, int row_hi, int group_last,
                                            float (&acc)[TILES][4]) {
  for (int ks = 0; ks < n_ks; ++ks, wf += ntiles * 32) {
    float2 w[CNT];
#pragma unroll
    for (int q = 0; q < CNT; ++q) w[q] = wf[q * 32];
    uint32_t ab[4], as[4];
    const int c = a.kk * 8 + t;
    split_tf32(a.lo[c], ab[0], as[0]);
    split_tf32(a.hi[c], ab[1], as[1]);
    split_tf32(a.lo[c + 4], ab[2], as[2]);
    split_tf32(a.hi[c + 4], ab[3], as[3]);
    uint32_t bb[CNT][2], bs[CNT][2];
#pragma unroll
    for (int q = 0; q < CNT; ++q) {
      split_tf32(w[q].x, bb[q][0], bs[q][0]);
      split_tf32(w[q].y, bb[q][1], bs[q][1]);
    }
    float sum[CNT][4];
#pragma unroll
    for (int q = 0; q < CNT; ++q) mma_tf32_zero(sum[q], ab, bs[q][0], bs[q][1]);
#pragma unroll
    for (int q = 0; q < CNT; ++q) mma_tf32(sum[q], as, bb[q][0], bb[q][1]);
#pragma unroll
    for (int q = 0; q < CNT; ++q) mma_tf32(sum[q], ab, bb[q][0], bb[q][1]);
#pragma unroll
    for (int q = 0; q < CNT; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][i] += sum[q][i];
    if (++a.kk == a.part_ksteps && ++a.part < L.n_parts) {
      a.kk = 0;
      a.part_ksteps = L.part[a.part].ksteps;
      a.lo = part_row(smem, L.part[a.part], row_lo, group_last);
      a.hi = part_row(smem, L.part[a.part], row_hi, group_last);
    }
  }
}

// Run every layer of the program over the block's mtiles x 16 rows, after
// prefetch_program (whose cursor and s0 it takes). The inputs must be in
// shared memory by the first slab's wait and barrier; a layer's output must
// not be one of its inputs. Rows of a part with group > 0 are clamped to
// group_last. Ends with a barrier, the last output visible to every thread
// and every ring slot free; returns the slab count, the s0 of the block's
// next program. TILES: the most n-tiles a warp takes in any layer of the
// program (a power of two; the host checks it), which sets the registers
// the accumulators take: a narrow program fits more blocks an SM.
template <int TILES = kMaxWarpNTiles>
__device__ __forceinline__ int run_program(const Program& p, SlabCursor next, float* smem,
                                          const Ring& ring, const float* bias, int group_last,
                                          int s0 = 0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int shares = kWarps / p.mtiles;
  const int wm = warp % p.mtiles, wn = warp / p.mtiles;
  const int row_lo = wm * kTileRows + g, row_hi = row_lo + 8;
  cp_async_wait_all();  // this thread's copies of the inputs and biases
  int s = s0;
  for (int l = 0; l < p.n_layers; ++l) {
    const LayerDesc& L = p.layer[l];
    const int ntiles = L.ntiles, ksps = L.ksteps_per_slab, ksteps = L.ksteps;
    const int per = (ntiles + shares - 1) / shares;
    const int nt0 = wn * per;
    const int cnt = wn < shares ? max(0, min(per, ntiles - nt0)) : 0;
    const int cnt_pow2 = cnt > 4 ? 8 : cnt > 2 ? 4 : cnt;
    float acc[TILES][4];
    APos a{part_row(smem, L.part[0], row_lo, group_last),
           part_row(smem, L.part[0], row_hi, group_last), 0, 0, L.part[0].ksteps};
    for (int j = 0; j < L.slabs; ++j, ++s) {
      wait_slab(ring, s);
      __syncthreads();  // slot of s - 1 free; the inputs, or the last layer's output, written
      load_slab(p, next, s + kStages - 1, ring);
      if (j == 0) {
#pragma unroll
        for (int q = 0; q < TILES; ++q) {
          float b0 = 0.0f, b1 = 0.0f;
          if (q < cnt) {
            const float* b = bias + L.bias_off + (nt0 + q) * 8 + 2 * t;
            b0 = b[0], b1 = b[1];
          }
          acc[q][0] = b0, acc[q][1] = b1, acc[q][2] = b0, acc[q][3] = b1;
        }
      }
      const float2* wf =
          reinterpret_cast<const float2*>(ring.slots + (s % kStages) * kSlotFloats) + nt0 * 32 +
          lane;
      const int n_ks = min(ksps, ksteps - j * ksps);
      switch (cnt_pow2) {
        case 8:
          if constexpr (TILES >= 8)
            slab_ksteps<8>(wf, n_ks, ntiles, t, a, L, smem, row_lo, row_hi, group_last, acc);
          break;
        case 4:
          if constexpr (TILES >= 4)
            slab_ksteps<4>(wf, n_ks, ntiles, t, a, L, smem, row_lo, row_hi, group_last, acc);
          break;
        case 2:
          if constexpr (TILES >= 2)
            slab_ksteps<2>(wf, n_ks, ntiles, t, a, L, smem, row_lo, row_hi, group_last, acc);
          break;
        case 1:
          slab_ksteps<1>(wf, n_ks, ntiles, t, a, L, smem, row_lo, row_hi, group_last, acc);
          break;
        default:
          break;
      }
    }
    float* out = smem + L.out;
#pragma unroll
    for (int q = 0; q < TILES; ++q) {
      if (q < cnt) {
        const int col = (nt0 + q) * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + row_lo * L.out_ld + col) =
            make_float2(fmaxf(acc[q][0], 0.0f), fmaxf(acc[q][1], 0.0f));
        *reinterpret_cast<float2*>(out + row_hi * L.out_ld + col) =
            make_float2(fmaxf(acc[q][2], 0.0f), fmaxf(acc[q][3], 0.0f));
      }
    }
  }
  __syncthreads();
  return s;
}

// Ask for `bytes` of dynamic shared memory for `kernel`; a CUDA error code.
template <typename Kernel>
inline int allow_dynamic_smem(Kernel kernel, int bytes) {
  if (bytes <= kDefaultDynamicSmem) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace pwclo_tc
