// One optimizer iteration on the H100, as three phases that nine kernels
// compose: megastep.cu (B5), fused_warp_splat.cu (B6), warp_splat_images.cu
// (B7a), warp_images_st.cu (B1), finish_partials.cu (B7b),
// megastep_finish.cu (B2), megastep2.cu (B12), finish_local.cu (B9, the
// tiled pipeline's finish) and fused_model_partials.cu (B10 and B11).
//
// The phases:
//   1. splat_phase: grid-stride warp + splat of every slot
//      (warp_splat_event, integer atomics) into the caller's image pair,
//      which is zero on entry, with the warp scalars its caller gives: B5
//      and B6 compute them once per block (block_warp, B5's f64 cos and
//      sin among them), B7a in every thread from the row; B1 runs the same
//      per-event functions with block_warp_start / block_warp_wait around
//      its slot's loads.
//      B10/B11's positions_phase splats precomputed positions instead.
//   2. band_phase, in place of an image pass and a gradient pass: blocks
//      take bands of R image rows in a grid-stride loop (B9: over every
//      tile's bands, each tile a pair of its own).  A band stages the
//      integer rows it needs into shared memory with 16-byte loads,
//      converting each value to f32 once; builds the normalised f32 rows
//      [r0 - 1, r1 + 1) there (the f32 image never goes to device memory);
//      and reduces its rows' nine f64 sums, each in finish.cuh's tree order,
//      into partials[i] (B9: only the pixels of its ownership window).
//   3. tail_phase: block 0 (B9: block k, tile k) sums the rows with
//      finish_sums and writes the output, while the other blocks zero the
//      image pair it read: no zeroing phase and no memset.
//
// The kernels:
//   - iteration_kernel<kMegastep> (B5) and <kFused> (B6): one cooperative
//     launch of all three phases, a grid.sync() between each two;
//   - <kPartials> (B10 and B11): the same with positions_phase first: the
//     splat of the caller's flat positions into a workspace pair, then B7b's
//     phases 2 and 3;
//   - <kFinish> (B7b), <kFinishState> (B2) and <kFinishLocal> (B9): one
//     cooperative launch of phases 2 and 3 on a pair its caller filled, one
//     grid.sync() between them; B7b writes the seven sums, B2 the scalar
//     update into the next state, B9 each tile's seven sums over its
//     window;
//   - <kMerged> (B12): phases 2 and 3 on the previous call's pair when the
//     state's HAS flag is set (B2's), a grid.sync(), then merged_phase: the
//     warp of every slot with B4's direction vectors and, while the new
//     state's CONT is set, the splat into the same pair, which the tail
//     left zero;
//   - B7a's kernel (warp_splat_images.cu) and B1's (warp_images_st.cu):
//     phase 1 alone, an ordinary launch with no grid barrier and no memset
//     (B1 with block_warp's block barrier); B8's (splat_local.cu) splats
//     precomputed positions the same way.
// So B7a -> B7b is B6 cut at the image seam, B1 -> B2 is B5 cut there, and
// B12 is B2 -> B1 (or B2 -> B4 on the call that clears CONT).  Every kernel
// runs the per-event function of common.cuh and the sums of finish.cuh in
// their order, so B5 is bitwise the B1 -> B2 chain, B6 the B7a -> B7b
// chain and B12 the B2 -> B1 chain with B4; the image pair is zero before
// B1, B5, B6, B7a, B8, B10, B11 and a slice's first B12, and again after
// B2, B5, B6, B7b, B9, B10, B11 and a B12 that clears CONT.
//
// Bound: the images (12 B a pixel, written by the splat, read by the band
// pass, zeroed for the next call) and the slots (32 B read and written)
// put the bytes bound at ~0.6 us at the main path's shapes; the kernels are
// bound by latency: the splat's atomics, the grid barriers, the band
// pass's chain of staging, box filter and trees on a few warps per SM, and
// the one-block tail.
#pragma once

#include <cooperative_groups.h>

#include "finish.cuh"

namespace bf {

// Threads per block: the finish's tree runs over this many values.
constexpr int BAND_THREADS = FINISH_THREADS;
// Dynamic shared memory a launch may ask for (227 KB less 1 KB of static
// shared memory); ops/fused_model.py mirrors it and picks R.
constexpr int BAND_SMEM_BUDGET = 231424;
// A row's leaves: the nine f64 sums of each of the BAND_THREADS threads.
constexpr int BAND_LEAF_BYTES = NSUM * BAND_THREADS * 8;

static_assert(BAND_THREADS == 256, "the tree below has 256 leaves");

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Shared-memory layout of a band of R rows at width W: the staged time and
// count rows [r0 - 1 - half, r1 + 1 + half) at columns [-half, ...), which
// the R rows' leaves overwrite once the f32 rows are built; then the f32
// rows [r0 - 1, r1 + 1) at columns [-1, W + 1).  The tail reuses it as
// finish.cuh's FinishShared (never larger than R rows' leaves).
struct BandLayout {
  int half, ns, sw, iw;
  __host__ __device__ BandLayout(int R, int W, int scale)
      : half(scale / 2),
        ns(R + 2 + 2 * (scale / 2)),
        sw(round4(round4(W + scale / 2) + 2 * (scale / 2))),
        iw(round4(W + 2)) {}
  // Bytes of the staged rows or of the leaves, whichever is larger.
  __host__ __device__ int stage_bytes(int R) const {
    return 8 * ns * sw > R * BAND_LEAF_BYTES ? 8 * ns * sw
                                              : R * BAND_LEAF_BYTES;
  }
  __host__ __device__ int bytes(int R) const {
    return stage_bytes(R) + 4 * (R + 2) * iw;
  }
};

struct IterationArgs {
  const float* geo;   // [x_sh, y_sh, w_dyn, h_dyn, ...]: the geometry row
                      // (B2, B5, B12), B6's and B7a's warp row (B7b: unused)
  const float* src;   // B2, B5, B12: the (1, 32) state; B6, B7a: the warp row
  const float* stat;
  const float* act;
  const float* pr;    // (nch, 2, CHUNK); B12: (nch, 4, CHUNK), rows 0-1 read
  float* npr;         // as pr
  unsigned long long* acc_t;  // the image pair (see the contract above)
  int* acc_c;
  double* partials;            // (tiles, H, 9)
  float* out;                  // B2, B5, B12: the next state, never src;
                               // B6, B7b: the (8,) sums; B9: (tiles, 8)
  int n, HP, WP, H, W, scale, time_lo, rows;   // n: slots (B2, B7b: 0)
  UpdateParams p;
  // B9 alone sets these: a batch of tiles, pair (tiles, HP, WP), and the
  // ownership window [r0, r1) x [c0, c1) of every tile's sums.  The
  // defaults are one image and the whole of it.
  int tiles = 1;
  int own_r0 = 0, own_r1 = 1 << 30, own_c0 = 0, own_c1 = 1 << 30;
  // B10 and B11 alone set these: the caller's flat (n,) positions, times in
  // nanoseconds and torch.bool activity (one byte a slot).
  const float* prx = nullptr;
  const float* pry = nullptr;
  const float* t_ns = nullptr;
  const unsigned char* active = nullptr;
};

// One fixed-point time value (2^-32 s) as f32.
__device__ inline float fixed_to_f32(long long v) {
  return static_cast<float>(static_cast<double>(v) * (1.0 / FIXED_PER_SEC));
}

// Rows [r0 - 1 - half, r1 + 1 + half) of the integer images, as f32, into
// sT and sC (columns offset by half; zero outside the padded image).  Each
// thread takes items (row, 4 columns) in batches of four whose loads are
// all issued before any is used.
__device__ inline void stage_band(const long long* acc_t, const int* acc_c,
                                  int r0, int HP, int WP, int W,
                                  const BandLayout& L, float* sT, float* sC) {
  constexpr int BATCH = 4;
  const int ws = min(WP, W + L.half);   // image columns [0, ws) are read
  const int quads = (ws + 3) / 4;       // ws <= WP and WP % 4 == 0
  const int items = L.ns * quads;
  for (int e0 = threadIdx.x; e0 < items; e0 += BATCH * blockDim.x) {
    longlong2 t01[BATCH], t23[BATCH];
    int4 cc[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + u * blockDim.x;
      const int s = e / quads;
      const int i = r0 - 1 - L.half + s;
      t01[u] = t23[u] = make_longlong2(0, 0);
      cc[u] = make_int4(0, 0, 0, 0);
      if (e < items && i >= 0 && i < HP) {
        const size_t base = static_cast<size_t>(i) * WP + 4 * (e - s * quads);
        t01[u] = __ldcg(reinterpret_cast<const longlong2*>(acc_t + base));
        t23[u] = __ldcg(reinterpret_cast<const longlong2*>(acc_t + base + 2));
        cc[u] = __ldcg(reinterpret_cast<const int4*>(acc_c + base));
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e >= items) break;
      const int s = e / quads;
      const int j0 = 4 * (e - s * quads);
      const float tv[4] = {fixed_to_f32(t01[u].x), fixed_to_f32(t01[u].y),
                           fixed_to_f32(t23[u].x), fixed_to_f32(t23[u].y)};
      const float cv[4] = {static_cast<float>(cc[u].x),
                           static_cast<float>(cc[u].y),
                           static_cast<float>(cc[u].z),
                           static_cast<float>(cc[u].w)};
      float* rt = sT + s * L.sw + L.half + j0;
      float* rc = sC + s * L.sw + L.half + j0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        rt[k] = j0 + k < ws ? tv[k] : 0.0f;
        rc[k] = j0 + k < ws ? cv[k] : 0.0f;
      }
    }
  }
  // The margins: columns [-half, 0) and beyond the staged quads.
  const int hi0 = L.half + 4 * quads;
  const int margin = L.half + L.sw - hi0;
  for (int e = threadIdx.x; e < L.ns * margin; e += blockDim.x) {
    const int s = e / margin;
    const int m = e - s * margin;
    const int col = m < L.half ? m : hi0 + (m - L.half);
    sT[s * L.sw + col] = 0.0f;
    sC[s * L.sw + col] = 0.0f;
  }
}

// The box filter's sum at staged row s, column b in the TPU kernel's
// order: rows first ((r + a[s+d]) + a[s-d]), then the columns of the row
// sums in the order b, b+1, b-1, b+2, ...  HALF >= 0 fixes scale / 2 at compile time, so
// every load of the box is issued at once; HALF < 0 reads it from ``half``.
template <int HALF>
__device__ inline float box_sum(const float* a, int s, int b, int sw,
                                int half) {
  const int h = HALF >= 0 ? HALF : half;
  float out = 0.0f;
#pragma unroll
  for (int dc = 0; dc <= h; ++dc) {
#pragma unroll
    for (int sgn = 0; sgn < (dc == 0 ? 1 : 2); ++sgn) {
      const int bb = dc == 0 ? b : (sgn == 0 ? b + dc : b - dc);
      float r = a[s * sw + bb];
#pragma unroll
      for (int dr = 1; dr <= h; ++dr) {
        r = r + a[(s + dr) * sw + bb];
        r = r + a[(s - dr) * sw + bb];
      }
      out = dc == 0 ? r : out + r;
    }
  }
  return out;
}

// The normalised f32 rows [r0 - 1, r1 + 1) at columns [-1, W + 1) into sI,
// zero outside the logical H x W image: the box sums of the staged rows
// and their quotient where the count's box is at least 1.
template <int HALF>
__device__ inline void band_image(int r0, int R, int H, int W,
                                  const BandLayout& L, const float* sT,
                                  const float* sC, float* sI) {
  for (int r = 0; r < R + 2; ++r) {
    const int i = r0 - 1 + r;
    const bool row_in = i >= 0 && i < H;
    for (int cidx = threadIdx.x; cidx < L.iw; cidx += blockDim.x) {
      const int j = cidx - 1;
      float v = 0.0f;
      if (row_in && j >= 0 && j < W) {
        const float tb = box_sum<HALF>(sT, r + L.half, j + L.half, L.sw,
                                       L.half);
        const float cb = box_sum<HALF>(sC, r + L.half, j + L.half, L.sw,
                                       L.half);
        v = cb >= 1.0f ? tb / fmaxf(cb, 1.0f) : 0.0f;
      }
      sI[r * L.iw + cidx] = v;
    }
  }
}

// Band rows [r0, r1)'s nine f64 sums into partials: per row, each
// thread's leaf is the per-pixel terms over its columns j = t, t + 256, ...
// in that order, the pixels outside the ownership window [own_r0, own_r1) x
// [own_c0, own_c1) adding nothing (the stencils still read them; row and
// column weights are the image's own indices); then block_sum's tree over
// the 256 leaves of every row and sum at once (strides 128, 64 and 32
// through shared memory, 16 to 1 by shuffles), pairing the same elements in
// the same order.
__device__ inline void band_sums(int r0, int r1, int W,
                                 const IterationArgs& a, const BandLayout& L,
                                 const float* sI, double* leaf,
                                 double* partials) {
  const int t = threadIdx.x;
  for (int i = r0; i < r1; ++i) {
    const int r = i - r0 + 1;   // the band's f32 row of image row i
    double acc[NSUM];
    for (int q = 0; q < NSUM; ++q) acc[q] = 0.0;
    const int j1 = i >= a.own_r0 && i < a.own_r1 ? min(W, a.own_c1) : 0;
    for (int j = t; j < j1; j += blockDim.x) {
      if (j < a.own_c0) continue;
      float v[3][3];
      bool all9 = true;
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) {
          v[a][b] = sI[(r + a - 1) * L.iw + j + b];
          all9 = all9 && v[a][b] > NONZERO_EPS;
        }
      const bool m = v[1][1] > NONZERO_EPS;
      const float cs_up = fmaf(3.0f, v[0][2], fmaf(3.0f, v[0][0], 10.0f * v[0][1]));
      const float cs_dn = fmaf(3.0f, v[2][2], fmaf(3.0f, v[2][0], 10.0f * v[2][1]));
      const float rs_lf = fmaf(3.0f, v[2][0], fmaf(3.0f, v[0][0], 10.0f * v[1][0]));
      const float rs_rt = fmaf(3.0f, v[2][2], fmaf(3.0f, v[0][2], 10.0f * v[1][2]));
      const float gxm = all9 ? cs_up - cs_dn : 0.0f;
      const float gym = all9 ? rs_lf - rs_rt : 0.0f;
      const double md = m ? 1.0 : 0.0;
      const double di = static_cast<double>(i), dj = static_cast<double>(j);
      acc[0] += md;
      acc[1] += md * di;
      acc[2] += md * dj;
      acc[3] += static_cast<double>(gxm);
      acc[4] += static_cast<double>(gym);
      acc[5] += static_cast<double>(gym) * di;
      acc[6] += static_cast<double>(gxm) * dj;
      acc[7] += static_cast<double>(gxm) * di;
      acc[8] += static_cast<double>(gym) * dj;
    }
    double* row = leaf + (i - r0) * NSUM * BAND_THREADS;
    for (int q = 0; q < NSUM; ++q) row[q * BAND_THREADS + t] = acc[q];
  }
  // Series (row, sum) of 256 leaves each: leaf[series * 256 + k].
  const int series = (r1 - r0) * NSUM;
  constexpr int BATCH = 4;
#pragma unroll
  for (int stride = 128; stride >= 32; stride >>= 1) {
    __syncthreads();
    const int n = series * stride;   // leaf[k] += leaf[k + stride], k < stride
    for (int e0 = t; e0 < n; e0 += BATCH * BAND_THREADS) {
      double x[BATCH], y[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = e0 + u * BAND_THREADS;
        const int at = (e / stride) * BAND_THREADS + e % stride;
        x[u] = e < n ? leaf[at] : 0.0;
        y[u] = e < n ? leaf[at + stride] : 0.0;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = e0 + u * BAND_THREADS;
        if (e < n)
          leaf[(e / stride) * BAND_THREADS + e % stride] = x[u] + y[u];
      }
    }
  }
  __syncthreads();
  const int lane = t & 31;
  for (int sr = t >> 5; sr < series; sr += BAND_THREADS / 32) {
    double v = leaf[sr * BAND_THREADS + lane];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
    if (lane == 0)
      partials[static_cast<size_t>(r0 + sr / NSUM) * NSUM + sr % NSUM] = v;
  }
}

// Blocks [b0, gridDim.x) zero the image pair of a.tiles images, each its
// share (16-byte stores; HP * WP is a multiple of 4).
__device__ inline void zero_pair(const IterationArgs& a, int b0) {
  unsigned long long* acc_t = a.acc_t;
  int* acc_c = a.acc_c;
  const size_t nthreads = static_cast<size_t>(gridDim.x - b0) * blockDim.x;
  const size_t quads = static_cast<size_t>(a.tiles) * a.HP * a.WP / 4;
  for (size_t k = static_cast<size_t>(blockIdx.x - b0) * blockDim.x +
                  threadIdx.x;
       k < quads; k += nthreads) {
    reinterpret_cast<longlong2*>(acc_t)[2 * k] = make_longlong2(0, 0);
    reinterpret_cast<longlong2*>(acc_t)[2 * k + 1] = make_longlong2(0, 0);
    reinterpret_cast<int4*>(acc_c)[k] = make_int4(0, 0, 0, 0);
  }
}

// The kernels of this template.
enum IterationKind {
  kMegastep = 0, kFused = 1, kFinish = 2, kFinishState = 3, kMerged = 4,
  kFinishLocal = 5, kPartials = 6, kFinishStatePredicated = 7
};

// Phase 1: warp + splat of slots [0, a.n) in a grid-stride loop.
__device__ inline void splat_phase(const IterationArgs& a, const Warp& w) {
  const size_t nthreads = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < static_cast<size_t>(a.n); i += nthreads)
    warp_splat_event(static_cast<int>(i), a.geo, w, a.stat, a.act, a.pr,
                     a.npr, a.acc_t, a.acc_c, a.WP, a.scale, a.time_lo);
}

// B10/B11's phase 1: the splat of precomputed positions, slots [0, a.n) of
// the caller's flat rows, in a grid-stride loop.  Slot i's time base is
// that of its chunk's slot 0, t_ns[i - i % CHUNK], which is a real event
// (the TPU kernel's rows pad the last chunk only), so the images are
// bitwise those of the rows padded to whole chunks with inactive slots.
__device__ inline void positions_phase(const IterationArgs& a) {
  const size_t nthreads = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < static_cast<size_t>(a.n); i += nthreads) {
    const size_t c0 = i - i % CHUNK;
    splat_position(a.prx[i], a.pry[i], a.active[i] != 0,
                   a.t_ns[i] * INV_NS_PER_SEC, a.t_ns[c0] * INV_NS_PER_SEC,
                   a.geo, a.acc_t, a.acc_c, a.WP, a.scale, a.time_lo);
  }
}

// Phase 2: the band pass over the image pair into a.partials: the bands of
// tile 0, then of tile 1, ... in one grid-stride loop.  Each tile's
// stencils stop at its own edges (rows outside [0, HP) read as zero).
__device__ inline void band_phase(const IterationArgs& a,
                                  unsigned char* smem) {
  const BandLayout L(a.rows, a.W, a.scale);
  float* sT = reinterpret_cast<float*>(smem);
  float* sC = sT + L.ns * L.sw;
  double* leaf = reinterpret_cast<double*>(smem);
  float* sI = reinterpret_cast<float*>(smem + L.stage_bytes(a.rows));
  const int nbands = (a.H + a.rows - 1) / a.rows;
  const size_t pixels = static_cast<size_t>(a.HP) * a.WP;
  for (int b = blockIdx.x; b < a.tiles * nbands; b += gridDim.x) {
    const int tile = b / nbands;
    const int r0 = (b - tile * nbands) * a.rows;
    const int r1 = min(r0 + a.rows, a.H);
    __syncthreads();   // the previous band's reads are done
    stage_band(reinterpret_cast<const long long*>(a.acc_t) + tile * pixels,
               a.acc_c + tile * pixels, r0, a.HP, a.WP, a.W, L, sT, sC);
    __syncthreads();
    if (L.half == 0)
      band_image<0>(r0, a.rows, a.H, a.W, L, sT, sC, sI);
    else if (L.half == 1)
      band_image<1>(r0, a.rows, a.H, a.W, L, sT, sC, sI);
    else
      band_image<-1>(r0, a.rows, a.H, a.W, L, sT, sC, sI);
    __syncthreads();
    band_sums(r0, r1, a.W, a, L, sI, leaf,
              a.partials + static_cast<size_t>(tile) * a.H * NSUM);
  }
}

// Phase 3, after a grid barrier: block k sums tile k's rows and writes
// its output (kState, one tile: the scalar update into the next state;
// otherwise the tile's seven sums and a zero at out + 8 k), the blocks past
// the last tile zero the image pair (all blocks, once their tiles are
// done, when the grid has no block past them).
template <bool kState>
__device__ inline void tail_phase(const IterationArgs& a,
                                  unsigned char* smem) {
  if (blockIdx.x >= a.tiles) {
    zero_pair(a, a.tiles);
    return;
  }
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    float vals[7];
    finish_sums(a.partials + static_cast<size_t>(tile) * a.H * NSUM, a.H,
                vals, *reinterpret_cast<FinishShared*>(smem));
    if (threadIdx.x == 0) {
      if (kState) {
        model_update(vals, a.src, a.geo, a.out, static_cast<float>(a.scale),
                     a.p);
      } else {
        float* out = a.out + 8 * tile;
        for (int q = 0; q < 7; ++q) out[q] = vals[q];
        out[7] = 0.0f;
      }
    }
  }
  if (gridDim.x <= a.tiles) zero_pair(a, 0);
}

// B12 after its head: every slot warped with the new state ``w`` (B4's
// arithmetic), [pr_x, pr_y, nx, ny] written, and, while the new state's
// CONT is set, the position splatted into the pair (B1's splat).
__device__ inline void merged_phase(const IterationArgs& a, const Warp& w) {
  const bool splat = a.out[ST_CONT] > 0.0f;
  const size_t nthreads = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < static_cast<size_t>(a.n); i += nthreads) {
    const size_t c = i / CHUNK;
    const size_t k = i - c * CHUNK;
    const float* s = a.stat + c * 3 * CHUNK;
    const float* p = a.pr + c * 4 * CHUNK;
    float* q = a.npr + c * 4 * CHUNK;
    const float t_ns = s[2 * CHUNK + k];
    float ox, oy, nx, ny;
    warp_event(w, s[k], s[CHUNK + k], t_ns, p[k], p[CHUNK + k], &ox, &oy, &nx,
               &ny);
    q[k] = ox;
    q[CHUNK + k] = oy;
    q[2 * CHUNK + k] = nx;
    q[3 * CHUNK + k] = ny;
    if (splat)
      splat_position(ox, oy, a.act[c * CHUNK + k] > 0.0f,
                     t_ns * INV_NS_PER_SEC, s[2 * CHUNK] * INV_NS_PER_SEC,
                     a.geo, a.acc_t, a.acc_c, a.WP, a.scale, a.time_lo);
  }
}

// kKind: kMegastep (B5: warp from the state, scalar update into the next
// state), kFused (B6: warp from the row, the seven sums and a zero),
// kFinish (B7b: no splat; the seven sums of the caller's pair),
// kFinishState (B2: no splat; the scalar update),
// kFinishStatePredicated (B2's predicated mode: kFinishState on a live
// state; a state whose CONT is not set is copied to the output by one
// thread, and the pair is left as it is), kMerged (B12),
// kFinishLocal (B9: no splat; each tile's seven sums over its window) or
// kPartials (B10, B11: the splat of precomputed positions, then B7b's).
// Two blocks an SM, B9 three: its batch has several bands for every block
// (656 at 4x2), and a third block an SM took its 4x2 device time from 35.5
// to 31.4 us on an H100 (80 registers, 12 bytes spilled; PERF.md); B5 and
// B6, with fewer bands than blocks, were no faster with three.
template <int kKind>
__global__ void __launch_bounds__(BAND_THREADS,
                                  kKind == kFinishLocal ? 3 : 2)
iteration_kernel(IterationArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if constexpr (kKind == kMegastep || kKind == kFused) {
    splat_phase(a, block_warp<kKind == kMegastep>(a.src));
    grid.sync();
  }
  if constexpr (kKind == kPartials) {
    positions_phase(a);
    grid.sync();
  }
  if constexpr (kKind == kFinishStatePredicated) {
    // Every thread reads the same flag of the input state, which no block
    // writes (out is never src): the whole grid returns here, before any
    // barrier, or none of it does.
    if (!(a.src[ST_CONT] > 0.0f)) {
      if (blockIdx.x == 0 && threadIdx.x == 0)
        for (int k = 0; k < ST_SIZE; ++k) a.out[k] = a.src[k];
      return;
    }
  }
  if constexpr (kKind == kMerged) {
    // The head: every thread reads the same flag, so the branch is uniform
    // across the grid; the barriers stay outside it.
    const bool head = a.src[ST_HAS] > 0.5f;
    if (head) band_phase(a, smem);
    grid.sync();
    if (head) {
      tail_phase<true>(a, smem);
    } else if (blockIdx.x == 0 && threadIdx.x == 0) {
      for (int k = 0; k < ST_SIZE; ++k) a.out[k] = a.src[k];
      a.out[ST_CONT] = 1.0f;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) a.out[ST_HAS] = 1.0f;
    grid.sync();   // the new state is written and the pair is zero
    merged_phase(a, block_warp<true>(a.out));
  } else {
    band_phase(a, smem);
    grid.sync();
    tail_phase<kKind == kMegastep || kKind == kFinishState ||
               kKind == kFinishStatePredicated>(a, smem);
  }
}

// Resident blocks of iteration_kernel<kKind> per device at ``smem``
// dynamic bytes, found once per (device, bytes); 0 on error.
template <int kKind>
inline int iteration_resident_blocks(int dev, int smem) {
  struct Entry { int dev, smem, blocks; };
  static Entry cache[32];
  static int used = 0;
  for (int k = 0; k < used; ++k)
    if (cache[k].dev == dev && cache[k].smem == smem) return cache[k].blocks;
  int per_sm = 0, sms = 0;
  auto* kernel = iteration_kernel<kKind>;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BAND_SMEM_BUDGET) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, BAND_THREADS, smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const int blocks = per_sm * sms;
  if (used < 32) cache[used++] = Entry{dev, smem, blocks};
  return blocks;
}

// One cooperative launch of iteration_kernel<kKind>.  blocks <= 0: as
// many as can be resident.  ``smem`` below the band layout's need or above
// the budget, a card without cooperative launch and a grid that cannot be
// resident are refused with their CUDA error; nothing runs in their place.
template <int kKind>
inline int launch_iteration(IterationArgs& a, int smem, int blocks,
                            void* stream) {
  if (a.rows < 1 || a.tiles < 1 ||
      smem < BandLayout(a.rows, a.W, a.scale).bytes(a.rows) ||
      smem > BAND_SMEM_BUDGET)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int resident = iteration_resident_blocks<kKind>(dev, smem);
  if (resident <= 0) {
    cudaGetLastError();
    return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  if (blocks <= 0) blocks = resident;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(iteration_kernel<kKind>), dim3(blocks),
      dim3(BAND_THREADS), args, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it: the next launch must not report it
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf
