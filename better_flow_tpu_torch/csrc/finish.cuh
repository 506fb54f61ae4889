// The finish of one optimizer iteration, shared by finish_local.cu (B9, a
// batch of tiles with an ownership window) and iteration.cuh (B2, B5, B6,
// B7b and B12, whose band pass repeats the per-row order on rows held in
// shared memory): image -> gradient sums -> next state (B6, B7b and B9 stop
// at the seven sums).
//
// _finish_values of the TPU kernel (box filter, count normalisation, mask to
// the logical H x W image, all-nine nonzero mask, Scharr, seven sums) as
// per-row device functions, and _model_update_phase (gradient from the
// sums, reference divider step or safeguarded secant step, Kahan totals,
// divider doubling, exit test) as one thread's function.  Every kernel
// calls these same functions, or repeats their order, with FINISH_THREADS
// threads per block, so their sums are taken in the same order and their
// states are bitwise equal.
//
// The TPU kernel rolls the padded image circularly and masks to H x W; here
// a read outside the image is zero.  The two agree because no accepted
// event lands in row or column 0 or at or beyond H or W (the window is
// [half, extent + half) with extent + half < H), so every wrapped read of
// the TPU kernel reads a zero.
#pragma once

#include "common.cuh"

namespace bf {

// Host-built parameters of the scalar update; ops/_build.py mirrors this
// layout.
struct UpdateParams {
  int fast;       // schedule == "fast"
  int use_grad;   // exit_grad > 0
  int use_pred;   // exit_pred > 0
  int max_iter;
  int hard_cap;
  float tol[4];   // (rot, div, dx, dy), each rounded to f32 once
  float tol4[4];  // 4 * tol
  float grad_tol[4];  // exit_grad * tol
  float pred_tol[4];  // exit_pred * tol
  float xy_cap;
  float rotdiv_cap;
};

// Threads per block of every finish pass.  The per-row and the row-sum
// reductions run in a tree over this many values, so the sums (and the
// state) depend on it: every finish must use the same value.
constexpr int FINISH_THREADS = 256;
constexpr int NSUM = 9;

using FinishShared = double[NSUM][FINISH_THREADS];

__device__ inline float time_at(const long long* a, int i, int j, int HP,
                                int WP) {
  if (i < 0 || i >= HP || j < 0 || j >= WP) return 0.0f;
  return static_cast<float>(static_cast<double>(a[static_cast<size_t>(i) * WP + j]) *
                            (1.0 / FIXED_PER_SEC));
}

__device__ inline float count_at(const int* a, int i, int j, int HP, int WP) {
  if (i < 0 || i >= HP || j < 0 || j >= WP) return 0.0f;
  return static_cast<float>(a[static_cast<size_t>(i) * WP + j]);
}

// Box sums in the TPU kernel's order: rows first ((r + a[i+d]) + a[i-d]),
// then columns of the row sums.
__device__ inline float box_time(const long long* a, int i, int j, int half,
                                 int HP, int WP) {
  float out = 0.0f;
  for (int dc = 0; dc <= half; ++dc) {
    for (int sgn = 0; sgn < (dc == 0 ? 1 : 2); ++sgn) {
      const int jj = dc == 0 ? j : (sgn == 0 ? j + dc : j - dc);
      float r = time_at(a, i, jj, HP, WP);
      for (int dr = 1; dr <= half; ++dr) {
        r = r + time_at(a, i + dr, jj, HP, WP);
        r = r + time_at(a, i - dr, jj, HP, WP);
      }
      out = dc == 0 ? r : out + r;
    }
  }
  return out;
}

__device__ inline float box_count(const int* a, int i, int j, int half,
                                  int HP, int WP) {
  float out = 0.0f;
  for (int dc = 0; dc <= half; ++dc) {
    for (int sgn = 0; sgn < (dc == 0 ? 1 : 2); ++sgn) {
      const int jj = dc == 0 ? j : (sgn == 0 ? j + dc : j - dc);
      float r = count_at(a, i, jj, HP, WP);
      for (int dr = 1; dr <= half; ++dr) {
        r = r + count_at(a, i + dr, jj, HP, WP);
        r = r + count_at(a, i - dr, jj, HP, WP);
      }
      out = dc == 0 ? r : out + r;
    }
  }
  return out;
}

// Row i of the normalised image: per pixel the box-filtered time and count
// and their quotient.  The fixed-point time image becomes f32 here.
__device__ inline void image_row(const long long* acc_t, const int* acc_c,
                                 float* img, int i, int HP, int WP, int W,
                                 int half) {
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const float tb = box_time(acc_t, i, j, half, HP, WP);
    const float cb = box_count(acc_c, i, j, half, HP, WP);
    img[static_cast<size_t>(i) * W + j] = cb >= 1.0f ? tb / fmaxf(cb, 1.0f)
                                                     : 0.0f;
  }
}

__device__ inline float img_at(const float* img, int i, int j, int H, int W) {
  if (i < 0 || i >= H || j < 0 || j >= W) return 0.0f;
  return img[static_cast<size_t>(i) * W + j];
}

// Fixed-order tree sum of FINISH_THREADS values per quantity; result in
// sh[q][0].
__device__ inline void block_sum(FinishShared& sh) {
  for (int stride = FINISH_THREADS / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (threadIdx.x < stride) {
      for (int q = 0; q < NSUM; ++q)
        sh[q][threadIdx.x] += sh[q][threadIdx.x + stride];
    }
  }
  __syncthreads();
}

// Row i's nine f64 sums into partials[i]: per pixel the masks and the
// Scharr pair, reduced in the block in a fixed order.  Every thread of the
// block calls it.  Only the pixels of the ownership window [r0, r1) x
// [c0, c1) are summed (finish_local.cu: a tile's owned region); the
// stencils read the whole image, and the row and column weights are the
// image's own indices.  A thread keeps its columns whatever the window, so
// the whole-image window sums in iteration.cuh's band order.
__device__ inline void gradient_row_window(const float* img, double* partials,
                                           int i, int H, int W, int r0,
                                           int r1, int c0, int c1,
                                           FinishShared& sh) {
  double acc[NSUM];
  for (int q = 0; q < NSUM; ++q) acc[q] = 0.0;
  const bool row_owned = i >= r0 && i < r1;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    if (!row_owned || j < c0 || j >= c1) continue;
    float v[3][3];
    bool all9 = true;
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) {
        v[a][b] = img_at(img, i + a - 1, j + b - 1, H, W);
        all9 = all9 && v[a][b] > NONZERO_EPS;
      }
    const bool m = v[1][1] > NONZERO_EPS;
    // Scharr, separable: gx = cs(i-1) - cs(i+1) with
    // cs = 3*img[j-1] + 10*img[j] + 3*img[j+1]; gy likewise on columns.
    // The smoothing is fused as XLA compiles it: fma(3, c, fma(3, a, 10 b)).
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
  __syncthreads();   // the previous row's result reads of sh are done
  for (int q = 0; q < NSUM; ++q) sh[q][threadIdx.x] = acc[q];
  block_sum(sh);
  if (threadIdx.x < NSUM)
    partials[static_cast<size_t>(i) * NSUM + threadIdx.x] = sh[threadIdx.x][0];
}

// _model_update_phase, one thread.  Op order follows the JAX source.
__device__ inline void model_update(const float vals[7], const float* st,
                                    const float* geo, float* out,
                                    float fscale, const UpdateParams& p) {
  // Components are handled in the order (rot, div, dx, dy); these are
  // their state slots.
  const int TOT[4] = {ST_TROT, ST_TDIV, ST_TDX, ST_TDY};
  const int COMP[4] = {ST_CROT, ST_CDIV, ST_CDX, ST_CDY};
  const int DIVS[4] = {ST_RDIV, ST_DDIV, ST_XDIV, ST_YDIV};
  const int GRAD[4] = {ST_ROT, ST_DIV, ST_DX, ST_DY};
  const float cnt = vals[0], s_row = vals[1], s_col = vals[2];
  const float s_gx = vals[3], s_gy = vals[4], s_rg = vals[5], s_dg = vals[6];
  const float denom = fmaxf(cnt, 1.0f);
  const float cx_img = s_row / denom;
  const float cy_img = s_col / denom;
  float g[4];
  g[2] = s_gx / denom;
  g[3] = s_gy / denom;
  // The centroid corrections are fused multiply-adds, as XLA compiles them.
  g[0] = fmaf(cy_img, s_gx, fmaf(-cx_img, s_gy, s_rg)) / denom;
  g[1] = fmaf(-cy_img, s_gy, fmaf(-cx_img, s_gx, s_dg)) / denom;

  float divs[4], ref[4], d[4], sl[4], pg[4], pd[4], psl[4];
  for (int k = 0; k < 4; ++k) {
    divs[k] = st[DIVS[k]];
    ref[k] = g[k] / divs[k];
    pg[k] = st[GRAD[k]];
    pd[k] = st[ST_PD + k];
    psl[k] = st[ST_SL + k];
  }
  for (int k = 0; k < 4; ++k) {
    if (p.fast) {
      // Safeguarded secant: in-slice two-point slope when usable, else the
      // carried slope memory, clamped to 4x (fresh) or 1x (carried) the
      // reference step; the reference step when neither slope is usable.
      const float slope2 = (g[k] - pg[k]) / pd[k];
      const bool valid2 =
          fabsf(pd[k]) > 0.0f && isfinite(slope2) && slope2 < 0.0f;
      const float slope = valid2 ? slope2 : psl[k];
      const float newton = (-0.9f * g[k]) / slope;
      const float lim = (valid2 ? 4.0f : 1.0f) * fabsf(ref[k]);
      const bool okp = slope < 0.0f && isfinite(newton);
      d[k] = okp ? fminf(fmaxf(newton, -lim), lim) : ref[k];
      sl[k] = slope;
    } else {
      d[k] = ref[k];
      sl[k] = 0.0f;
    }
  }
  // Kahan total += delta.
  for (int k = 0; k < 4; ++k) {
    const float total = st[TOT[k]];
    const float y = d[k] - st[COMP[k]];
    const float t = total + y;
    out[TOT[k]] = t;
    out[COMP[k]] = (t - total) - y;
  }
  // Divider doubling on sign flips, gated on a real previous step.
  for (int k = 0; k < 4; ++k) {
    const bool gate = fabsf(pd[k]) > 0.0f && g[k] * pg[k] < 0.0f;
    divs[k] = gate ? divs[k] * 2.0f : divs[k];
  }
  const float new_iters = st[ST_ITERS] + 1.0f;
  const bool over_max =
      p.max_iter > 0 && new_iters > static_cast<float>(p.max_iter);
  const bool under_cap = new_iters < static_cast<float>(p.hard_cap);
  bool cont;
  if (p.fast) {
    bool ref_small = true, small = true;
    for (int k = 0; k < 4; ++k) {
      const float gref = fabsf(g[k] / divs[k]);
      ref_small = ref_small && gref < p.tol4[k];
      bool sm = fabsf(d[k]) < p.tol[k];
      if (p.use_grad) sm = sm && gref < p.grad_tol[k];
      if (p.use_pred) {
        // Model-validated one-step-ahead exit.
        const float g_pred = fmaf(psl[k], pd[k], pg[k]);
        const float relerr = fabsf(g[k] - g_pred) / fmaxf(fabsf(pg[k]), 1e-30f);
        const float png = fmaf(sl[k], d[k], g[k]);
        const float pnd = fabsf(0.9f * png / (sl[k] < 0.0f ? sl[k] : -1e-30f));
        const float pngr = fabsf(png) / divs[k];
        const bool pred = fabsf(pd[k]) > 0.0f && relerr < 0.75f &&
                          sl[k] < 0.0f && pnd < p.tol[k] &&
                          pngr < p.tol[k] && fabsf(d[k]) < p.pred_tol[k];
        sm = sm || pred;
      }
      small = small && sm;
    }
    small = small && (new_iters >= 2.0f || ref_small);
    cont = !small && !over_max && under_cap;
  } else {
    const bool open = divs[2] < p.xy_cap || divs[3] < p.xy_cap ||
                      divs[0] < p.rotdiv_cap || divs[1] < p.rotdiv_cap;
    bool small = true;
    for (int k = 0; k < 4; ++k) small = small && fabsf(g[k] / divs[k]) < p.tol[k];
    cont = open && !small && !over_max && under_cap;
  }

  // Division by the constant scale: a multiplication by its reciprocal.
  const float inv_scale = 1.0f / fscale;
  out[ST_CX] = (cx_img - geo[0]) * inv_scale;
  out[ST_CY] = (cy_img - geo[1]) * inv_scale;
  for (int k = 0; k < 4; ++k) {
    out[DIVS[k]] = divs[k];
    out[ST_SL + k] = sl[k];
    out[ST_PD + k] = d[k];
    out[GRAD[k]] = g[k];
  }
  out[ST_ITERS] = new_iters;
  out[ST_CONT] = cont ? 1.0f : 0.0f;
  out[ST_CNT] = cnt;
  out[ST_FB] = st[ST_FB];
  out[ST_HAS] = st[ST_HAS];
  out[31] = 0.0f;
}

// Sum the rows' partials in a fixed order into the seven sums (cnt, s_row,
// s_col, s_gx, s_gy, s_rg, s_dg), each rounded to f32 once; thread 0
// receives them in vals.  Every thread of one block calls it.
__device__ inline void finish_sums(const double* partials, int rows,
                                   float vals[7], FinishShared& sh) {
  double acc[NSUM];
  for (int q = 0; q < NSUM; ++q) acc[q] = 0.0;
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    for (int q = 0; q < NSUM; ++q) acc[q] += partials[static_cast<size_t>(r) * NSUM + q];
  __syncthreads();
  for (int q = 0; q < NSUM; ++q) sh[q][threadIdx.x] = acc[q];
  block_sum(sh);
  if (threadIdx.x != 0) return;
  for (int q = 0; q < 5; ++q) vals[q] = static_cast<float>(sh[q][0]);
  vals[5] = static_cast<float>(sh[5][0]) - static_cast<float>(sh[6][0]);
  vals[6] = static_cast<float>(sh[7][0]) + static_cast<float>(sh[8][0]);
}

}  // namespace bf
