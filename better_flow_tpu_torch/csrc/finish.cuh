// The end of the finish of one optimizer iteration, shared by every kernel
// of iteration.cuh (B2, B5, B6, B7b, B9 and B12), whose band pass computes
// _finish_values of the TPU kernel (box filter, count normalisation, mask to
// the logical H x W image, all-nine nonzero mask, Scharr) and each row's
// nine f64 sums: the sum of the rows into the seven sums (finish_sums) and
// _model_update_phase (gradient from the sums, reference divider step or
// safeguarded secant step, Kahan totals, divider doubling, exit test) as
// one thread's function (B6, B7b and B9 stop at the seven sums).  Every
// kernel runs them with FINISH_THREADS threads per block, so their sums are
// taken in the same order and their states are bitwise equal.
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
