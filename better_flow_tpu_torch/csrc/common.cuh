// Shared layout and per-event math of the main path's kernels.
//
// The constants repeat better_flow_tpu_torch/ops/layout.py (a CPU test
// parses this file and checks them).
//
// Arithmetic: that of the JAX package as XLA compiles it, measured bit for
// bit on the CPU (see ops/warp.py): a multiply feeding an add in the warp
// is one fmaf, and a division by a constant is a multiplication by the
// constant's f32 reciprocal.  Every source is compiled with --fmad=false,
// so nvcc fuses nothing else: the Kahan-compensated model update and every
// other expression round after each operation, in the written order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf {

constexpr int CHUNK = 2048;

constexpr int ST_TDX = 0, ST_TDY = 1, ST_TROT = 2, ST_TDIV = 3;
constexpr int ST_CDX = 4, ST_CDY = 5, ST_CROT = 6, ST_CDIV = 7;
constexpr int ST_CX = 8, ST_CY = 9;
constexpr int ST_XDIV = 10, ST_YDIV = 11, ST_RDIV = 12, ST_DDIV = 13;
constexpr int ST_SL = 14;
constexpr int ST_PD = 18;
constexpr int ST_ITERS = 22;
constexpr int ST_CONT = 23;
constexpr int ST_DX = 24, ST_DY = 25, ST_ROT = 26, ST_DIV = 27;
constexpr int ST_CNT = 28;
constexpr int ST_FB = 29;
constexpr int ST_HAS = 30;
constexpr int ST_SIZE = 32;

// Fixed-point units per second of the time image (see warp_images_st.cu).
constexpr double FIXED_PER_SEC = 4294967296.0;  // 2^32

constexpr float INV_NZ = 1.0f / 127.0f;
constexpr float INV_WARP_TIME_DIV = 1.0f / 10000.0f;
constexpr float INV_NS_PER_SEC = 1.0f / 1e9f;
constexpr float NONZERO_EPS = 1e-6f;
// f32(UV_FACTOR / NZ), rounded once from the f64 quotient.
constexpr float UV_K = static_cast<float>(100000.0 / 127.0);

struct Warp {
  float dnx, dny, cx, cy, divp, cosv, sinv;
};

// The cosine and the sine of the state's warp angle -total_rot, each taken
// in f64 and rounded to f32 once, as the plain version does.  Each is a
// chain of dependent f64 operations and loads of its polynomial's
// coefficients, so block_warp_start below runs the two on two threads at
// once.
__device__ inline float state_cos(const float* st) {
  return static_cast<float>(cos(static_cast<double>(-st[ST_TROT])));
}

__device__ inline float state_sin(const float* st) {
  return static_cast<float>(sin(static_cast<double>(-st[ST_TROT])));
}

// Warp scalars from a (1, 16) row [x_sh, y_sh, w_dyn, h_dyn, dnx, dny, cx,
// cy, divp, cos, sin, 0...] that the caller built (warp_splat_images.cu).
__device__ inline Warp warp_from_row(const float* scal) {
  Warp w;
  w.dnx = scal[4];
  w.dny = scal[5];
  w.cx = scal[6];
  w.cy = scal[7];
  w.divp = scal[8];
  w.cosv = scal[9];
  w.sinv = scal[10];
  return w;
}

// The block's copy of its warp scalars.
__device__ inline Warp& block_warp_shared() {
  __shared__ Warp sw;
  return sw;
}

// The warp scalars, computed once per block into block_warp_shared(): from
// the state (kState: B1, B4, B5, and B12 from the new state; the sign
// pattern of optimizer_rolling.h:340, -total_dx, -total_dy, -total_rot) by
// two threads at once, thread 0 all but the sine and thread 32 the sine
// (each an f64 chain that waits on its own coefficient loads), or from the
// caller's row (B6) by thread 0.  block_warp_wait() returns them once the
// block has reached it; a caller may issue its slots' loads between the two
// (B1, B4).  B7a reads the row in every thread instead: its
// one-slot-a-thread blocks would wait on the barrier before their first
// load (0.15-0.2 us more device time on an H100).  Needs blocks of more
// than 32 threads.
template <bool kState>
__device__ inline void block_warp_start(const float* src) {
  Warp& sw = block_warp_shared();
  if (kState && threadIdx.x == 32) {
    sw.sinv = state_sin(src);
  } else if (threadIdx.x == 0) {
    if (kState) {
      sw.dnx = -src[ST_TDX];
      sw.dny = -src[ST_TDY];
      sw.divp = src[ST_TDIV];
      sw.cx = src[ST_CX];
      sw.cy = src[ST_CY];
      sw.cosv = state_cos(src);
    } else {
      sw = warp_from_row(src);
    }
  }
}

__device__ inline Warp block_warp_wait() {
  __syncthreads();
  return block_warp_shared();
}

template <bool kState>
__device__ inline Warp block_warp(const float* src) {
  block_warp_start<kState>(src);
  return block_warp_wait();
}

// Event::project_4param_reinit for one event (ops/warp.py).
__device__ inline void warp_event(const Warp& w, float frx, float fry,
                                  float t_ns, float prx, float pry,
                                  float* ox, float* oy, float* onx,
                                  float* ony) {
  const float rx = prx - w.cx;
  const float ry = pry - w.cy;
  const float rpx = fmaf(w.cosv, rx, -(w.sinv * ry));
  const float rpy = fmaf(w.sinv, rx, w.cosv * ry);
  const float nx = fmaf(-rpx, w.divp, rpx - rx) + w.dnx;
  const float ny = fmaf(-rpy, w.divp, rpy - ry) + w.dny;
  const float kx = nx * INV_NZ;
  const float ky = ny * INV_NZ;
  const float ts = t_ns * INV_WARP_TIME_DIV;
  *ox = fmaf(-kx, ts, frx);
  *oy = fmaf(-ky, ts, fry);
  *onx = nx;
  *ony = ny;
}

__device__ inline long long to_fixed(float v) {
  return __double2ll_rn(static_cast<double>(v) * FIXED_PER_SEC);
}

__device__ inline float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// An event's fixed-point time weight, the TPU kernels' own (_windowed_splat):
// the chunk's time base t0 (its slot 0, padding or not) plus the bf16 hi part
// of the residual and, with time_lo, the bf16 lo part.  Shared by every
// splat (warp_splat_event below and splat_local.cu).
__device__ inline long long time_weight(float t_sec, float t0, int time_lo) {
  const float tr = t_sec - t0;
  const float w_hi = bf16_round(tr);
  long long f = to_fixed(t0) + to_fixed(w_hi);
  if (time_lo) f += to_fixed(bf16_round(tr - w_hi));
  return f;
}

// Scale the position (ox, oy), truncate to a pixel, accept it when the
// slot is active and the pixel lies inside the dynamic window given by
// geo[0..3] ([x_sh, y_sh, w_dyn, h_dyn]), and add the event's fixed-point
// time weight and a count of one to that pixel.  Shared by every splat of
// warped positions (warp_splat_event below, fused_model_partials.cu).
__device__ inline bool accept_pixel(float ox, float oy, bool active,
                                    const float* geo, int scale, int* pix_x,
                                    int* pix_y) {
  const float x_sh = geo[0], y_sh = geo[1], wd = geo[2], hd = geo[3];
  const int half = scale / 2;
  const float fscale = static_cast<float>(scale);
  const float fhalf = static_cast<float>(half);
  const int ix = static_cast<int>(fmaf(ox, fscale, x_sh));  // toward zero
  const int iy = static_cast<int>(fmaf(oy, fscale, y_sh));
  *pix_x = ix;
  *pix_y = iy;
  return active && ix >= half && static_cast<float>(ix) < wd + fhalf &&
         iy >= half && static_cast<float>(iy) < hd + fhalf;
}

__device__ inline void splat_position(float ox, float oy, bool active,
                                      float t_sec, float t0, const float* geo,
                                      unsigned long long* acc_t, int* acc_c,
                                      int WP, int scale, int time_lo) {
  int ix, iy;
  if (!accept_pixel(ox, oy, active, geo, scale, &ix, &iy)) return;
  const long long f = time_weight(t_sec, t0, time_lo);
  const size_t lin = static_cast<size_t>(ix) * WP + iy;
  atomicAdd(&acc_t[lin], static_cast<unsigned long long>(f));
  atomicAdd(&acc_c[lin], 1);
}

// Warp + splat of event i (chunk i / CHUNK, slot i % CHUNK), shared by
// warp_images_st.cu (B1), warp_splat_images.cu (B7a) and iteration.cuh (B5
// and B6): re-warp with ``w`` (B1 and B5 take it from the state vector's
// totals, B6 and B7a from their caller's row),
// write the new position and splat it (splat_position; see
// warp_images_st.cu).
__device__ inline void warp_splat_event(
    int i, const float* geo, const Warp& w, const float* stat,
    const float* act, const float* pr, float* npr,
    unsigned long long* acc_t, int* acc_c, int WP, int scale, int time_lo) {
  const int c = i / CHUNK;
  const int k = i - c * CHUNK;
  const float* s = stat + static_cast<size_t>(c) * 3 * CHUNK;
  const float* p = pr + static_cast<size_t>(c) * 2 * CHUNK;
  float* q = npr + static_cast<size_t>(c) * 2 * CHUNK;

  const float t_ns = s[2 * CHUNK + k];
  float ox, oy, nx, ny;
  warp_event(w, s[k], s[CHUNK + k], t_ns, p[k], p[CHUNK + k], &ox, &oy, &nx,
             &ny);
  q[k] = ox;
  q[CHUNK + k] = oy;
  splat_position(ox, oy, act[static_cast<size_t>(c) * CHUNK + k] > 0.0f,
                 t_ns * INV_NS_PER_SEC, s[2 * CHUNK] * INV_NS_PER_SEC, geo,
                 acc_t, acc_c, WP, scale, time_lo);
}

}  // namespace bf
