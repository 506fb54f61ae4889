// One iteration's event phase and finish of the composed path: warp +
// splat, then the seven partial sums.
//
// Replaces _kernel_warp_windowed / fused_warp_splat (better_flow_tpu/ops/
// pallas/fused_model.py), the kernel of the composed optimizer loop that
// f64 totals and use_megastep=False take: re-warp every event with warp
// scalars its caller computed (a (1, 16) f32 row, bf::warp_from_row), splat
// the hi+lo time pair (the TPU kernel always splats both rows), then the
// finish (box filter, normalise, all-nine mask, Scharr) down to the seven
// sums (cnt, s_row, s_col, s_gx, s_gy, s_rg, s_dg), written with a zero
// eighth slot (the TPU kernel's window-fallback count: the port's splat has
// no window, so no chunk falls back).  The scalar model update runs outside,
// in the composed loop.
//
// One stream of several launches, on B1's and B2's device functions
// (common.cuh, finish.cuh) with their block size, so the images and sums
// are bitwise those of B1 with time_lo followed by B2's finish:
//   1. two memsets: the int64 fixed-point time image and the int32 count
//      image;
//   2. warp_splat_kernel: one thread per event slot, integer atomics;
//   3. image_kernel: one block per row, box filter and normalise;
//   4. gradient_kernel: one block per row, Scharr and the row's nine f64
//      sums in a fixed order;
//   5. sums_kernel: one block sums the rows in a fixed order and writes the
//      (8,) f32 output.
//
// Bound: launch latency and bytes, as B1 + B2 (61k events, 442k pixels at
// scale 3); the sums are f64 in a fixed order, so the output is the same on
// every run.
#include "finish.cuh"

namespace {

using bf::FINISH_THREADS;

__global__ void warp_splat_kernel(const float* __restrict__ scal,
                                  const float* __restrict__ stat,
                                  const float* __restrict__ act,
                                  const float* __restrict__ pr,
                                  float* __restrict__ npr,
                                  unsigned long long* __restrict__ acc_t,
                                  int* __restrict__ acc_c, int n, int WP,
                                  int scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bf::warp_splat_event(i, scal, bf::warp_from_row(scal), stat, act, pr, npr,
                       acc_t, acc_c, WP, scale, /*time_lo=*/1);
}

__global__ void image_kernel(const long long* __restrict__ acc_t,
                             const int* __restrict__ acc_c,
                             float* __restrict__ img, int HP, int WP, int W,
                             int half) {
  bf::image_row(acc_t, acc_c, img, blockIdx.x, HP, WP, W, half);
}

__global__ void gradient_kernel(const float* __restrict__ img,
                                double* __restrict__ partials, int H, int W) {
  __shared__ bf::FinishShared sh;
  bf::gradient_row(img, partials, blockIdx.x, H, W, sh);
}

__global__ void sums_kernel(const double* __restrict__ partials, int rows,
                            float* __restrict__ out) {
  __shared__ bf::FinishShared sh;
  float vals[7];
  bf::finish_sums(partials, rows, vals, sh);
  if (threadIdx.x != 0) return;
  for (int q = 0; q < 7; ++q) out[q] = vals[q];
  out[7] = 0.0f;
}

}  // namespace

extern "C" int bf_fused_warp_splat(const float* scal, const float* stat,
                                   const float* act, const float* pr,
                                   float* npr, float* out, long long* acc_t,
                                   int* acc_c, float* img, double* partials,
                                   int nch, int HP, int WP, int H, int W,
                                   int scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t pixels = static_cast<size_t>(HP) * WP;
  cudaError_t e = cudaMemsetAsync(acc_t, 0, pixels * sizeof(long long), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(acc_c, 0, pixels * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = nch * bf::CHUNK;
  const int threads = 256;
  warp_splat_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
      scal, stat, act, pr, npr, reinterpret_cast<unsigned long long*>(acc_t),
      acc_c, n, WP, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  image_kernel<<<H, FINISH_THREADS, 0, s>>>(acc_t, acc_c, img, HP, WP, W,
                                            scale / 2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gradient_kernel<<<H, FINISH_THREADS, 0, s>>>(img, partials, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sums_kernel<<<1, FINISH_THREADS, 0, s>>>(partials, H, out);
  return static_cast<int>(cudaGetLastError());
}
