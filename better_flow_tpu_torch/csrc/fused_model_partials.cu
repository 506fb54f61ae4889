// The seven partial sums of the time image of already-warped events.
//
// Two entry points, one function and one kernel:
//   bf_fused_model_partials (B10) replaces _kernel / fused_model_partials
//     (better_flow_tpu/ops/pallas/fused_model.py);
//   bf_fused_model_partials_windowed (B11) replaces _kernel_windowed /
//     fused_model_partials_windowed, the splat of the pallas branch of the
//     XLA-composed iteration step, for events sorted by sort_key_blocks.
// Inputs are (nch, CHUNK) f32 rows of positions, times in seconds and
// activity, padded with inactive slots, and the (1, 8) geometry row
// [x_sh, y_sh, w_dyn, h_dyn, ...].  One thread a slot: each slot is scaled,
// truncated, accepted inside the dynamic window and splatted with the TPU
// kernel's time weight (bf::splat_position, bf::time_weight: relative to its
// chunk's slot 0, bf16 hi + lo parts) into the int64 fixed-point time image
// and the int32 count image; then three finish launches (image rows,
// gradient rows, one block of f64 row sums in a fixed order; finish.cuh's
// device functions, as B2 runs them) write the (8,) f32 [cnt, s_row, s_col,
// s_gx, s_gy, s_rg, s_dg, 0], bitwise finish_partials.cu's (B7b) sums of
// the same images.
//
// The TPU kernel of B11 splats a sorted chunk into an (RH, WC) window of its
// image, with a full-image fallback: a way to scatter into VMEM.  The card
// has no such window, and integer sums are exact in any order, so B11 runs
// B10's splat and is bitwise B10 on sorted and unsorted input alike.
//
// Bound: bytes (16 B a slot read, the two images written once and read by
// the finish, 12 B a pixel) and, on a converged slice, the atomics on the few
// pixels the events pile onto.
#include "finish.cuh"

namespace {

using bf::FINISH_THREADS;
constexpr int SPLAT_THREADS = 256;

__global__ void splat_positions_kernel(const float* __restrict__ geo,
                                       const float* __restrict__ prx,
                                       const float* __restrict__ pry,
                                       const float* __restrict__ t_sec,
                                       const float* __restrict__ act,
                                       unsigned long long* __restrict__ acc_t,
                                       int* __restrict__ acc_c, int n, int WP,
                                       int scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c0 = i - i % bf::CHUNK;
  bf::splat_position(prx[i], pry[i], act[i] > 0.0f, t_sec[i], t_sec[c0], geo,
                     acc_t, acc_c, WP, scale, /*time_lo=*/1);
}

int zero_images(long long* acc_t, int* acc_c, int HP, int WP,
                cudaStream_t s) {
  const size_t pixels = static_cast<size_t>(HP) * WP;
  cudaError_t e = cudaMemsetAsync(acc_t, 0, pixels * sizeof(long long), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemsetAsync(acc_c, 0, pixels * sizeof(int), s));
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

// The finish of the splatted images in three launches: one block per row
// normalises the box-filtered images into ``img``, one block per row takes
// the row's nine f64 sums, one block sums the rows.  This is the finish
// that finish_partials.cu ran before it became iteration.cuh's band pass,
// kept here so that B10's and B11's times stay comparable; ROADMAP P5's
// item "B10 and B11's finish onto B7b's band pass and tail" replaces it
// with bf_finish_partials, and it goes then.
int finish_three_launches(const long long* acc_t, const int* acc_c,
                          float* out, float* img, double* partials, int HP,
                          int WP, int H, int W, int scale, cudaStream_t s) {
  image_kernel<<<H, FINISH_THREADS, 0, s>>>(acc_t, acc_c, img, HP, WP, W,
                                            scale / 2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gradient_kernel<<<H, FINISH_THREADS, 0, s>>>(img, partials, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sums_kernel<<<1, FINISH_THREADS, 0, s>>>(partials, H, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bf_fused_model_partials(const float* geo, const float* prx,
                                       const float* pry, const float* t_sec,
                                       const float* act, float* out,
                                       long long* acc_t, int* acc_c,
                                       float* img, double* partials, int nch,
                                       int HP, int WP, int H, int W, int scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = zero_images(acc_t, acc_c, HP, WP, s);
  if (e != 0) return e;
  const int n = nch * bf::CHUNK;
  splat_positions_kernel<<<(n + SPLAT_THREADS - 1) / SPLAT_THREADS,
                           SPLAT_THREADS, 0, s>>>(
      geo, prx, pry, t_sec, act, reinterpret_cast<unsigned long long*>(acc_t),
      acc_c, n, WP, scale);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  return finish_three_launches(acc_t, acc_c, out, img, partials, HP, WP, H,
                               W, scale, s);
}

extern "C" int bf_fused_model_partials_windowed(
    const float* geo, const float* prx, const float* pry, const float* t_sec,
    const float* act, float* out, long long* acc_t, int* acc_c, float* img,
    double* partials, int nch, int HP, int WP, int H, int W, int scale,
    void* stream) {
  return bf_fused_model_partials(geo, prx, pry, t_sec, act, out, acc_t, acc_c,
                                 img, partials, nch, HP, WP, H, W, scale,
                                 stream);
}
