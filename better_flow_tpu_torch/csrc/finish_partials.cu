// The finish of one composed iteration on the summed images: the seven
// partial sums.
//
// Replaces _kernel_finish / finish_partials (better_flow_tpu/ops/pallas/
// fused_model.py), the kernel that runs replicated on every shard of the
// event-parallel composed loop after the pre-filter images were summed:
// _finish_values (box filter, count normalisation, mask to the logical
// H x W image, all-nine nonzero mask, Scharr) down to the seven sums (cnt,
// s_row, s_col, s_gx, s_gy, s_rg, s_dg), written with a zero eighth slot.
// The scalar model update runs outside, in the composed loop.
//
// Three launches on the stream, on the finish's device functions
// (finish.cuh) with their block size, so the sums are bitwise those of B2,
// B5 and B6 on the same images:
//   1. image_kernel: one block per row, box filter and normalise;
//   2. gradient_kernel: one block per row, Scharr and the row's nine f64
//      sums in a fixed order;
//   3. sums_kernel: one block sums the rows in a fixed order and writes the
//      (8,) f32 output.
//
// Bound: bytes (the two images, 12 B a pixel, read once) and launch
// latency; the sums are f64 in a fixed order, so every shard and every run
// computes the same values.
#include "finish.cuh"

namespace {

using bf::FINISH_THREADS;

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

extern "C" int bf_finish_partials(const long long* acc_t, const int* acc_c,
                                  float* out, float* img, double* partials,
                                  int HP, int WP, int H, int W, int scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
