// Finish of one optimizer iteration: image -> gradient sums -> next state.
//
// Replaces _kernel_finish_st / megastep_finish_call (better_flow_tpu/ops/
// pallas/fused_model.py): _finish_values followed by _model_update_phase,
// writing the next (1, 32) state.  The per-row and scalar work is in
// finish.cuh, which megastep.cu (B5) shares.
//
// Three launches on the stream:
//   1. image_kernel: one block per row; per pixel the box-filtered time and
//      count and their quotient, written as an H x W f32 image.
//   2. gradient_kernel: one block per row; per pixel the masks and the
//      Scharr pair, and the row's nine f64 partial sums, reduced in the
//      block in a fixed order.
//   3. update_kernel: one block sums the rows in a fixed order, and its
//      first thread runs the scalar update.
//
// Bound: bytes and launch latency.  The images are 442k pixels (5.3 MB of
// integer images and 3.5 MB of f32 image traffic per call), the update is a
// few hundred scalar operations on one thread.  The sums are taken in f64
// so that their f32 values do not depend on the reduction order, and the
// order is fixed, so the state is the same on every run.
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

__global__ void update_kernel(const double* __restrict__ partials, int rows,
                              const float* __restrict__ st,
                              const float* __restrict__ geo,
                              float* __restrict__ st_out, float fscale,
                              bf::UpdateParams p) {
  __shared__ bf::FinishShared sh;
  bf::update_block(partials, rows, st, geo, st_out, fscale, p, sh);
}

}  // namespace

extern "C" int bf_megastep_finish(const long long* acc_t, const int* acc_c,
                                  const float* st, const float* geo,
                                  float* st_out, float* img, double* partials,
                                  int HP, int WP, int H, int W, int scale,
                                  const bf::UpdateParams* params,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  image_kernel<<<H, FINISH_THREADS, 0, s>>>(acc_t, acc_c, img, HP, WP, W,
                                            scale / 2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gradient_kernel<<<H, FINISH_THREADS, 0, s>>>(img, partials, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  update_kernel<<<1, FINISH_THREADS, 0, s>>>(partials, H, st, geo, st_out,
                                             static_cast<float>(scale),
                                             *params);
  return static_cast<int>(cudaGetLastError());
}
