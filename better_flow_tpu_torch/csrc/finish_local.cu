// The finish of the tiled pipeline: a batch of tiles' local images to each
// tile's seven partial sums over its owned window.
//
// Replaces _kernel_local_finish / finish_local_call (better_flow_tpu/ops/
// pallas/fused_model.py), the kernel that ends one tile's iteration in
// parallel/spatial.py: _finish_values with own = (r0, r1, c0, c1).  The box
// filter, the normalisation, the all-nine mask and the Scharr ring read the
// whole local image (its halo ring holds the neighbours' completed edge
// strips); only the seven sums are restricted to the owned window, and their
// row and column weights are local indices (the caller shifts the sums to
// global coordinates).  Written as (8,) f32 per tile, the eighth slot zero.
//
// One call serves every tile the process holds: images (n_tiles, HP, WP)
// with the logical H x W image in the top-left corner, the same window for
// every tile.  Three launches on the stream, on the finish's device
// functions (finish.cuh) with their block size, blockIdx.y the tile:
//   1. image_kernel: one block per row, box filter and normalise;
//   2. gradient_kernel: one block per row, Scharr and the row's nine f64
//      sums over the window's columns in a fixed order (zeros outside the
//      window's rows);
//   3. sums_kernel: one block per tile sums the rows in a fixed order.
// With the whole image as the window the sums are bitwise those of
// finish_partials.cu (B7b) on the same images.
//
// Bound: bytes (the two images, 12 B a pixel, read once) and launch
// latency; the sums are f64 in a fixed order, so every run computes the
// same values.
#include "finish.cuh"

namespace {

using bf::FINISH_THREADS;

__global__ void image_kernel(const long long* __restrict__ acc_t,
                             const int* __restrict__ acc_c,
                             float* __restrict__ img, int HP, int WP, int H,
                             int W, int half) {
  const size_t tile = blockIdx.y;
  bf::image_row(acc_t + tile * HP * WP, acc_c + tile * HP * WP,
                img + tile * H * W, blockIdx.x, HP, WP, W, half);
}

__global__ void gradient_kernel(const float* __restrict__ img,
                                double* __restrict__ partials, int H, int W,
                                int r0, int r1, int c0, int c1) {
  __shared__ bf::FinishShared sh;
  const size_t tile = blockIdx.y;
  bf::gradient_row_window(img + tile * H * W, partials + tile * H * bf::NSUM,
                          blockIdx.x, H, W, r0, r1, c0, c1, sh);
}

__global__ void sums_kernel(const double* __restrict__ partials, int rows,
                            float* __restrict__ out) {
  __shared__ bf::FinishShared sh;
  const size_t tile = blockIdx.x;
  float vals[7];
  bf::finish_sums(partials + tile * rows * bf::NSUM, rows, vals, sh);
  if (threadIdx.x != 0) return;
  for (int q = 0; q < 7; ++q) out[tile * 8 + q] = vals[q];
  out[tile * 8 + 7] = 0.0f;
}

}  // namespace

extern "C" int bf_finish_local(const long long* acc_t, const int* acc_c,
                               float* out, float* img, double* partials,
                               int n_tiles, int HP, int WP, int H, int W,
                               int scale, int r0, int r1, int c0, int c1,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, n_tiles);
  image_kernel<<<grid, FINISH_THREADS, 0, s>>>(acc_t, acc_c, img, HP, WP, H,
                                               W, scale / 2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gradient_kernel<<<grid, FINISH_THREADS, 0, s>>>(img, partials, H, W, r0, r1,
                                                  c0, c1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sums_kernel<<<n_tiles, FINISH_THREADS, 0, s>>>(partials, H, out);
  return static_cast<int>(cudaGetLastError());
}
