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
// Design: one cooperative launch of iteration.cuh's band pass and tail, the
// phases B6 ends with: bands of R rows staged in shared memory (the f32
// image never goes to device memory), one grid.sync(), then block 0 sums
// the rows and writes the (8,) output while the other blocks zero the pair
// it read, so that the next warp_splat_images.cu (B7a) finds it zero.  The
// band pass repeats finish.cuh's box order and tree order, so the sums are
// bitwise those of B2, B5 and B6 on the same images.  A launch the card
// refuses (too little shared memory for R rows, a grid that cannot be
// resident) returns its error and runs nothing.
//
// Bound: bytes (the two images, 12 B a pixel, read once; the zeroing that
// leaves them clear for the next call is not counted) and latency: the grid
// barrier and the one-block tail.  The sums are f64 in a fixed order, so
// every shard and every run computes the same values.
#include "iteration.cuh"

extern "C" int bf_finish_partials(long long* acc_t, int* acc_c, float* out,
                                  double* partials, int HP, int WP, int H,
                                  int W, int scale, int rows, int smem,
                                  void* stream) {
  bf::IterationArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      reinterpret_cast<unsigned long long*>(acc_t), acc_c,
                      partials, out, 0, HP, WP, H, W, scale, 0, rows,
                      bf::UpdateParams{}};
  return bf::launch_iteration<bf::kFinish>(a, smem, 0, stream);
}

// The grid bf_finish_partials launches at ``smem`` dynamic bytes (0 on
// error).
extern "C" int bf_finish_partials_grid(int smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  return bf::iteration_resident_blocks<bf::kFinish>(dev, smem);
}
