// The finish of the tiled pipeline: a batch of tiles' local images to each
// tile's seven partial sums over its owned window, in one cooperative
// launch that leaves the image pair zero.
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
// One call serves every tile the process holds: the pair (n_tiles, HP, WP)
// that splat_local.cu (B8) filled, HP x WP = padded_image_shape(H, W) with
// the logical H x W image in the top-left corner and zeros around it, the
// same window for every tile.
//
// Design: iteration.cuh's band pass and tail over the batch (kFinishLocal):
// blocks take (tile, band) pairs in one grid-stride loop, stage each band's
// integer rows in shared memory (the f32 image never goes to device
// memory) and reduce the window's pixels of each row, one grid.sync(), then
// block k sums tile k's rows and writes its output while the blocks past the
// last tile zero the whole pair, so that the next B8 finds it zero and needs
// no memset.  The band pass repeats finish.cuh's box order and tree order,
// and a pixel outside the window adds nothing to its thread's leaf, so with
// the whole image as the window the sums are bitwise those of
// finish_partials.cu (B7b) on the same tile.  A launch
// the card refuses (too little shared memory for R rows, a grid that cannot
// be resident) returns its error and runs nothing: the pair is as it was.
//
// Bound: bytes (the two images, 12 B a pixel, read once; the zeroing that
// leaves them clear for the next call is not counted) and latency: the grid
// barrier and the tail.  The sums are f64 in a fixed order, so every run
// computes the same values.
#include "iteration.cuh"

// rows and smem: the band height and the dynamic shared bytes
// (ops/fused_model.band_rows with n_tiles).  Returns the CUDA error of the
// launch (0 on success).
extern "C" int bf_finish_local(long long* acc_t, int* acc_c, float* out,
                               double* partials, int n_tiles, int HP, int WP,
                               int H, int W, int scale, int r0, int r1,
                               int c0, int c1, int rows, int smem,
                               void* stream) {
  bf::IterationArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      reinterpret_cast<unsigned long long*>(acc_t), acc_c,
                      partials, out, 0, HP, WP, H, W, scale, 0, rows,
                      bf::UpdateParams{}};
  a.tiles = n_tiles;
  a.own_r0 = r0;
  a.own_r1 = r1;
  a.own_c0 = c0;
  a.own_c1 = c1;
  return bf::launch_iteration<bf::kFinishLocal>(a, smem, 0, stream);
}

// The grid bf_finish_local launches at ``smem`` dynamic bytes (0 on
// error).
extern "C" int bf_finish_local_grid(int smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  return bf::iteration_resident_blocks<bf::kFinishLocal>(dev, smem);
}
