// Finish of one optimizer iteration: the images -> gradient sums -> next
// state, in one cooperative launch that leaves the image pair zero.
//
// Replaces _kernel_finish_st / megastep_finish_call (better_flow_tpu/ops/
// pallas/fused_model.py): _finish_values followed by _model_update_phase,
// writing the next (1, 32) state, on the images that warp_images_st.cu
// (B1) splatted.
//
// Design: iteration.cuh's band pass and tail, the phases B5 ends with (so
// B1 -> B2 is B5 cut at the image seam, as B7a -> B7b is B6): bands of R
// rows staged in shared memory (the f32 image never goes to device
// memory), one grid.sync(), then block 0 sums the rows and runs the scalar
// update into st_out while the other blocks zero the pair it read, so that
// the next B1 finds it zero and needs no memset.  The band pass repeats
// finish.cuh's box order and tree order, so the state is bitwise B5's on
// the same events.  A launch the card refuses (too little shared memory for
// R rows, a grid that cannot be resident) returns its error and runs
// nothing: the pair and st_out are as they were.
//
// Predicated mode (predicated = 1, the unrolled split drive of
// OptimizerConfig.megastep_unroll; iteration.cuh's kFinishStatePredicated):
// a state whose CONT is not set is copied to st_out by block 0, and the
// pair is left as it is (zero: the predicated B1 before it added nothing).
// The flag is the input state's, the same for every block, so the grid
// takes the branch whole and no grid.sync() is reached by some blocks
// only.  A live state runs kFinishState's phases.
//
// Bound: bytes (the two images, 12 B a pixel, read once; the zeroing that
// leaves them clear for the next call is not counted) and latency: the grid
// barrier and the one-block tail.  The sums are f64 in a fixed order, so
// the state is the same on every run.
#include "iteration.cuh"

// rows and smem: the band height and the dynamic shared bytes
// (ops/fused_model.band_rows); predicated: the mode above.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int bf_megastep_finish(long long* acc_t, int* acc_c,
                                  const float* st, const float* geo,
                                  float* st_out, double* partials, int HP,
                                  int WP, int H, int W, int scale, int rows,
                                  int smem, int predicated,
                                  const bf::UpdateParams* params,
                                  void* stream) {
  bf::IterationArgs a{geo, st, nullptr, nullptr, nullptr, nullptr,
                      reinterpret_cast<unsigned long long*>(acc_t), acc_c,
                      partials, st_out, 0, HP, WP, H, W, scale, 0, rows,
                      *params};
  return predicated
             ? bf::launch_iteration<bf::kFinishStatePredicated>(a, smem, 0,
                                                               stream)
             : bf::launch_iteration<bf::kFinishState>(a, smem, 0, stream);
}

// The grid bf_megastep_finish launches at ``smem`` dynamic bytes (0 on
// error).
extern "C" int bf_megastep_finish_grid(int smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  return bf::iteration_resident_blocks<bf::kFinishState>(dev, smem);
}
