// One whole optimizer iteration in one launch: warp + splat, finish, model
// update and the exit test.
//
// Replaces _kernel_megastep / megastep_call (better_flow_tpu/ops/pallas/
// fused_model.py), the reference schedule's per-iteration kernel: what
// warp_images_st.cu (B1) followed by megastep_finish.cu (B2) compute, in one
// cooperative launch of iteration.cuh's kernel (warp from the state's
// totals, computed once per block; the scalar update as the tail).  It runs
// the per-event function of common.cuh and the sums of finish.cuh in their
// order, so its new positions and state are bitwise those of the B1 -> B2
// chain.
//
// The caller's image pair is zero on entry and is left zero (the blocks
// that do not run the tail zero it), so there is no zeroing phase and no
// memset.  One grid barrier separates the splat from the band pass
// (iteration.cuh: integer rows staged in shared memory, the f32 image
// never in device memory), a second one the band pass from the tail.
//
// Bound: latency (iteration.cuh); the bytes bound is ~0.6 us at the main
// path's shapes (61k slots, 576x768 images).
#include "iteration.cuh"

// blocks <= 0: as many blocks as can be resident.  rows and smem: the band
// height and the dynamic shared bytes (ops/fused_model.band_rows).
// Returns the CUDA error of the launch (0 on success).
extern "C" int bf_megastep(const float* geo, const float* st,
                           const float* stat, const float* act,
                           const float* pr, float* npr, float* st_out,
                           long long* acc_t, int* acc_c, double* partials,
                           int nch, int HP, int WP, int H, int W, int scale,
                           int time_lo, int rows, int smem,
                           const bf::UpdateParams* params, int blocks,
                           void* stream) {
  bf::IterationArgs a{geo, st, stat, act, pr, npr,
                      reinterpret_cast<unsigned long long*>(acc_t), acc_c,
                      partials, st_out, nch * bf::CHUNK, HP, WP, H, W, scale,
                      time_lo, rows, *params};
  return bf::launch_iteration<bf::kMegastep>(a, smem, blocks, stream);
}

// The grid bf_megastep launches at ``smem`` dynamic bytes (0 on error).
extern "C" int bf_megastep_grid(int smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  return bf::iteration_resident_blocks<bf::kMegastep>(dev, smem);
}
