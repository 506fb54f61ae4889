// The merged megastep: one launch an iteration, with the previous
// iteration's finish at its head; the call whose head ends the loop is the
// final warp.
//
// Replaces _kernel_megastep2 / megastep2_call (better_flow_tpu/ops/pallas/
// fused_model.py), the per-iteration kernel of OptimizerConfig.
// megastep_merged.  One cooperative launch of iteration.cuh's kernel
// (kMerged), two grid barriers:
//   head, when st[ST_HAS] is set (every call of a slice but its first):
//     the band pass over the previous call's image pair (B2's), then block
//     0 sums the rows and runs the scalar update into st_out (CONT, ITERS,
//     ...) while the other blocks zero the pair;
//   head, on a slice's first call: st_out = st with CONT = 1 (the pair is
//     zero, as its owner made it);
//   both: ST_HAS = 1; a grid barrier;
//   then, over the slots: the warp with st_out (B4's arithmetic,
//   bf::warp_event), [pr_x, pr_y, nx, ny] written, and, while st_out's CONT
//   is set, the splat (bf::splat_position, B1's) into the same pair.
// The caller's pair is read, left zero and splatted into: no zeroing pass,
// no second pair and no f32 image in device memory.  The device functions
// and the block size are those of B5, B2 and B4, so a merged run's states,
// positions and direction vectors are bitwise those of the B1 -> B2 chain
// followed by B4.  The splat has no window, so the fallback count (ST_FB)
// is passed through unchanged.  st and st_out never alias.
//
// Bound: latency, as B5: per iteration the events (61k at the production
// shapes, 28 B read and 16 B written a slot) and the two images (442k
// pixels at scale 3); one launch an iteration, and none for the final warp.
#include "iteration.cuh"

// blocks <= 0: as many blocks as can be resident.  rows and smem: the band
// height and the dynamic shared bytes (ops/fused_model.band_rows).
// Returns the CUDA error of the launch (0 on success).
extern "C" int bf_megastep2(const float* geo, const float* st,
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
  return bf::launch_iteration<bf::kMerged>(a, smem, blocks, stream);
}

// The grid bf_megastep2 launches at ``smem`` dynamic bytes (0 on error).
extern "C" int bf_megastep2_grid(int smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  return bf::iteration_resident_blocks<bf::kMerged>(dev, smem);
}
