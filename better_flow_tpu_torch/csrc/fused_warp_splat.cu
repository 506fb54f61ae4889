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
// One cooperative launch of iteration.cuh's three phases, the template B5
// runs too (warp from the row; the sums as the tail).  The event-parallel
// path's two entry points run the same phases cut at the image seam:
// warp_splat_images.cu (B7a) the splat phase, finish_partials.cu (B7b) the
// band pass and the tail, with the image sum between them; so B6's output
// is bitwise the B7a -> B7b chain's.  The image pair is zero on entry and
// left zero (see megastep.cu): no memset.
//
// Bound: latency (iteration.cuh); the bytes bound is ~0.6 us at the main
// path's shapes (61k slots, 576x768 images).  The sums are f64 in a fixed
// order, so the output is the same on every run.
#include "iteration.cuh"

extern "C" int bf_fused_warp_splat(const float* scal, const float* stat,
                                   const float* act, const float* pr,
                                   float* npr, float* out, long long* acc_t,
                                   int* acc_c, double* partials, int nch,
                                   int HP, int WP, int H, int W, int scale,
                                   int rows, int smem, void* stream) {
  bf::IterationArgs a{scal, scal, stat, act, pr, npr,
                      reinterpret_cast<unsigned long long*>(acc_t), acc_c,
                      partials, out, nch * bf::CHUNK, HP, WP, H, W, scale,
                      /*time_lo=*/1, rows, bf::UpdateParams{}};
  return bf::launch_iteration<bf::kFused>(a, smem, 0, stream);
}

// The grid bf_fused_warp_splat launches at ``smem`` dynamic bytes (0 on
// error).
extern "C" int bf_fused_warp_splat_grid(int smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  return bf::iteration_resident_blocks<bf::kFused>(dev, smem);
}
