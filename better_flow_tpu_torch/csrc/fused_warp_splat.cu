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
// One host call that queues, on one stream, the event-parallel path's two
// entry points back to back: bf_warp_splat_images (warp_splat_images.cu:
// two memsets and the warp + splat launch) and bf_finish_partials
// (finish_partials.cu: image rows, gradient rows, one block of row sums).
// The unsharded iteration is therefore bitwise the sharded one (whose
// images are summed between the two), and, those being built on B1's and
// B2's device functions (common.cuh, finish.cuh) with their block size,
// bitwise B1 with time_lo followed by B2's finish.
//
// Bound: launch latency and bytes, as B1 + B2 (61k events, 442k pixels at
// scale 3); the sums are f64 in a fixed order, so the output is the same on
// every run.
extern "C" int bf_warp_splat_images(const float* scal, const float* stat,
                                    const float* act, const float* pr,
                                    float* npr, long long* acc_t, int* acc_c,
                                    int nch, int HP, int WP, int scale,
                                    void* stream);
extern "C" int bf_finish_partials(const long long* acc_t, const int* acc_c,
                                  float* out, float* img, double* partials,
                                  int HP, int WP, int H, int W, int scale,
                                  void* stream);

extern "C" int bf_fused_warp_splat(const float* scal, const float* stat,
                                   const float* act, const float* pr,
                                   float* npr, float* out, long long* acc_t,
                                   int* acc_c, float* img, double* partials,
                                   int nch, int HP, int WP, int H, int W,
                                   int scale, void* stream) {
  const int e = bf_warp_splat_images(scal, stat, act, pr, npr, acc_t, acc_c,
                                     nch, HP, WP, scale, stream);
  if (e != 0) return e;
  return bf_finish_partials(acc_t, acc_c, out, img, partials, HP, WP, H, W,
                            scale, stream);
}
