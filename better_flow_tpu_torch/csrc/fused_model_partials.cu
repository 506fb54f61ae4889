// The seven partial sums of the time image of already-warped events.
//
// Two entry points, one function and one kernel:
//   bf_fused_model_partials (B10) replaces _kernel / fused_model_partials
//     (better_flow_tpu/ops/pallas/fused_model.py);
//   bf_fused_model_partials_windowed (B11) replaces _kernel_windowed /
//     fused_model_partials_windowed, the splat of the pallas branch of the
//     XLA-composed iteration step, for events sorted by sort_key_blocks.
// Inputs are the caller's flat (n,) f32 positions and times in nanoseconds,
// the (n,) torch.bool activity read as bytes, and the (1, 8) geometry row
// [x_sh, y_sh, w_dyn, h_dyn, ...].
//
// Design: one cooperative launch of iteration.cuh's kernel<kPartials>.
// Phase 1 (positions_phase) splats every slot i < n: scaled, truncated,
// accepted inside the dynamic window and added with the TPU kernel's time
// weight (bf::splat_position, bf::time_weight: relative to its chunk's slot
// 0, bf16 hi + lo parts) into the int64 fixed-point time image and the int32
// count image of the workspace pair, which is zero on entry.  Then one
// grid.sync() and B7b's band pass and tail (finish_partials.cu), which write
// the (8,) f32 [cnt, s_row, s_col, s_gx, s_gy, s_rg, s_dg, 0] and leave the
// pair zero for the next call.  The TPU wrapper's padded (nch, CHUNK) rows
// are never built: a slot past n is inactive, and every chunk's slot 0 is a
// real event, so the images, and the sums, are bitwise those of the padded
// rows.  The call is one device operation: no row copy, no elementwise
// kernel, no memset; a launch the card refuses runs nothing and leaves the
// pair zero.
//
// The TPU kernel of B11 splats a sorted chunk into an (RH, WC) window of its
// image, with a full-image fallback: a way to scatter into VMEM.  The card
// has no such window, and integer sums are exact in any order, so B11 runs
// B10's launch and is bitwise B10 on sorted and unsorted input alike.
//
// Bound: operations (the finish's per-pixel work over the logical image and
// a slot's acceptance test and time weight), then latency: the splat's
// atomics, the grid barriers and the one-block tail.  The images never
// leave the launch, so no image byte is counted.
#include "iteration.cuh"

// rows and smem: the band height and the dynamic shared bytes
// (ops/fused_model.band_rows).  Returns the CUDA error of the launch (0 on
// success).
extern "C" int bf_fused_model_partials(const float* geo, const float* prx,
                                       const float* pry, const float* t_ns,
                                       const unsigned char* active,
                                       float* out, long long* acc_t,
                                       int* acc_c, double* partials, int n,
                                       int HP, int WP, int H, int W,
                                       int scale, int rows, int smem,
                                       void* stream) {
  bf::IterationArgs a{geo, nullptr, nullptr, nullptr, nullptr, nullptr,
                      reinterpret_cast<unsigned long long*>(acc_t), acc_c,
                      partials, out, n, HP, WP, H, W, scale,
                      /*time_lo=*/1, rows, bf::UpdateParams{}};
  a.prx = prx;
  a.pry = pry;
  a.t_ns = t_ns;
  a.active = active;
  return bf::launch_iteration<bf::kPartials>(a, smem, 0, stream);
}

extern "C" int bf_fused_model_partials_windowed(
    const float* geo, const float* prx, const float* pry, const float* t_ns,
    const unsigned char* active, float* out, long long* acc_t, int* acc_c,
    double* partials, int n, int HP, int WP, int H, int W, int scale,
    int rows, int smem, void* stream) {
  return bf_fused_model_partials(geo, prx, pry, t_ns, active, out, acc_t,
                                 acc_c, partials, n, HP, WP, H, W, scale,
                                 rows, smem, stream);
}

// The grid bf_fused_model_partials launches at ``smem`` dynamic bytes (0 on
// error).
extern "C" int bf_fused_model_partials_grid(int smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  return bf::iteration_resident_blocks<bf::kPartials>(dev, smem);
}
