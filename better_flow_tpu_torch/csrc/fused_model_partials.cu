// The seven partial sums of the time image of already-warped events.
//
// Two entry points, one function and one kernel:
//   bf_fused_model_partials (B10) replaces _kernel / fused_model_partials
//     (better_flow_tpu/ops/pallas/fused_model.py);
//   bf_fused_model_partials_windowed (B11) replaces _kernel_windowed /
//     fused_model_partials_windowed, the splat of the pallas branch of the
//     XLA-composed iteration step, for events sorted by sort_key_blocks.
// Inputs are (nch, CHUNK) f32 rows of positions, times in seconds and
// activity, padded with inactive slots, and the (1, 8) geometry row
// [x_sh, y_sh, w_dyn, h_dyn, ...].  One thread a slot: each slot is scaled,
// truncated, accepted inside the dynamic window and splatted with the TPU
// kernel's time weight (bf::splat_position, bf::time_weight: relative to its
// chunk's slot 0, bf16 hi + lo parts) into the int64 fixed-point time image
// and the int32 count image of the caller's pair, which is zero on entry;
// then finish_partials.cu (B7b) on that pair: iteration.cuh's band pass and
// tail in one cooperative launch, which writes the (8,) f32 [cnt, s_row,
// s_col, s_gx, s_gy, s_rg, s_dg, 0] and leaves the pair zero for the next
// call, so no memset runs.  The sums are bitwise B7b's of the same images.
//
// The TPU kernel of B11 splats a sorted chunk into an (RH, WC) window of its
// image, with a full-image fallback: a way to scatter into VMEM.  The card
// has no such window, and integer sums are exact in any order, so B11 runs
// B10's splat and is bitwise B10 on sorted and unsorted input alike.
//
// Bound: bytes (16 B a slot read, the two images written once and read by
// the finish, 12 B a pixel) and, on a converged slice, the atomics on the few
// pixels the events pile onto; then B7b's latency.
#include "common.cuh"

extern "C" int bf_finish_partials(long long* acc_t, int* acc_c, float* out,
                                  double* partials, int HP, int WP, int H,
                                  int W, int scale, int rows, int smem,
                                  void* stream);

namespace {

constexpr int SPLAT_THREADS = 256;

__global__ void splat_positions_kernel(const float* __restrict__ geo,
                                       const float* __restrict__ prx,
                                       const float* __restrict__ pry,
                                       const float* __restrict__ t_sec,
                                       const float* __restrict__ act,
                                       unsigned long long* __restrict__ acc_t,
                                       int* __restrict__ acc_c, int n, int WP,
                                       int scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c0 = i - i % bf::CHUNK;
  bf::splat_position(prx[i], pry[i], act[i] > 0.0f, t_sec[i], t_sec[c0], geo,
                     acc_t, acc_c, WP, scale, /*time_lo=*/1);
}

}  // namespace

// rows and smem: B7b's band height and dynamic shared bytes
// (ops/fused_model.band_rows).  A finish the card refuses returns its error
// with the splat in the pair; the caller clears it.
extern "C" int bf_fused_model_partials(const float* geo, const float* prx,
                                       const float* pry, const float* t_sec,
                                       const float* act, float* out,
                                       long long* acc_t, int* acc_c,
                                       double* partials, int nch, int HP,
                                       int WP, int H, int W, int scale,
                                       int rows, int smem, void* stream) {
  const int n = nch * bf::CHUNK;
  splat_positions_kernel<<<(n + SPLAT_THREADS - 1) / SPLAT_THREADS,
                           SPLAT_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      geo, prx, pry, t_sec, act, reinterpret_cast<unsigned long long*>(acc_t),
      acc_c, n, WP, scale);
  const int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  return bf_finish_partials(acc_t, acc_c, out, partials, HP, WP, H, W, scale,
                            rows, smem, stream);
}

extern "C" int bf_fused_model_partials_windowed(
    const float* geo, const float* prx, const float* pry, const float* t_sec,
    const float* act, float* out, long long* acc_t, int* acc_c,
    double* partials, int nch, int HP, int WP, int H, int W, int scale,
    int rows, int smem, void* stream) {
  return bf_fused_model_partials(geo, prx, pry, t_sec, act, out, acc_t, acc_c,
                                 partials, nch, HP, WP, H, W, scale, rows,
                                 smem, stream);
}
