// The event phase of one composed iteration, cut at the image seam: warp +
// splat into the two pre-filter images.
//
// Replaces _kernel_warp_images / fused_warp_splat_images (better_flow_tpu/
// ops/pallas/fused_model.py), the shard-local kernel of the event-parallel
// composed loop: re-warp every event slot with warp scalars its caller
// computed (a (1, 16) f32 row, bf::warp_from_row, as fused_warp_splat.cu),
// scale, truncate, accept inside the dynamic window, and splat the hi+lo
// time pair (always, as the TPU kernel does) and a count of one.  The new
// positions are the output; the images are added into the caller's pair.
//
// The images are the port's integer ones (int64 fixed-point time at 2^-32 s,
// int32 count; see warp_images_st.cu), so the sum over slots, launches,
// shards and ranks is exact and does not depend on the order: one launch
// over all of a process's shards (contiguous chunk ranges of one slice) is
// bitwise one launch per shard, and a sharded iteration bitwise the
// unsharded one.
//
// Design: iteration.cuh's splat phase alone (the phase B5 and B6 start
// with), as one ordinary launch: no barrier, no memset.  The pair is zero
// on entry because finish_partials.cu (B7b), which reads it after the image
// sum, leaves it zero.  One thread a slot; every thread builds the warp
// scalars from the row itself (bf::warp_from_row), so its slot's loads
// wait on no barrier.
//
// Bound: bytes (32 B per slot read and written plus the two images, 12 B a
// pixel, written once) and launch latency; on a converged slice atomic
// contention on the few pixels the events pile onto.
#include "iteration.cuh"

namespace {

__global__ void __launch_bounds__(bf::BAND_THREADS)
warp_splat_images_kernel(bf::IterationArgs a) {
  bf::splat_phase(a, bf::warp_from_row(a.src));
}

}  // namespace

extern "C" int bf_warp_splat_images(const float* scal, const float* stat,
                                    const float* act, const float* pr,
                                    float* npr, long long* acc_t, int* acc_c,
                                    int nch, int HP, int WP, int scale,
                                    void* stream) {
  bf::IterationArgs a{scal, scal, stat, act, pr, npr,
                      reinterpret_cast<unsigned long long*>(acc_t), acc_c,
                      nullptr, nullptr, nch * bf::CHUNK, HP, WP, 0, 0, scale,
                      /*time_lo=*/1, 0, bf::UpdateParams{}};
  const int blocks = (a.n + bf::BAND_THREADS - 1) / bf::BAND_THREADS;
  warp_splat_images_kernel<<<blocks, bf::BAND_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
