// The event phase of one composed iteration, cut at the image seam: warp +
// splat to the two pre-filter images.
//
// Replaces _kernel_warp_images / fused_warp_splat_images (better_flow_tpu/
// ops/pallas/fused_model.py), the shard-local kernel of the event-parallel
// composed loop: re-warp every event slot with warp scalars its caller
// computed (a (1, 16) f32 row, bf::warp_from_row, as fused_warp_splat.cu),
// scale, truncate, accept inside the dynamic window, and splat the hi+lo
// time pair (always, as the TPU kernel does) and a count of one.  The new
// positions and the two images are the outputs; each shard's images are
// summed across shards before finish_partials.cu reads them.
//
// The images are the port's integer ones (int64 fixed-point time at 2^-32 s,
// int32 count; see warp_images_st.cu), so the sum over shards is exact and
// does not depend on the order or the number of shards: a sharded iteration
// is bitwise the unsharded one.  The caller owns the images (several shards
// may live on one card), so nothing here is shared scratch.
//
// Two memsets and one launch on the stream, one thread per event slot, on
// the per-event function that B1, B5 and B6 share (common.cuh).
//
// Bound: bytes (32 B per slot read and written plus the two images, 12 B a
// pixel, written once); on a converged slice atomic contention on the few
// pixels the events pile onto.
#include "common.cuh"

namespace {

__global__ void warp_splat_images_kernel(
    const float* __restrict__ scal, const float* __restrict__ stat,
    const float* __restrict__ act, const float* __restrict__ pr,
    float* __restrict__ npr, unsigned long long* __restrict__ acc_t,
    int* __restrict__ acc_c, int n, int WP, int scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bf::warp_splat_event(i, scal, bf::warp_from_row(scal), stat, act, pr, npr,
                       acc_t, acc_c, WP, scale, /*time_lo=*/1);
}

}  // namespace

extern "C" int bf_warp_splat_images(const float* scal, const float* stat,
                                    const float* act, const float* pr,
                                    float* npr, long long* acc_t, int* acc_c,
                                    int nch, int HP, int WP, int scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t pixels = static_cast<size_t>(HP) * WP;
  cudaError_t e = cudaMemsetAsync(acc_t, 0, pixels * sizeof(long long), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(acc_c, 0, pixels * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = nch * bf::CHUNK;
  const int threads = 256;
  warp_splat_images_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
      scal, stat, act, pr, npr, reinterpret_cast<unsigned long long*>(acc_t),
      acc_c, n, WP, scale);
  return static_cast<int>(cudaGetLastError());
}
