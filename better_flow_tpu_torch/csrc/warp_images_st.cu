// Warp every event of a slice and add its splat into the time and count
// images of the caller's pair.
//
// Replaces _kernel_warp_images_st / warp_images_st_call (better_flow_tpu/
// ops/pallas/fused_model.py).  Per event (bf::warp_splat_event in
// common.cuh, which megastep.cu shares): re-warp from the state vector's
// totals, scale, truncate to a pixel, accept inside the dynamic window, and
// add the event's time weight and a count of one to its pixel.
//
// The time weight is that of the TPU kernel: t0 + bf16(t - t0) (+ the bf16
// low part when time_lo), with t = t_ns * f32(1e-9) and t0 the time of slot 0 of
// the event's chunk, whether or not slot 0 holds an event.
//
// Determinism: both images accumulate in integers.  The count image is an
// int32 atomicAdd; the time image is an int64 fixed-point sum at 2^-32 s per
// unit (each of t0, the bf16 high and low parts rounded to the grid once),
// which the finish kernel converts to f32.  Integer addition is
// associative, so the images, and everything after them, are the same on
// every run; an f32 atomicAdd would make the sums depend on the order in
// which threads arrive.  The grid is 2^-32 s (0.23 ns), far below the bf16
// quantisation of the weight; an int64 holds 2^31 s of summed time per
// pixel, beyond 61,440 events of any slice span a sensor records.
//
// The pair is zero on entry: megastep_finish.cu (B2), which reads it, leaves
// it zero, so this launch needs no memset.  One launch may cover all of a
// process's event-parallel shards (contiguous chunk ranges of one slice):
// the integer sum is that of a launch a shard.
//
// Bound: on a spread slice, bytes (36 B read and 8 B written per event plus
// the two images, 12 B a pixel, written once); on a converged slice, where
// events pile onto a few pixels, atomic contention on those pixels.  The
// grid runs over events, not chunks (30 chunks would fill 30 of 132 SMs);
// the window, the row-band fallbacks and the one-hot matmul of the TPU
// kernel are devices of the TPU and have no counterpart here.
#include "common.cuh"

namespace {

__global__ void warp_images_st_kernel(
    const float* __restrict__ geo, const float* __restrict__ st,
    const float* __restrict__ stat, const float* __restrict__ act,
    const float* __restrict__ pr, float* __restrict__ npr,
    unsigned long long* __restrict__ acc_t, int* __restrict__ acc_c, int n,
    int WP, int scale, int time_lo) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bf::warp_splat_event(i, geo, bf::warp_from_state(st), stat, act, pr, npr,
                       acc_t, acc_c, WP, scale, time_lo);
}

}  // namespace

extern "C" int bf_warp_images_st(const float* geo, const float* st,
                                 const float* stat, const float* act,
                                 const float* pr, float* npr,
                                 long long* acc_t, int* acc_c, int nch,
                                 int WP, int scale, int time_lo,
                                 void* stream) {
  const int n = nch * bf::CHUNK;
  const int threads = 256;
  warp_images_st_kernel<<<(n + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      geo, st, stat, act, pr, npr,
      reinterpret_cast<unsigned long long*>(acc_t), acc_c, n, WP, scale,
      time_lo);
  return static_cast<int>(cudaGetLastError());
}
