// The splat of the tiled pipeline: precomputed local pixel positions added
// into a batch of tiles' raw time-sum and count images.
//
// Replaces _kernel_local_splat / splat_local_call (better_flow_tpu/ops/
// pallas/fused_model.py), the kernel of one tile's iteration in
// parallel/spatial.py: the caller has warped, scaled, truncated, accepted and
// halo-shifted the events; lx, ly are the f32 integer positions in the
// tile's (tile + 2 halo)^2 frame, negative for a rejected or padding slot,
// and t_sec the timestamps in seconds.  The time weight is the TPU kernel's
// own (bf::time_weight, common.cuh): relative to the chunk's slot 0, bf16 hi
// and (time_lo) lo parts.  The TPU kernel's one-hot window, its row-band and
// full-joint fallbacks are its way to scatter and have no counterpart here.
//
// One launch serves every tile the process holds: slots are (n_tiles, n_pad)
// with n_pad a multiple of CHUNK, images (n_tiles, HP, WP) with the logical
// H x W image in each tile's top-left corner, int64 fixed-point time at
// 2^-32 s and int32 count, as every splat of the port: the halo fold-in,
// the escape lane's adds and the sum over ranks are then exact in any
// order.  The pair is the caller's (the tiled run holds one for the run)
// and zero on entry: finish_local.cu (B9) leaves it so.
//
// One launch on the stream, one thread per slot, no memset.
//
// Bound: bytes (12 B per slot read, 12 B per pixel hit written); sorted
// buckets put neighbouring threads on neighbouring pixels, so on a
// converged slice the atomics contend on the few pixels the events pile
// onto.
#include "common.cuh"

namespace {

constexpr int kSplatThreads = 256;

__global__ void splat_local_kernel(
    const float* __restrict__ lx, const float* __restrict__ ly,
    const float* __restrict__ t_sec, unsigned long long* __restrict__ acc_t,
    int* __restrict__ acc_c, long long n_total, int n_pad, int HP, int WP,
    int H, int W, int time_lo) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_total) return;
  const float fx = lx[i], fy = ly[i];
  if (fx < 0.0f || fy < 0.0f) return;
  const int ix = static_cast<int>(fx), iy = static_cast<int>(fy);
  if (ix >= H || iy >= W) return;
  const long long tile = i / n_pad;
  const long long k = i - tile * n_pad;
  const float t0 = t_sec[i - k % bf::CHUNK];
  const long long f = bf::time_weight(t_sec[i], t0, time_lo);
  const size_t lin = (static_cast<size_t>(tile) * HP + ix) * WP + iy;
  atomicAdd(&acc_t[lin], static_cast<unsigned long long>(f));
  atomicAdd(&acc_c[lin], 1);
}

}  // namespace

// One thread a slot: the blocks of a launch over n_tiles x n_pad slots.
extern "C" int bf_splat_local_grid(int n_tiles, int n_pad) {
  const long long n = static_cast<long long>(n_tiles) * n_pad;
  return static_cast<int>((n + kSplatThreads - 1) / kSplatThreads);
}

extern "C" int bf_splat_local(const float* lx, const float* ly,
                              const float* t_sec, long long* acc_t,
                              int* acc_c, int n_tiles, int n_pad, int HP,
                              int WP, int H, int W, int time_lo,
                              void* stream) {
  const unsigned blocks =
      static_cast<unsigned>(bf_splat_local_grid(n_tiles, n_pad));
  splat_local_kernel<<<blocks, kSplatThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      lx, ly, t_sec, reinterpret_cast<unsigned long long*>(acc_t), acc_c,
      static_cast<long long>(n_tiles) * n_pad, n_pad, HP, WP, H, W, time_lo);
  return static_cast<int>(cudaGetLastError());
}
