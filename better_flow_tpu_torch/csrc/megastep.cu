// One whole optimizer iteration in one launch: warp + splat, finish, model
// update and the exit test.
//
// Replaces _kernel_megastep / megastep_call (better_flow_tpu/ops/pallas/
// fused_model.py), the reference schedule's per-iteration kernel: what
// warp_images_st.cu (B1) followed by megastep_finish.cu (B2) compute, in one
// call.  It runs the same device functions as those two (common.cuh,
// finish.cuh) with the same block size for every reduction, so its new
// positions and state are bitwise those of the B1 -> B2 chain.
//
// One cooperative launch: blocks stay resident on the SMs and the phases
// are separated by grid-wide barriers (cooperative_groups grid.sync()):
//   0. zero the int64 fixed-point time image and the int32 count image
//      (the TPU kernel zeroes its scratch at grid step 0);
//   1. grid-stride warp + splat of every event, integer atomics;
//   2. grid-stride over rows: the box filter and normalise pass;
//   3. grid-stride over rows: Scharr and the row's nine f64 sums;
//   4. block 0 sums the rows in the fixed order and runs the scalar update.
// The grid is as many blocks as can be resident at once (the occupancy of
// this kernel times the SM count, or the caller's count); a cooperative
// launch that cannot be resident is refused by CUDA and the error is
// returned, never run as something else.
//
// Bound: launch latency and the grid barriers.  The work per iteration is
// that of B1 + B2 (61k events, 442k pixels at scale 3); the gain over the
// chain is three launches and two memsets fewer per iteration, paid for with
// four grid-wide barriers, and phase 4 runs on one block while the others
// wait at the kernel's end.
#include <cooperative_groups.h>

#include "finish.cuh"

namespace cg = cooperative_groups;

namespace {

using bf::FINISH_THREADS;

struct MegastepArgs {
  const float* geo;
  const float* st;
  const float* stat;
  const float* act;
  const float* pr;
  float* npr;
  float* st_out;
  unsigned long long* acc_t;
  int* acc_c;
  float* img;
  double* partials;
  int n, HP, WP, H, W, scale, time_lo;
  bf::UpdateParams p;
};

__global__ void __launch_bounds__(FINISH_THREADS)
megastep_kernel(MegastepArgs a) {
  __shared__ bf::FinishShared sh;
  cg::grid_group grid = cg::this_grid();
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t nthreads = static_cast<size_t>(gridDim.x) * blockDim.x;

  const size_t pixels = static_cast<size_t>(a.HP) * a.WP;
  for (size_t k = tid; k < pixels; k += nthreads) {
    a.acc_t[k] = 0ull;
    a.acc_c[k] = 0;
  }
  grid.sync();

  const bf::Warp w = bf::warp_from_state(a.st);
  for (size_t i = tid; i < static_cast<size_t>(a.n); i += nthreads)
    bf::warp_splat_event(static_cast<int>(i), a.geo, w, a.stat, a.act, a.pr,
                         a.npr, a.acc_t, a.acc_c, a.WP, a.scale, a.time_lo);
  grid.sync();

  const long long* acc_t = reinterpret_cast<const long long*>(a.acc_t);
  for (int i = blockIdx.x; i < a.H; i += gridDim.x)
    bf::image_row(acc_t, a.acc_c, a.img, i, a.HP, a.WP, a.W, a.scale / 2);
  grid.sync();

  for (int i = blockIdx.x; i < a.H; i += gridDim.x)
    bf::gradient_row(a.img, a.partials, i, a.H, a.W, sh);
  grid.sync();

  if (blockIdx.x == 0)
    bf::update_block(a.partials, a.H, a.st, a.geo, a.st_out,
                     static_cast<float>(a.scale), a.p, sh);
}

// Resident blocks of megastep_kernel per device, found once.
int resident_blocks(int dev) {
  static int cached[64] = {0};
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, megastep_kernel, FINISH_THREADS, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const int blocks = per_sm * sms;
  if (dev >= 0 && dev < 64) cached[dev] = blocks;
  return blocks;
}

}  // namespace

// blocks <= 0: as many blocks as can be resident.  Returns the CUDA error
// of the launch (0 on success).
extern "C" int bf_megastep(const float* geo, const float* st,
                           const float* stat, const float* act,
                           const float* pr, float* npr, float* st_out,
                           long long* acc_t, int* acc_c, float* img,
                           double* partials, int nch, int HP, int WP, int H,
                           int W, int scale, int time_lo,
                           const bf::UpdateParams* params, int blocks,
                           void* stream) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (blocks <= 0) {
    blocks = resident_blocks(dev);
    if (blocks <= 0) {
      cudaGetLastError();
      return static_cast<int>(cudaErrorLaunchOutOfResources);
    }
  }
  MegastepArgs a{geo, st, stat, act, pr, npr, st_out,
                 reinterpret_cast<unsigned long long*>(acc_t), acc_c, img,
                 partials, nch * bf::CHUNK, HP, WP, H, W, scale, time_lo,
                 *params};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(megastep_kernel),
                                  dim3(blocks), dim3(FINISH_THREADS), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it: the next launch must not report it
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
