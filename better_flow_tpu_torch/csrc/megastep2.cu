// The merged megastep: one launch an iteration, with the previous
// iteration's finish at its head; the call whose head ends the loop is the
// final warp.
//
// Replaces _kernel_megastep2 / megastep2_call (better_flow_tpu/ops/pallas/
// fused_model.py), the per-iteration kernel of OptimizerConfig.
// megastep_merged.  One cooperative launch; phases separated by grid-wide
// barriers (cooperative_groups grid.sync()):
//   head, when st[ST_HAS] is set (every call of a slice but its first):
//     0. grid-stride over rows: the box filter and normalise pass over the
//        previous call's images (img_t int64 fixed point, img_c int32);
//     1. grid-stride over rows: Scharr and the row's nine f64 sums;
//     2. block 0 sums the rows in the fixed order and runs the scalar update
//        into st_out (CONT, ITERS, ...);
//   head, on a slice's first call: st_out = st with CONT = 1;
//   both: ST_HAS = 1, and the new images are zeroed;
//   3. grid-stride over events: warp with st_out, write [pr_x, pr_y, nx, ny]
//      (bf::warp_event, B4's arithmetic), and, while st_out's CONT is set,
//      splat (bf::splat_position, B1's).
// The device functions and the block size are those of megastep.cu (B5),
// megastep_finish.cu (B2) and warp_uv.cu (B4), so a merged run's states,
// positions and direction vectors are bitwise those of the B5 (or B1 + B2)
// chain followed by B4.  The splat has no window, so the fallback count
// (ST_FB) is passed through unchanged.
//
// Bound: launch latency and the grid barriers, as B5: per iteration the
// events (61k at the production shapes, 28 B read and 16 B written a slot)
// and the two images (442k pixels at scale 3); one launch an iteration, and
// none for the final warp.
#include <cooperative_groups.h>

#include "finish.cuh"

namespace cg = cooperative_groups;

namespace {

using bf::FINISH_THREADS;

struct Megastep2Args {
  const float* geo;
  const float* st;
  const float* stat;
  const float* act;
  const float* pr;
  const long long* img_t;
  const int* img_c;
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
megastep2_kernel(Megastep2Args a) {
  __shared__ bf::FinishShared sh;
  cg::grid_group grid = cg::this_grid();
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t nthreads = static_cast<size_t>(gridDim.x) * blockDim.x;

  const size_t pixels = static_cast<size_t>(a.HP) * a.WP;
  for (size_t k = tid; k < pixels; k += nthreads) {
    a.acc_t[k] = 0ull;
    a.acc_c[k] = 0;
  }
  if (a.st[bf::ST_HAS] > 0.5f) {
    for (int i = blockIdx.x; i < a.H; i += gridDim.x)
      bf::image_row(a.img_t, a.img_c, a.img, i, a.HP, a.WP, a.W, a.scale / 2);
    grid.sync();
    for (int i = blockIdx.x; i < a.H; i += gridDim.x)
      bf::gradient_row(a.img, a.partials, i, a.H, a.W, sh);
    grid.sync();
    if (blockIdx.x == 0)
      bf::update_block(a.partials, a.H, a.st, a.geo, a.st_out,
                       static_cast<float>(a.scale), a.p, sh);
  } else if (tid == 0) {
    for (int k = 0; k < bf::ST_SIZE; ++k) a.st_out[k] = a.st[k];
    a.st_out[bf::ST_CONT] = 1.0f;
  }
  if (tid == 0) a.st_out[bf::ST_HAS] = 1.0f;
  grid.sync();

  const bf::Warp w = bf::warp_from_state(a.st_out);
  const bool splat = a.st_out[bf::ST_CONT] > 0.0f;
  for (size_t i = tid; i < static_cast<size_t>(a.n); i += nthreads) {
    const size_t c = i / bf::CHUNK;
    const size_t k = i - c * bf::CHUNK;
    const float* s = a.stat + c * 3 * bf::CHUNK;
    const float* p = a.pr + c * 4 * bf::CHUNK;
    float* q = a.npr + c * 4 * bf::CHUNK;
    const float t_ns = s[2 * bf::CHUNK + k];
    float ox, oy, nx, ny;
    bf::warp_event(w, s[k], s[bf::CHUNK + k], t_ns, p[k], p[bf::CHUNK + k],
                   &ox, &oy, &nx, &ny);
    q[k] = ox;
    q[bf::CHUNK + k] = oy;
    q[2 * bf::CHUNK + k] = nx;
    q[3 * bf::CHUNK + k] = ny;
    if (splat)
      bf::splat_position(ox, oy, a.act[c * bf::CHUNK + k] > 0.0f,
                         t_ns * bf::INV_NS_PER_SEC,
                         s[2 * bf::CHUNK] * bf::INV_NS_PER_SEC, a.geo, a.acc_t,
                         a.acc_c, a.WP, a.scale, a.time_lo);
  }
}

// Resident blocks of megastep2_kernel per device, found once.
int resident_blocks(int dev) {
  static int cached[64] = {0};
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, megastep2_kernel, FINISH_THREADS, 0) != cudaSuccess ||
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
extern "C" int bf_megastep2(const float* geo, const float* st,
                            const float* stat, const float* act,
                            const float* pr, const long long* img_t,
                            const int* img_c, float* npr, float* st_out,
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
  Megastep2Args a{geo, st, stat, act, pr, img_t, img_c, npr, st_out,
                  reinterpret_cast<unsigned long long*>(acc_t), acc_c, img,
                  partials, nch * bf::CHUNK, HP, WP, H, W, scale, time_lo,
                  *params};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(megastep2_kernel),
                                  dim3(blocks), dim3(FINISH_THREADS), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it: the next launch must not report it
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
