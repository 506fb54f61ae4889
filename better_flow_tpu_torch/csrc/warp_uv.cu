// Final warp of a slice and its packed per-event output.
//
// Replaces _kernel_warp_uv / warp_uv_call (better_flow_tpu/ops/pallas/
// fused_model.py): one warp with the converged model, writing
// [pr_x, pr_y, nx, ny] and the scan's per-event [u, v, noise] rows, where
// u = nx * UV_FACTOR / NZ and noise = max(1 - act, window_small).  The warp
// scalars come from the device state vector, so the host reads nothing.
//
// Bound: bytes (28 B read and 28 B written per slot, 3.4 MB per slice at
// 61,440 slots).  One thread per slot, coalesced along the chunk.
#include "common.cuh"

namespace {

__global__ void warp_uv_kernel(const float* __restrict__ stat,
                               const float* __restrict__ pr,
                               const float* __restrict__ act,
                               const float* __restrict__ st, float wsmall,
                               float* __restrict__ out,
                               float* __restrict__ uvn, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = i / bf::CHUNK;
  const int k = i - c * bf::CHUNK;
  const float* s = stat + static_cast<size_t>(c) * 3 * bf::CHUNK;
  const float* p = pr + static_cast<size_t>(c) * 2 * bf::CHUNK;
  float* o = out + static_cast<size_t>(c) * 4 * bf::CHUNK;
  float* u = uvn + static_cast<size_t>(c) * 3 * bf::CHUNK;

  const bf::Warp w = bf::warp_from_state(st);
  float ox, oy, nx, ny;
  bf::warp_event(w, s[k], s[bf::CHUNK + k], s[2 * bf::CHUNK + k], p[k],
                 p[bf::CHUNK + k], &ox, &oy, &nx, &ny);
  o[k] = ox;
  o[bf::CHUNK + k] = oy;
  o[2 * bf::CHUNK + k] = nx;
  o[3 * bf::CHUNK + k] = ny;
  u[k] = nx * bf::UV_K;
  u[bf::CHUNK + k] = ny * bf::UV_K;
  u[2 * bf::CHUNK + k] =
      fmaxf(1.0f - act[static_cast<size_t>(c) * bf::CHUNK + k], wsmall);
}

}  // namespace

extern "C" int bf_warp_uv(const float* stat, const float* pr,
                          const float* act, const float* st, float wsmall,
                          float* out, float* uvn, int nch, void* stream) {
  const int n = nch * bf::CHUNK;
  const int threads = 256;
  warp_uv_kernel<<<(n + threads - 1) / threads, threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(stat, pr, act, st,
                                                        wsmall, out, uvn, n);
  return static_cast<int>(cudaGetLastError());
}
