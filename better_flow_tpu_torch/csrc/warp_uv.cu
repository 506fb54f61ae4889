// Final warp of a slice and its packed per-event output.
//
// Replaces _kernel_warp_uv / warp_uv_call (better_flow_tpu/ops/pallas/
// fused_model.py): one warp with the converged model, writing
// [pr_x, pr_y, nx, ny] and the scan's per-event [u, v, noise] rows, where
// u = nx * UV_FACTOR / NZ and noise = max(1 - act, window_small).  The warp
// scalars come from the device state vector, so the host reads nothing.
// The [u, v, noise] rows go where the caller points: the scan passes its
// run's (S, nch, 3, CHUNK) output at slice s, so no copy follows.  One
// launch may cover all of a process's event-parallel shards (contiguous
// chunk ranges of one slice under one state): the warp is slot-wise.
//
// Bound: bytes (24 B read and 28 B written per slot, 3.2 MB per slice at
// 61,440 slots, ~1 us at 3.35 TB/s); at the main path's size, latency:
// one wave of blocks whose critical path is the state's load and the f64
// cos/sin chains.  Design: B1's (warp_images_st.cu), one slot a thread,
// the warp scalars computed once a block (block_warp_start: cos on thread
// 0, sin on thread 32) while every thread's loads are in flight, then the
// warp and the stores.  The bits are those of the warp in every thread:
// the same functions of the same values.  Two slots a thread (8-byte
// loads and stores along the rows) were no faster on an H100, four slower
// (PERF.md, section 6).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
warp_uv_kernel(const float* __restrict__ stat, const float* __restrict__ pr,
               const float* __restrict__ act, const float* __restrict__ st,
               float wsmall, float* __restrict__ out,
               float* __restrict__ uvn, int n) {
  using bf::CHUNK;
  bf::block_warp_start<true>(st);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = i / CHUNK;
  const int k = i - c * CHUNK;
  const float* s = stat + static_cast<size_t>(c) * 3 * CHUNK;
  const float* p = pr + static_cast<size_t>(c) * 2 * CHUNK;
  float fx = 0.0f, fy = 0.0f, t_ns = 0.0f, px = 0.0f, py = 0.0f, a = 0.0f;
  if (i < n) {
    fx = s[k];
    fy = s[CHUNK + k];
    t_ns = s[2 * CHUNK + k];
    px = p[k];
    py = p[CHUNK + k];
    a = act[static_cast<size_t>(c) * CHUNK + k];
  }
  const bf::Warp w = bf::block_warp_wait();
  if (i >= n) return;
  float ox, oy, nx, ny;
  bf::warp_event(w, fx, fy, t_ns, px, py, &ox, &oy, &nx, &ny);
  float* o = out + static_cast<size_t>(c) * 4 * CHUNK;
  float* u = uvn + static_cast<size_t>(c) * 3 * CHUNK;
  o[k] = ox;
  o[CHUNK + k] = oy;
  o[2 * CHUNK + k] = nx;
  o[3 * CHUNK + k] = ny;
  u[k] = nx * bf::UV_K;
  u[CHUNK + k] = ny * bf::UV_K;
  u[2 * CHUNK + k] = fmaxf(1.0f - a, wsmall);
}

}  // namespace

extern "C" int bf_warp_uv(const float* stat, const float* pr,
                          const float* act, const float* st, float wsmall,
                          float* out, float* uvn, int nch, void* stream) {
  const int n = nch * bf::CHUNK;
  warp_uv_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(stat, pr, act, st,
                                                        wsmall, out, uvn, n);
  return static_cast<int>(cudaGetLastError());
}
