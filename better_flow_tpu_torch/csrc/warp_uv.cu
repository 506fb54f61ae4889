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
//
// The slice loop's hand-off (optional, null by default): block 0 also
// writes the next slice's start state and (12,) seed, the copies and
// constants of global_flow.initial_state on this slice's final state and
// of run_slices' seed row, so the loop rebuilds nothing between slices.
// Warp 2 of block 0 writes them, one slot a thread, beside its slots'
// loads; threads 0 and 32 keep the warp scalars' chains to themselves.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int HANDOFF_WARP = 2;

struct Handoff {
  const float* st_in;   // (1, 32) the slice's start state
  float* st_next;       // (1, 32) the next slice's start state; null: none
  float* seed_next;     // (12,) [slope memory, last deltas, st_in totals]
  float xy_div;         // the initial dividers
  float rotdiv_div;
  int keep_slope;       // the fast schedule carries the slope memory
};

// Slot k of the next start state and of the seed row: the state's
// totals, compensations, centroid and count, the initial dividers,
// CONT = 1, the slope memory under the fast schedule, zero elsewhere;
// the seed [st[SL:+4], st[PD:+4], st_in's totals in (rot, div, dx, dy)
// order].
__device__ inline void write_handoff(const Handoff& h, const float* st,
                                     int k) {
  using namespace bf;
  float v = 0.0f;
  if (k <= ST_CY || k == ST_CNT ||
      (h.keep_slope && k >= ST_SL && k < ST_SL + 4)) {
    v = st[k];
  } else if (k == ST_XDIV || k == ST_YDIV) {
    v = h.xy_div;
  } else if (k == ST_RDIV || k == ST_DDIV) {
    v = h.rotdiv_div;
  } else if (k == ST_CONT) {
    v = 1.0f;
  }
  h.st_next[k] = v;
  static_assert(ST_TDX == 0 && ST_TDY == 1 && ST_TROT == 2 && ST_TDIV == 3,
                "the totals are slots 0-3");
  if (k < 4) {
    h.seed_next[k] = st[ST_SL + k];
  } else if (k < 8) {
    h.seed_next[k] = st[ST_PD + k - 4];
  } else if (k < 12) {
    h.seed_next[k] = h.st_in[(k - 6) & 3];   // rot, div, dx, dy: 2, 3, 0, 1
  }
}

__global__ void __launch_bounds__(THREADS)
warp_uv_kernel(const float* __restrict__ stat, const float* __restrict__ pr,
               const float* __restrict__ act, const float* __restrict__ st,
               float wsmall, float* __restrict__ out,
               float* __restrict__ uvn, int n, Handoff h) {
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
  const int lane = threadIdx.x - HANDOFF_WARP * 32;
  if (h.st_next != nullptr && blockIdx.x == 0 && lane >= 0 &&
      lane < bf::ST_SIZE) {
    write_handoff(h, st, lane);
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
                          float* out, float* uvn, int nch,
                          const float* st_in, float* st_next,
                          float* seed_next, float xy_div, float rotdiv_div,
                          int keep_slope, void* stream) {
  const int n = nch * bf::CHUNK;
  const Handoff h{st_in, st_next, seed_next, xy_div, rotdiv_div, keep_slope};
  warp_uv_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      stat, pr, act, st, wsmall, out, uvn, n, h);
  return static_cast<int>(cudaGetLastError());
}
