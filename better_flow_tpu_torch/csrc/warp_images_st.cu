// Warp every event of a slice and add its splat into the time and count
// images of the caller's pair.
//
// Replaces _kernel_warp_images_st / warp_images_st_call (better_flow_tpu/
// ops/pallas/fused_model.py).  Per event (common.cuh's warp_event and
// splat_position, the functions of warp_splat_event that megastep.cu
// shares): re-warp from the state vector's totals, scale, truncate to a
// pixel, accept inside the dynamic window, and add the event's time weight
// and a count of one to its pixel.
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
// Design: B5's splat phase (iteration.cuh) as an ordinary launch, one
// slot a thread.  The warp scalars are computed once a block
// (block_warp_start: thread 0 all but the sine, thread 32 the sine, two f64
// chains at once), not in every thread; every thread issues its slot's
// loads before it waits for them (block_warp_wait), so their latency
// overlaps the chains.  The new positions and the images are bitwise those
// of the warp in every thread (the same functions of the same values).  On
// an H100 this is faster than the warp in every thread, and than cos and
// sin on one thread; two or four slots a thread (16-byte loads, fewer
// blocks) were slower than one (PERF.md, section 6).
//
// Predicated mode (predicated = 1, the unrolled split drive of
// OptimizerConfig.megastep_unroll): a state whose CONT is not set passes
// through: every slot copies its pr into npr and the pair gets nothing.
// Every thread reads the same flag of the input state, which no thread
// writes, so the branch is uniform and no block reaches block_warp's
// barrier on one side of it only.  A live state runs the same code as the
// unpredicated kernel (one template, the predicate a template argument).
// The TPU kernel's splat_pair (several chunks a grid step) is a block shape
// of its pipeline: here one slot is a thread, so it selects nothing.
//
// Bound: on a spread slice, bytes (36 B read and 8 B written per event, and
// 12 B for each pixel the events hit, added by atomics); on a converged
// slice, where events pile onto a few pixels, atomic contention on those
// pixels; at the main path's 61k slots, latency: one wave of blocks, whose
// critical path is the state's load, the cos/sin chain, the block's
// barrier and the atomics.  The window, the row-band fallbacks and the
// one-hot matmul of the TPU kernel are devices of the TPU and have no
// counterpart here.
#include "iteration.cuh"

namespace {

template <bool kPredicated>
__global__ void __launch_bounds__(bf::BAND_THREADS)
warp_images_st_kernel(const float* __restrict__ geo,
                      const float* __restrict__ st,
                      const float* __restrict__ stat,
                      const float* __restrict__ act,
                      const float* __restrict__ pr, float* __restrict__ npr,
                      unsigned long long* __restrict__ acc_t,
                      int* __restrict__ acc_c, int n, int WP, int scale,
                      int time_lo) {
  using bf::CHUNK;
  if constexpr (kPredicated) {
    if (!(st[bf::ST_CONT] > 0.0f)) {   // converged: pr passes through
      const int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) {
        const size_t c = i / CHUNK;
        const size_t k = i - c * CHUNK;
        npr[c * 2 * CHUNK + k] = pr[c * 2 * CHUNK + k];
        npr[c * 2 * CHUNK + CHUNK + k] = pr[c * 2 * CHUNK + CHUNK + k];
      }
      return;
    }
  }
  bf::block_warp_start<true>(st);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = i / CHUNK;
  const int k = i - c * CHUNK;
  const float* s = stat + static_cast<size_t>(c) * 3 * CHUNK;
  const float* p = pr + static_cast<size_t>(c) * 2 * CHUNK;
  float fx = 0.0f, fy = 0.0f, t_ns = 0.0f, px = 0.0f, py = 0.0f, a = 0.0f;
  float t0 = 0.0f;
  if (i < n) {
    fx = s[k];
    fy = s[CHUNK + k];
    t_ns = s[2 * CHUNK + k];
    px = p[k];
    py = p[CHUNK + k];
    a = act[static_cast<size_t>(c) * CHUNK + k];
    t0 = s[2 * CHUNK];
  }
  const bf::Warp w = bf::block_warp_wait();
  if (i >= n) return;
  float ox, oy, nx, ny;
  bf::warp_event(w, fx, fy, t_ns, px, py, &ox, &oy, &nx, &ny);
  float* q = npr + static_cast<size_t>(c) * 2 * CHUNK;
  q[k] = ox;
  q[CHUNK + k] = oy;
  bf::splat_position(ox, oy, a > 0.0f, t_ns * bf::INV_NS_PER_SEC,
                     t0 * bf::INV_NS_PER_SEC, geo, acc_t, acc_c, WP, scale,
                     time_lo);
}

}  // namespace

extern "C" int bf_warp_images_st(const float* geo, const float* st,
                                 const float* stat, const float* act,
                                 const float* pr, float* npr,
                                 long long* acc_t, int* acc_c, int nch,
                                 int WP, int scale, int time_lo,
                                 int predicated, void* stream) {
  const int n = nch * bf::CHUNK;
  const int blocks = (n + bf::BAND_THREADS - 1) / bf::BAND_THREADS;
  auto* kernel = predicated ? warp_images_st_kernel<true>
                            : warp_images_st_kernel<false>;
  kernel<<<blocks, bf::BAND_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      geo, st, stat, act, pr, npr,
      reinterpret_cast<unsigned long long*>(acc_t), acc_c, n, WP, scale,
      time_lo);
  return static_cast<int>(cudaGetLastError());
}
