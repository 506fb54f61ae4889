// Activity rows of a staged range of slices, in one launch.
//
// Replaces _kernel_act / act_rows_call (better_flow_tpu/ops/pallas/
// fused_model.py): a slot is active when it holds an event (sidx >= 0) and
// the event's original index lies in none of the last K window-gated
// slices' [start, end] ranges.  The TPU kernel runs once a slice, inside
// the scan's loop, because the gate history rides in the scan's carry; here
// every slice's (3, K) history is known on the host before the loop, so
// one launch covers all S slices of the range (S = 1 for one slice).
//
// Bound: bytes.  It reads 4 B and writes 4 B per slot (49 MB for the 100
// slices of 61,440 slots of a 2M-event scan) and does K compares per slot.
// A launch costs ~4 us on an H100 whatever its work, which is all of a
// one-slice launch's time, so the design is about the launch count: one a
// range, not one a slice.  Each block covers 4 * blockDim.x slots of one
// slice (capp is a multiple of CHUNK, so a block never crosses a slice),
// stages that slice's history into shared memory once, and each thread
// loads four slots as one int4 and stores four values as one float4.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SLOTS = 4 * THREADS;   // a block's slots; divides CHUNK

__global__ void __launch_bounds__(THREADS)
act_rows_kernel(const int* __restrict__ sidx, const int* __restrict__ hist,
                int K, int capp, float* __restrict__ act) {
  extern __shared__ int sh[];   // the slice's (3, K) history
  const size_t b0 = static_cast<size_t>(blockIdx.x) * SLOTS;
  const int s = static_cast<int>(b0 / capp);
  for (int j = threadIdx.x; j < 3 * K; j += THREADS)
    sh[j] = hist[static_cast<size_t>(s) * 3 * K + j];
  const size_t i = b0 + 4 * threadIdx.x;
  const int4 q = *reinterpret_cast<const int4*>(sidx + i);
  __syncthreads();
  const int v[4] = {q.x, q.y, q.z, q.w};
  float r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    bool ok = v[e] >= 0;
    for (int j = 0; j < K; ++j) {
      const bool noise =
          sh[j] > 0 && v[e] >= sh[K + j] && v[e] <= sh[2 * K + j];
      ok = ok && !noise;
    }
    r[e] = ok ? 1.0f : 0.0f;
  }
  *reinterpret_cast<float4*>(act + i) = make_float4(r[0], r[1], r[2], r[3]);
}

}  // namespace

// sidx (S, capp) int32 and hist (S, 3, K) int32 give act (S, capp) f32;
// capp a multiple of CHUNK, sidx and act 16-byte aligned.
extern "C" int bf_act_rows(const int* sidx, const int* hist, int K, int S,
                           int capp, float* act, void* stream) {
  static_assert(bf::CHUNK % SLOTS == 0, "a block crosses a chunk");
  if (S == 0) return 0;
  const long long blocks = static_cast<long long>(S) * (capp / SLOTS);
  act_rows_kernel<<<static_cast<unsigned>(blocks), THREADS,
                    3 * K * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      sidx, hist, K, capp, act);
  return static_cast<int>(cudaGetLastError());
}
