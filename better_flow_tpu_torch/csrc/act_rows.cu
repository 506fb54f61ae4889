// Activity rows of one slice.
//
// Replaces _kernel_act / act_rows_call (better_flow_tpu/ops/pallas/
// fused_model.py): a slot is active when it holds an event (sidx >= 0) and
// the event's original index lies in none of the last K window-gated
// slices' [start, end] ranges.
//
// Bound: bytes.  It reads 4 B and writes 4 B per slot (0.5 MB per slice at
// 61,440 slots) and does K compares per slot.  One thread per slot with
// coalesced loads and stores; the (3, K) history is a few dozen bytes that
// every thread reads through the cache.
#include "common.cuh"

namespace {

__global__ void act_rows_kernel(const int* __restrict__ sidx,
                                const int* __restrict__ hist, int K, int n,
                                float* __restrict__ act) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = sidx[i];
  bool ok = s >= 0;
  for (int j = 0; j < K; ++j) {
    const bool noise = hist[j] > 0 && s >= hist[K + j] && s <= hist[2 * K + j];
    ok = ok && !noise;
  }
  act[i] = ok ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int bf_act_rows(const int* sidx, const int* hist, int K, int n,
                           float* act, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  act_rows_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      sidx, hist, K, n, act);
  return static_cast<int>(cudaGetLastError());
}
