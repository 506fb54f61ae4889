// One trip of the single-device split drive in one call: ``unroll`` B1 + B2
// pairs, then the copy of the last state's [ITERS, CONT] into a pinned host
// slot and an event recorded after it.
//
// Replaces, on the card, the Python of a trip of run_fused_mega
// (models/global_flow.py): the wrappers' checks, the launch arguments, the
// two output allocations and the pageable read of CONT that synchronised the
// stream, once a trip.  The launch plan (TripArgs, mirrored by
// ops/_build.TripArgs and filled once per drive call or per slice range by
// ops/fused_model.TripPlan) holds what does not change across the trips.
//
// Design: the launches are those of bf_warp_images_st (B1) and
// bf_megastep_finish (B2), called here with the wrappers' arguments, in the
// same order on the same stream, so the kernels, their grids and their
// outputs are bitwise those of the wrapper drive.  The pairs' positions and
// states go to two buffers in turn: pair k reads the drive's start (k = 0)
// or buffer (k - 1) & 1 and writes buffer k & 1, so the start state, which
// the final warp's hand-off reads, is never written.  The host then waits
// on the event (bf_trip_wait) and reads the two floats from the slot: one
// blocking wait a trip, as the wrapper drive's read, without the pageable
// copy's staging.
#include "iteration.cuh"

extern "C" int bf_warp_images_st(const float* geo, const float* st,
                                 const float* stat, const float* act,
                                 const float* pr, float* npr,
                                 long long* acc_t, int* acc_c, int nch,
                                 int WP, int scale, int time_lo,
                                 int predicated, void* stream);
extern "C" int bf_megastep_finish(long long* acc_t, int* acc_c,
                                  const float* st, const float* geo,
                                  float* st_out, double* partials, int HP,
                                  int WP, int H, int W, int scale, int rows,
                                  int smem, int predicated,
                                  const bf::UpdateParams* params,
                                  void* stream);

// A drive's launch plan.  The slice's tensors (geo to st0) are set per
// drive call; the rest once per plan.
struct TripArgs {
  const float* geo;    // (1, 8) the slice's geometry row
  const float* stat;   // (nch, 3, CHUNK)
  const float* act;    // (nch, 1, CHUNK)
  const float* pr0;    // (nch, 2, CHUNK) the start positions, read only
  const float* st0;    // (1, 32) the start state, read only
  long long* acc_t;    // the image pair, zero between trips
  int* acc_c;
  float* pr[2];        // (nch, 2, CHUNK) the pairs' positions, in turn
  float* st[2];        // (1, 32) the pairs' states, in turn
  double* partials;    // (H, 9) B2's row sums
  float* slot;         // pinned (2,) host floats: [ITERS, CONT]
  void* event;         // recorded after the slot's copy
  void* stream;        // the stream current when the plan was made
  int nch, HP, WP, H, W, scale, rows, smem, time_lo, unroll, predicated;
  bf::UpdateParams params;
};

// ``unroll`` pairs after ``done`` pairs of this drive call, the slot's copy
// and the event.  Returns the first CUDA error (0 on success); a refused
// launch stops the trip there.
extern "C" int bf_trip(const TripArgs* p, int done) {
  for (int j = 0; j < p->unroll; ++j) {
    const int k = done + j;
    const float* pr = k ? p->pr[(k - 1) & 1] : p->pr0;
    const float* st = k ? p->st[(k - 1) & 1] : p->st0;
    int rc = bf_warp_images_st(p->geo, st, p->stat, p->act, pr, p->pr[k & 1],
                               p->acc_t, p->acc_c, p->nch, p->WP, p->scale,
                               p->time_lo, p->predicated, p->stream);
    if (rc != 0) return rc;
    rc = bf_megastep_finish(p->acc_t, p->acc_c, st, p->geo, p->st[k & 1],
                            p->partials, p->HP, p->WP, p->H, p->W, p->scale,
                            p->rows, p->smem, p->predicated, &p->params,
                            p->stream);
    if (rc != 0) return rc;
  }
  const float* last = p->st[(done + p->unroll - 1) & 1];
  auto stream = static_cast<cudaStream_t>(p->stream);
  cudaError_t e = cudaMemcpyAsync(p->slot, last + bf::ST_ITERS,
                                  2 * sizeof(float), cudaMemcpyDeviceToHost,
                                  stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaEventRecord(static_cast<cudaEvent_t>(p->event), stream));
}

// Blocks until the last trip's slot is written.
extern "C" int bf_trip_wait(const TripArgs* p) {
  return static_cast<int>(
      cudaEventSynchronize(static_cast<cudaEvent_t>(p->event)));
}

// A new event without timing on the current device, into ``*event``.
extern "C" int bf_trip_event(void** event) {
  cudaEvent_t e = nullptr;
  const cudaError_t rc = cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
  *event = rc == cudaSuccess ? static_cast<void*>(e) : nullptr;
  return static_cast<int>(rc);
}
