#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the thirteen CUDA kernels of
``better_flow_tpu_torch/csrc`` (one nvcc per source, in parallel) and then,
in phases that each raise on failure:

1. environment: the card, its power limit, the torch, CUDA and nvcc
   versions and the build time;
2. each kernel against its plain PyTorch twin on the card, at the main
   path's shapes (180x240 sensor, scale 3: 30 chunks of 2048 events,
   576x768 images, a gate history of 3), with the errors and the median
   time of kernel and twin over 25 runs (CUDA events); B1 adds into its
   caller's image pair and B2 reads it and leaves it zero, each bitwise
   its twin on the card; the megastep (B5) also at the live preset's scale-1
   shapes (15 chunks, 192x256 images), bitwise equal to its twin and to
   the B1 -> B2 kernel chain, with the chain's time beside its own; the
   composed path's kernel (B6) on the
   warp rows of an f32 and of an f64 carry, bitwise equal to its twin and
   to the B7a -> B7b chain, with that chain's time beside its own; for B2,
   B5, B6, B7b and B12 their band height R and resident grid, and each
   chain's device operations one by one (``[kernels] breakdown`` lines,
   torch.profiler, median of 20 calls: one kernel each for B1, B2, B7a and
   B7b, no memset; B1's alone beside a one-element PyTorch kernel's, the
   fixed cost of a launch); the event-parallel pair (B7a warp + splat
   added into an image pair, B7b finish to the seven sums, leaving the pair
   zero) against their twins on both rows, their chain bitwise B6, and four
   shards a B7a launch each bitwise one launch over them all; B3 on one
   slice and over the main path's whole staged range in one launch
   (bitwise its twin and the one-slice calls), B4 into its own rows and
   into the caller's (bitwise its twin on the card), each with its device
   time; beside each
   kernel's time the least time the card could take (``bound_ms``, the
   pair's bytes by one rule, ``pair_bytes``);
3. the scan, ``compensate_recording_scan`` with ``OptimizerConfig.fast()``,
   on the 2,000,000-event bench stream of ``bench.py`` (one warm-up run,
   then a measured run), with every kernel's launch count in that run (B3
   once, B4 once a slice that ran) and a digest of its output
   (``scan_digest``, to compare two trees);
4. determinism: a second measured run gives bitwise the same output;
   then the cold path (``[cold]``, ``phase_cold``):
   ``compensate_recording_cold`` on the same 2M events in four batches,
   bitwise the scan, B3 launched once a batch and B4 once a slice that
   ran; with ``compact_results`` within f16 rounding (its packed bytes
   those of the exact run); killed while staging its third batch and
   resumed from its checkpoint, bitwise, exact and compact; the scan
   routed to it under a tiny ``BF_SCAN_DEVICE_BUDGET_GB``, bitwise; and
   bench.py's cold protocol on 12M events (``compact_results``, a warm-up
   call, then the measured one): events/s, each batch's staging, run and
   fetch time, their overlap, and peak device memory against the scan's;
5. the card against the CPU twins on the stream's first 200,000 events;
   then the fast schedule's quality (``[quality]``, ``phase_quality``):
   tools/sweep_exit.py's three scenes at five seeds each (180x240,
   120,000-200,000 events) under the reference schedule, ``fast()``,
   ``fast_accurate()`` and ``fast_throughput()``, each scene's seed mean
   and max of the AEE ratio and the iteration fraction beside
   BASELINE.md:360; the gates of tests/test_fast_schedule.py at their own
   seeds (``FAST_GATES``; the two that the JAX package's own kernel path
   misses printed MET or NOT MET, outside the verdict); every gate run
   against the CPU twins (noise identical, >= 90% of slices with equal
   iterations); and each run's launches (B3, B1, B2, B4 under the fast
   presets, B3, B5, B4 under the reference schedule);
   then the numpy staging route (``[staging]``, ``phase_staging``): the
   main path's staging asserted native; the scan of the 2M stream with
   seeded sub-pixel offsets (B3, B1, B2, B4 counted, a repeat bitwise,
   the CPU twins on the first 200,000 events under the scan gates,
   ``plan_s`` by route), the integer stream at ``max_events`` 100,000
   (54 chunks a slice) against its CPU twins on its first slices, the
   cold path (4 batches, exact and ``compact_results``) and the 4-shard
   scan on the sub-pixel stream bitwise its scan, and the CLI's ``--scan
   -o`` on a sub-pixel text file;
6. the streaming path, ``runtime.offline.compensate_recording``, on the
   same 2M events under the reference schedule (B5 + B4) and under
   ``fast()`` (B1 + B2 + B4), each run twice (bitwise equal), with the
   launch counts and host syncs, and against the CPU twins on the first
   200,000 events;
7. the CLI, ``--bufferize-file -o`` on the card, against the library call;
   ``--img`` and ``--video`` on the first 60,000 events (a frame a slice,
   the first frame equal to the CPU run's, B5 and B4 counted); one
   manual-mode tick, 'c' (B5, B4) and a tick on the first slice window,
   equal to the CPU's;
8. the composed path (one B6 launch per iteration, the scalar update
   between launches): the scan with f64 totals (``PipelineConfig(
   f64_totals=True)``, reference schedule) on the 2M events, run twice
   (bitwise equal), with its launch counts, and against the CPU twins on
   the first 200,000 events; then the stream on those 200,000 events with
   f64 totals and with ``fast(use_megastep=False)``, each against the CPU
   twins;
9. the event-parallel path: ``compensate_recording_scan_sharded`` on the 2M
   events with 1 and 4 shards on the one card, under ``fast()`` (one B1
   launch for all shards, the seam, B2) and with f64 totals (one B7a launch
   for all shards, the seam, B7b), each bitwise the unsharded scan staged
   with the same padding, with the launch counts (B3 once for the staged
   range, B4 once a slice that ran, whatever the shards) and the
   host ms an iteration beside the unsharded run's, and for 4 shards in
   turns with it; then
   ``compensate_recording_multihost`` in one
   process over three slice ranges (chained carries, disjoint claims),
   bitwise the full scan;
10. the tiled megapixel pipeline (``parallel.spatial``), all tiles resident
    on the one card, at the protocol of ``tools/bench_tiled.py``: a 720x1280
    sensor at scale 1, slices of <= 60,000 events / 70 ms, a retrigger every
    25,000 events / 30 ms, ``max_iter`` 10, halo 32, ``esc_cap`` 32768,
    600,000 synthetic events.  First B8 (``splat_local``) and B9
    (``finish_local``) against their twins at the 1x1 tile's shapes (one
    785x1345 image pair, 30 chunks) and at the 4x2 batch (eight 245x705
    tiles), sorted and unsorted slots, an owned window and the whole image
    (bitwise B7b): B8 adds into a padded pair (n_tiles, HP, WP) and leaves
    its padding zero, B9 reads it and leaves it zero; B9's band height R
    and grid, and the device operations of one B8 -> B9 (one kernel each,
    no memset).  Then ``compensate_recording_tiled`` on 1x1 and 4x2 tiles
    under the reference schedule and on 4x2 under ``fast``: no event dropped
    from the escape lane, B8 and B9 launched once per iteration, 4x2 against
    1x1 and against the untiled scan under the gates of
    ``tests/test_spatial.py`` (against the untiled scan the iteration gate
    is printed, met or not, and does not decide the phase), a second run
    bitwise the first, the XLA branch on 2x2 tiles (no launch) against the
    2x2 kernel run under ``tests/test_spatial.py:350-354``'s flow gates
    (its iteration gate printed, as against the untiled scan) with the
    PyTorch operations an iteration of both, the card against the CPU
    twins on the first 150,000 events (4x2, and 2x2 on the XLA branch),
    and one slice whose warp drifts beyond an 8-pixel halo so that
    the lane carries events;
11. B10 and B11 (``fused_model_partials``, ``fused_model_partials_windowed``:
    the seven sums of already-warped events) against their twins at the
    main path's shapes (a 30-chunk slice's B1 positions, in the staged band
    order and sorted by ``sort_key_blocks``), B11 bitwise B10, each call
    one device operation (``[kernels] breakdown``); B10's launches are
    those two calls, its only path;
12. the merged megastep (B12, ``OptimizerConfig.megastep_merged``): the
    kernel against its twin and the B1 -> B2 -> B1 chain, its exit call
    against B4 (the pair left zero), its first and later call each one
    kernel (``[kernels] breakdown``), then the ``fast()`` scan with
    ``megastep_merged`` on the 2M
    events, bitwise the B1-B4 scan, with its launches (no B4), its run time
    in turns with the B1-B4 scan and the calls of each that block the host;
13. the XLA-composed branch (``scatter_mode="xla"``): the ``fast()`` scan
    on the 2M events twice (bitwise equal), its host time, PyTorch
    operations and blocking calls an iteration; the same scan over 4
    shards resident on the card (an event group), bitwise the first, no
    launch, with its host time and operations an iteration; the card
    against the CPU run on the first 100,000 events; then ``run_optimizer`` with "pallas"
    as a warm-start chain over the first 20 slices, sorted (B11), with its
    host time an iteration;
14. the dense local flow field (``models.local_flow``, BASELINE
    configuration 3, plain PyTorch, ``[local]``): the config-3 test scene
    (two objects on 346x260, 30,000 events, step 32, k 3072, dense)
    bitwise the CPU run and under the test's AEE gates; at full width
    (2 x 100,000 events, ``flow_field_grid``'s defaults: 300 windows) the
    time a call (median of 5 after a warm-up), the rounds a scale, the
    blocking reads a call and the card's busy share, and the first 64
    windows' chained scales bitwise the CPU's;
15. the score search (``models.score_search``, ``[search]``): the first
    50,000 bench events through ``compute_flow_bruteforce``'s reference
    sweep (14,400 candidates, scale 5, wsize 25), its time beside the
    bound of the bytes counted a candidate, and the first 256 candidates
    bitwise the CPU's;
16. clustering, the four debug views and the sampled model terms
    (``[views]``) on the first production slice's warp and final time
    image (``process_slice``, 180x240, scale 3), equal on the card and
    the CPU;
17. the options (``[options]``, ``phase_options``, run after the XLA
    branch): B1 and B2 with ``predicated=1`` (the converged pass-through
    of ``megastep_unroll``) bitwise their unpredicated selves on a live
    state and a pass-through on a converged one, with the no-op's time;
    the ``fast()`` scan with ``megastep_unroll`` 2 and 4 bitwise unroll 1,
    its host syncs equal to the reads taken and fewer than unroll 1's;
    ``fast(warm_extrapolate=1.0)`` against the CPU twins and two ranges
    stitched through ``make_carry(..., seed=)`` bitwise the full scan; the
    flat-slice ``process_event_slice`` bitwise the staged call;
18. the entry hooks (``[dryrun]``, ``better_flow_tpu_torch.graft_entry``):
    ``entry``'s slice and ``dryrun(4)``'s four stages on the card (the
    temporal batch under "auto" and "xla", the 4-shard scan on B1/B2, the
    tiled 180x240 recording under "xla" and "pallas" with no event
    dropped, two chained ranges bitwise the whole scan).

It prints a JSON line of per-kernel results, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  It exits non-zero, with
no result line, when there is no CUDA device or a phase fails.
"""

import functools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PALLAS = "better_flow_tpu/ops/pallas/fused_model.py"
KERNELS = [   # name, source, the TPU kernel's pallas_call it replaces
    ("act_rows", "better_flow_tpu_torch/csrc/act_rows.cu", f"{PALLAS}:624"),
    ("warp_images_st", "better_flow_tpu_torch/csrc/warp_images_st.cu",
     f"{PALLAS}:1692"),
    ("megastep_finish", "better_flow_tpu_torch/csrc/megastep_finish.cu",
     f"{PALLAS}:1778"),
    ("warp_uv", "better_flow_tpu_torch/csrc/warp_uv.cu", f"{PALLAS}:1559"),
    ("megastep", "better_flow_tpu_torch/csrc/megastep.cu", f"{PALLAS}:1458"),
    ("fused_warp_splat", "better_flow_tpu_torch/csrc/fused_warp_splat.cu",
     f"{PALLAS}:664"),
    ("fused_warp_splat_images",
     "better_flow_tpu_torch/csrc/warp_splat_images.cu", f"{PALLAS}:496"),
    ("finish_partials", "better_flow_tpu_torch/csrc/finish_partials.cu",
     f"{PALLAS}:544"),
    ("splat_local", "better_flow_tpu_torch/csrc/splat_local.cu",
     f"{PALLAS}:924"),
    ("finish_local", "better_flow_tpu_torch/csrc/finish_local.cu",
     f"{PALLAS}:981"),
    ("fused_model_partials",
     "better_flow_tpu_torch/csrc/fused_model_partials.cu", f"{PALLAS}:263"),
    ("fused_model_partials_windowed",
     "better_flow_tpu_torch/csrc/fused_model_partials.cu", f"{PALLAS}:1056"),
    ("megastep2", "better_flow_tpu_torch/csrc/megastep2.cu",
     f"{PALLAS}:1933"),
]
N_EVENTS = 2_000_000
N_COMPARE = 200_000
N_TILED = 600_000
N_TILED_COMPARE = 150_000
N_XLA_COMPARE = 100_000
N_PARTIALS_SLICES = 20
N_COLD = 12_000_000
N_FRAMES = 60_000
XLA_SHARDS = 4      # the XLA branch's event group, resident on the card
DRYRUN_SHARDS = 4
TILED_HALO, TILED_ESC_CAP = 32, 32768
# The slices of the megapixel stream whose iteration count depends on the
# order in which the image is summed: from the seventh slice on the
# optimizer exits within an ulp of its tolerance, and the JAX package's own
# runs (untiled, 2x2 and 4x2 tiles, "xla" and "pallas") count differently
# in these (tests/test_torch_tiled_fullwidth.py holds the list).
TILED_FRAGILE_SLICES = (6, 8, 9, 10)

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, and the f32 rate outside the tensor cores (no kernel here has a
# matrix product).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations counted per unit of work, from the per-event and per-pixel
# functions of csrc/common.cuh and csrc/finish.cuh (an fma counts two):
OPS_WARP = 40      # a slot's re-warp (28), scaled truncation and window test
OPS_SPLAT = 16     # an accepted event's time weight (t0 + bf16 hi + lo as
#                    fixed point) and its two integer adds
OPS_UV = 4         # B4's u, v and noise per slot, on top of the warp
OPS_ACCEPT = 12    # a slot's scaled truncation and window test (B10, B11)


def ops_finish(pixels, scale):
    """The finish on ``pixels`` logical pixels: a separable box filter of
    two images (8 * (scale // 2) adds), fixed point to f32, normalise (5),
    the centre and all-nine masks (17), the Scharr pair (24) and the nine
    sums' terms (14)."""
    return pixels * (8 * (scale // 2) + 60)


def log(*a):
    print(*a, flush=True)


def bench_stream(n_events):
    """The stream of bench.py: 0.5 s segments of a 1 Mev/s scene, tiled."""
    import numpy as np

    from better_flow_tpu_torch.io.synthetic import synthetic_events

    seg = min(n_events, 500_000)
    base = synthetic_events(seg, duration_s=seg / 1e6, res_x=180, res_y=240,
                            vx=60.0, vy=-40.0, rot=0.12, div=0.05,
                            n_points=800, seed=42)
    k = max(1, round(n_events / seg))
    step = int(seg / 1e6 * 1e9)
    cat = lambda key: np.concatenate([base[key]] * k)
    return {"x": cat("x"), "y": cat("y"), "u": cat("u"), "v": cat("v"),
            "t_ns": np.concatenate([base["t_ns"] + j * step
                                    for j in range(k)])}


def timed(fn, runs=25, warmup=3, setup=None):
    """Median milliseconds of one ``fn()`` on the card, between two CUDA
    events queued behind a ~1 ms spin kernel: the host enqueues the call
    while the card spins, so the time is the card's and not the launch
    overhead's (unless the call itself waits for the card).  ``setup()``,
    run before each call and queued before the spin, is not timed (it puts
    back the inputs that a call consumes)."""
    import torch

    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if setup is not None:
            setup()
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _op_name(name):
    """A device operation's short name: a kernel's function name without
    its namespace, template arguments and parameters; a memset or a copy as
    the profiler names it."""
    if name.startswith(("Memset", "Memcpy")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip() or name


def _launch_records(events):
    """The correlation ids of a trace's host-side CUDA calls that put an
    operation on the card (a kernel launch, a memset, a copy)."""
    from torch.autograd import DeviceType

    return [e.correlation_id() for e in events
            if e.device_type() == DeviceType.CPU and e.correlation_id()
            and any(k in e.name() for k in ("Launch", "Memset", "Memcpy"))]


def breakdown(fn, runs=20, traces=8):
    """The device operations of one ``fn()`` in launch order, each with its
    median time in microseconds over ``runs`` calls, from torch.profiler's
    device trace.  A trace counts only when its device operations are
    exactly its host-side launch records, matched by correlation id, and
    there is at least one.  The profiler drops device records (119
    operations in 20 calls of six once, every one of a trace's once, cause
    unknown), so a trace that does not count is taken again, up to
    ``traces`` times, and then it raises: an empty trace is retaken rather
    than failed at once, since a whole trace has come back empty while the
    same calls' other traces held their kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        launched = _launch_records(events)
        dev = [e for e in events if e.device_type() == DeviceType.CUDA]
        if (launched and len(dev) % runs == 0
                and sorted(e.correlation_id() for e in dev)
                == sorted(launched)):
            break
        log(f"[kernels] breakdown: {len(dev)} device operations for "
            f"{len(launched)} launches in {runs} calls; tracing again")
    else:
        raise AssertionError(f"breakdown: {len(dev)} device operations for "
                             f"{len(launched)} launches in {runs} calls, "
                             f"{traces} traces")
    ops = sorted((e.start_ns(), _op_name(e.name()),
                  (e.end_ns() - e.start_ns()) * 1e-3) for e in dev)
    per = len(ops) // runs
    return [(ops[k][1], statistics.median(ops[r * per + k][2]
                                          for r in range(runs)))
            for k in range(per)]


def wall_times(fn, runs):
    """Host seconds of each of ``runs`` calls of ``fn()``, each from a
    synchronized card to a synchronized card."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def device_time(fn):
    """One ``fn()`` under torch.profiler: (the sum of its device
    operations' times in ms, their count).  Divided by the call's untraced
    time it gives the card's busy share (its operations run on one stream,
    one at a time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    return sum(e.end_ns() - e.start_ns() for e in dev) * 1e-6, len(dev)


def log_breakdown(label, fn):
    """Print ``breakdown(fn)`` as one ``[kernels] breakdown`` line; return
    it."""
    ops = breakdown(fn)
    log(f"[kernels] breakdown {label}: " + ", ".join(
        f"{name} {us:.2f} us" for name, us in ops)
        + f"; sum {sum(us for _, us in ops):.2f} us")
    return ops


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def pair_bytes(role, acc_c=None, H=None, W=None):
    """An image pair's bytes in a bound (int64 time and int32 count
    images, 12 B a pixel), by one rule for every kernel: a finish that
    reads the pair (``role`` "finish") counts each logical H x W pixel of
    every image of ``acc_c`` ((HP, WP) or (tiles, HP, WP)), not the
    padding; a splat that adds into it by atomics ("splat") counts each
    pixel it hits once, from the count image ``acc_c`` after the splat; an
    image that never leaves the launch ("internal": B5, B6, B10, B11)
    counts nothing.  The zeroing that leaves a pair clear for the next
    call is counted nowhere."""
    if role == "finish":
        tiles = acc_c.numel() // (acc_c.shape[-2] * acc_c.shape[-1])
        return 12 * tiles * H * W
    if role == "splat":
        return 12 * int((acc_c > 0).sum())
    if role == "internal":
        return 0
    raise ValueError(f"pair_bytes: unknown role {role!r}")


def bound(n_bytes, n_ops):
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations at
    the f32 peak, whichever is larger.  No single PyTorch call computes any
    of these kernels' functions, so ``library_ms`` is null."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                library_ms=None)


def scan_digest(r):
    """SHA-256 of a scan's u, v, noise and iterations: two trees' runs of
    the same stream agree bit for bit when their digests do."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for k in ("u", "v", "noise", "iters"):
        h.update(np.ascontiguousarray(r[k]).tobytes())
    return h.hexdigest()


def max_err(a, b):
    return float((a.double() - b.double()).abs().max().item())


def assert_close(name, got, want, rtol, atol=0.0):
    import torch

    if not torch.allclose(got.double(), want.double(), rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: max abs error {max_err(got, want)} "
                             f"beyond rtol {rtol}, atol {atol}")


def kernel_slice(cfg, d, dev):
    """The kernels' inputs at the main path's shapes: slice 2 (full,
    interior) of the stream's first 120,000 events staged under ``cfg``,
    a gate history of three with gated ranges in it, a mid-optimization
    state and warped positions near the pixels, made from seed 7."""
    import numpy as np
    import torch

    from better_flow_tpu_torch.ops.layout import ST_CONT, ST_ITERS
    from better_flow_tpu_torch.runtime.scan_pipeline import prepare_recording

    prep = prepare_recording(d["x"][:120_000], d["y"][:120_000],
                             d["t_ns"][:120_000], cfg, device=dev)
    s = 2                                    # a full, interior slice
    stat, sidx, geo = prep["stat"][s], prep["sidx"][s], prep["geo"][s]
    rng = np.random.default_rng(7)
    starts, ends = prep["plan"].starts, prep["plan"].ends
    hist = torch.from_numpy(np.array(
        [[1, 0, 1], [starts[0], starts[1], starts[1] + 5000],
         [ends[0] - 10000, ends[1], starts[1] + 9000]], np.int32)).to(dev)
    st = np.zeros((1, 32), np.float32)
    st[0, 0:4] = rng.uniform(-0.03, 0.03, 4) * [1, 1, 0.1, 0.1]
    st[0, 8:10] = [90.0 + rng.normal(), 120.0 + rng.normal()]
    st[0, 10:14] = [1.0, 2.0, 1e4, 2e4]
    st[0, 14:18] = [-2e3, -1e3, -40.0, -35.0]
    st[0, 18:22] = rng.uniform(-1e-3, 1e-3, 4) * [0.01, 0.01, 1, 1]
    st[0, 24:28] = rng.uniform(-0.3, 0.3, 4)
    st[0, ST_ITERS] = 2.0
    st[0, ST_CONT] = 1.0
    st = torch.from_numpy(st).to(dev)
    pr = (stat[:, 0:2] + torch.from_numpy(rng.normal(
        0, 0.2, (stat.shape[0], 2, stat.shape[2])).astype(np.float32)
    ).to(dev)).contiguous()
    return dict(stat=stat, sidx=sidx, geo=geo, hist=hist, st=st, pr=pr)


def phase_kernels(cfg, d, dev):
    """Each kernel against its twin on the card at the main path's shapes
    (B3 on one slice; over a staged range in ``act_rows_range``)."""
    import torch

    from better_flow_tpu_torch.models.global_flow import (
        finish_statics, static_image_shape,
    )
    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.ops.layout import ST_CONT, ST_ITERS

    opt = cfg.optimizer
    H, W = static_image_shape(opt.scale, cfg.sensor)
    ks = kernel_slice(cfg, d, dev)
    stat, sidx, geo, hist, st, pr = (ks[k] for k in (
        "stat", "sidx", "geo", "hist", "st", "pr"))
    K = hist.shape[1]
    statics = finish_statics(opt)
    time_lo = opt.splat_time_lo
    out = {}

    # B3 on one slice; over the main path's whole staged range in
    # act_rows_range.
    act = fm.act_rows_call(sidx, hist)
    act_p = fm.act_rows_plain(sidx, hist)
    if not torch.equal(act, act_p):
        raise AssertionError("act_rows differs from its twin")
    b3 = lambda: fm.act_rows_call(sidx, hist)
    ops = log_breakdown("act_rows one slice", b3)
    out["act_rows"] = dict(
        max_abs_err=max_err(act, act_p), ms=timed(b3), device_us=ops[0][1],
        plain_ms=timed(lambda: fm.act_rows_plain(sidx, hist)),
        **bound(nbytes(sidx, hist, act), sidx.numel() * (4 * K + 2)))
    slots = stat.shape[0] * stat.shape[2]
    pixels = H * W

    kw = dict(scale=opt.scale, H=H, W=W, time_lo=time_lo)
    # B1 adds into its caller's pair, B2 reads it and leaves it zero: each
    # call gets its own pair, and the timed calls one that setup() puts
    # back (zeroed for B1, B1's splat for B2).
    pair = fm.image_pair(dev, H, W)
    npr, at, ac = fm.warp_images_st_call(stat, act, pr, st, geo, *pair, **kw)
    npr_p, at_p, ac_p = fm.warp_images_st_plain(
        stat, act, pr, st, geo, *fm.image_pair(dev, H, W), **kw)
    assert_close("warp_images_st npr", npr, npr_p, rtol=1e-6)
    if not torch.equal(ac, ac_p):
        raise AssertionError("warp_images_st count image differs")
    assert_close("warp_images_st time image", fm.time_image_f32(at),
                 fm.time_image_f32(at_p), rtol=1e-5, atol=1e-6)
    if int(ac.sum()) < 10_000:
        raise AssertionError(f"only {int(ac.sum())} events splatted")
    at0, ac0 = at.clone(), ac.clone()
    err1 = max(max_err(npr, npr_p), max_err(at, at_p), max_err(ac, ac_p))
    if err1 != 0.0:
        raise AssertionError(f"warp_images_st: max abs error {err1} against "
                             "its twin on the card")
    zeroed = lambda: (pair[0].zero_(), pair[1].zero_())
    filled = lambda: (pair[0].copy_(at0), pair[1].copy_(ac0))
    b1 = lambda: fm.warp_images_st_call(stat, act, pr, st, geo, *pair, **kw)
    ops = log_breakdown("warp_images_st", b1)
    if len(ops) != 1 or ops[0][0].startswith("Memset"):
        raise AssertionError(f"warp_images_st: device operations {ops}, "
                             "expected one kernel")
    # The fixed cost of any launch between two CUDA events: one PyTorch
    # kernel on one element, beside B1's.
    one = torch.zeros(1, device=dev)
    floor_ops = log_breakdown("one-element add_", lambda: one.add_(1.0))
    out["warp_images_st"] = dict(
        max_abs_err=err1, ms=timed(b1, setup=zeroed), device_us=ops[0][1],
        plain_ms=timed(lambda: fm.warp_images_st_plain(stat, act, pr, st,
                                                       geo, *pair, **kw),
                       setup=zeroed),
        **bound(nbytes(stat, act, pr, st, geo, npr)
                + pair_bytes("splat", ac0),
                slots * OPS_WARP + int(ac0.sum()) * OPS_SPLAT),
        redesigned=11)
    floor_us = 1e3 * timed(lambda: one.add_(1.0))
    log(f"[kernels] launch floor: a one-element add_ {floor_us:.2f} us "
        f"between CUDA events, device {floor_ops[0][1]:.2f} us; B1 "
        f"{out['warp_images_st']['ms'] * 1e3:.2f} us, device "
        f"{ops[0][1]:.2f} us")

    kw2 = dict(scale=opt.scale, H=H, W=W, **statics)
    filled()
    st2 = fm.megastep_finish_call(*pair, st, geo, **kw2)
    if pair[0].any() or pair[1].any():
        raise AssertionError("megastep_finish: the pair is not zero")
    st2_p = fm.megastep_finish_plain(at_p, ac_p, st, geo, **kw2)
    exact = [ST_ITERS, ST_CONT]
    if not torch.equal(st2[0, exact], st2_p[0, exact]):
        raise AssertionError("megastep_finish ITERS/CONT differ")
    comp = list(range(4, 8))
    other = [k for k in range(32) if k not in exact + comp]
    assert_close("megastep_finish state", st2[0, other], st2_p[0, other],
                 rtol=1e-5)
    # Kahan compensations hold the totals' rounding residue: within two
    # ulps of the total.
    tot_ulp = st2_p[0, 0:4].abs() * 2.0 ** -22
    if not bool(((st2[0, comp] - st2_p[0, comp]).abs() <= tot_ulp).all()):
        raise AssertionError("megastep_finish compensations differ")
    # B2 against its twin on the card's copy of the same pair: bitwise.
    filled()
    st2_c = fm.megastep_finish_plain(*pair, st, geo, **kw2)
    if not torch.equal(st2, st2_c):
        raise AssertionError("megastep_finish differs from its twin on the "
                             "card")
    out["megastep_finish"] = dict(
        max_abs_err=max_err(st2[0, other], st2_p[0, other]),
        ms=timed(lambda: fm.megastep_finish_call(*pair, st, geo, **kw2),
                 setup=filled),
        plain_ms=timed(lambda: fm.megastep_finish_plain(*pair, st, geo,
                                                        **kw2),
                       setup=filled),
        **bound(nbytes(st, geo, st2) + pair_bytes("finish", ac0, H, W),
                ops_finish(pixels, opt.scale) + 300),
        **dict(zip(("R", "grid"), fm.iteration_grid(
            "megastep_finish", dev, H, W, opt.scale))),
        redesigned=9)

    # The options the main path does not take: the hi+lo time pair, the
    # reference schedule and the predicted exit (correctness only).
    kw_lo = dict(kw, time_lo=True)
    npr_l, at_l, ac_l = fm.warp_images_st_call(
        stat, act, pr, st, geo, *fm.image_pair(dev, H, W), **kw_lo)
    npr_lp, at_lp, _ = fm.warp_images_st_plain(
        stat, act, pr, st, geo, *fm.image_pair(dev, H, W), **kw_lo)
    assert_close("warp_images_st time_lo npr", npr_l, npr_lp, rtol=1e-6)
    if not torch.equal(at_l, at_lp):
        raise AssertionError("warp_images_st time_lo image differs")
    for variant in (dict(schedule="reference", exit_grad=0.0),
                    dict(exit_pred=4.0)):
        kv = dict(kw2, **variant)
        a = fm.megastep_finish_call(at_l.clone(), ac_l.clone(), st, geo, **kv)
        b = fm.megastep_finish_plain(at_l.clone(), ac_l.clone(), st, geo,
                                     **kv)
        if not torch.equal(a, b):
            raise AssertionError(f"megastep_finish {variant}: differs from "
                                 "its twin on the card")
    log("[kernels] time_lo, reference schedule and predicted exit agree")

    # B4 bitwise its twin on the card's tensors, into its own rows and
    # into the caller's.
    o, u = fm.warp_uv_call(stat, npr, act, st, 0.0)
    o_p, u_p = fm.warp_uv_plain(stat, npr, act, st, 0.0)
    err4 = max(max_err(o, o_p), max_err(u, u_p))
    rows = torch.empty_like(u)
    o_r, u_r = fm.warp_uv_call(stat, npr, act, st, 0.0, rows)
    if not (torch.equal(o, o_p) and torch.equal(u, u_p)) or u_r is not rows \
            or not (torch.equal(o_r, o) and torch.equal(rows, u)):
        raise AssertionError(f"warp_uv: max abs error {err4} against its "
                             "twin on the card, or not in the given rows")
    b4 = lambda: fm.warp_uv_call(stat, npr, act, st, 0.0)
    ops = log_breakdown("warp_uv", b4)
    if len(ops) != 1:
        raise AssertionError(f"warp_uv: device operations {ops}, expected "
                             "one kernel")
    out["warp_uv"] = dict(
        max_abs_err=err4, ms=timed(b4), device_us=ops[0][1],
        plain_ms=timed(lambda: fm.warp_uv_plain(stat, npr, act, st, 0.0)),
        **bound(nbytes(stat, npr, act, st, o, u),
                slots * (OPS_WARP + OPS_UV)),
        redesigned=12)
    out.update(check_b6_b7(stat, act, pr, st, geo, opt.scale, H, W, dev))
    for name, r in out.items():
        log(f"[kernels] {name}: max_abs_err {r['max_abs_err']:.3g}  kernel "
            f"{r['ms']:.4f} ms"
            + (f" (device {r['device_us']:.2f} us)" if "device_us" in r
               else "")
            + f"  plain {r['plain_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")
    return out, dict(stat=stat, act=act, pr=pr, st=st, geo=geo)


def act_rows_range(cfg, prep, dev, one_slice):
    """B3 over ``prep``, the main path's staged range, in one launch (as
    run_slices calls it): bitwise its twin and the one-slice calls, with
    its time, device time and bound; ``one_slice``, phase_kernels' B3
    result, rides along."""
    import torch

    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.runtime.scan_pipeline import (
        initial_carry, staged_histories,
    )

    sidx = prep["sidx"]
    hist = torch.from_numpy(staged_histories(
        prep, initial_carry(prep, cfg))[0]).to(dev)
    act = fm.act_rows_call(sidx, hist)
    act_p = fm.act_rows_plain(sidx, hist)
    if not torch.equal(act, act_p):
        raise AssertionError("act_rows over the staged range differs from "
                             "its twin")
    if not all(torch.equal(act[k], fm.act_rows_call(sidx[k], hist[k]))
               for k in range(len(sidx))):
        raise AssertionError("act_rows over the staged range differs from "
                             "its one-slice calls")
    b3 = lambda: fm.act_rows_call(sidx, hist)
    ops = log_breakdown(f"act_rows {len(sidx)} slices", b3)
    if len(ops) != 1:
        raise AssertionError(f"act_rows: device operations {ops}, expected "
                             "one kernel")
    r = dict(max_abs_err=max_err(act, act_p), ms=timed(b3),
             device_us=ops[0][1],
             plain_ms=timed(lambda: fm.act_rows_plain(sidx, hist)),
             **bound(nbytes(sidx, hist, act),
                     sidx.numel() * (4 * hist.shape[-1] + 2)),
             slices=len(sidx), one_slice=one_slice, redesigned=12)
    log(f"[kernels] act_rows over {len(sidx)} slices: kernel "
        f"{r['ms']:.4f} ms (device {r['device_us']:.2f} us)  plain "
        f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms "
        f"({r['bound_by']})")
    return r


def check_b6_b7(stat, act, pr, st, geo, scale, H, W, dev):
    """B6, B7a and B7b against their twins on the warp row of an f32 carry
    (the state's model) and of an f64 carry (f64 totals whose angle's f32
    rounding changes the row's sine): new positions, images and the seven
    sums bitwise; B7b leaves the pair zero; the B7a -> B7b chain bitwise
    B6; four shards, a B7a launch each into one pair, bitwise one launch
    over them all.  Returns the three kernels' errors, median times and
    bounds on the f32 row."""
    import torch

    from better_flow_tpu_torch.models.global_flow import model_from_state
    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.ops.warp import cos_sin_f32

    m32 = model_from_state(st)
    f64 = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
    angle = 0.02603218874814671
    m64 = m32.replace(total_dx=f64(float(m32.total_dx) + 1e-10),
                      total_dy=f64(float(m32.total_dy) - 1e-10),
                      total_rot=f64(angle), total_div=f64(float(
                          m32.total_div)), comp_dx=f64(0.0), comp_dy=f64(0.0),
                      comp_rot=f64(0.0), comp_div=f64(0.0))
    _, s32 = cos_sin_f32(torch.tensor(-angle, dtype=torch.float32))
    nch = stat.shape[0]
    slots, pixels = nch * stat.shape[2], H * W
    kw = dict(scale=scale, H=H, W=W)
    one_per_slot = -(-slots // fm.BAND_THREADS)
    res = {}
    for name, model in (("f32", m32), ("f64", m64)):
        scal = fm.warp_scal_row(geo, model)
        if name == "f64" and float(scal[0, 10]) == float(s32):
            raise AssertionError("B6 f64 row: the sine of the f32-cast angle")
        npr, vals = fm.fused_warp_splat_call(stat, act, pr, scal, **kw)
        npr_p, vals_p = fm.fused_warp_splat_plain(stat, act, pr, scal, **kw)
        err = max(max_err(npr, npr_p), max_err(vals, vals_p))
        if err != 0.0:
            raise AssertionError(f"fused_warp_splat {name} row: max abs error "
                                 f"{err} against its twin")
        if float(vals[0]) < 10_000 or float(vals[7]) != 0.0:
            raise AssertionError(f"fused_warp_splat {name} row: sums "
                                 f"{vals.tolist()}")

        pair = fm.image_pair(dev, H, W)
        npr7, at, ac, fb = fm.fused_warp_splat_images_call(stat, act, pr,
                                                           scal, *pair, **kw)
        npr7_p, at_p, ac_p, _ = fm.fused_warp_splat_images_plain(
            stat, act, pr, scal, *fm.image_pair(dev, H, W), **kw)
        err_a = max(max_err(npr7, npr7_p), max_err(at, at_p),
                    max_err(ac, ac_p))
        at0, ac0 = at.clone(), ac.clone()
        vals7 = fm.finish_partials_call(at, ac, **kw)
        err_b = max_err(vals7, fm.finish_partials_plain(at_p, ac_p, **kw))
        if err_a != 0.0 or err_b != 0.0 or fb != 0:
            raise AssertionError(f"B7 {name} row: max abs errors {err_a} "
                                 f"(images), {err_b} (sums) against the twins")
        if at.any() or ac.any():
            raise AssertionError(f"B7b {name} row: the pair is not zero")
        if not (torch.equal(npr7, npr) and torch.equal(vals7, vals)):
            raise AssertionError(f"B7a -> B7b differs from B6 on the {name} "
                                 "row")
        # Four shards cut on chunk boundaries (30 chunks: 8 + 8 + 8 + 6), a
        # launch a shard into one pair: bitwise the one launch over them all.
        cuts = [slice(a, min(a + 8, nch)) for a in range(0, nch, 8)]
        p = fm.image_pair(dev, H, W)
        got = torch.cat([fm.fused_warp_splat_images_call(
            stat[c], act[c], pr[c].contiguous(), scal, *p, **kw)[0]
            for c in cuts])
        if not (torch.equal(got, npr7) and torch.equal(p[0], at0)
                and torch.equal(p[1], ac0)):
            raise AssertionError(f"B7a {name} row: a launch a shard differs "
                                 "from the one launch over all shards")
        n_acc = int(ac0.sum())
        filled = lambda: (pair[0].copy_(at0), pair[1].copy_(ac0))
        zeroed = lambda: (pair[0].zero_(), pair[1].zero_())

        def chain(scal=scal):
            _, t, c, _ = fm.fused_warp_splat_images_call(stat, act, pr, scal,
                                                         *pair, **kw)
            return fm.finish_partials_call(t, c, **kw)

        ops = log_breakdown(f"B7a -> B7b chain {name} row", chain)
        if len(ops) != 2 or any(o.startswith("Memset") for o, _ in ops):
            raise AssertionError(f"B7a -> B7b chain {name} row: device "
                                 f"operations {ops}, expected one kernel "
                                 "each and no memset")
        log_breakdown(f"fused_warp_splat {name} row",
                      lambda: fm.fused_warp_splat_call(stat, act, pr, scal,
                                                       **kw))
        b7a = lambda: fm.fused_warp_splat_images_call(stat, act, pr, scal,
                                                      *pair, **kw)
        b7a_plain = lambda: fm.fused_warp_splat_images_plain(
            stat, act, pr, scal, *pair, **kw)
        b7b = lambda: fm.finish_partials_call(*pair, **kw)
        b7b_plain = lambda: fm.finish_partials_plain(*pair, **kw)
        res[name] = {
            "fused_warp_splat": dict(
                max_abs_err=err,
                ms=timed(lambda: fm.fused_warp_splat_call(stat, act, pr, scal,
                                                          **kw)),
                chain_ms=timed(chain),
                plain_ms=timed(lambda: fm.fused_warp_splat_plain(
                    stat, act, pr, scal, **kw)),
                **bound(nbytes(scal, stat, act, pr, npr, vals)
                        + pair_bytes("internal"),
                        slots * OPS_WARP + n_acc * OPS_SPLAT
                        + ops_finish(pixels, scale)),
                **dict(zip(("R", "grid"), fm.iteration_grid(
                    "fused_warp_splat", dev, H, W, scale))),
                redesigned=7),
            "fused_warp_splat_images": dict(
                max_abs_err=err_a,
                ms=timed(b7a, setup=zeroed),
                plain_ms=timed(b7a_plain, setup=zeroed),
                **bound(nbytes(scal, stat, act, pr, npr7)
                        + pair_bytes("splat", ac0),
                        slots * OPS_WARP + n_acc * OPS_SPLAT),
                grid=one_per_slot, redesigned=8),
            "finish_partials": dict(
                max_abs_err=err_b,
                ms=timed(b7b, setup=filled),
                plain_ms=timed(b7b_plain, setup=filled),
                **bound(nbytes(vals7) + pair_bytes("finish", ac0, H, W),
                        ops_finish(pixels, scale)),
                **dict(zip(("R", "grid"), fm.iteration_grid(
                    "finish_partials", dev, H, W, scale))),
                redesigned=8),
        }
        for k, r in res[name].items():
            log(f"[kernels] {k} {name} row: max_abs_err "
                f"{r['max_abs_err']:.3g}  kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms"
                + (f"  chain {r['chain_ms']:.4f} ms" if "chain_ms" in r
                   else "")
                + (f"  R {r['R']}" if "R" in r else "")
                + f"  grid {r['grid']}")
        log(f"[kernels] {name} row: B7a -> B7b bitwise B6, the pair zero "
            "after B7b; a launch a shard bitwise one launch over all shards")
    return res["f32"]


def phase_composed(d, dev):
    """The composed path on the bench stream: the f64-totals scan twice
    (bitwise equal) with its launch counts, against the CPU twins on the
    first N_COMPARE events; the stream with f64 totals and with
    ``fast(use_megastep=False)`` against the CPU twins on those events.
    Returns the scan's launch counts."""
    import numpy as np
    import torch

    from better_flow_tpu_torch.config import OptimizerConfig, PipelineConfig
    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.runtime.offline import compensate_recording
    from better_flow_tpu_torch.runtime.scan_pipeline import (
        compensate_recording_scan, prepare_recording,
    )

    t_phase = time.perf_counter()
    n = len(d["x"])
    cfg = PipelineConfig(f64_totals=True)
    prep = prepare_recording(d["x"], d["y"], d["t_ns"], cfg, device=dev)
    compensate_recording_scan(None, None, None, cfg, prepared=prep)  # warm-up
    fm.reset_launches()
    r1 = compensate_recording_scan(None, None, None, cfg, prepared=prep)
    launches = dict(fm.LAUNCHES)
    check_outputs(r1, n)
    if r1["model"].total_dx.dtype != torch.float64:
        raise AssertionError("composed scan: the carry left f64")
    for k in ("fused_warp_splat", "act_rows"):
        if launches[k] <= 0:
            raise AssertionError(f"composed scan: {k} was not launched")
    if launches["act_rows"] != 1:
        raise AssertionError(f"composed scan: act_rows launched "
                             f"{launches['act_rows']} times, expected 1")
    for k in ("megastep", "warp_images_st", "megastep_finish"):
        if launches[k] != 0:
            raise AssertionError(f"composed scan: {k} launched {launches[k]} "
                                 "times")
    if launches["fused_warp_splat"] != int(r1["iters"].sum()):
        raise AssertionError("composed scan: B6 launches != iterations")
    st = r1["stats"]
    log(f"[composed] f64 scan: events/s {st['events_per_s']:.1f}  run_s "
        f"{st['run_s']:.4f}  n_slices {st['n_slices']}  mean_iters "
        f"{st['mean_iters']:.4f}  host_syncs {st['host_syncs']}  "
        f"host_ms_per_iter {1e3 * st['run_s'] / max(1, st['host_syncs']):.4f}")
    log(f"[composed] launches {json.dumps(launches)}")
    r2 = compensate_recording_scan(None, None, None, cfg, prepared=prep)
    for k in ("u", "v", "noise", "iters"):
        if not np.array_equal(r1[k], r2[k]):
            raise AssertionError(f"composed scan: repeated run differs in {k}")
    log(f"[composed] second run bitwise identical; events/s "
        f"{r2['stats']['events_per_s']:.1f}")

    m = N_COMPARE
    part = {k: d[k][:m] for k in ("x", "y", "t_ns")}
    rg = compensate_recording_scan(part["x"], part["y"], part["t_ns"], cfg,
                                   device=dev)
    rc = compensate_recording_scan(part["x"], part["y"], part["t_ns"], cfg,
                                   device="cpu")
    same_twins("composed f64 scan", rg, rc)
    log(f"[composed] f64 scan: card = CPU twins on {m} events "
        f"({int(rg['iters'].sum())} iterations, median du = dv = 0)")

    for name, c in (("f64 stream", cfg),
                    ("fast(use_megastep=False) stream", PipelineConfig(
                        optimizer=OptimizerConfig.fast(use_megastep=False)))):
        fm.reset_launches()
        vg = stream_view(compensate_recording(part["x"], part["y"],
                                              part["t_ns"], c, device=dev))
        lc = dict(fm.LAUNCHES)
        if lc["fused_warp_splat"] != int(vg["iters"].sum()) or \
                lc["megastep"] or lc["warp_images_st"]:
            raise AssertionError(f"composed {name}: launches {lc}")
        vc = stream_view(compensate_recording(part["x"], part["y"],
                                              part["t_ns"], c, device="cpu"))
        same_twins(f"composed {name}", vg, vc)
        log(f"[composed] {name}: card = CPU twins on {m} events ("
            f"{int(vg['iters'].sum())} iterations, median du = dv = 0)")
    log(f"[composed] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_sharded(d, dev):
    """The event-parallel path on the bench stream, all shards resident on
    the one card: the sharded scan with 1 and 4 shards under ``fast()`` and
    with f64 totals, each bitwise the unsharded scan on the same staging,
    with its launch counts; then the multihost entry point in one process
    over three chained slice ranges, bitwise the full scan.  Returns the
    four-shard f64 run's launch counts."""
    import numpy as np

    from better_flow_tpu_torch.config import OptimizerConfig, PipelineConfig
    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.parallel.event_parallel import (
        compensate_recording_scan_sharded, prepare_recording_sharded,
    )
    from better_flow_tpu_torch.parallel.mesh import make_event_mesh
    from better_flow_tpu_torch.parallel.multihost import (
        compensate_recording_multihost,
    )
    from better_flow_tpu_torch.runtime import scan_pipeline
    from better_flow_tpu_torch.runtime.scan_pipeline import (
        compensate_recording_scan,
    )

    t_phase = time.perf_counter()
    n = len(d["x"])
    cfgs = (("fast", PipelineConfig(optimizer=OptimizerConfig.fast())),
            ("f64", PipelineConfig(f64_totals=True)))
    keep = None
    for shards in (1, 4):
        mesh = make_event_mesh(shards, device=dev)
        # One staging serves both configs (it depends on neither the
        # schedule nor the totals' dtype) and both the unsharded and the
        # sharded run: the padding is the sharded run's.
        prep = prepare_recording_sharded(d["x"], d["y"], d["t_ns"],
                                         cfgs[0][1], mesh)
        for name, cfg in cfgs:
            ru = compensate_recording_scan(None, None, None, cfg,
                                           prepared=prep)
            fm.reset_launches()
            rs = compensate_recording_scan_sharded(None, None, None, cfg,
                                                   mesh, prepared=prep)
            lc = dict(fm.LAUNCHES)
            check_outputs(rs, n)
            for k in ("u", "v", "noise", "iters", "ran"):
                if not np.array_equal(ru[k], rs[k]):
                    raise AssertionError(f"sharded {name} x{shards}: {k} "
                                         "differs from the unsharded scan")
            total = int(rs["iters"].sum())
            # B3 once for the staged range, the splat (B1 or B7a) once an
            # iteration and B4 once a slice that ran, each for all the
            # resident shards.
            want = dict.fromkeys(lc, 0)
            want["act_rows"] = 1
            if name == "fast":
                want.update(warp_images_st=total, megastep_finish=total,
                            warp_uv=int(rs["ran"].sum()))
            else:
                want.update(fused_warp_splat_images=total,
                            finish_partials=total)
            if lc != want:
                raise AssertionError(f"sharded {name} x{shards}: launches "
                                     f"{lc}, expected {want}")
            st, su = rs["stats"], ru["stats"]
            log(f"[sharded] {name} x{shards}: bitwise the unsharded scan; "
                f"events/s {st['events_per_s']:.1f} (unsharded "
                f"{su['events_per_s']:.1f})  run_s {st['run_s']:.4f}  "
                f"mean_iters {st['mean_iters']:.4f}  host_syncs "
                f"{st['host_syncs']}  host_ms_per_iter "
                f"{1e3 * st['run_s'] / max(1, st['host_syncs']):.4f} "
                f"(unsharded {1e3 * su['run_s'] / max(1, su['host_syncs']):.4f})"
                f"  n_devices {st['n_devices']}")
            log(f"[sharded] {name} x{shards}: launches {json.dumps(lc)}")
            if shards == 4:
                # Host ms an iteration of the unsharded and the 4-shard
                # scan, in turns.
                runs = {"x1": lambda: compensate_recording_scan(
                            None, None, None, cfg, prepared=prep),
                        "x4": lambda: compensate_recording_scan_sharded(
                            None, None, None, cfg, mesh, prepared=prep)}
                turns = []
                for tag in ("x1", "x4", "x4", "x1", "x1", "x4"):
                    t_ = runs[tag]()["stats"]
                    ms = 1e3 * t_["run_s"] / max(1, t_["host_syncs"])
                    turns.append(f"{tag} {ms:.4f}")
                log(f"[sharded] {name}: host ms an iteration in turns: "
                    + ", ".join(turns))
            if name == "f64" and shards == 4:
                keep = lc
                full = ru
                # The host's share: PyTorch operations (and views) a slice
                # of each run, the wrappers' own included.
                per_slice = {tag: count_operations(scan_pipeline,
                                                   "process_slice", f)
                             for tag, f in (("unsharded", lambda: (
                                 compensate_recording_scan(
                                     None, None, None, cfg, prepared=prep))),
                                 ("x4", lambda: (
                                     compensate_recording_scan_sharded(
                                         None, None, None, cfg, mesh,
                                         prepared=prep))))}
                log(f"[sharded] f64 x4: PyTorch operations, views a slice "
                    f"{per_slice['x4']} (unsharded {per_slice['unsharded']})"
                    f", {total / len(rs['iters']):.4f} iterations a slice")
    cfg = cfgs[1][1]
    fm.reset_launches()
    rm = compensate_recording_multihost(d["x"], d["y"], d["t_ns"], cfg,
                                        n_ranges=3, ev_per_host=2,
                                        device=dev)
    for k in ("u", "v", "noise", "iters"):
        if not np.array_equal(rm[k], full[k]):
            raise AssertionError(f"multihost, three ranges: {k} differs from "
                                 "the full scan")
    if fm.LAUNCHES["act_rows"] != 3:
        raise AssertionError(f"multihost, three ranges: act_rows launched "
                             f"{fm.LAUNCHES['act_rows']} times, expected 3")
    st = rm["stats"]
    log(f"[sharded] multihost, one process, 3 chained ranges x 2 shards "
        f"(f64): bitwise the full scan; events/s {st['events_per_s']:.1f}  "
        f"run_s {st['run_s']:.4f}  plan_s {st['plan_s']:.4f}  B7a launches "
        f"{fm.LAUNCHES['fused_warp_splat_images']}  B7b launches "
        f"{fm.LAUNCHES['finish_partials']}")
    log(f"[sharded] phase {time.perf_counter() - t_phase:.1f} s")
    return keep


def tiled_cfg(fast=False, mode="auto"):
    """The tiled protocol's configuration (tools/bench_tiled.py), its
    ``scatter_mode`` ``mode``."""
    from better_flow_tpu_torch.config import (
        OptimizerConfig, PipelineConfig, SensorConfig, SliceConfig,
    )

    opt = OptimizerConfig.fast(scale=1, min_events=1000,
                               scatter_mode=mode) if fast else \
        OptimizerConfig(scale=1, max_iter=10, min_events=1000,
                        scatter_mode=mode)
    return PipelineConfig(
        sensor=SensorConfig(720, 1280),
        slice=SliceConfig(max_events=60_000, span_ns=int(0.07e9),
                          refresh_events=25_000, refresh_time_ns=int(0.03e9)),
        optimizer=opt)


def tiled_stream(n=N_TILED):
    """``n`` events at 1.5M events/s on the megapixel sensor; the jitter
    fattens the clusters so that 3x3 neighbourhoods fill at scale 1."""
    from better_flow_tpu_torch.io.synthetic import synthetic_events

    return synthetic_events(n, duration_s=n / 1.5e6, res_x=720, res_y=1280,
                            vx=120.0, vy=-80.0, rot=0.1, div=0.03,
                            n_points=600, jitter_px=1.5, seed=4)


def phase_tiled_kernels(d, dev):
    """B8 and B9 against their twins at the tiled path's shapes: the first
    iteration's inputs of a full slice on 1x1 and on 4x2 tiles.  Returns the
    4x2 batch's results for the ``kernels`` line."""
    import torch

    from better_flow_tpu_torch.models.global_flow import geometry_from_bbox
    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.parallel import spatial as sp
    from better_flow_tpu_torch.parallel.mesh import make_tiled_mesh

    cfg = tiled_cfg()
    opt = cfg.optimizer
    m = min(len(d["x"]), 200_000)
    for shape in ((1, 1), (4, 2)):
        mesh = make_tiled_mesh(shape, device=dev)
        prep = sp.prepare_recording_tiled(d["x"][:m], d["y"][:m],
                                          d["t_ns"][:m], cfg, *shape)
        staged = sp._stage_tiles(prep, mesh)
        s = len(prep["plan"].ends) // 2          # a full, interior slice
        tl = sp._Tiling(cfg.sensor, opt.scale, mesh, TILED_HALO)
        geom = geometry_from_bbox(*prep["bbox"][s], opt.scale, cfg.sensor,
                                  opt.min_window_fraction)
        x, y, t, idx = (staged[k][s] for k in ("x", "y", "t", "idx"))
        ev = sp._tile_events(x, y, t, idx >= 0, tl, geom)
        lx, ly, *_ = sp._local_positions(x, y, ev, tl)
        name = f"{shape[0]}x{shape[1]}"
        kw = dict(H=tl.H, W=tl.W)
        gen = torch.Generator().manual_seed(5)
        perm = torch.stack([torch.randperm(lx.shape[1], generator=gen)
                            for _ in range(lx.shape[0])]).to(dev)
        cases = {"sorted": (lx, ly, ev.t_sec),
                 "unsorted": tuple(a.gather(1, perm)
                                   for a in (lx, ly, ev.t_sec))}
        n_tiles = lx.shape[0]
        new_pair = lambda: fm.image_pair(dev, tl.H, tl.W, n_tiles=n_tiles)
        # B8 adds into its caller's pair and B9 reads it and leaves it
        # zero: each call gets its own pair, and the timed calls one that
        # setup() puts back (zeroed for B8, B8's splat for B9).
        res8 = {}
        for order, args in cases.items():
            pair = new_pair()
            at, ac = fm.splat_local_call(*args, *pair, **kw)
            at_p, ac_p = fm.splat_local_plain(*args, *new_pair(), **kw)
            err = max(max_err(at, at_p), max_err(ac, ac_p))
            if err != 0.0:
                raise AssertionError(f"splat_local {name} {order}: max abs "
                                     f"error {err} against its twin")
            if at[:, tl.H:].any() or at[:, :, tl.W:].any() or \
                    ac[:, tl.H:].any() or ac[:, :, tl.W:].any():
                raise AssertionError(f"splat_local {name} {order}: a pixel "
                                     "outside the H x W image is not zero")
            n_acc = int(ac.sum())
            # (On 4x2 tiles the window's shift moves most events off their
            # home tiles, beyond the halo: those go by the escape lane.)
            if n_acc < 20_000:
                raise AssertionError(f"splat_local {name} {order}: only "
                                     f"{n_acc} events splatted")
            zeroed = lambda pair=pair: (pair[0].zero_(), pair[1].zero_())
            splat_bytes = pair_bytes("splat", ac)
            res8[order] = dict(
                max_abs_err=err,
                ms=timed(lambda: fm.splat_local_call(*args, *pair, **kw),
                         setup=zeroed),
                plain_ms=timed(lambda: fm.splat_local_plain(*args, *pair,
                                                            **kw),
                               setup=zeroed),
                **bound(nbytes(*args) + splat_bytes,
                        args[0].numel() * 4 + n_acc * OPS_SPLAT),
                grid=fm.splat_local_grid(*args[0].shape), redesigned=10)
        pair = new_pair()
        at, ac = fm.splat_local_call(*cases["sorted"], *pair, **kw)
        at0, ac0 = at.clone(), ac.clone()
        if not torch.equal(fm.splat_local_call(*cases["unsorted"],
                                               *new_pair(), **kw)[1], ac0):
            raise AssertionError(f"splat_local {name}: the count image "
                                 "depends on the slots' order")
        # A yardstick, not the same function: one index_add_ of precomputed
        # weights at precomputed pixels gives one of the two images.
        ok = lx >= 0
        tile = torch.arange(n_tiles, device=dev)[:, None]
        lin = torch.where(ok, (tile * tl.H + lx.long()) * tl.W + ly.long(),
                          0).reshape(-1)
        w = torch.where(ok, fm.to_fixed(ev.t_sec), 0).reshape(-1)
        ia_ms = timed(lambda: torch.zeros(n_tiles * tl.H * tl.W,
                                          dtype=torch.int64,
                                          device=dev).index_add_(0, lin, w))

        own = tl.own
        kw9 = dict(scale=opt.scale, **kw)
        filled = lambda: (pair[0].copy_(at0), pair[1].copy_(ac0))
        vals = fm.finish_local_call(*pair, own=own, **kw9)
        if pair[0].any() or pair[1].any():
            raise AssertionError(f"finish_local {name}: the pair is not "
                                 "zero")
        err9 = max_err(vals, fm.finish_local_plain(at0.clone(), ac0.clone(),
                                                   own=own, **kw9))
        whole = fm.finish_local_call(at0.clone(), ac0.clone(),
                                     own=(0, tl.H, 0, tl.W), **kw9)
        b7b = torch.stack([fm.finish_partials_call(
            at0[k].clone(), ac0[k].clone(), **kw9) for k in range(n_tiles)])
        if err9 != 0.0 or not torch.equal(whole, b7b):
            raise AssertionError(
                f"finish_local {name}: max abs error {err9} against its "
                f"twin; whole image bitwise B7b: {torch.equal(whole, b7b)}")
        if float(vals[:, 0].sum()) < 0.2 * n_acc or \
                float(vals[:, 7].abs().max()) != 0.0:
            raise AssertionError(f"finish_local {name}: sums {vals.tolist()}")
        res9 = dict(
            max_abs_err=err9,
            ms=timed(lambda: fm.finish_local_call(*pair, own=own, **kw9),
                     setup=filled),
            plain_ms=timed(lambda: fm.finish_local_plain(*pair, own=own,
                                                         **kw9),
                           setup=filled),
            **bound(nbytes(vals) + pair_bytes("finish", ac0, tl.H, tl.W),
                    ops_finish(n_tiles * tl.H * tl.W, opt.scale)),
            **dict(zip(("R", "grid"), fm.iteration_grid(
                "finish_local", dev, tl.H, tl.W, opt.scale, n_tiles))),
            redesigned=10)
        chain = lambda: fm.finish_local_call(*fm.splat_local_call(
            *cases["sorted"], *pair, **kw), own=own, **kw9)
        ops = log_breakdown(f"B8 -> B9 {name} ({n_tiles} x {tl.H}x{tl.W})",
                            chain)
        if len(ops) != 2 or any(o.startswith("Memset") for o, _ in ops):
            raise AssertionError(f"B8 -> B9 {name}: device operations {ops}, "
                                 "expected one kernel each and no memset")
        for k, r in (("splat_local sorted", res8["sorted"]),
                     ("splat_local unsorted", res8["unsorted"]),
                     ("finish_local", res9)):
            log(f"[kernels] {k} {name} ({lx.shape[0]} x {lx.shape[1]} slots, "
                f"{n_tiles} x {tl.H}x{tl.W} images): max_abs_err "
                f"{r['max_abs_err']:.3g}  kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']})" + (f"  R {r['R']}" if "R" in r else "")
                + f"  grid {r['grid']}")
        log(f"[kernels] {name}: finish_local on the whole image bitwise "
            f"finish_partials, the pair zero after finish_local; index_add_ "
            f"of one image {ia_ms:.4f} ms; {int(ac0.sum())} of the slice's "
            f"{int(prep['nval'][s])} events land inside their home tile's "
            "halo ring (the others go by the escape lane)")
        out = dict(splat_local=res8["sorted"], finish_local=res9)
    return out


def phase_tiled(d, dev, n_compare=N_TILED_COMPARE):
    """The tiled pipeline on the megapixel stream (see the module
    docstring, 10).  Returns the 4x2 reference run's launch counts."""
    import numpy as np
    import torch

    from better_flow_tpu_torch.config import OptimizerConfig, SensorConfig
    from better_flow_tpu_torch.core.model import MotionModel
    from better_flow_tpu_torch.io.synthetic import synthetic_events
    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.parallel import spatial as sp
    from better_flow_tpu_torch.parallel.mesh import make_tiled_mesh
    from better_flow_tpu_torch.runtime.scan_pipeline import (
        compensate_recording_scan,
    )

    t_phase = time.perf_counter()
    preps = {}

    def run(shape, fast=False, device=dev, m=None, warm=False, mode="auto"):
        part = d if m is None else {k: d[k][:m] for k in ("x", "y", "t_ns")}
        cfg = tiled_cfg(fast, mode)
        key = (shape, m)
        if key not in preps:
            preps[key] = sp.prepare_recording_tiled(
                part["x"], part["y"], part["t_ns"], cfg, *shape)
        call = lambda: sp.compensate_recording_tiled(
            None, None, None, cfg, make_tiled_mesh(shape, device=device),
            halo=TILED_HALO, esc_cap=TILED_ESC_CAP, prepared=preps[key])
        if warm:
            call()
        return call()

    def report(name, r, kernels=True):
        st = r["stats"]
        total = int(r["iters"].sum())
        for k in ("u", "v", "noise"):
            if r[k].shape != (st["n_events"],):
                raise AssertionError(f"tiled {name}: {k} shape {r[k].shape}")
        if not (np.isfinite(r["u"]).all() and np.isfinite(r["v"]).all()):
            raise AssertionError(f"tiled {name}: non-finite flow")
        if st["escaped_dropped"] != 0:
            raise AssertionError(f"tiled {name}: escape lane dropped "
                                 f"{st['escaped_dropped']} events")
        lc = st["launches"]
        want = dict.fromkeys(lc, 0)
        if kernels:
            want.update(splat_local=total, finish_local=total)
        if lc != want or total <= st["n_slices"]:
            raise AssertionError(f"tiled {name}: launches {lc}, expected "
                                 f"{want}")
        log(f"[tiled] {name}: events/s {st['events_per_s']:.1f}  run_s "
            f"{st['run_s']:.4f}  plan_s {st['plan_s']:.4f}  n_slices "
            f"{st['n_slices']}  mean_iters {st['mean_iters']:.4f}  "
            f"host_syncs {st['host_syncs']} "
            f"({st['host_syncs'] / total:.2f} an iteration)  "
            f"host_ms_per_iter {1e3 * st['run_s'] / total:.4f}  "
            f"cap_per_tile {st['cap_per_tile']}  launches: splat_local "
            f"{lc['splat_local']}, finish_local {lc['finish_local']}")
        return r

    def tiled_gates(name, a, b, iterations=True, median=0.005,
                    min_speed=50.0, may_part=()):
        """The gates of tests/test_spatial.py:192-205 of ``a`` against the
        reference run ``b``: noise and iterations identical, median |du|,
        |dv| <= 0.5% (``median``) and max |du| <= 5% of a mean speed above
        50 (``min_speed``; its XLA-against-Pallas gate at :350-354: 0.1%
        and 20).  The iteration counts may part in the slices
        ``may_part`` only.  With ``iterations=False`` the iteration gate is
        reported (met or NOT MET, with the counts) and does not decide the
        phase."""
        if not np.array_equal(a["noise"], b["noise"]):
            raise AssertionError(f"tiled {name}: noise flags differ")
        same = a["iters"] == b["iters"]
        parted = np.flatnonzero(~same).tolist()
        if not set(parted) <= set(may_part):
            log(f"[tiled] {name}: iteration gate NOT MET: the counts differ "
                f"in slices {parted} of {len(same)} (may part: "
                f"{list(may_part)}): "
                f"{a['iters'].tolist()} vs {b['iters'].tolist()}")
            if iterations:
                raise AssertionError(f"tiled {name}: iterations differ")
        elif parted:
            log(f"[tiled] {name}: iteration gate met ({len(same)} slices; "
                f"the counts part in slices {parted}, where the JAX "
                f"package's own runs part)")
        else:
            log(f"[tiled] {name}: iteration gate met ({len(same)} slices)")
        ok = ~b["noise"]
        speed = float(np.hypot(b["u"][ok], b["v"][ok]).mean())
        du = np.abs(a["u"][ok] - b["u"][ok])
        dv = np.abs(a["v"][ok] - b["v"][ok])
        got = dict(speed=speed, median_du=float(np.median(du)),
                   median_dv=float(np.median(dv)), max_du=float(du.max()))
        log(f"[tiled] {name}: {json.dumps(got)}")
        if speed <= min_speed or got["median_du"] > median * speed or \
                got["median_dv"] > median * speed or \
                got["max_du"] > 0.05 * speed:
            raise AssertionError(f"tiled {name}: beyond the gates (median "
                                 f"<= {median} x speed, max <= 0.05 x "
                                 f"speed, speed > {min_speed})")

    def operations(shape, mode="auto"):
        """PyTorch operations dispatched inside one tiled iteration, views
        apart, averaged over a run (the kernels' wrappers are two calls)."""
        return count_operations(sp, "_tiled_iteration",
                                lambda: run(shape, mode=mode))

    r11 = report("1x1 reference", run((1, 1), warm=True))
    run((4, 2))                                             # warm-up
    fm.reset_launches()
    r42 = report("4x2 reference", run((4, 2)))
    launches = dict(fm.LAUNCHES)
    tiled_gates("4x2 against 1x1", r42, r11)
    r42b = run((4, 2))
    for k in ("u", "v", "noise", "iters"):
        if not np.array_equal(r42[k], r42b[k]):
            raise AssertionError(f"tiled 4x2: repeated run differs in {k}")
    log(f"[tiled] 4x2 reference: second run bitwise identical; events/s "
        f"{r42b['stats']['events_per_s']:.1f}")
    log(f"[tiled] PyTorch operations (and views) an iteration around B8 and "
        f"B9: 1x1 {operations((1, 1))}, 4x2 {operations((4, 2))}")
    # The XLA branch on 2x2 tiles (no launch: the exact scatter and the
    # JAX package's image chain in place of B8 and B9) against the 2x2
    # kernel run, under tests/test_spatial.py:350-354's gates.
    r22 = report("2x2 reference", run((2, 2), warm=True))
    fm.reset_launches()
    rx = report("2x2 reference xla", run((2, 2), warm=True, mode="xla"),
                kernels=False)
    if any(fm.LAUNCHES.values()):
        raise AssertionError(f"tiled xla: launched {dict(fm.LAUNCHES)}")
    # The counts may part only in the slices where the JAX package's own
    # runs part (TILED_FRAGILE_SLICES, held by
    # tests/test_torch_tiled_fullwidth.py); the card's XLA run is also held
    # to its CPU run below.
    tiled_gates("2x2 xla against 2x2 kernels", rx, r22, median=0.001,
                min_speed=20.0, may_part=TILED_FRAGILE_SLICES)
    log(f"[tiled] PyTorch operations (and views) an iteration at 2x2: "
        f"kernels {operations((2, 2))}, xla {operations((2, 2), 'xla')}")
    rf = report("4x2 fast", run((4, 2), fast=True, warm=True))
    # The fast schedule against the reference one (reported, not gated:
    # the reference schedule stops at max_iter in most slices).
    okf = ~(rf["noise"] | r42["noise"])
    speed = float(np.hypot(r42["u"][okf], r42["v"][okf]).mean())
    dfu = float(np.median(np.abs(rf["u"][okf] - r42["u"][okf])))
    dfv = float(np.median(np.abs(rf["v"][okf] - r42["v"][okf])))
    log(f"[tiled] 4x2 fast against 4x2 reference: median |du| {dfu:.4f} "
        f"|dv| {dfv:.4f} of speed {speed:.2f}; iterations "
        f"{int(rf['iters'].sum())} vs {int(r42['iters'].sum())}")

    # The untiled scan of the port at this geometry, on the card.
    ru = compensate_recording_scan(d["x"], d["y"], d["t_ns"], tiled_cfg(),
                                   device=dev)
    su = ru["stats"]
    log(f"[tiled] untiled scan: events/s {su['events_per_s']:.1f}  run_s "
        f"{su['run_s']:.4f}  plan_s {su['plan_s']:.4f}  n_slices "
        f"{su['n_slices']}  mean_iters {su['mean_iters']:.4f}  host_syncs "
        f"{su['host_syncs']}  host_ms_per_iter "
        f"{1e3 * su['run_s'] / max(1, su['host_syncs']):.4f}")
    if su["n_slices"] != r42["stats"]["n_slices"]:
        raise AssertionError("tiled: slice counts differ from the untiled "
                             "scan's")
    # Noise and flow are held to the gates.  The iteration gate is not met
    # on this stream and is printed as it is: from the seventh slice on the
    # exit falls within an ulp of the tolerance, and the untiled scan sums
    # the image in the megastep's order, the tiled path tile by tile (the
    # JAX package's own untiled and tiled runs part in the same slices:
    # tests/test_torch_tiled_fullwidth.py).
    tiled_gates("4x2 against the untiled scan", r42, ru, iterations=False)

    # The card against the CPU twins.
    m = n_compare
    t0 = time.perf_counter()
    same_twins("tiled 4x2", run((4, 2), m=m), run((4, 2), device="cpu", m=m))
    same_twins("tiled 2x2 xla", run((2, 2), m=m, mode="xla"),
               run((2, 2), device="cpu", m=m, mode="xla"))
    part = {k: d[k][:m] for k in ("x", "y", "t_ns")}
    same_twins("untiled scan at 720x1280",
               compensate_recording_scan(part["x"], part["y"], part["t_ns"],
                                         tiled_cfg(), device=dev),
               compensate_recording_scan(part["x"], part["y"], part["t_ns"],
                                         tiled_cfg(), device="cpu"))
    log(f"[tiled] card = CPU twins on {m} events, tiled 4x2, tiled 2x2 xla "
        f"and the untiled scan (noise and iterations identical, median du = "
        f"dv = 0); "
        f"{time.perf_counter() - t0:.1f} s")

    # Beyond the halo: a fast scene on a small sensor, 4x1 tiles, halo 8.
    e = synthetic_events(6000, duration_s=0.1, res_x=48, res_y=64, vx=80.0,
                         vy=-50.0, n_points=100, seed=3)
    opt = OptimizerConfig(scale=3, max_iter=16, min_events=100)

    def lane(shape, esc_cap, device=dev):
        args = sp.bucket_events_2d(e["x"], e["y"],
                                   e["t_ns"].astype(np.float32), 48, 64, 3,
                                   *shape, None)
        mesh = make_tiled_mesh(shape, device=device)
        return sp.process_slice_tiled(
            *args, MotionModel.zero(mesh.device), opt, SensorConfig(48, 64),
            mesh, halo=8, n_iters=16, esc_cap=esc_cap), args[3]

    (sized, _), (starved, _), (one, ok1), (twin, _) = (
        lane((4, 1), 4096), lane((4, 1), 1), lane((1, 1), 4096),
        lane((4, 1), 4096, device="cpu"))
    med = float(np.median(one.u.cpu().numpy()[ok1]))
    twin_du = float((sized.u.cpu() - twin.u).abs().median())
    close = lambda a, b: \
        abs(float(a) - float(b)) <= 1e-4 * abs(float(b)) + 1e-6
    if sized.escaped_dropped != 0 or starved.escaped_dropped <= 0 or \
            not close(sized.model.total_dx, one.model.total_dx) or \
            not close(sized.model.total_dy, one.model.total_dy) or \
            abs(med - 80.0) >= 8.0 or twin_du != 0.0:
        raise AssertionError(
            f"tiled escape lane: dropped {sized.escaped_dropped} (sized), "
            f"{starved.escaped_dropped} (esc_cap 1); total_dx "
            f"{float(sized.model.total_dx)} vs 1x1 "
            f"{float(one.model.total_dx)}; median u {med}; median |du| "
            f"against the CPU twins {twin_du}")
    log(f"[tiled] beyond an 8-pixel halo (4x1 tiles, 16 iterations): the "
        f"lane carried the events (a lane of 1 drops "
        f"{starved.escaped_dropped}), dropped none, total_dx "
        f"{float(sized.model.total_dx):.6f} = the 1x1 run's "
        f"{float(one.model.total_dx):.6f}, median u {med:.2f}, median |du| "
        "against the CPU twins 0")
    log(f"[tiled] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def same_twins(name, g, c):
    """Card run ``g`` against CPU-twin run ``c``: the same noise and
    iterations, median |du| = |dv| = 0."""
    import numpy as np

    for k in ("noise", "iters"):
        if not np.array_equal(g[k], c[k]):
            raise AssertionError(f"{name}: card and CPU twins differ in {k}")
    du = float(np.median(np.abs(g["u"] - c["u"])))
    dv = float(np.median(np.abs(g["v"] - c["v"])))
    if du != 0.0 or dv != 0.0:
        raise AssertionError(f"{name}: median |du|, |dv| = {du}, {dv} "
                             "against the CPU twins")


def live_slice_inputs(d, dev):
    """One slice of the live preset (``low_latency_config()``: 30,000
    events, scale 1) as the streaming path lays it out: 15 chunks, sorted
    by 32-row band and column."""
    import numpy as np
    import torch

    from better_flow_tpu_torch.config import low_latency_config
    from better_flow_tpu_torch.models.global_flow import (
        geo_row, geometry_from_bbox,
    )
    from better_flow_tpu_torch.ops.layout import pack_act, prepare_chunk_layouts

    cfg = low_latency_config()
    n = cfg.slice.max_events
    x, y = d["x"][:n].astype(np.float32), d["y"][:n].astype(np.float32)
    t = (d["t_ns"][:n] - d["t_ns"][0]).astype(np.float32)
    order = np.argsort((x.astype(np.int64) // 32) * 4096 + y.astype(np.int64),
                       kind="stable")
    xt, yt, tt = (torch.from_numpy(a[order]).to(dev) for a in (x, y, t))
    stat = prepare_chunk_layouts(xt, yt, tt)
    act = pack_act(torch.ones(n, dtype=torch.bool, device=dev))
    g = geometry_from_bbox(int(x.min()), int(x.max()), int(y.min()),
                           int(y.max()), 1, cfg.sensor)
    geo = torch.from_numpy(geo_row(g)).to(dev)
    return cfg, dict(stat=stat, act=act, geo=geo)


def phase_megastep(scan_inputs, d, dev):
    """B5 at the main path's scale-3 shapes and at the live preset's
    scale-1 shapes: bitwise its twin and the B1 -> B2 kernel chain, with
    the median device time of all three."""
    import numpy as np
    import torch

    from better_flow_tpu_torch.config import OptimizerConfig, SensorConfig
    from better_flow_tpu_torch.models.global_flow import (
        finish_statics, static_image_shape,
    )
    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.ops.layout import padded_image_shape

    live_cfg, live = live_slice_inputs(d, dev)
    rng = np.random.default_rng(11)
    live["pr"] = (live["stat"][:, 0:2] + torch.from_numpy(rng.normal(
        0, 0.2, (live["stat"].shape[0], 2, live["stat"].shape[2])).astype(
            np.float32)).to(dev)).contiguous()
    live["st"] = scan_inputs["st"]
    cases = [("scale3", scan_inputs, OptimizerConfig(), SensorConfig()),
             ("scale1", live, live_cfg.optimizer, live_cfg.sensor)]
    out = {}
    for name, inp, opt, sensor in cases:
        H, W = static_image_shape(opt.scale, sensor)
        statics = finish_statics(opt)
        args = [inp[k] for k in ("stat", "act", "pr", "st", "geo")]
        kw = dict(scale=opt.scale, H=H, W=W, time_lo=True, **statics)

        pair = fm.image_pair(dev, H, W)

        def chain():
            npr, at, ac = fm.warp_images_st_call(*args, *pair,
                                                 scale=opt.scale, H=H, W=W,
                                                 time_lo=True)
            return npr, fm.megastep_finish_call(at, ac, args[3], args[4],
                                                scale=opt.scale, H=H, W=W,
                                                **statics)

        npr, st = fm.megastep_call(*args, **kw)
        npr_p, st_p = fm.megastep_plain(*args, **kw)
        npr_c, st_c = chain()
        err = max(max_err(npr, npr_p), max_err(st, st_p))
        if err != 0.0:
            raise AssertionError(f"megastep {name}: max abs error {err} "
                                 "against its twin")
        if not (torch.equal(npr, npr_c) and torch.equal(st, st_c)):
            raise AssertionError(f"megastep {name}: differs from the "
                                 "B1 -> B2 chain")
        if pair[0].any() or pair[1].any():
            raise AssertionError(f"B1 -> B2 chain {name}: the pair is not "
                                 "zero after B2")
        ac = fm.warp_images_st_call(*args, *fm.image_pair(dev, H, W),
                                    scale=opt.scale, H=H, W=W,
                                    time_lo=True)[2]
        if int(ac.sum()) < 10_000:
            raise AssertionError(f"megastep {name}: only {int(ac.sum())} "
                                 "events splatted")
        ops = log_breakdown(f"B1 -> B2 chain {name}", chain)
        if len(ops) != 2 or any(o.startswith("Memset") for o, _ in ops):
            raise AssertionError(f"B1 -> B2 chain {name}: device operations "
                                 f"{ops}, expected one kernel each and no "
                                 "memset")
        log_breakdown(f"megastep {name}", lambda: fm.megastep_call(*args,
                                                                   **kw))
        R, grid = fm.iteration_grid("megastep", dev, H, W, opt.scale)
        r = dict(max_abs_err=err,
                 ms=timed(lambda: fm.megastep_call(*args, **kw)),
                 chain_ms=timed(chain),
                 plain_ms=timed(lambda: fm.megastep_plain(*args, **kw)),
                 **bound(nbytes(*args, npr, st) + pair_bytes("internal"),
                         args[0].shape[0] * args[0].shape[2] * OPS_WARP
                         + int(ac.sum()) * OPS_SPLAT
                         + ops_finish(H * W, opt.scale) + 300),
                 R=R, grid=grid, redesigned=7)
        if name == "scale3":
            sweep_band_rows(args, kw, dev)
        HP, WP = padded_image_shape(H, W)
        log(f"[kernels] megastep {name} ({args[0].shape[0]} chunks, "
            f"{HP}x{WP} images, R {R}, grid {grid}): max_abs_err "
            f"{err:.3g}, "
            f"bitwise the B1 -> B2 chain; kernel {r['ms']:.4f} ms  chain "
            f"{r['chain_ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.5f} ms")
        out[name] = r
    return out


def sweep_band_rows(args, kw, dev):
    """B5 at band heights R = 1 to 6 beside ``band_rows``' choice, at the
    main path's image (543x723, scale 3) and at 721x1281, scale 1 (the
    same slice: its events land in the image's corner, and the band pass
    covers the whole image), in turns: each bitwise B5 at that shape, with
    its median time.  ``BAND_MAX_ROWS`` rests on these times."""
    import ctypes

    import torch

    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.ops._build import library
    from better_flow_tpu_torch.ops.layout import padded_image_shape

    stat, act, pr, st, geo = args
    statics = {k: v for k, v in kw.items()
               if k not in ("scale", "H", "W", "time_lo")}
    cp = fm._c_params(statics)

    def run(R, H, W, scale):
        HP, WP = padded_image_shape(H, W)
        acc_t, acc_c = fm._images(dev, H, W)
        npr, st_out = torch.empty_like(pr), torch.empty_like(st)
        rc = library().bf_megastep(
            fm._ptr(geo), fm._ptr(st), fm._ptr(stat), fm._ptr(act),
            fm._ptr(pr), fm._ptr(npr), fm._ptr(st_out), fm._ptr(acc_t),
            fm._ptr(acc_c), fm._ptr(fm._workspace(dev, H, W)["partials"]),
            stat.shape[0], HP, WP, H, W, scale, int(kw["time_lo"]), R,
            fm.band_smem_bytes(R, W, scale), ctypes.byref(cp), 0,
            fm._stream(dev))
        if rc != 0:
            raise RuntimeError(f"megastep at R {R}: CUDA error {rc}")
        return npr, st_out

    for H, W, scale in ((kw["H"], kw["W"], kw["scale"]), (721, 1281, 1)):
        want = fm.megastep_call(*args, **dict(kw, H=H, W=W, scale=scale))
        chosen = fm._device_bands(dev, H, W, scale)[0]
        times = []
        for R in (chosen, 1, 2, 3, 4, 5, 6, chosen):
            got = run(R, H, W, scale)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"megastep at R {R}, {H}x{W}: differs "
                                     "from B5")
            us = 1e3 * timed(lambda: run(R, H, W, scale))
            times.append(f"R {R} {us:.2f}")
        log(f"[kernels] megastep band heights at {H}x{W}, scale {scale} "
            f"(band_rows: {chosen}), us in turns: " + ", ".join(times))


def count_operations(module, name, run):
    """PyTorch operations dispatched inside each call of ``module.name``
    during ``run()``, views apart, averaged over the calls (a kernel's
    wrapper counts as the operations it dispatches around its launch).
    Returns (operations, views) per call."""
    from torch.utils._python_dispatch import TorchDispatchMode

    views = ("slice", "select", "view", "unsqueeze", "squeeze", "expand",
             "detach", "unbind", "reshape", "transpose", "permute",
             "alias", "narrow", "as_strided", "t.default", "unsafe_view")
    count = dict(on=False, ops=0, views=0, calls=0)

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if count["on"]:
                op = str(func).split("aten.")[-1]
                count["views" if op.startswith(views) else "ops"] += 1
            return func(*args, **(kwargs or {}))

    real = getattr(module, name)

    def counted(*a, **k):
        count["on"], count["calls"] = True, count["calls"] + 1
        try:
            return real(*a, **k)
        finally:
            count["on"] = False

    setattr(module, name, counted)
    try:
        with Counter():
            run()
    finally:
        setattr(module, name, real)
    return (round(count["ops"] / max(count["calls"], 1), 1),
            round(count["views"] / max(count["calls"], 1), 1))


def _synced(fn):
    """``fn()``'s result and the calls inside it that block the host until
    the card catches up: the warnings of PyTorch's sync debug mode (reads
    of a device value, copies between the card and pageable host memory,
    stream and device synchronisations)."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def count_syncs(run):
    """Calls that block the host made during ``run()`` (``_synced``)."""
    return _synced(run)[1]


def count_syncs_in(module, name, run):
    """``count_syncs`` restricted to the calls of ``module.name`` made
    during ``run()``: the calls that block the host inside them."""
    real = getattr(module, name)
    n = [0]

    def counted(*a, **k):
        out, k_syncs = _synced(lambda: real(*a, **k))
        n[0] += k_syncs
        return out

    setattr(module, name, counted)
    try:
        run()
    finally:
        setattr(module, name, real)
    return n[0]


def phase_partials_kernels(scan_inputs, cfg, dev):
    """B10 and B11 at the main path's shapes: the warped positions of a
    full 30-chunk slice (B1's), its times and activity, in the staged band
    order and sorted by ``sort_key_blocks``.  First B10 on both orders with
    every count set to 0 just before: B10's path, since the JAX package
    calls it from its tests only.  Then each kernel bitwise its twin, B11
    bitwise B10, with the median times of the calls and of the twins, and
    a call's device operations (one kernel, no memset).  Returns (the
    results, B10's launches)."""
    import torch

    from better_flow_tpu_torch.models.global_flow import static_image_shape
    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.ops.layout import sort_key_blocks

    opt = cfg.optimizer
    H, W = static_image_shape(opt.scale, cfg.sensor)
    inp = scan_inputs
    npr, _, _ = fm.warp_images_st_call(inp["stat"], inp["act"], inp["pr"],
                                       inp["st"], inp["geo"],
                                       *fm.image_pair(dev, H, W),
                                       scale=opt.scale, H=H, W=W)
    flat = lambda a: a.reshape(-1).contiguous()
    x, y, t = (flat(inp["stat"][:, k]) for k in range(3))
    band = dict(pr_x=flat(npr[:, 0]), pr_y=flat(npr[:, 1]), t_ns=t,
                active=flat(inp["act"][:, 0]) > 0)
    order = torch.argsort(sort_key_blocks(x, y, band["active"]), stable=True)
    ordered = {k: v[order].contiguous() for k, v in band.items()}
    geo = inp["geo"]
    kw = dict(scale=opt.scale, H=H, W=W)
    orders = (("band", band), ("sorted", ordered))
    fm.reset_launches()
    b10 = {o: fm.fused_model_partials_call(e["pr_x"], e["pr_y"], e["t_ns"],
                                           e["active"], geo, **kw)
           for o, e in orders}
    b10_launches = fm.LAUNCHES["fused_model_partials"]
    if b10_launches != len(orders):
        raise AssertionError(f"fused_model_partials launched {b10_launches} "
                             f"times in {len(orders)} calls")
    out = {}
    for name, call, plain in (
            ("fused_model_partials", fm.fused_model_partials_call,
             fm.fused_model_partials_plain),
            ("fused_model_partials_windowed",
             fm.fused_model_partials_windowed_call,
             fm.fused_model_partials_windowed_plain)):
        res = {}
        for order_name, e in orders:
            args = (e["pr_x"], e["pr_y"], e["t_ns"], e["active"], geo)
            got = call(*args, **kw)
            rows = fm.partials_rows(*args[:4])
            want = plain(*rows, geo, **kw)
            err = max_err(got, want)
            if err != 0.0 or not torch.equal(got, b10[order_name]):
                raise AssertionError(f"{name} ({order_name}): max abs error "
                                     f"{err} against its twin, or not B10")
            if float(got[0]) < 10_000:
                raise AssertionError(f"{name}: only {float(got[0])} pixels")
            res[order_name] = dict(
                err=err, ms=timed(lambda: call(*args, **kw)),
                plain_ms=timed(lambda: plain(*rows, geo, **kw)))
        slots = band["pr_x"].numel()
        accepted = int(band["active"].sum())
        main = "sorted" if name.endswith("windowed") else "band"
        e = orders[0][1] if main == "band" else orders[1][1]
        ops = log_breakdown(name, lambda: call(
            e["pr_x"], e["pr_y"], e["t_ns"], e["active"], geo, **kw))
        if len(ops) != 1 or ops[0][0].startswith("Memset"):
            raise AssertionError(f"{name}: device operations {ops}, expected "
                                 "one kernel")
        out[name] = dict(
            max_abs_err=max(r["err"] for r in res.values()),
            ms=res[main]["ms"], device_us=ops[0][1],
            plain_ms=res[main]["plain_ms"],
            **bound(nbytes(*(band[k] for k in ("pr_x", "pr_y", "t_ns",
                                                "active")), geo)
                    + 32 + pair_bytes("internal"),
                    slots * OPS_ACCEPT + accepted * OPS_SPLAT
                    + ops_finish(H * W, opt.scale)),
            **dict(zip(("R", "grid"), fm.iteration_grid(
                "fused_model_partials", dev, H, W, opt.scale))),
            redesigned=11)
        log(f"[kernels] {name}: bitwise its twin and B10 on band-ordered and "
            f"sorted events; kernel {res['band']['ms']:.4f} ms (band order) "
            f"{res['sorted']['ms']:.4f} ms (sorted), device "
            f"{ops[0][1]:.2f} us  plain {out[name]['plain_ms']:.4f} ms  bound "
            f"{out[name]['bound_ms']:.5f} ms ({out[name]['bound_by']})  R "
            f"{out[name]['R']}  grid {out[name]['grid']}")
    log(f"[kernels] fused_model_partials: {b10_launches} launches on its "
        "path (the slice in band order and sorted)")
    return out, b10_launches


def phase_merged(scan_inputs, cfg, prep, r_split, dev):
    """B12 at the main path's shapes, then the merged drive on the bench
    stream.  The kernel: a slice's first call and a full iteration (the
    head finish of the first call's images, the warp and the splat)
    bitwise their twins and the B1 -> B2 -> B1 chain, and a call whose
    head ends the loop bitwise B4's final warp.  The drive: the ``fast()``
    scan with ``megastep_merged`` on the staged 2M events, bitwise the
    B1-B4 scan ``r_split`` (iterations, u, v, noise), with its launches:
    one B12 an iteration plus one a slice that runs, no B1, B2 or B4.
    Returns (the kernel's results, its launches in the merged scan)."""
    import dataclasses

    import numpy as np
    import torch

    from better_flow_tpu_torch.models.global_flow import (
        finish_statics, static_image_shape,
    )
    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.ops.layout import ST_CONT, ST_HAS
    from better_flow_tpu_torch.runtime.scan_pipeline import (
        compensate_recording_scan,
    )

    t_phase = time.perf_counter()
    opt = cfg.optimizer
    H, W = static_image_shape(opt.scale, cfg.sensor)
    inp = scan_inputs
    stat, act, pr, geo = inp["stat"], inp["act"], inp["pr"], inp["geo"]
    st = inp["st"].clone()
    st[0, ST_HAS] = 0.0
    time_lo = opt.splat_time_lo or opt.schedule != "fast"
    kw = dict(scale=opt.scale, H=H, W=W, time_lo=time_lo,
              **finish_statics(opt))
    chain_kw = dict(scale=opt.scale, H=H, W=W)
    fin_kw = {k: v for k, v in kw.items() if k != "time_lo"}
    pr4 = torch.cat([pr, torch.zeros_like(pr)], dim=1)
    # A call reads its pair, clears it and splats into it: every call and
    # every twin gets a copy, so that each call's images stay to compare.
    zero = fm.image_pair(dev, H, W)
    copy = lambda p: tuple(t.clone() for t in p)
    first = fm.megastep2_call(stat, act, pr4, st, *copy(zero), geo, **kw)
    second = fm.megastep2_call(stat, act, first[0], first[1],
                               *copy(first[2:]), geo, **kw)
    err = 0.0
    for got, args in ((first, (pr4, st, *zero)), (second, first)):
        want = fm.megastep2_plain(stat, act, args[0], args[1],
                                  *copy(args[2:4]), geo, **kw)
        err = max(err, *(max_err(g, w) for g, w in zip(got, want)))
    if err != 0.0:
        raise AssertionError(f"megastep2: max abs error {err} against its "
                             "twin")
    npr1, at1, ac1 = fm.warp_images_st_call(stat, act, pr, first[1], geo,
                                            *fm.image_pair(dev, H, W),
                                            time_lo=time_lo, **chain_kw)
    same = (torch.equal(first[0][:, 0:2], npr1) and torch.equal(first[2], at1)
            and torch.equal(first[3], ac1))
    st2 = fm.megastep_finish_call(*copy((at1, ac1)), first[1], geo, **fin_kw)
    npr2, at2, ac2 = fm.warp_images_st_call(stat, act, npr1, st2, geo,
                                            *fm.image_pair(dev, H, W),
                                            time_lo=time_lo, **chain_kw)
    same = same and torch.equal(second[1], st2)
    if float(st2[0, ST_CONT]) > 0:     # the loop goes on: the next B1
        same = same and torch.equal(second[0][:, 0:2], npr2) and \
            torch.equal(second[2], at2) and torch.equal(second[3], ac2)
    if not same:
        raise AssertionError("megastep2 differs from the B1 -> B2 -> B1 chain")
    # A head that ends the loop: the call is B4's final warp and leaves the
    # pair zero.
    ended = dataclasses.replace(opt, max_iter=1)
    kw_end = dict(kw, **finish_statics(ended))
    last = fm.megastep2_call(stat, act, first[0], first[1], *copy(first[2:]),
                             geo, **kw_end)
    st_end = fm.megastep_finish_call(*copy((at1, ac1)), first[1], geo,
                                     **{k: v for k, v in kw_end.items()
                                        if k != "time_lo"})
    out4, _ = fm.warp_uv_call(stat, npr1, act, st_end)
    if float(last[1][0, ST_CONT]) != 0.0 or not torch.equal(last[0], out4) \
            or last[2].any() or last[3].any():
        raise AssertionError("megastep2's exit call is not B4's final warp")
    slots = stat.shape[0] * stat.shape[2]
    # Timed on a pair that setup() puts back: the first call's splat for a
    # later call, zero for a first call.  The breakdowns chain their calls
    # on one pair, as the drive does.
    pair = copy(first[2:])
    filled = lambda: (pair[0].copy_(first[2]), pair[1].copy_(first[3]))
    zeroed = lambda: (pair[0].zero_(), pair[1].zero_())
    later = lambda: fm.megastep2_call(stat, act, first[0], first[1], *pair,
                                      geo, **kw)
    start = lambda: fm.megastep2_call(stat, act, pr4, st, *pair, geo, **kw)
    for label, fn in (("first call", start), ("later call", later)):
        zeroed()
        ops = log_breakdown(f"megastep2 {label}", fn)
        if len(ops) != 1:
            raise AssertionError(f"megastep2 {label}: device operations "
                                 f"{ops}, expected one kernel")
    R, grid = fm.iteration_grid("megastep2", dev, H, W, opt.scale)
    r = dict(max_abs_err=err, ms=timed(later, setup=filled),
             first_ms=timed(start, setup=zeroed),
             plain_ms=timed(lambda: fm.megastep2_plain(
                 stat, act, first[0], first[1], *pair, geo, **kw),
                 setup=filled),
             # pr's rows 0-1 are read; nx, ny (rows 2-3) only written; the
             # head reads the first call's pair, the splat adds into it.
             **bound(nbytes(stat, act, first[0][:, 0:2], first[1], geo,
                            *second[:2])
                     + pair_bytes("finish", first[3], H, W)
                     + pair_bytes("splat", second[3]),
                     slots * (OPS_WARP + OPS_UV) + int(ac2.sum()) * OPS_SPLAT
                     + ops_finish(H * W, opt.scale) + 300),
             R=R, grid=grid, redesigned=9)
    log(f"[merged] megastep2: max_abs_err {err:.3g}, bitwise the B1 -> B2 -> "
        f"B1 chain and, on its exit call, B4, the pair zero after it; kernel "
        f"{r['ms']:.4f} ms (first call {r['first_ms']:.4f} ms)  plain "
        f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms "
        f"({r['bound_by']})  R {R}  grid {grid}")

    merged_cfg = dataclasses.replace(
        cfg, optimizer=dataclasses.replace(opt, megastep_merged=True))
    compensate_recording_scan(None, None, None, merged_cfg, prepared=prep)
    fm.reset_launches()
    rm = compensate_recording_scan(None, None, None, merged_cfg,
                                   prepared=prep)
    lc = dict(fm.LAUNCHES)
    for k in ("u", "v", "noise", "iters", "ran"):
        if not np.array_equal(rm[k], r_split[k]):
            raise AssertionError(f"merged scan differs from the B1-B4 scan "
                                 f"in {k}")
    iters, ran = int(rm["iters"].sum()), int(rm["ran"].sum())
    want = dict(megastep2=iters + ran, warp_images_st=0, megastep_finish=0,
                warp_uv=0, megastep=0, act_rows=1)
    for k, v in want.items():
        if lc[k] != v:
            raise AssertionError(f"merged scan: {k} launched {lc[k]} times, "
                                 f"expected {v}")
    st = rm["stats"]
    log(f"[merged] fast() scan with megastep_merged: bitwise the B1-B4 scan "
        f"(iterations, u, v, noise); events/s {st['events_per_s']:.1f} "
        f"(B1-B4 scan {r_split['stats']['events_per_s']:.1f})  run_s "
        f"{st['run_s']:.4f}  host_syncs {st['host_syncs']}  launches "
        f"{json.dumps(lc)}")
    # The two drives in turns, and the calls of each that block the host.
    scan = lambda c: compensate_recording_scan(None, None, None, c,
                                               prepared=prep)
    runs = dict(split=[], merged=[])
    for name in ("split", "merged", "merged", "split", "split", "merged"):
        runs[name].append(
            scan(cfg if name == "split" else merged_cfg)["stats"]["run_s"])
    syncs = {name: count_syncs(lambda: scan(c)) for name, c in
             (("split", cfg), ("merged", merged_cfg))}
    log(f"[merged] run_s in turns (split, merged, merged, split, split, "
        f"merged): split {runs['split']}  merged {runs['merged']}; blocking "
        f"calls a scan (sync debug mode, {iters} iterations, {ran} slices "
        f"run): {json.dumps(syncs)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return r, lc["megastep2"]


def phase_xla(d, cfg, prep, r_fast, dev):
    """The XLA-composed branch: the ``fast(scatter_mode="xla")`` scan on the
    bench stream twice (bitwise equal), with its host time and PyTorch
    operations an iteration beside the ``fast()`` kernel scan ``r_fast``,
    and against the CPU run on the first N_XLA_COMPARE events; then
    ``run_optimizer`` with "pallas" over the first N_PARTIALS_SLICES staged
    slices as a warm-start chain, on events sorted by ``sort_key_blocks``.
    Returns B11's launches in that run."""
    import dataclasses

    import numpy as np
    import torch

    from better_flow_tpu_torch.core.events import EventSlice
    from better_flow_tpu_torch.core.model import MotionModel
    from better_flow_tpu_torch.models import global_flow as gf
    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.ops.layout import sort_key_blocks
    from better_flow_tpu_torch.runtime.scan_pipeline import (
        compensate_recording_scan, slice_events,
    )

    t_phase = time.perf_counter()
    opt = dataclasses.replace(cfg.optimizer, scatter_mode="xla")
    xcfg = dataclasses.replace(cfg, optimizer=opt)
    compensate_recording_scan(None, None, None, xcfg, prepared=prep)
    fm.reset_launches()
    r1 = compensate_recording_scan(None, None, None, xcfg, prepared=prep)
    if any(fm.LAUNCHES.values()):
        raise AssertionError(f"xla scan launched kernels: {fm.LAUNCHES}")
    check_outputs(r1, len(d["x"]))
    r2 = compensate_recording_scan(None, None, None, xcfg, prepared=prep)
    for k in ("u", "v", "noise", "iters"):
        if not np.array_equal(r1[k], r2[k]):
            raise AssertionError(f"xla scan: repeated run differs in {k}")
    st, sf = r1["stats"], r_fast["stats"]
    iters, iters_f = int(r1["iters"].sum()), int(r_fast["iters"].sum())
    xla_scan = lambda: compensate_recording_scan(None, None, None, xcfg,
                                                 prepared=prep)
    ops = count_operations(gf, "iteration_step", xla_scan)
    syncs = count_syncs(xla_scan)
    log(f"[xla] fast(scatter_mode='xla') scan: events/s "
        f"{st['events_per_s']:.1f} (kernel scan {sf['events_per_s']:.1f})  "
        f"run_s {st['run_s']:.4f}  mean_iters {st['mean_iters']:.4f} "
        f"(kernel scan {sf['mean_iters']:.4f})  host ms an iteration "
        f"{1e3 * st['run_s'] / iters:.4f} (kernel scan "
        f"{1e3 * sf['run_s'] / iters_f:.4f})  PyTorch operations (and views) "
        f"an iteration {ops}; blocking calls a scan {syncs} ({iters} "
        f"iterations); second run bitwise identical")
    phase_xla_sharded(d, xcfg, r1, dev)
    m = N_XLA_COMPARE
    part = {k: d[k][:m] for k in ("x", "y", "t_ns")}
    rg = compensate_recording_scan(part["x"], part["y"], part["t_ns"], xcfg,
                                   device=dev)
    rc = compensate_recording_scan(part["x"], part["y"], part["t_ns"], xcfg,
                                   device="cpu")
    gates = compare_runs(rg, rc, d, m)
    log(f"[xla] card against the CPU run on {m} events: {json.dumps(gates)}")

    # run_optimizer's pallas branch over the first slices, chained, on
    # events sorted by sort_key_blocks as the JAX package's process_slice
    # sorts them.
    H, W = gf.static_image_shape(opt.scale, cfg.sensor)
    popt = dataclasses.replace(cfg.optimizer, scatter_mode="pallas")
    hist = torch.zeros((3, prep["hist_k"]), dtype=torch.int32, device=dev)
    hist[2] = -1
    S = min(N_PARTIALS_SLICES, len(prep["plan"].ends))
    key = "fused_model_partials_windowed"
    model = MotionModel.zero(dev)
    seed = torch.zeros(8, dtype=torch.float32, device=dev)
    fm.reset_launches()
    n_it = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_run = time.perf_counter()
    for s in range(S):
        ev = slice_events(prep["stat"][s], prep["sidx"][s], hist)
        o = torch.argsort(sort_key_blocks(ev.x, ev.y, ev.valid), stable=True)
        ev = EventSlice(*(f[o] for f in ev))
        final, seed = gf.run_optimizer(
            gf.warp_init(ev, model), ev, prep["geoms"][s], opt.scale, H, W,
            popt, seed=seed, geo=prep["geo"][s])
        model = final.model
        n_it.append(final.iters)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_run = time.perf_counter() - t_run
    launches = {key: fm.LAUNCHES[key]}
    if launches[key] != sum(n_it) or sum(n_it) <= 0:
        raise AssertionError(f"run_optimizer pallas: {key} launched "
                             f"{launches[key]} times in {sum(n_it)} "
                             "iterations")
    if not np.isfinite(model.totals4().cpu().numpy()).all():
        raise AssertionError("run_optimizer pallas: non-finite totals")
    log(f"[xla] run_optimizer(scatter_mode='pallas') over {S} slices, sorted "
        f"(B11): iterations {n_it}; xla scan {r1['iters'][:S].tolist()}; "
        f"host ms an iteration {1e3 * t_run / max(sum(n_it), 1):.4f}")
    log(f"[xla] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_xla_sharded(d, xcfg, r1, dev, n_shards=XLA_SHARDS):
    """The XLA branch under an event group: the ``fast(scatter_mode=
    "xla")`` scan of the whole bench stream over ``n_shards`` shards
    resident on the card (each iteration's integer pre-filter pair summed
    over the shards before the image chain), bitwise the single-device
    XLA scan ``r1``, with no kernel launched; its host ms and PyTorch
    operations an iteration beside the single-device run's."""
    import numpy as np

    from better_flow_tpu_torch.models import global_flow as gf
    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.parallel.event_parallel import (
        compensate_recording_scan_sharded, prepare_recording_sharded,
    )
    from better_flow_tpu_torch.parallel.mesh import make_event_mesh

    mesh = make_event_mesh(n_shards, device=dev)
    prep = prepare_recording_sharded(d["x"], d["y"], d["t_ns"], xcfg, mesh)
    run = lambda: compensate_recording_scan_sharded(None, None, None, xcfg,
                                                    mesh, prepared=prep)
    run()                                                   # warm-up
    fm.reset_launches()
    rs = run()
    if any(fm.LAUNCHES.values()):
        raise AssertionError(f"xla scan over {n_shards} shards launched "
                             f"kernels: {fm.LAUNCHES}")
    same_outputs(f"xla scan over {n_shards} shards against one device", rs,
                 r1, keys=("u", "v", "noise", "iters", "ran"))
    ops = count_operations(gf, "iteration_step", run)
    st, s1 = rs["stats"], r1["stats"]
    iters = int(rs["iters"].sum())
    log(f"[xla] fast(scatter_mode='xla') scan over {n_shards} shards on the "
        f"card: bitwise the single-device xla scan, no launch; run_s "
        f"{st['run_s']:.4f} (one device {s1['run_s']:.4f})  host ms an "
        f"iteration {1e3 * st['run_s'] / iters:.4f} (one device "
        f"{1e3 * s1['run_s'] / iters:.4f})  PyTorch operations (and views) "
        f"an iteration {ops}  host_syncs {st['host_syncs']}  n_slices "
        f"{st['n_slices']}  mean_iters {st['mean_iters']:.4f}")


def phase_dryrun(dev, n_shards=DRYRUN_SHARDS):
    """The port's entry hooks on the card (``graft_entry``): ``entry``'s
    slice and ``dryrun(n_shards)``'s four stages, each of which raises on
    a failure."""
    from better_flow_tpu_torch import graft_entry

    t_phase = time.perf_counter()
    fn, args = graft_entry.entry()
    res = fn(*args)
    if not res.ran or res.u.device.type != dev.type:
        raise AssertionError(f"entry: ran {res.ran} on {res.u.device}")
    log(f"[dryrun] entry: one slice on the card, iters {res.iters}")
    graft_entry.dryrun(n_shards)
    log(f"[dryrun] dryrun({n_shards}): four stages passed; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


def phase_options(scan_inputs, cfg, prep, r1, d, dev):
    """``[options]``: the JAX package's options that the port runs since
    they stopped raising.  B1 and B2 with ``predicated=1`` at the main
    path's shapes: on the live state bitwise ``predicated=0``, on a state
    whose CONT is 0 a pass-through (``new_pr == pr``, the next state the
    state, the pair zero), bitwise, as their twins on the card, with the
    no-op's time.  The ``fast()`` scan with ``megastep_unroll`` 2 and 4 on
    the staged 2M events: u, v, noise and iterations bitwise ``r1``,
    ``host_syncs`` equal to the blocking calls inside the megastep drive
    (sync debug mode) and fewer than ``r1``'s, the launches, and run_s in
    turns with ``megastep_unroll=1``.  ``fast(warm_extrapolate=1.0)``: the
    card against the CPU twins on the first ``N_COMPARE`` events under
    ``compare_runs``' gates, then two ranges of the 2M events stitched by
    ``make_carry(..., seed=, ws_h=...)`` bitwise the full scan.  And
    ``process_event_slice`` on the first production slice in time order
    bitwise the staged call un-permuted.  Returns the no-op times of B1
    and B2."""
    import dataclasses

    import numpy as np
    import torch

    from better_flow_tpu_torch.core.events import bounding_box, make_slice
    from better_flow_tpu_torch.core.model import MotionModel
    from better_flow_tpu_torch.models import global_flow as gf
    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.ops.layout import (
        ST_CONT, pack_act, prepare_chunk_layouts, sort_key_blocks,
    )
    from better_flow_tpu_torch.runtime import scan_pipeline as sp

    t_phase = time.perf_counter()
    opt = cfg.optimizer
    H, W = gf.static_image_shape(opt.scale, cfg.sensor)
    stat, act, pr, st, geo = (scan_inputs[k] for k in (
        "stat", "act", "pr", "st", "geo"))
    kw = dict(scale=opt.scale, H=H, W=W, time_lo=opt.splat_time_lo)
    fin = dict(scale=opt.scale, H=H, W=W, **gf.finish_statics(opt))

    # The kernels: predicated on the live state is the unpredicated pair.
    live = fm.warp_images_st_call(stat, act, pr, st, geo,
                                  *fm.image_pair(dev, H, W), **kw)
    live_p = fm.warp_images_st_call(stat, act, pr, st, geo,
                                    *fm.image_pair(dev, H, W), predicated=1,
                                    **kw)
    same = all(torch.equal(a, b) for a, b in zip(live, live_p))
    st_a = fm.megastep_finish_call(*live[1:], st, geo, **fin)
    st_b = fm.megastep_finish_call(*live_p[1:], st, geo, predicated=1, **fin)
    if not (same and torch.equal(st_a, st_b)) or live_p[2].any():
        raise AssertionError("predicated B1/B2 on a live state differ from "
                             "the unpredicated kernels")
    # ... and on a converged state a pass-through, as the twins.
    done = st.clone()
    done[0, ST_CONT] = 0.0
    pair = fm.image_pair(dev, H, W)
    npr, at, ac = fm.warp_images_st_call(stat, act, pr, done, geo, *pair,
                                         predicated=1, **kw)
    st_out = fm.megastep_finish_call(at, ac, done, geo, predicated=1, **fin)
    npr_t, _, _ = fm.warp_images_st_plain(stat, act, pr, done, geo,
                                          *fm.image_pair(dev, H, W),
                                          predicated=1, **kw)
    st_t = fm.megastep_finish_plain(*fm.image_pair(dev, H, W), done, geo,
                                    predicated=1, **fin)
    if not (torch.equal(npr, pr) and torch.equal(st_out, done)
            and torch.equal(npr_t, pr) and torch.equal(st_t, done)) \
            or at.any() or ac.any():
        raise AssertionError("predicated B1/B2 on a converged state are not "
                             "a pass-through")
    b1 = lambda: fm.warp_images_st_call(stat, act, pr, done, geo, *pair,
                                        predicated=1, **kw)
    b2 = lambda: fm.megastep_finish_call(*pair, done, geo, predicated=1,
                                         **fin)
    noop = dict(
        warp_images_st=dict(noop_ms=timed(b1), noop_bound_ms=bound(
            nbytes(pr, done, npr), 0)["bound_ms"]),
        megastep_finish=dict(noop_ms=timed(b2), noop_bound_ms=bound(
            nbytes(done, st_out), 0)["bound_ms"]))
    log(f"[options] predicated B1/B2: bitwise the unpredicated kernels on "
        f"the live state; a pass-through on a converged state (new_pr = pr, "
        f"state copied, pair zero), as their twins; no-op B1 "
        f"{noop['warp_images_st']['noop_ms']:.4f} ms (bound "
        f"{noop['warp_images_st']['noop_bound_ms']:.5f}), B2 "
        f"{noop['megastep_finish']['noop_ms']:.4f} ms")

    # The unrolled drive on the 2M events.
    with_opt = lambda **o: dataclasses.replace(
        cfg, optimizer=dataclasses.replace(opt, **o))
    scan = lambda c: sp.compensate_recording_scan(None, None, None, c,
                                                  prepared=prep)
    s1 = r1["stats"]["host_syncs"]
    for u in (2, 4):
        cu = with_opt(megastep_unroll=u)
        scan(cu)                                       # warm-up
        fm.reset_launches()
        ru = scan(cu)
        lc = dict(fm.LAUNCHES)
        same_outputs(f"megastep_unroll={u}", ru, r1)
        su = ru["stats"]["host_syncs"]
        reads = count_syncs_in(gf, "run_fused_mega", lambda: scan(cu))
        if reads != su or su >= s1:
            raise AssertionError(f"megastep_unroll={u}: host_syncs {su}, "
                                 f"reads taken {reads}, unroll 1's {s1}")
        if lc["warp_images_st"] != u * su or lc["megastep_finish"] != u * su:
            raise AssertionError(f"megastep_unroll={u}: launches {lc}")
        log(f"[options] fast(megastep_unroll={u}) scan: bitwise unroll 1 "
            f"(u, v, noise, iterations); host_syncs {su} (reads taken in "
            f"the drive {reads}; unroll 1: {s1}); run_s "
            f"{ru['stats']['run_s']:.4f} (unroll 1: "
            f"{r1['stats']['run_s']:.4f}); launches {json.dumps(lc)}")
    runs = {1: [], 2: [], 4: []}
    for u in (1, 2, 4, 4, 2, 1):
        runs[u].append(scan(with_opt(megastep_unroll=u))["stats"]["run_s"])
    log(f"[options] run_s in turns (1, 2, 4, 4, 2, 1): {json.dumps(runs)}")

    # The extrapolated warm start: card against the CPU twins ...
    wcfg = with_opt(warm_extrapolate=1.0)
    m = N_COMPARE
    part = {k: d[k][:m] for k in ("x", "y", "t_ns")}
    rg = sp.compensate_recording_scan(part["x"], part["y"], part["t_ns"],
                                      wcfg, device=dev)
    rc = sp.compensate_recording_scan(part["x"], part["y"], part["t_ns"],
                                      wcfg, device="cpu")
    gates = compare_runs(rg, rc, d, m)
    fm.reset_launches()
    full = scan(wcfg)
    lc = dict(fm.LAUNCHES)
    log(f"[options] fast(warm_extrapolate=1.0): card against the CPU twins "
        f"on {m} events {json.dumps(gates)}; 2M scan mean_iters "
        f"{full['stats']['mean_iters']:.4f} (plain warm start "
        f"{r1['stats']['mean_iters']:.4f}), run_s "
        f"{full['stats']['run_s']:.4f}, launches {json.dumps(lc)}")
    # ... and two ranges stitched through the hand-off seed.
    S = len(prep["plan"].ends)
    mid = S // 2
    stage = lambda lo, hi: sp.prepare_recording(
        d["x"], d["y"], d["t_ns"], wcfg, slice_range=(lo, hi), device=dev)
    p0, p1 = stage(0, mid), stage(mid, S)
    r0 = sp.compensate_recording_scan(None, None, None, wcfg, prepared=p0)
    ws_h, st_h, en_h = p1["hist0"]
    carry = sp.make_carry(r0["carry"][0], p1["hist_k"], seed=r0["carry"][1],
                          ws_h=ws_h, st_h=st_h, en_h=en_h)
    rr = sp.compensate_recording_scan(None, None, None, wcfg, prepared=p1,
                                      carry_in=carry)
    cut = p1["prev_end"] + 1
    stitched = {k: np.concatenate([r0[k][:cut], rr[k][cut:]])
                for k in ("u", "v", "noise")}
    stitched["iters"] = np.concatenate([r0["iters"], rr["iters"]])
    same_outputs("two ranges stitched by make_carry(seed=)", stitched, full)
    log(f"[options] two ranges ({mid} + {S - mid} slices) stitched by "
        f"make_carry(..., seed=carry[1], ws_h=...): bitwise the full "
        f"extrapolated scan")

    # The flat-slice form on the first production slice, in time order.
    plan = prep["plan"]
    a, b = int(plan.starts[0]), int(plan.ends[0]) + 1
    t_loc = (d["t_ns"][a:b] - plan.slice_start_ns[0]).astype(np.float32)
    ev = make_slice(d["x"][a:b], d["y"][a:b], t_loc, device=dev)
    n = b - a
    fm.reset_launches()
    res = gf.process_event_slice(ev, MotionModel.zero(dev), opt, cfg.sensor)
    lc = dict(fm.LAUNCHES)
    order = torch.argsort(sort_key_blocks(ev.x, ev.y, ev.valid), stable=True)
    sev = type(ev)(*(f[order] for f in ev))
    staged, _ = gf.process_slice(
        prepare_chunk_layouts(sev.x, sev.y, sev.t), pack_act(sev.active),
        MotionModel.zero(dev), opt, cfg.sensor, bounding_box(sev), n, ev=sev)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    for f in ("u", "v", "noise", "pr_x", "pr_y"):
        if not torch.equal(getattr(res, f), getattr(staged, f)[:n][inv]):
            raise AssertionError(f"process_event_slice differs from the "
                                 f"staged call in {f}")
    if res.iters != staged.iters or not res.ran or lc["warp_uv"] != 1 or \
            lc["warp_images_st"] != res.iters:
        raise AssertionError(f"process_event_slice: {res.iters} iterations "
                             f"(staged {staged.iters}), launches {lc}")
    log(f"[options] process_event_slice on the first production slice "
        f"({n} events in time order): bitwise the staged call un-permuted, "
        f"{res.iters} iterations, launches {json.dumps(lc)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return noop


def check_outputs(r, n):
    import numpy as np

    for k in ("u", "v", "noise"):
        if r[k].shape != (n,):
            raise AssertionError(f"{k}: shape {r[k].shape}, expected ({n},)")
    if not (np.isfinite(r["u"]).all() and np.isfinite(r["v"]).all()):
        raise AssertionError("non-finite flow")
    if r["noise"].all() or not r["ran"].any():
        raise AssertionError("no slice ran")


def compare_runs(a, b, d, n):
    """The scan gates of tests/test_torch_scan.py: ``a`` against the
    reference run ``b`` on the first ``n`` events with ground truth."""
    import numpy as np

    if not np.array_equal(a["noise"], b["noise"]):
        raise AssertionError("noise flags differ")
    if not np.array_equal(a["ran"], b["ran"]):
        raise AssertionError("ran flags differ")
    eq = float(np.mean(a["iters"] == b["iters"]))
    sa, sb = int(a["iters"].sum()), int(b["iters"].sum())
    if eq < 0.9 or abs(sa - sb) > 0.1 * sb:
        raise AssertionError(f"iterations: {eq:.2f} of slices equal, sums "
                             f"{sa} vs {sb}")
    ok = ~b["noise"]
    speed = float(np.hypot(b["u"][ok], b["v"][ok]).mean())
    du = float(np.median(np.abs(a["u"][ok] - b["u"][ok])))
    dv = float(np.median(np.abs(a["v"][ok] - b["v"][ok])))
    if du >= 0.01 * speed or dv >= 0.01 * speed:
        raise AssertionError(f"median |du|, |dv| = {du}, {dv} vs speed "
                             f"{speed}")
    aee = lambda r: float(np.median(np.hypot(r["u"][ok] - d["u"][:n][ok],
                                             r["v"][ok] - d["v"][:n][ok])))
    if aee(a) > 1.05 * aee(b):
        raise AssertionError(f"AEE {aee(a)} > 1.05 x {aee(b)}")
    return dict(iters_equal=eq, iters_sum=(sa, sb), median_du=du,
                median_dv=dv, speed=speed, aee=(aee(a), aee(b)))


def same_outputs(label, a, b, keys=("u", "v", "noise", "iters")):
    import numpy as np

    for k in keys:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{label}: {k} differs")


def within_f16(label, comp, exact):
    """``comp``'s u and v within f16 rounding of ``exact``'s, noise
    identical."""
    import numpy as np

    same_outputs(label, comp, exact, keys=("noise", "iters"))
    for k in ("u", "v"):
        err = np.abs(comp[k] - exact[k]) - (2.0 ** -11 * np.abs(exact[k])
                                            + 2.0 ** -25)
        if not (err <= 0).all():
            raise AssertionError(f"{label}: {k} beyond f16 rounding by "
                                 f"{float(err.max())}")


# ------------------------------------------------------------ [quality]

# tools/sweep_exit.py's scenes (:39-54) and seeds (:65-69): the gate scenes
# of tests/test_fast_schedule.py, each at four more seeds.
SCENE_SEEDS = {
    "production": (42, 101, 202, 303, 404),
    "rotdiv": (777, 11, 23, 57, 91),
    "noisy": (31, 7, 99, 11, 5),
}
QUALITY_PRESETS = ("reference", "fast", "fast_accurate", "fast_throughput")
# BASELINE.md:360: fast()'s AEE ratio, seed mean / max, on the JAX
# package's XLA branch.
BASELINE_FAST = {"production": (1.012, 1.021), "rotdiv": (1.033, 1.155),
                 "noisy": (1.058, 1.175)}
# The gates that the JAX package's own kernel path (Pallas in interpret
# mode on the CPU) misses on its gate stream.  On the kernel route the CPU
# tests hold the port to the larger of the gate and that path's ratio
# (tests/test_torch_fast_gates.py); the card prints them MET or NOT MET.
SHARED_MISSES = ("112 fast AEE", "112 fast_accurate AEE")


def quality_opt(cls, preset, **kw):
    """``preset`` ("reference", "fast", "fast6": fast() at
    exit_grad_factor 6, "fast_accurate", "fast_throughput") built from
    ``cls``, either package's OptimizerConfig."""
    if preset == "reference":
        return cls(schedule="reference", **kw)
    if preset == "fast6":
        return cls.fast(exit_grad_factor=6.0, **kw)
    return getattr(cls, preset)(**kw)


def quality_runner(scan, pipeline_cls, opt_cls, scene, **opt_kw):
    """``run(name, seed, preset)``: ``scan(d, cfg)`` on the events of
    ``scene(name, seed)`` under ``pipeline_cls(optimizer=quality_opt(
    opt_cls, preset, **opt_kw))``, each run once and kept in ``run.runs``
    by (name, seed, preset)."""
    runs = {}

    def run(name, seed, preset):
        if (name, seed, preset) not in runs:
            d, _ = scene(name, seed)
            runs[name, seed, preset] = scan(d, pipeline_cls(
                optimizer=quality_opt(opt_cls, preset, **opt_kw)))
        return runs[name, seed, preset]
    run.runs = runs
    return run


def gate_scene(name, seed):
    """tools/sweep_exit.py's scene ``name`` at ``seed``: the events and the
    mask of the events whose error counts (the noisy stream's signal
    events; None elsewhere)."""
    from better_flow_tpu_torch.io.dvs_sim import dvs_events
    from better_flow_tpu_torch.io.synthetic import synthetic_events

    if name == "production":
        return synthetic_events(200_000, duration_s=0.2, res_x=180,
                                res_y=240, vx=60.0, vy=-40.0, rot=0.12,
                                div=0.05, n_points=800, seed=seed), None
    if name == "rotdiv":
        return synthetic_events(150_000, duration_s=0.2, res_x=180,
                                res_y=240, vx=10.0, vy=8.0, rot=0.6,
                                div=0.12, n_points=600, seed=seed), None
    if name == "noisy":
        d = dvs_events(120_000, duration_s=0.25, res_x=180, res_y=240,
                       vx=45.0, vy=-30.0, rot=0.1, div=0.04, seed=seed)
        return d, ~d["is_noise"]
    raise ValueError(name)


def aee_med(out, d, mask=None):
    """The median endpoint error of the events not flagged noise (and in
    ``mask``), tests/test_fast_schedule.py's ``_aee_med``."""
    import numpy as np

    m = ~out["noise"]
    if mask is not None:
        m = m & mask
    return float(np.median(np.hypot(out["u"][m] - d["u"][m],
                                    out["v"][m] - d["v"][m])))


def gate(label, value, limit, base=1.0, strict=False):
    """One gate: ``value <= limit * base`` (``<`` when ``strict``)."""
    return dict(label=label, value=value, limit=limit, base=base,
                strict=strict)


def gate_held(g, limit=None):
    """Whether ``g`` holds at its own limit or at ``limit``."""
    bound = (g["limit"] if limit is None else limit) * g["base"]
    return g["value"] < bound if g["strict"] else g["value"] <= bound


def gates_29(run, scene):
    """test_fast_schedule.py:29: fast() against the reference schedule on
    the production scene, seed 42.  ``run(name, seed, preset)`` is the
    scan's output and ``scene(name, seed)`` ``gate_scene``'s, both cached
    by the caller."""
    import numpy as np

    d, _ = scene("production", 42)
    ref, fast = (run("production", 42, p) for p in ("reference", "fast"))
    ok = ~(ref["noise"] | fast["noise"])
    speed = float(np.hypot(ref["u"][ok], ref["v"][ok]).mean())
    return [
        gate("29 median |du|",
             float(np.median(np.abs(fast["u"][ok] - ref["u"][ok]))), 0.01,
             speed, strict=True),
        gate("29 median |dv|",
             float(np.median(np.abs(fast["v"][ok] - ref["v"][ok]))), 0.01,
             speed, strict=True),
        gate("29 fast AEE", aee_med(fast, d), 1.02, aee_med(ref, d)),
        gate("29 fast iterations", int(fast["iters"].sum()), 0.7,
             int(ref["iters"].sum())),
    ]


def gates_93(run, scene):
    """test_fast_schedule.py:93: fast() on the rotdiv scene, seed 777."""
    d, _ = scene("rotdiv", 777)
    ref, fast = (run("rotdiv", 777, p) for p in ("reference", "fast"))
    return [gate("93 fast AEE", aee_med(fast, d), 1.05, aee_med(ref, d)),
            gate("93 fast iterations", int(fast["iters"].sum()), 1.0,
                 int(ref["iters"].sum()))]


def gates_112(run, scene):
    """test_fast_schedule.py:112: fast() and fast_accurate() on the noisy
    dvs_sim stream, seed 31, the error over its signal events."""
    d, sig = scene("noisy", 31)
    ref, fast, acc = (run("noisy", 31, p)
                      for p in ("reference", "fast", "fast_accurate"))
    a_r, it_r = aee_med(ref, d, sig), int(ref["iters"].sum())
    return [gate("112 fast AEE", aee_med(fast, d, sig), 1.2, a_r),
            gate("112 fast_accurate AEE", aee_med(acc, d, sig), 1.02, a_r),
            gate("112 fast iterations", int(fast["iters"].sum()), 1.0, it_r),
            gate("112 fast_accurate iterations", int(acc["iters"].sum()),
                 0.7, it_r)]


def gates_141(run, scene):
    """test_fast_schedule.py:141: the rotdiv margin canary, fast() at
    exit_grad_factor 4 and 6, seed 777."""
    d, _ = scene("rotdiv", 777)
    a_r = aee_med(run("rotdiv", 777, "reference"), d)
    return [gate("141 factor-4 AEE", aee_med(run("rotdiv", 777, "fast"), d),
                 1.03, a_r),
            gate("141 factor-6 AEE",
                 aee_med(run("rotdiv", 777, "fast6"), d), 1.3, a_r)]


def gates_407(run, scene):
    """test_fast_schedule.py:407: fast_throughput() on the production
    scene at seeds 42, 101 and 202, and on the rotdiv scene, seed 777."""
    import numpy as np

    out, ratios, it_ft, it_f = [], [], 0, 0
    for seed in (42, 101, 202):
        d, _ = scene("production", seed)
        ft = run("production", seed, "fast_throughput")
        r = aee_med(ft, d) / aee_med(run("production", seed, "reference"), d)
        ratios.append(r)
        out.append(gate(f"407 seed {seed} fast_throughput AEE", r, 1.12))
        it_ft += int(ft["iters"].sum())
        it_f += int(run("production", seed, "fast")["iters"].sum())
    d, _ = scene("rotdiv", 777)
    return out + [
        gate("407 mean AEE ratio", float(np.mean(ratios)), 1.05),
        gate("407 iterations against fast()", it_ft, 0.9, it_f),
        gate("407 rotdiv fast_throughput AEE",
             aee_med(run("rotdiv", 777, "fast_throughput"), d), 1.5,
             aee_med(run("rotdiv", 777, "reference"), d)),
    ]


FAST_GATES = {29: gates_29, 93: gates_93, 112: gates_112, 141: gates_141,
              407: gates_407}


def phase_quality(dev):
    """``[quality]``: the fast schedule's quality on the card's kernels.
    (a) tools/sweep_exit.py's sweep, 3 scenes x 5 seeds under the four
    ``QUALITY_PRESETS``: per scene and preset the seed mean and max of the
    AEE ratio against the reference schedule and of the iteration
    fraction; (b) the gates of tests/test_fast_schedule.py at their own
    seeds (``FAST_GATES``), raising on any but ``SHARED_MISSES``, which are
    printed MET or NOT MET; (c) every gate run against the CPU twins' run
    (noise identical, >= 90% of slices with equal iterations), both ratios
    printed; (d) each run's launches: B3 once and B4 once a slice that
    ran, B1 and B2 under the fast presets, B5 under the reference
    schedule."""
    import numpy as np

    from better_flow_tpu_torch.config import OptimizerConfig, PipelineConfig
    from better_flow_tpu_torch.runtime.scan_pipeline import (
        compensate_recording_scan,
    )

    t_phase = time.perf_counter()
    scene = functools.lru_cache(maxsize=None)(gate_scene)

    def runner(device):
        return quality_runner(
            lambda d, cfg: compensate_recording_scan(
                d["x"], d["y"], d["t_ns"], cfg, device=device),
            PipelineConfig, OptimizerConfig, scene)

    card = runner(dev)
    card_runs = card.runs
    rows = []
    for name, seeds in SCENE_SEEDS.items():
        for seed in seeds:
            d, mask = scene(name, seed)
            ref = card(name, seed, "reference")
            a_r, it_r = aee_med(ref, d, mask), int(ref["iters"].sum())
            for preset in QUALITY_PRESETS:
                r = card(name, seed, preset)
                it = int(r["iters"].sum())
                rows.append(dict(scene=name, seed=seed, preset=preset,
                                 ratio=aee_med(r, d, mask) / a_r, iters=it,
                                 iterfrac=it / it_r))
    t_sweep = time.perf_counter() - t_phase
    for name in SCENE_SEEDS:
        for preset in QUALITY_PRESETS:
            rs = [r for r in rows if r["scene"] == name
                  and r["preset"] == preset]
            ratio = [r["ratio"] for r in rs]
            frac = [r["iterfrac"] for r in rs]
            base = (f"; BASELINE.md:360 (JAX, XLA branch): "
                    f"{BASELINE_FAST[name][0]} / {BASELINE_FAST[name][1]}"
                    if preset == "fast" else "")
            log(f"[quality] sweep {name} {preset}: AEE ratio mean "
                f"{np.mean(ratio):.4f} max {max(ratio):.4f}, iteration "
                f"fraction mean {np.mean(frac):.4f} max {max(frac):.4f} "
                f"(seeds {[r['seed'] for r in rs]}: ratios "
                f"{[round(x, 4) for x in ratio]}, iterations "
                f"{[r['iters'] for r in rs]}){base}")
    log(f"[quality] sweep: {len(card_runs)} scans on the card in "
        f"{t_sweep:.1f} s")

    t0 = time.perf_counter()
    cpu = runner("cpu")
    cpu_runs = cpu.runs
    verdict = []
    for gates_of in FAST_GATES.values():
        for g, c in zip(gates_of(card, scene), gates_of(cpu, scene)):
            met = gate_held(g)
            log(f"[quality] gate {g['label']}: card "
                f"{g['value'] / g['base']:.4f}, CPU twins "
                f"{c['value'] / c['base']:.4f}, limit "
                f"{g['limit']} ({'<' if g['strict'] else '<='}): "
                f"{'MET' if met else 'NOT MET'}"
                + (" (shared with the JAX kernel path, not in the verdict)"
                   if g["label"] in SHARED_MISSES else ""))
            if not met and g["label"] not in SHARED_MISSES:
                verdict.append(g["label"])
    for key, c in cpu_runs.items():
        g = card_runs[key]
        if not np.array_equal(g["noise"], c["noise"]):
            raise AssertionError(f"[quality] {key}: card and CPU noise "
                                 f"flags differ")
        eq = float(np.mean(g["iters"] == c["iters"]))
        bitwise = all(np.array_equal(g[k], c[k]) for k in ("u", "v", "iters"))
        log(f"[quality] card against CPU twins {key}: noise identical, "
            f"{eq:.3f} of {len(g['iters'])} slices with equal iterations"
            f"{', u and v bitwise' if bitwise else ''}")
        if eq < 0.9:
            raise AssertionError(f"[quality] {key}: iterations "
                                 f"{g['iters'].tolist()} on the card, "
                                 f"{c['iters'].tolist()} on the CPU")
    if verdict:
        raise AssertionError(f"[quality] gates not met: {verdict}")
    log(f"[quality] gates and CPU twins ({len(cpu_runs)} scans): "
        f"{time.perf_counter() - t0:.1f} s")

    fast_kernels = ("warp_images_st", "megastep_finish")
    for key, r in card_runs.items():
        lc, ran = r["stats"]["launches"], int(r["ran"].sum())
        want = ("megastep",) if key[2] == "reference" else fast_kernels
        other = fast_kernels if key[2] == "reference" else ("megastep",)
        if (lc["act_rows"] != 1 or lc["warp_uv"] != ran
                or any(lc[k] <= 0 for k in want)
                or any(lc[k] for k in other)):
            raise AssertionError(f"[quality] {key}: launches {lc}, "
                                 f"{ran} slices ran")
    log(f"[quality] launches: B3 once and B4 once a slice that ran in each "
        f"of {len(card_runs)} scans, B1 and B2 under the fast presets, B5 "
        f"under the reference schedule; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


def phase_cold(d, cfg, r1, dev, n_cold=N_COLD):
    """The cold path, ``compensate_recording_cold``, on the stream of
    ``[main]``: four batches bitwise the scan ``r1`` with B3 launched once a
    batch and B4 once a slice that ran; ``compact_results`` within f16
    rounding and its bytes those of ``pack_results`` of the exact run; a
    run killed while staging its third batch and resumed from its
    checkpoint, bitwise the uninterrupted one, exact and compact; the
    scan routed to the cold path under a tiny ``BF_SCAN_DEVICE_BUDGET_GB``,
    bitwise ``r1``.  Then bench.py's cold protocol on ``n_cold`` events
    (a warm-up call, then the measured one, both compact): events/s, each
    batch's staging, run and fetch time, their overlap, and the peak
    device memory of the cold run and of the scan of the same events."""
    import tempfile

    import numpy as np
    import torch

    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.runtime import scan_pipeline as sp

    t_phase = time.perf_counter()
    n = len(d["x"])

    def cold(dd, **kw):
        return sp.compensate_recording_cold(dd["x"], dd["y"], dd["t_ns"], cfg,
                                            device=dev, **kw)

    fm.reset_launches()
    exact = cold(d, n_batch=4)
    launches = dict(fm.LAUNCHES)
    same_outputs("cold", exact, r1)
    ran = int(r1["ran"].sum())
    if launches["act_rows"] != 4 or launches["warp_uv"] != ran or \
            launches["warp_images_st"] <= 0 or \
            launches["megastep_finish"] <= 0 or \
            launches != exact["stats"]["launches"]:
        raise AssertionError(f"cold launches {launches} (act_rows 4, "
                             f"warp_uv {ran} expected)")
    log(f"[cold] {n} events, 4 batches: bitwise the scan; launches "
        f"{json.dumps(launches)}; total_s {exact['stats']['total_s']:.4f}")

    comp = cold(d, n_batch=4, compact_results=True)
    within_f16("cold compact", comp, exact)
    put = lambda r: [torch.from_numpy(r[k]).to(dev)
                     for k in ("u", "v", "noise")]
    if not torch.equal(sp.pack_results(*put(comp)),
                       sp.pack_results(*put(exact))):
        raise AssertionError("cold compact: packed bytes differ")
    log("[cold] compact: noise identical, u and v within f16 rounding, "
        "packed bytes equal")

    orig = sp.prepare_recording
    calls = []

    def dying_prepare(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("simulated kill")
        return orig(*a, **k)

    with tempfile.TemporaryDirectory() as tmp:
        for compact, clean in ((False, exact), (True, comp)):
            ckpt = os.path.join(tmp, f"cold{int(compact)}.npz")
            calls.clear()
            sp.prepare_recording = dying_prepare
            try:
                cold(d, n_batch=4, checkpoint_path=ckpt,
                     compact_results=compact)
                raise AssertionError("the killed run did not raise")
            except RuntimeError as e:
                if str(e) != "simulated kill":
                    raise
            finally:
                sp.prepare_recording = orig
            resumed = cold(d, n_batch=4, checkpoint_path=ckpt, resume=True,
                           compact_results=compact)
            if resumed["stats"]["resumed_batches"] != 1:
                raise AssertionError(f"resumed after "
                                     f"{resumed['stats']['resumed_batches']}"
                                     " batches, expected 1")
            same_outputs(f"cold resume (compact={compact})", resumed, clean)
    log("[cold] killed while staging batch 3, resumed after batch 1: "
        "bitwise, exact and compact")

    old = os.environ.get("BF_SCAN_DEVICE_BUDGET_GB")
    os.environ["BF_SCAN_DEVICE_BUDGET_GB"] = "0.001"
    try:
        routed = sp.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                              device=dev)
    finally:
        if old is None:
            del os.environ["BF_SCAN_DEVICE_BUDGET_GB"]
        else:
            os.environ["BF_SCAN_DEVICE_BUDGET_GB"] = old
    if routed["stats"].get("routed_cold") is not True:
        raise AssertionError("the scan was not routed to the cold path")
    same_outputs("routed scan", routed, r1)
    log(f"[cold] routed scan: {routed['stats']['n_batches']} batches, "
        f"est_device_gb {routed['stats']['est_device_gb']}, bitwise the scan")

    dc = bench_stream(n_cold)
    cold(dc, compact_results=True)   # warm-up
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rc = cold(dc, compact_results=True)
    peak_cold = torch.cuda.max_memory_allocated(dev) - base
    st = rc["stats"]
    torch.cuda.reset_peak_memory_stats(dev)
    rs = sp.compensate_recording_scan(dc["x"], dc["y"], dc["t_ns"], cfg,
                                      device=dev)
    peak_scan = torch.cuda.max_memory_allocated(dev) - base
    check_outputs(rs, len(dc["x"]))
    within_f16("cold 12M compact", rc, rs)
    phases = sum(b["stage_s"] + b["run_s"] + b["fetch_s"]
                 for b in st["batches"])
    log(f"[cold] bench protocol, {len(dc['x'])} events, compact: "
        f"total_s {st['total_s']:.4f}  events/s {st['events_per_s']:.1f}  "
        f"n_slices {st['n_slices']}  n_batches {st['n_batches']}  "
        f"mean_iters {st['mean_iters']:.4f}  host_syncs {st['host_syncs']}")
    for b, ph in enumerate(st["batches"]):
        log(f"[cold] batch {b}: stage_s {ph['stage_s']:.4f}  run_s "
            f"{ph['run_s']:.4f}  fetch_s {ph['fetch_s']:.4f}")
    log(f"[cold] overlap (phases {phases:.4f} s - total_s) / phases = "
        f"{(phases - st['total_s']) / phases:.4f}")
    log(f"[cold] peak device memory over {base} B resident: cold "
        f"{peak_cold} B, scan {peak_scan} B ({peak_cold / peak_scan:.4f}); "
        f"scan run_s {rs['stats']['run_s']:.4f} plan_s "
        f"{rs['stats']['plan_s']:.4f}")
    if not peak_cold < peak_scan:
        raise AssertionError(f"cold peak {peak_cold} B not below the scan's "
                             f"{peak_scan} B")
    log(f"[cold] phase {time.perf_counter() - t_phase:.1f} s")


def subpixel_stream(d, res=(180, 240), seed=7):
    """``d`` with seeded uniform [0, 1) offsets on x and y, clipped inside
    the sensor: a rectified stream's sub-pixel float64 coordinates."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = dict(d)
    for k, r in zip(("x", "y"), res):
        out[k] = np.clip(d[k] + rng.uniform(0, 1, len(d[k])), 0,
                         np.nextafter(r, 0))
    return out


def scan_launches(label, r, lc):
    """The scan's kernels on the megastep drive: B3 once for the staged
    range, B1 and B2 once an iteration, B4 once a slice that ran."""
    total, ran = int(r["iters"].sum()), int(r["ran"].sum())
    want = dict.fromkeys(lc, 0)
    want.update(act_rows=1, warp_images_st=total, megastep_finish=total,
                warp_uv=ran)
    if lc != want or total <= 0:
        raise AssertionError(f"{label}: launches {lc}, expected {want}")


def phase_staging(d, cfg, prep_native, dev):
    """The numpy staging route (``materialize_slices``) on the card: the
    ``fast()`` scan of the bench stream with sub-pixel coordinates (B3,
    B1, B2, B4 launched and counted, a repeat bitwise, against the CPU
    twins on the first N_COMPARE events under the scan gates, ``plan_s``
    beside the native route's); the integer stream at ``max_events``
    100,000 against its CPU twins on its first slices; then on the
    sub-pixel stream the cold path in four batches (exact and
    ``compact_results``) and the four-shard scan resident on the card, each
    bitwise the scan, and the CLI's ``--scan -o`` on a sub-pixel text
    file.  It also checks that the main path's staging ``prep_native``
    took the native route."""
    import dataclasses
    import tempfile

    import numpy as np

    from better_flow_tpu_torch.cli.motion_compensator import (
        build_parser, config_from_args,
    )
    from better_flow_tpu_torch.io.event_file import (
        read_events, write_events_uv,
    )
    from better_flow_tpu_torch.ops import _build, fused_model as fm
    from better_flow_tpu_torch.parallel.event_parallel import (
        compensate_recording_scan_sharded,
    )
    from better_flow_tpu_torch.parallel.mesh import make_event_mesh
    from better_flow_tpu_torch.runtime import scan_pipeline as sp

    t_phase = time.perf_counter()
    bd = prep_native["plan_breakdown"]
    if not prep_native["compact"] or "native_sort" not in bd or \
            "numpy_staging" in bd:
        raise AssertionError(f"the main path's staging left the native "
                             f"route: {json.dumps(bd)}")
    ds = subpixel_stream(d)
    n = len(ds["x"])
    prep = sp.prepare_recording(ds["x"], ds["y"], ds["t_ns"], cfg,
                                device=dev)
    if prep["compact"] or "numpy_staging" not in prep["plan_breakdown"]:
        raise AssertionError("sub-pixel staging: not the numpy route: "
                             + json.dumps(prep["plan_breakdown"]))
    log(f"[staging] plan_s by route, {n} events: numpy (sub-pixel) "
        f"{prep['plan_s']:.4f} {json.dumps(prep['plan_breakdown'])}; native "
        f"(integer, [main]) {prep_native['plan_s']:.4f} {json.dumps(bd)}")
    fm.reset_launches()
    rs = sp.compensate_recording_scan(None, None, None, cfg, prepared=prep)
    lc = dict(fm.LAUNCHES)
    check_outputs(rs, n)
    scan_launches("sub-pixel scan", rs, lc)
    st = rs["stats"]
    log(f"[staging] sub-pixel scan: events/s {st['events_per_s']:.1f}  "
        f"run_s {st['run_s']:.4f}  n_slices {st['n_slices']}  mean_iters "
        f"{st['mean_iters']:.4f}; launches {json.dumps(lc)}")
    same_outputs("sub-pixel scan repeat", sp.compensate_recording_scan(
        None, None, None, cfg, prepared=prep), rs)
    m = N_COMPARE
    part = {k: ds[k][:m] for k in ("x", "y", "t_ns")}
    rg = sp.compensate_recording_scan(part["x"], part["y"], part["t_ns"],
                                      cfg, device=dev)
    rc = sp.compensate_recording_scan(part["x"], part["y"], part["t_ns"],
                                      cfg, device="cpu")
    log(f"[staging] sub-pixel scan repeat bitwise; card vs CPU twins on {m} "
        f"events: {json.dumps(compare_runs(rg, rc, ds, m))}")

    cfg_l = cfg.replace(slice=dataclasses.replace(cfg.slice,
                                                  max_events=100_000))
    prep_l = sp.prepare_recording(d["x"], d["y"], d["t_ns"], cfg_l,
                                  device=dev)
    if prep_l["compact"] or "numpy_staging" not in prep_l["plan_breakdown"]:
        raise AssertionError("max_events 100,000: not the numpy route")
    fm.reset_launches()
    rl = sp.compensate_recording_scan(None, None, None, cfg_l,
                                      prepared=prep_l)
    lc = dict(fm.LAUNCHES)
    check_outputs(rl, n)
    scan_launches("max_events 100,000", rl, lc)
    part = {k: d[k][:m] for k in ("x", "y", "t_ns")}
    rg = sp.compensate_recording_scan(part["x"], part["y"], part["t_ns"],
                                      cfg_l, device=dev)
    rc = sp.compensate_recording_scan(part["x"], part["y"], part["t_ns"],
                                      cfg_l, device="cpu")
    gates = compare_runs(rg, rc, d, m)
    log(f"[staging] max_events 100,000 ({prep_l['stat'].shape[1]} chunks a "
        f"slice): plan_s {prep_l['plan_s']:.4f}  run_s "
        f"{rl['stats']['run_s']:.4f}  n_slices {rl['stats']['n_slices']}  "
        f"mean_iters {rl['stats']['mean_iters']:.4f}; launches "
        f"{json.dumps(lc)}; card vs CPU twins on {m} events ("
        f"{len(rc['iters'])} slices): {json.dumps(gates)}")

    for compact in (False, True):
        fm.reset_launches()
        rcold = sp.compensate_recording_cold(
            ds["x"], ds["y"], ds["t_ns"], cfg, n_batch=4,
            compact_results=compact, device=dev)
        same_outputs(f"sub-pixel cold (compact_results={compact})", rcold, rs)
        if fm.LAUNCHES["act_rows"] != rcold["stats"]["n_batches"] or \
                fm.LAUNCHES["warp_uv"] != int(rs["ran"].sum()):
            raise AssertionError(f"sub-pixel cold: launches {fm.LAUNCHES}")
    log(f"[staging] sub-pixel cold, 4 batches, exact and compact_results: "
        f"bitwise the scan (sub-pixel batches stay f32); total_s "
        f"{rcold['stats']['total_s']:.4f}")
    mesh = make_event_mesh(4, device=dev)
    fm.reset_launches()
    r4 = compensate_recording_scan_sharded(ds["x"], ds["y"], ds["t_ns"], cfg,
                                           mesh)
    same_outputs("sub-pixel 4-shard scan", r4, rs,
                 keys=("u", "v", "noise", "iters", "ran"))
    scan_launches("sub-pixel 4-shard scan", r4, dict(fm.LAUNCHES))
    log(f"[staging] sub-pixel scan, 4 shards resident on the card: bitwise "
        f"the scan; run_s {r4['stats']['run_s']:.4f}  plan_s "
        f"{r4['stats']['plan_s']:.4f}")

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        rec = os.path.join(tmp, "rec.txt")
        with open(rec, "w") as f:   # t y x p, the reader swaps x and y
            f.writelines(f"{t:.9f} {y:.4f} {x:.4f} 1\n" for t, x, y in zip(
                ds["t_ns"][:m] / 1e9, ds["x"][:m], ds["y"][:m]))
        out_cli, out_lib = (os.path.join(tmp, f) for f in ("cli", "lib"))
        argv = [rec, "--scan", "--schedule", "fast", "-o", out_cli,
                "--device", dev.type]
        proc = subprocess.run(
            [sys.executable, "-m",
             "better_flow_tpu_torch.cli.motion_compensator", *argv],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI --scan on a sub-pixel file failed "
                                 f"({proc.returncode}):\n{proc.stderr}")
        r = read_events(rec)
        if not (r["x"] != np.floor(r["x"])).any():
            raise AssertionError("the sub-pixel file read back as integers")
        lib = sp.compensate_recording_scan(
            r["x"], r["y"], r["t_ns"],
            config_from_args(build_parser().parse_args(argv)), device=dev)
        write_events_uv(out_lib, r["x"], r["y"], r["t_ns"], lib["u"],
                        lib["v"])
        with open(out_cli, "rb") as a, open(out_lib, "rb") as b:
            if a.read() != b.read():
                raise AssertionError("CLI --scan on a sub-pixel file differs "
                                     "from write_events_uv of the scan")
    log(f"[staging] CLI --scan --schedule fast -o on a {m}-event sub-pixel "
        f"file: equal to the library call's; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


def stream_view(r):
    """The per-event and per-slice outputs of a streaming run."""
    import numpy as np

    acc, sl = r["accumulated"], r["engine"].slices
    iters = np.array([s.iters for s in sl])
    return dict(u=acc["u"], v=acc["v"], noise=acc["noise"],
                timestamp=acc["timestamp"], iters=iters, ran=iters > 0)


def phase_stream(d, dev):
    """The streaming path on the bench stream under both schedules, each
    run twice, and against the CPU twins on the first N_COMPARE events.
    Returns each schedule's launch counts of its first run."""
    import numpy as np

    from better_flow_tpu_torch.config import OptimizerConfig, PipelineConfig
    from better_flow_tpu_torch.ops import fused_model as fm
    from better_flow_tpu_torch.runtime.offline import compensate_recording

    n = len(d["x"])
    launches = {}
    for name, opt in (("reference", OptimizerConfig()),
                      ("fast", OptimizerConfig.fast())):
        cfg = PipelineConfig(optimizer=opt)
        t0 = time.perf_counter()
        fm.reset_launches()
        r1 = compensate_recording(d["x"], d["y"], d["t_ns"], cfg, device=dev)
        lc = dict(fm.LAUNCHES)
        v1 = stream_view(r1)
        if not (0.99 * n <= len(v1["u"]) <= n):
            raise AssertionError(f"stream {name}: {len(v1['u'])} merged "
                                 f"events of {n}")
        if not (np.isfinite(v1["u"]).all() and np.isfinite(v1["v"]).all()):
            raise AssertionError(f"stream {name}: non-finite flow")
        if v1["noise"].all() or not v1["ran"].any():
            raise AssertionError(f"stream {name}: no slice ran")
        total = int(v1["iters"].sum())
        path = (["megastep"] if name == "reference"
                else ["warp_images_st", "megastep_finish"])
        for k in ("megastep", "warp_images_st", "megastep_finish"):
            want = total if k in path else 0
            if lc[k] != want:
                raise AssertionError(f"stream {name}: {k} launched {lc[k]} "
                                     f"times, expected {want}")
        if lc["warp_uv"] != int(v1["ran"].sum()):
            raise AssertionError(f"stream {name}: warp_uv launches "
                                 f"{lc['warp_uv']}")
        st = r1["stats"]
        log(f"[stream] {name}: {n} events, {st['n_slices']} slices, "
            f"events/s {st['events_per_s']:.1f}  elapsed_s "
            f"{st['elapsed_s']:.4f}  mean_iters {st['mean_iters']:.4f}  "
            f"host_syncs {r1['engine'].host_syncs}  mean_slice_wall_s "
            f"{st['mean_slice_wall_s']:.6f}")
        log(f"[stream] {name}: launches {json.dumps(lc)}")
        r2 = compensate_recording(d["x"], d["y"], d["t_ns"], cfg, device=dev)
        v2 = stream_view(r2)
        for k in v1:
            if not np.array_equal(v1[k], v2[k]):
                raise AssertionError(f"stream {name}: repeated run differs "
                                     f"in {k}")
        log(f"[stream] {name}: second run bitwise identical; events/s "
            f"{r2['stats']['events_per_s']:.1f}")
        launches[name] = lc

        m = N_COMPARE
        part = {k: d[k][:m] for k in ("x", "y", "t_ns")}
        vg = stream_view(compensate_recording(part["x"], part["y"],
                                              part["t_ns"], cfg, device=dev))
        vc = stream_view(compensate_recording(part["x"], part["y"],
                                              part["t_ns"], cfg,
                                              device="cpu"))
        for k in ("noise", "iters", "timestamp"):
            if not np.array_equal(vg[k], vc[k]):
                raise AssertionError(f"stream {name}: card and CPU twins "
                                     f"differ in {k}")
        du = float(np.median(np.abs(vg["u"] - vc["u"])))
        dv = float(np.median(np.abs(vg["v"] - vc["v"])))
        if du != 0.0 or dv != 0.0:
            raise AssertionError(f"stream {name}: median |du|, |dv| = {du}, "
                                 f"{dv} against the CPU twins")
        log(f"[stream] {name}: card = CPU twins on {m} events ("
            f"{int(vg['iters'].sum())} iterations, median du = dv = 0); "
            f"phase {time.perf_counter() - t0:.1f} s")
    return launches


def phase_cli(d, dev):
    """The port's CLI with --bufferize-file -o on the card against
    write_events_uv of the library call."""
    import tempfile

    from better_flow_tpu_torch.cli.motion_compensator import (
        build_parser, config_from_args,
    )
    from better_flow_tpu_torch.io.event_file import (
        read_events, write_events, write_events_uv,
    )
    from better_flow_tpu_torch.ops import _build
    from better_flow_tpu_torch.runtime.offline import compensate_recording

    t0 = time.perf_counter()
    # Scratch files live in the checkout's git-ignored build directory.
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        rec = os.path.join(tmp, "rec.txt")
        m = N_COMPARE
        write_events(rec, d["x"][:m], d["y"][:m], d["t_ns"][:m])
        out_cli = os.path.join(tmp, "cli.txt")
        argv = [rec, "--bufferize-file", "-o", out_cli, "--device",
                dev.type]
        proc = subprocess.run(
            [sys.executable, "-m",
             "better_flow_tpu_torch.cli.motion_compensator", *argv],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI failed ({proc.returncode}):\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        r = read_events(rec)
        cfg = config_from_args(build_parser().parse_args(argv))
        acc = compensate_recording(r["x"], r["y"], r["t_ns"], cfg,
                                   device=dev)["accumulated"]
        out_lib = os.path.join(tmp, "lib.txt")
        write_events_uv(out_lib, acc["x"], acc["y"], acc["timestamp"],
                        acc["u"], acc["v"])
        with open(out_cli, "rb") as a, open(out_lib, "rb") as b:
            got, want = a.read(), b.read()
        if got != want:
            raise AssertionError("CLI output differs from write_events_uv of "
                                 "the library call")
        lines = got.count(b"\n")
    tail = [ln for ln in proc.stdout.splitlines() if ln.strip()][-2:]
    log(f"[cli] --bufferize-file -o on the card: {lines} lines, equal to the "
        f"library call's; {' | '.join(tail)}")
    cli_frames(d, dev)
    cli_manual(d, dev)
    log(f"[cli] phase {time.perf_counter() - t0:.1f} s")


def frames_in(path):
    """The frames of a video file, read back with OpenCV."""
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def cli_frames(d, dev, n=N_FRAMES):
    """The CLI's ``--img`` and ``--video`` (the stream under the reference
    schedule, B5 and B4, a HUD frame a slice) on the first ``n`` events, on
    the card and on the CPU twins: one frame a slice in each, the card's
    launches counted, the first frame equal to the CPU run's."""
    import tempfile

    import cv2
    import numpy as np

    from better_flow_tpu_torch.cli import motion_compensator as cli
    from better_flow_tpu_torch.io.event_file import write_events
    from better_flow_tpu_torch.ops import _build, fused_model as fm

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        rec = os.path.join(tmp, "rec.txt")
        write_events(rec, d["x"][:n], d["y"][:n], d["t_ns"][:n])
        runs = {}
        for label, where in (("card", dev.type), ("cpu", "cpu")):
            img = os.path.join(tmp, label)
            os.makedirs(img)
            video = os.path.join(tmp, f"{label}.mp4")
            fm.reset_launches()
            t = time.perf_counter()
            rc = cli.main([rec, "--img", "--img-prefix", img, "--video",
                           "--video-name", video, "--device", where,
                           "--quiet"])
            t = time.perf_counter() - t
            names = sorted(os.listdir(img))
            runs[label] = dict(rc=rc, lc=dict(fm.LAUNCHES), names=names,
                               video=frames_in(video), s=t,
                               first=cv2.imread(os.path.join(
                                   img, "frame_0.jpg")))
    g, c = runs["card"], runs["cpu"]
    want = [f"frame_{k}.jpg" for k in range(len(g["names"]))]
    if g["rc"] or c["rc"] or len(g["names"]) < 2 or \
            sorted(want) != g["names"] or g["names"] != c["names"] or \
            g["video"] != len(g["names"]) or c["video"] != len(c["names"]):
        raise AssertionError(
            f"--img/--video: rc {g['rc']}/{c['rc']}, frames "
            f"{len(g['names'])}/{len(c['names'])}, video frames "
            f"{g['video']}/{c['video']}")
    if g["lc"]["megastep"] <= 0 or g["lc"]["warp_uv"] <= 0:
        raise AssertionError(f"--img/--video on the card: launches {g['lc']}")
    if not np.array_equal(g["first"], c["first"]):
        raise AssertionError(
            f"--img: the card's first frame differs from the CPU's in "
            f"{int((g['first'] != c['first']).any(axis=2).sum())} pixels")
    log(f"[cli] --img --video on {n} events: {len(g['names'])} slices, a "
        f"frame each and a video of {g['video']} frames, card and CPU; the "
        f"first frame equal to the CPU run's; card launches "
        f"{json.dumps(g['lc'])}; s card {g['s']:.2f}, CPU {c['s']:.2f}")


def cli_manual(d, dev):
    """One manual-mode tick, then 'c' (``process_slice`` under the reference
    schedule: B5 and B4), then a tick, on the CLI's first slice window of
    the bench stream, on the card and on the CPU twins: the time images
    and views of the ticks, the iterations and the warp of 'c' equal."""
    import numpy as np

    from better_flow_tpu_torch.cli.manual_mode import (
        ManualSession, slider_deltas,
    )
    from better_flow_tpu_torch.config import SensorConfig
    from better_flow_tpu_torch.ops import fused_model as fm

    k = 50_000
    runs = {}
    for label, where in (("card", dev), ("cpu", "cpu")):
        t = time.perf_counter()
        sess = ManualSession(d["x"][:k], d["y"][:k],
                             d["t_ns"][:k] - d["t_ns"][0], SensorConfig(),
                             device=where)
        tick1 = sess.tick(slider_deltas((140, 120, 200, 60, 3)))
        views = sess.views()
        fm.reset_launches()
        res = sess.optimize()
        lc = dict(fm.LAUNCHES)
        warp = np.stack([sess.pr_x.cpu().numpy(), sess.pr_y.cpu().numpy()])
        tick2 = sess.tick(slider_deltas((127, 127, 127, 127, 500)))
        runs[label] = dict(
            ticks=(tick1.cpu().numpy(), tick2.cpu().numpy()), views=views,
            iters=res.iters, warp=warp, lc=lc, s=time.perf_counter() - t,
            totals=[float(getattr(sess.model, f)) for f in
                    ("total_dx", "total_dy", "total_rot", "total_div")])
    g, c = runs["card"], runs["cpu"]
    if g["lc"]["megastep"] != g["iters"] or g["lc"]["warp_uv"] != 1:
        raise AssertionError(f"manual 'c' on the card: launches {g['lc']}, "
                             f"{g['iters']} iterations")
    if not np.array_equal(g["ticks"][0], c["ticks"][0]) or any(
            not np.array_equal(a, b) for a, b in zip(g["views"],
                                                     c["views"])):
        raise AssertionError("manual tick: the card's time image or views "
                             "differ from the CPU's")
    if g["iters"] != c["iters"] or not np.array_equal(g["warp"], c["warp"]) \
            or g["totals"] != c["totals"] \
            or not np.array_equal(g["ticks"][1], c["ticks"][1]):
        raise AssertionError(
            f"manual 'c': card {g['iters']} iterations, totals "
            f"{g['totals']}; CPU {c['iters']}, {c['totals']}; max |warp "
            f"diff| {float(np.abs(g['warp'] - c['warp']).max())}")
    log(f"[cli] manual mode on {k} events: tick, 'c' ({g['iters']} "
        f"iterations; launches {json.dumps(g['lc'])}), tick: time images, "
        f"views, warp and totals bitwise the CPU's; s card {g['s']:.2f}, "
        f"CPU {c['s']:.2f}")


def two_object_scene(n_per_obj, seed=0, duration_s=0.1):
    """The two-object DAVIS 346x260 scene of
    ``tests/test_config3_local_field.py``: object A (left) at (+80, +30)
    px/s, object B (right) at (-80, -30), ``n_per_obj`` events each."""
    import numpy as np

    from better_flow_tpu_torch.io.synthetic import synthetic_events

    va, vb = (80.0, 30.0), (-80.0, -30.0)
    a = synthetic_events(n_per_obj, duration_s=duration_s, res_x=150,
                         res_y=220, vx=va[0], vy=va[1], n_points=150,
                         seed=seed, margin=0.2)
    b = synthetic_events(n_per_obj, duration_s=duration_s, res_x=150,
                         res_y=220, vx=vb[0], vy=vb[1], n_points=150,
                         seed=seed + 1, margin=0.2)
    x = np.concatenate([a["x"] + 10, b["x"] + 186])
    y = np.concatenate([a["y"] + 20, b["y"] + 20])
    t = np.concatenate([a["t_ns"], b["t_ns"]])
    order = np.argsort(t, kind="stable")
    return x[order], y[order], t[order], va, vb


def same_arrays(label, a, b, keys=None):
    """Bitwise equality of two dicts (or tuples) of arrays or tensors."""
    import numpy as np

    pairs = ([(k, a[k], b[k]) for k in (keys or a)] if isinstance(a, dict)
             else list(zip(keys, a, b)))
    for k, u, w in pairs:
        u = u.cpu().numpy() if hasattr(u, "cpu") else np.asarray(u)
        w = w.cpu().numpy() if hasattr(w, "cpu") else np.asarray(w)
        if u.shape != w.shape or u.dtype != w.dtype or \
                not np.array_equal(u, w):
            raise AssertionError(f"{label}: {k} differs")


def config3_gates(out, va, vb):
    """The AEE gates of ``tests/test_config3_local_field.py``; returns the
    two objects' median AEE."""
    import numpy as np

    gx, gy = out["grid_x"], out["grid_y"]
    u, v, n_ev = out["u"], out["v"], out["n_events"]
    in_a = (gx > 40) & (gx < 130) & (gy > 70) & (gy < 210) & (n_ev >= 200)
    in_b = (gx > 216) & (gx < 306) & (gy > 70) & (gy < 210) & (n_ev >= 200)
    speed = float(np.hypot(*va))
    aee_a = float(np.median(np.hypot(u[in_a] - va[0], v[in_a] - va[1])))
    aee_b = float(np.median(np.hypot(u[in_b] - vb[0], v[in_b] - vb[1])))
    if in_a.sum() < 3 or in_b.sum() < 3 or aee_a >= 0.25 * speed or \
            aee_b >= 0.25 * speed or not (np.median(u[in_a]) > 40
                                          and np.median(u[in_b]) < -40) \
            or not (out["u_dense"][85, 130] > 40
                    and out["u_dense"][261, 130] < -40):
        raise AssertionError(f"config-3 gates: AEE {aee_a}, {aee_b} px/s "
                             f"(limit {0.25 * speed}), windows "
                             f"{int(in_a.sum())}, {int(in_b.sum())}")
    return aee_a, aee_b


def phase_local(dev):
    """The dense local flow field (``models.local_flow``, BASELINE
    configuration 3, plain PyTorch): the config-3 test scene on the card
    bitwise the CPU run, under the test's AEE gates; then the full width,
    2 x 100,000 events on 346x260 with ``flow_field_grid``'s defaults (300
    windows): the time a call, rounds a scale and blocking reads a call,
    and the first 64 windows' three chained scales bitwise the CPU's."""
    import numpy as np
    import torch

    from better_flow_tpu_torch.models import local_flow as lf

    t_phase = time.perf_counter()
    x, y, t, va, vb = two_object_scene(15_000)
    kw = dict(step=32, wsz=31, k=3072, dense=True)
    g = lf.flow_field_grid(x, y, t, 346, 260, device=dev, **kw)
    same_arrays("[local] config-3 card vs CPU", g,
                lf.flow_field_grid(x, y, t, 346, 260, device="cpu", **kw))
    aee = config3_gates(g, va, vb)
    log(f"[local] config-3 scene ({len(x)} events, {g['u'].size} windows): "
        f"bitwise the CPU run; AEE A {aee[0]:.4f}, B {aee[1]:.4f} px/s")

    x, y, t, va, vb = two_object_scene(100_000)
    lf.flow_field_grid(x, y, t, 346, 260, device=dev)   # warm-up
    stats = []

    def call():
        stats.append({})
        return lf.flow_field_grid(x, y, t, 346, 260, device=dev,
                                  stats=stats[-1])

    times = wall_times(call, 5)
    out = call()
    G = out["u"].size
    if G != 300 or not (np.isfinite(out["u"]).all()
                        and np.isfinite(out["v"]).all()):
        raise AssertionError(f"[local] full width: {G} windows or "
                             "non-finite flow")
    cx, cy = (c.ravel()[:64].astype(np.float32)
              for c in (out["grid_x"], out["grid_y"]))
    f32 = lambda a: np.asarray(a, np.float32)
    chain = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        w = lf.gather_windows(f32(x), f32(y), f32(t), np.ones(len(x), bool),
                              cx, cy, 31, 1024, device=where)
        seed, res = (None, None), []
        for scale, dn0 in zip((1, 3, 3), (0.04, 0.02, 0.01)):
            r = lf.local_flow_field(w, scale, 31, init_nx=seed[0],
                                    init_ny=seed[1], dn0=dn0)
            seed = r[4], r[5]
            res.append(r)
        chain[str(where)] = (w, res, time.perf_counter() - t0)
    (wg, rg, _), (wc, rc, cpu_s) = chain[str(dev)], chain["cpu"]
    same_arrays("[local] 64 windows' gather", wg, wc, lf.LocalWindow._fields)
    names = ("u", "v", "n_events", "iters", "nx", "ny")
    for i, (a, b) in enumerate(zip(rg, rc)):
        same_arrays(f"[local] 64 windows, scale {i}", a, b, names)
    same_arrays("[local] 64 windows against the 300-window call",
                (rg[-1][0].cpu().numpy(), rg[-1][1].cpu().numpy()),
                (out["u"].ravel()[:64], out["v"].ravel()[:64]), ("u", "v"))
    ms = 1e3 * statistics.median(times)
    dev_ms, n_ops = device_time(
        lambda: lf.flow_field_grid(x, y, t, 346, 260, device=dev))
    log(f"[local] full width ({len(x)} events, {G} windows, k 1024, scales "
        f"(1, 3, 3)): {ms:.2f} ms a call (median of 5; "
        f"{', '.join(f'{1e3 * v:.2f}' for v in times)}), rounds a scale "
        f"{stats[0]['rounds']}, blocking reads a call "
        f"{sum(stats[0]['reads'])} ({stats[0]['reads']}); device time "
        f"{dev_ms:.2f} ms in {n_ops} operations (torch.profiler), busy share "
        f"{dev_ms / ms:.4f}; first 64 windows bitwise the CPU's "
        f"({cpu_s:.1f} s on the CPU); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(ms=ms, rounds=stats[0]["rounds"], reads=stats[0]["reads"],
                device_ms=dev_ms)


def phase_search(d, dev, n=50_000, n_compare=256):
    """The score search (``models.score_search``, plain PyTorch) on the
    first 50,000 events of the bench stream with
    ``compute_flow_bruteforce``'s reference defaults (14,400 candidates,
    scale 5, wsize 25): the full sweep's time on the card beside the bound
    of the bytes counted a candidate (one int32 count image written by the
    splat and read once, and the events' 13 bytes read once), and the
    first ``n_compare`` candidates bitwise the CPU's."""
    import numpy as np
    import torch

    from better_flow_tpu_torch.models import score_search as ss

    t_phase = time.perf_counter()
    x, y, t = (np.asarray(d[k][:n], np.float32) for k in ("x", "y", "t_ns"))
    cnx, cny = np.meshgrid(np.arange(-0.09, 0.09, 0.001),
                           np.arange(-0.04, 0.04, 0.001), indexing="ij")
    cnx, cny = cnx.ravel().astype(np.float32), cny.ravel().astype(np.float32)
    scale, wsize = 5, 25
    x_min, y_min = float(np.floor(x.min())), float(np.floor(y.min()))
    w_img = int((x.max() - x_min + 1) * scale) + scale
    h_img = int((y.max() - y_min + 1) * scale) + scale
    geo = (x_min, y_min, w_img, h_img)
    pixels = (w_img + wsize) * (h_img + wsize)
    per_cand = 8 * pixels + 13 * n
    bound_ms = 1e3 * len(cnx) * per_cand / HBM_BYTES_PER_S

    ss.compute_flow_bruteforce(x[:1000], y[:1000], t[:1000], device=dev,
                               x_range=(-0.09, -0.05))   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = ss.compute_flow_bruteforce(x, y, t, device=dev)
    sweep_s = time.perf_counter() - t0
    ok = r["score"] > 0
    if len(cnx) != 14_400 or ok.mean() < 0.5 or not (
            np.isfinite(r["u"]).all() and np.isfinite(r["v"]).all()):
        raise AssertionError(f"[search] {len(cnx)} candidates, "
                             f"{ok.mean():.3f} of events scored")

    best = {}
    for where in (dev, "cpu"):
        f = lambda a: torch.from_numpy(a).to(where)
        ev = (f(x), f(y), f(t), torch.ones(n, dtype=torch.bool, device=where))
        t0 = time.perf_counter()
        b = ss.sweep_candidates(*ev, f(cnx[:n_compare]), f(cny[:n_compare]),
                                scale, wsize, *geo)
        best[str(where)] = (b, time.perf_counter() - t0)
    # The card's busy share over ten chunks, untraced against traced.
    f = lambda a: torch.from_numpy(a).to(dev)
    ev = (f(x), f(y), f(t), torch.ones(n, dtype=torch.bool, device=dev))
    part = (f(cnx[:10 * ss.CHUNK]), f(cny[:10 * ss.CHUNK]))
    run = lambda: ss.sweep_candidates(*ev, *part, scale, wsize, *geo)
    part_ms = 1e3 * statistics.median(wall_times(run, 3))
    part_dev_ms, _ = device_time(run)
    same_arrays(f"[search] first {n_compare} candidates card vs CPU",
                best[str(dev)][0], best["cpu"][0], ss.BestFlow._fields)
    log(f"[search] {n} events, {len(cnx)} candidates, scale {scale}, wsize "
        f"{wsize}, chunk C {ss.CHUNK}, images {w_img + wsize}x"
        f"{h_img + wsize}: full sweep {sweep_s:.4f} s on the card "
        f"({1e6 * sweep_s / len(cnx):.2f} us a candidate; over "
        f"{10 * ss.CHUNK} candidates {part_ms:.2f} ms, device "
        f"{part_dev_ms:.2f} ms, busy share {part_dev_ms / part_ms:.4f}); "
        f"bytes counted a "
        f"candidate {per_cand} (count image 8 B a pixel, events 13 B), "
        f"bound {bound_ms:.3f} ms at {HBM_BYTES_PER_S / 1e12} TB/s "
        f"({bound_ms / (1e3 * sweep_s):.4f} of it); {ok.mean():.4f} of events "
        f"scored, median u {np.median(r['u'][ok]):.2f}, v "
        f"{np.median(r['v'][ok]):.2f} px/s; first {n_compare} candidates "
        f"bitwise the CPU's ({best['cpu'][1]:.1f} s on the CPU); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(sweep_s=sweep_s, bound_ms=bound_ms, per_cand=per_cand)


def phase_views(d, dev, n=50_000):
    """Clustering, the debug views and the sampled model terms on the bench
    stream's first production slice (180x240, scale 3) through the port's
    ``process_slice`` (the XLA branch, ``fast()``): its warped positions,
    flow and final time image, copied to the host, give the same inputs
    to the card and the CPU, whose outputs must be equal."""
    import importlib

    import numpy as np
    import torch

    from better_flow_tpu_torch.config import OptimizerConfig, SensorConfig
    from better_flow_tpu_torch.core.events import make_slice
    from better_flow_tpu_torch.core.model import MotionModel
    from better_flow_tpu_torch.models import clustering
    from better_flow_tpu_torch.models import global_flow as gf
    from better_flow_tpu_torch.ops import reductions as red
    from better_flow_tpu_torch.viz import debug_images as di

    # The module: ``ops`` exports the function ``time_image`` under the
    # module's name, as the JAX package's ``ops`` does.
    ti = importlib.import_module("better_flow_tpu_torch.ops.time_image")

    t_phase = time.perf_counter()
    sensor, scale = SensorConfig(), 3
    x, y = d["x"][:n], d["y"][:n]
    t = (d["t_ns"][:n] - d["t_ns"][0]).astype(np.float32)
    ev = make_slice(x, y, t, device=dev)
    bbox = (int(x.min()), int(x.max()), int(y.min()), int(y.max()))
    res, _ = gf.process_slice(None, None, MotionModel.zero(dev),
                              OptimizerConfig.fast(scatter_mode="xla"),
                              sensor, bbox, n, ev=ev)
    img = gf.final_time_image(ev, res, scale, sensor)
    geom = gf.slice_geometry(ev, scale, sensor)
    H, W = gf.static_image_shape(scale, sensor)
    keep = ev.valid & ~res.noise
    pr_img = ti.count_image(res.pr_x, res.pr_y, keep, scale, geom.x_shift,
                            geom.y_shift, geom.w_dyn, geom.h_dyn, H, W)
    h = {k: v.cpu().numpy() for k, v in dict(
        pr_x=res.pr_x, pr_y=res.pr_y, u=res.u, v=res.v, keep=keep, img=img,
        pr_img=pr_img).items()}
    if not res.ran or int((h["img"] > 0).sum()) < 1000:
        raise AssertionError("[views] the slice did not run")
    cx, cy, _ = red.center_of_mass(torch.from_numpy(h["img"]))
    idx = np.random.default_rng(0).integers(0, n, n // 10)
    xs, ys = float(geom.x_shift), float(geom.y_shift)

    views, times = {}, {}
    for where in (dev, "cpu"):
        out, dt = {}, {}

        def run(name, fn):
            if str(where) != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = fn()
            if str(where) != "cpu":
                torch.cuda.synchronize()
            dt[name] = time.perf_counter() - t0

        f = lambda a: torch.from_numpy(a).to(where)
        cl = {}
        run("cluster_events", lambda: cl.update(clustering.cluster_events(
            h["pr_x"], h["pr_y"], h["u"], h["v"], h["keep"], scale,
            sensor.res_x, sensor.res_y, device=where)))
        for k in ("cluster_id", "sizes", "mean_u", "mean_v", "label_img"):
            out[f"cluster_{k}"] = cl[k]
        out["n_clusters"] = np.int64(cl["n_clusters"])
        run("gradient_img", lambda: di.gradient_img(
            h["img"], h["pr_img"], wsize=9, device=where))
        run("gradient_img_color", lambda: di.gradient_img_color(
            h["img"], device=where))
        run("lr_gradient_img_color", lambda: di.lr_gradient_img_color(
            h["img"], wsize=9, device=where))
        run("misalignment_img", lambda: di.misalignment_img(
            h["img"], device=where))
        run("model_compute_sampled", lambda: torch.stack(list(
            red.model_compute_sampled_at(
                f(h["img"]), f(h["pr_x"]), f(h["pr_y"]),
                f(np.ones(n, bool)), cx.to(where), cy.to(where), scale, xs,
                ys, f(idx)))))
        views[str(where)], times[str(where)] = out, dt
    same_arrays("[views] card vs CPU", views[str(dev)], views["cpu"])
    if views["cpu"]["n_clusters"] < 1 or views["cpu"]["gradient_img"].max() \
            == 0 or views["cpu"]["misalignment_img"].max() != 255:
        raise AssertionError("[views] empty views")
    log(f"[views] first slice ({n} events, {res.iters} iterations, "
        f"{int(views['cpu']['n_clusters'])} clusters, {H}x{W} images): card "
        f"equal to the CPU in clusters, the four views (wsize 9) and the "
        f"sampled terms ({len(idx)} samples); card s "
        + json.dumps({k: round(v, 4) for k, v in times[str(dev)].items()})
        + f"; phase {time.perf_counter() - t_phase:.1f} s")
    return times[str(dev)]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "better_flow_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(better_flow_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from better_flow_tpu_torch.config import OptimizerConfig, PipelineConfig
    from better_flow_tpu_torch.ops import _build, fused_model as fm
    from better_flow_tpu_torch.runtime.scan_pipeline import (
        compensate_recording_scan, prepare_recording,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"[env] {smi}")
    log(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc: {nvcc}")
    t0 = time.perf_counter()
    _build.library()
    log(f"[env] kernel build {time.perf_counter() - t0:.1f} s "
        f"({'cached' if _build.BUILD_INFO.get('cached') else 'compiled'})")
    if _build.BUILD_INFO.get("log"):
        log(_build.BUILD_INFO["log"].strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda")
    cfg = PipelineConfig(optimizer=OptimizerConfig.fast())
    d = bench_stream(N_EVENTS)
    n = len(d["x"])

    t_phase = time.perf_counter()
    results, scan_inputs = phase_kernels(cfg, d, dev)
    mega = phase_megastep(scan_inputs, d, dev)
    results["megastep"] = mega["scale3"]
    partials, b10_launches = phase_partials_kernels(scan_inputs, cfg, dev)
    results.update(partials)
    log(f"[kernels] phase {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    prep = prepare_recording(d["x"], d["y"], d["t_ns"], cfg, device=dev)
    log(f"[main] {n} events, {len(prep['plan'].ends)} slices staged in "
        f"{time.perf_counter() - t0:.2f} s")
    # B3 as the main path launches it: once over the staged range.
    results["act_rows"] = act_rows_range(cfg, prep, dev, results["act_rows"])
    compensate_recording_scan(None, None, None, cfg, prepared=prep)  # warm-up
    fm.reset_launches()
    r1 = compensate_recording_scan(None, None, None, cfg, prepared=prep)
    launches = dict(fm.LAUNCHES)
    check_outputs(r1, n)
    st = r1["stats"]
    log(f"[main] events/s {st['events_per_s']:.1f}  run_s {st['run_s']:.4f}  "
        f"plan_s {st['plan_s']:.4f}  n_slices {st['n_slices']}  mean_iters "
        f"{st['mean_iters']:.4f}  host_syncs {st['host_syncs']}")
    log(f"[main] plan_breakdown {json.dumps(prep['plan_breakdown'])}")
    log(f"[main] launches {json.dumps(launches)}")
    log(f"[main] output digest {scan_digest(r1)}")
    for name in ("act_rows", "warp_images_st", "megastep_finish", "warp_uv"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the main path")
    # B3 once for the staged range, B4 once a slice that ran.
    if launches["act_rows"] != 1 or \
            launches["warp_uv"] != int(r1["ran"].sum()):
        raise AssertionError(f"main path: act_rows launched "
                             f"{launches['act_rows']} times (expected 1), "
                             f"warp_uv {launches['warp_uv']} (expected "
                             f"{int(r1['ran'].sum())})")

    r2 = compensate_recording_scan(None, None, None, cfg, prepared=prep)
    for k in ("u", "v", "noise", "iters"):
        if not np.array_equal(r1[k], r2[k]):
            raise AssertionError(f"repeated run differs in {k}")
    log(f"[determinism] second run bitwise identical; events/s "
        f"{r2['stats']['events_per_s']:.1f}")
    phase_cold(d, cfg, r1, dev)

    m = N_COMPARE
    part = {k: d[k][:m] for k in ("x", "y", "t_ns")}
    rg = compensate_recording_scan(part["x"], part["y"], part["t_ns"], cfg,
                                   device=dev)
    t0 = time.perf_counter()
    rc = compensate_recording_scan(part["x"], part["y"], part["t_ns"], cfg,
                                   device="cpu")
    gates = compare_runs(rg, rc, d, m)
    log(f"[card-vs-cpu] {m} events, CPU twins {time.perf_counter() - t0:.1f}"
        f" s: {json.dumps(gates)}")
    # The fast schedule's quality gates and seed sweep on the kernels.
    phase_quality(dev)
    # The numpy staging route: sub-pixel coordinates, slices past 65,535
    # events; its runs count their own launches.
    phase_staging(d, cfg, prep, dev)

    t_phase = time.perf_counter()
    stream_launches = phase_stream(d, dev)
    phase_cli(d, dev)
    log(f"[stream+cli] phases {time.perf_counter() - t_phase:.1f} s")
    # Each kernel's launches in the path that first needs it: the scan for
    # B1-B4, the reference-schedule stream for the megastep ...
    launches["megastep"] = stream_launches["reference"]["megastep"]
    if launches["megastep"] <= 0:
        raise AssertionError("megastep was not launched by the stream")
    # ... the f64-totals scan for B6 ...
    launches["fused_warp_splat"] = phase_composed(d, dev)["fused_warp_splat"]
    # ... and the four-shard f64-totals scan for B7a and B7b.
    sharded = phase_sharded(d, dev)
    for k in ("fused_warp_splat_images", "finish_partials"):
        launches[k] = sharded[k]
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched by the sharded scan")

    # ... the merged fast() scan for B12 ...
    results["megastep2"], launches["megastep2"] = phase_merged(
        scan_inputs, cfg, prep, r1, dev)
    # ... run_optimizer's pallas branch for B11, its kernel phase for B10 ...
    launches.update(phase_xla(d, cfg, prep, r1, dev))
    launches["fused_model_partials"] = b10_launches
    # The options that ran only in the JAX package until this phase.
    for name, extra in phase_options(scan_inputs, cfg, prep, r1, d,
                                     dev).items():
        results[name].update(extra)
    for k in ("megastep2", "fused_model_partials",
              "fused_model_partials_windowed"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched by its path")

    # ... and the 4x2 tiled recording for B8 and B9.
    dt = tiled_stream()
    results.update(phase_tiled_kernels(dt, dev))
    tiled = phase_tiled(dt, dev)
    for k in ("splat_local", "finish_local"):
        launches[k] = tiled[k]
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched by the tiled run")

    # The entry hooks: the JAX package's dry run, on the card.
    phase_dryrun(dev)

    # The other optimizers and views: plain PyTorch, no kernel.
    t_phase = time.perf_counter()
    phase_local(dev)
    phase_search(d, dev)
    phase_views(d, dev)
    log(f"[local+search+views] phases {time.perf_counter() - t_phase:.1f} s")

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **results[name])
               for name, src, rep in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        import traceback

        traceback.print_exc()
        rc = 1
    sys.exit(rc)
