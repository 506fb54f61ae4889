"""Typed configuration of the port: the constants, the four frozen
dataclasses and the presets.

The port's own copy of ``better_flow_tpu/config.py`` (same fields, defaults
and presets; a test holds the two together), so that the port imports
nothing of that package.  The reference spreads configuration over
compile-time macros (common.h:38-64, bf_motion_compensator.cpp:6-10), a CLI
parser (bf_motion_compensator.cpp:36-130) and ROS params
(bf_visualizer.cpp:275-292); here one set of frozen dataclasses feeds both
the CLI and the library.  The combinations the port does not run are
named in ``models.global_flow.check_supported``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# --- Global numeric conventions (reference: common.h:58-64) -----------------
# Z (time) component of the direction vector; "can be anything, as long as
# variables do not overflow" (common.h:58-60).
NZ: int = 127
# The event timestamp is divided by T_DIVIDER (integer), converted to float
# and additionally divided by 10000 (common.h:62-64, event.h:164-168).
T_DIVIDER: int = 1
# Nanoseconds per "warp time unit": pr = fr - (n/nz) * (t/T_DIVIDER) / 1e4.
WARP_TIME_DIV: float = 10000.0
# px/s per unit n at nz=1: u = nx * UV_FACTOR / nz  (event.h:131-142).
UV_FACTOR: float = 1e9 / (T_DIVIDER * 10000.0)  # = 1e5

# Nonzero threshold used by every masked image op (accel_lib.h:534, 599,
# object_model.cpp:22, 114).
NONZERO_EPS: float = 0.000001


def from_sec(seconds: float) -> int:
    """Seconds -> integer nanoseconds (reference FROM_SEC, common.h:35)."""
    return int(1_000_000_000 * seconds)


def from_ms(ms: float) -> int:
    """Milliseconds -> integer nanoseconds (reference FROM_MS, common.h:36)."""
    return int(1_000_000 * ms)


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Camera geometry.

    The reference hardcodes RES_X=180, RES_Y=240 (common.h:39-40) with the
    x axis indexing image *rows* and y indexing *columns* (events are read
    with x/y swapped relative to the file, event_file.h:60).  Here the
    resolution is configuration so DAVIS 346x260 and megapixel sensors are
    first-class.
    """

    res_x: int = 180  # rows
    res_y: int = 240  # cols


@dataclasses.dataclass(frozen=True)
class SliceConfig:
    """Sliding-slice geometry and retrigger thresholds.

    Mirrors the reference's compile-time EVENT_WIDTH/TIME_WIDTH
    (bf_motion_compensator.cpp:6-7) and runtime refresh flags (:9-10).
    """

    max_events: int = 50_000          # ring capacity (EVENT_WIDTH)
    span_ns: int = from_sec(0.2)      # time-span eviction (TIME_WIDTH)
    refresh_events: int = 20_000      # retrigger on this many new events
    refresh_time_ns: int = from_sec(0.033)  # or on this much elapsed time


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Global 4-parameter optimizer settings (optimizer_rolling.h).

    ``scale`` is the image super-resolution factor (odd; assert at
    optimizer_rolling.h:274).  ``max_iter`` < 0 means unbounded, matching
    set_maxiter(-1) (dvs_flow.h:109).  The divider schedule and convergence
    thresholds transcribe optimizer_rolling.h:48-101.
    """

    scale: int = 3
    max_iter: int = -1
    min_events: int = 1000            # size gate (optimizer_rolling.h:57)
    # Initial adaptive-step dividers (optimizer_rolling.h:61-63).
    init_xy_divider: float = 1.0
    init_rotdiv_divider: float = 10_000.0
    # Loop continues while any divider is below its cap (:76-79).
    xy_divider_cap: float = 32.0 * 10.0
    rotdiv_divider_cap: float = 32.0 * 1000.0
    # Delta convergence thresholds (:81-84).
    dx_tol: float = 1e-5
    dy_tol: float = 1e-5
    rot_tol: float = 1e-4
    div_tol: float = 1e-1
    # Window-size gate: skip when both scaled window dims are below
    # scale*RES/15 (optimizer_rolling.h:49; integer division).
    min_window_fraction: int = 15
    # Scatter strategy of the JAX package's images.  The port runs the
    # kernel branch for "auto" and "pallas", and the XLA-composed branch
    # (on one device, under an event group and on the tiled path) for
    # "xla" and the JAX package's TPU scatter strategies "rep" and "mxu",
    # all three with its exact integer scatter.
    scatter_mode: str = "auto"
    # Keep the low-order bf16 part of the splatted time weight (the hi+lo
    # pair gives ~16-bit event-time precision).  False (fast schedule only:
    # the reference schedule always splats the pair) quantizes times to
    # bf16 (~0.4 ms worst case on a 0.2 s slice).
    splat_time_lo: bool = True
    # Step-size schedule: "reference" transcribes the sign-flip divider
    # doubling of optimizer_rolling.h:60-111 (bisection-like, ~log2 steps
    # per parameter).  "fast" keeps the same per-iteration gradient signal
    # and the same convergence tolerances but sizes each step with a
    # safeguarded per-parameter secant (Newton on the gradient root,
    # clamped to 4x the reference step, reference fallback when the local
    # slope isn't concave) — typically 2-3x fewer iterations for the same
    # converged warp.  Accuracy-gated against the reference schedule in
    # tests/test_fast_schedule.py.
    schedule: str = "reference"
    # Gradient-qualified exit for the fast schedule (0 = off): exit only
    # when, in addition to sub-tolerance DELTAS, the reference step
    # |g|/divider is below exit_grad_factor * tol, the reference
    # schedule's own convergence test.  A clamped secant step can be tiny
    # while the gradient is still large; on rot/div-dominated scenes
    # exiting on such steps under-converges.  Ignored by the reference
    # schedule (whose exit IS this test at factor 1).
    exit_grad_factor: float = 0.0
    # Model-validated one-step-ahead exit for the fast schedule (0 = off).
    # With this cap > 0 a component may exit, bypassing the delta and
    # gradient tests, when (a) the secant's linear model predicted THIS
    # iteration's gradient well (one-step prediction error < 0.75 of the
    # previous gradient), (b) the predicted next step AND next reference
    # step are both sub-tolerance, and (c) the current delta is within
    # cap*tol.  Sound on translation-dominated streams; on rot/div-
    # dominated scenes the terminal iterates oscillate beyond what a
    # one-step predictor sees, so the presets other than
    # fast_throughput() keep it off.  Ignored by the reference schedule.
    exit_predict_cap: float = 0.0
    # Extrapolated warm start (0 = off, the reference's plain warm start):
    # the scan starts a slice's optimizer at model + alpha*(model_k -
    # model_{k-1}); a skipped slice and the warm-start warp keep the plain
    # model.  Scan routes only: the stream and the tiled path ignore it.
    warm_extrapolate: float = 0.0
    # Run an f32 carry through the megastep (a whole iteration including
    # the scalar model update in the kernels); False forces the composed
    # loop (one warp + splat + finish launch per iteration, the scalar
    # update between launches).
    use_megastep: bool = True
    # Run the megastep as the two-kernel split (warp + splat emitting the
    # pre-filter images, then finish + model update) even on one device:
    # the same two kernels the event-parallel path runs around its sum.
    megastep_split: bool = False
    # Merged megastep (one call per iteration with the previous
    # iteration's finish at its head; the exit call is the final warp).
    # Taken on one device by the megastep drive only, as in the JAX
    # package: ignored under an event group and on the composed loop.
    megastep_merged: bool = False
    # Iterations per loop trip of the single-device split megastep drive:
    # above 1 the trip runs that many predicated B1 + B2 pairs, of which a
    # pair past the exit passes the state through on the device, and the
    # host reads the continue flag once a trip.  Bitwise 1's results.
    megastep_unroll: int = 1
    # Chunks per grid step of the JAX package's warp + splat kernel, a
    # bit-exact block shape of the TPU.  The port's B1 runs one slot a
    # thread, so it selects nothing.
    splat_pair: int = 1
    # Hard bound on optimizer iterations when max_iter < 0.  The
    # reference's divider caps guarantee termination (each divider at most
    # doubles ~9 times per parameter before its cap); 250 is far above
    # anything observed.
    iter_hard_cap: int = 250

    @classmethod
    def fast(cls, **overrides) -> "OptimizerConfig":
        """The canonical fast preset used by bench.py: secant schedule with
        20x relaxed convergence tolerances, the gradient-qualified exit at
        exit_grad_factor=4, and the bf16 time weight (splat_time_lo=False).
        The reference's tolerances demand 1e-5 px warp precision, two
        orders below anything visible in the flow.

        Measured on the kernels (chip_smoke.py's ``[quality]``, NVIDIA
        H100 80GB HBM3 at 700 W; tools/sweep_exit.py's scenes, five seeds
        each): the median AEE over the reference schedule's, seed mean /
        max, is 0.984 / 1.022 on the production scene, 0.998 / 1.020 on
        rot/div and 1.026 / 1.211 on the noisy dvs_sim stream, at 0.39,
        0.37 and 0.38 of its iterations.  A noisy seed can cost ~20%
        (seed 31, above test_fast_schedule.py's 1.2 gate, as in the JAX
        package's kernel path); use fast_accurate() when that matters."""
        kw = dict(schedule="fast", dx_tol=2e-4, dy_tol=2e-4,
                  rot_tol=2e-3, div_tol=2.0, splat_time_lo=False,
                  exit_grad_factor=4.0, megastep_split=True)
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def fast_throughput(cls, **overrides) -> "OptimizerConfig":
        """fast() plus the model-validated one-step-ahead exit
        (exit_predict_cap=4), for TRANSLATION-DOMINATED deployments: fewer
        iterations there, wrong for spin/zoom-heavy scenes (see
        exit_predict_cap), which fast() or fast_accurate() cover.

        Measured as fast() is: AEE ratio 1.027 / 1.105 on the production
        scene at 0.33 of the reference schedule's iterations (0.84 of
        fast()'s), 1.212 / 1.391 on rot/div and 1.087 / 1.537 on the
        noisy stream (the max at seed 31)."""
        kw = dict(exit_predict_cap=4.0)
        kw.update(overrides)
        return cls.fast(**kw)

    @classmethod
    def fast_accurate(cls, **overrides) -> "OptimizerConfig":
        """Fast schedule tuned for accuracy close to the reference
        schedule's: 10x tolerances with the gradient-qualified exit at
        factor 1, at somewhat more iterations than fast().

        Measured as fast() is: AEE ratio 0.984 / 0.993 on the production
        scene, 1.017 / 1.140 on rot/div and 0.974 / 1.052 on the noisy
        stream, at 0.47, 0.51 and 0.46 of the reference schedule's
        iterations.  Its AEE is at or below the reference schedule's in
        the seed means of two scenes, not seed by seed: two of the
        fifteen seeds (rot/div 91: 1.140, noisy 5: 1.052) exceed the 1.02
        that test_fast_schedule.py:112 holds on its own seed (0.935)."""
        kw = dict(schedule="fast", dx_tol=1e-4, dy_tol=1e-4,
                  rot_tol=1e-3, div_tol=1.0, splat_time_lo=False,
                  exit_grad_factor=1.0, megastep_split=True)
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end streaming pipeline configuration (DVS_flow equivalent)."""

    sensor: SensorConfig = dataclasses.field(default_factory=SensorConfig)
    slice: SliceConfig = dataclasses.field(default_factory=SliceConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    # Do not warm-start from the previous slice's model (--stm-disable,
    # bf_motion_compensator.cpp:46, dvs_flow.h:137-139).
    stm_disable: bool = False
    # Accumulate processed slices for offline output (dvs_flow.h:100-103).
    accumulate: bool = False
    # Optional picture/video generation (dvs_flow.h:114-135).
    generate_pictures: bool = False
    img_prefix: str = "./"
    generate_video: bool = False
    video_name: str = "./out.mp4"
    video_fps: int = 60
    quiet: bool = True
    # Accumulate the warp totals in float64.  The reference keeps its
    # accumulators in double (object_model.h:10-13); the default f32 carry
    # emulates that with Kahan compensation.  The per-event warp stays f32
    # in both modes.
    f64_totals: bool = False

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def low_latency_config() -> PipelineConfig:
    """The ROS live preset: 30k events / 0.07 s slices, scale 1, max 10
    iterations (bf_visualizer.cpp:33-34, 102-104)."""
    return PipelineConfig(
        slice=SliceConfig(
            max_events=30_000,
            span_ns=from_sec(0.07),
            refresh_events=30_000,
            refresh_time_ns=from_sec(0.05),
        ),
        optimizer=OptimizerConfig(scale=1, max_iter=10),
    )
