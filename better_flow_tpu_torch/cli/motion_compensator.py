"""bf_motion_compensator on the PyTorch/CUDA port.

    python -m better_flow_tpu_torch.cli.motion_compensator file.txt -o out.txt

The flags are those of the JAX package's CLI
(better_flow_tpu/cli/motion_compensator.py, flag-compatible with the
reference binary, bf_motion_compensator.cpp:36-130; ``build_parser`` and
``config_from_args`` here are the port's own copies), plus ``--device``
(default ``cuda``; it fails where no CUDA device is present rather than run
on the CPU).  Every flag runs: the default streaming path,
``--bufferize-file``, ``--scan``, ``--cold`` with ``--checkpoint``/
``--resume``, ``--schedule``, ``--stm-disable``, ``--quiet``, ``-o``,
``--img``/``--video`` (a HUD frame a slice of the stream, ``viz.video``)
and ``-i`` (the manual mode on the first slice window,
``cli.manual_mode``).  Without a display ``-i`` says so and carries on
with the batch run; any other error of the manual mode reaches the caller.
"""

from __future__ import annotations

import argparse
import sys

import torch

from better_flow_tpu_torch import __version__
from better_flow_tpu_torch.config import (
    OptimizerConfig, PipelineConfig, SensorConfig, SliceConfig, from_sec,
)

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bf_motion_compensator (PyTorch/CUDA port)",
        description="DVS flow estimator (better flow, PyTorch/CUDA port)")
    p.add_argument("file", nargs="?", help='event .txt file ("-" for stdin)')
    p.add_argument("--refresh-time", type=float, default=0.033,
                   help="recompute after this many seconds of new events")
    p.add_argument("--refresh-event-count", type=int, default=20000,
                   help="recompute after this many new events")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="interactive trackbar mode (requires a display)")
    p.add_argument("-G", action="store_true",
                   help="accepted for reference compatibility (no-op: the "
                        "accelerator path is always on)")
    p.add_argument("--stm-disable", action="store_true",
                   help="do not warm-start from the previous slice's model")
    p.add_argument("--img", action="store_true",
                   help="write a HUD frame after every slice")
    p.add_argument("--img-prefix", default="./")
    p.add_argument("--video", action="store_true")
    p.add_argument("--video-name", default="./out.mp4")
    p.add_argument("--video-fps", type=int, default=60)
    p.add_argument("--bufferize-file", action="store_true",
                   help="read whole file first; print per-slice perf")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("-o", "--outfile", default=None)
    p.add_argument("-v", "--version", action="store_true")
    p.add_argument("--scan", action="store_true",
                   help="the device-resident slice loop (fastest offline)")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="with --cold: persist (carry, completed batches) "
                        "at every batch boundary so a killed run can "
                        "--resume bit-identically")
    p.add_argument("--resume", action="store_true",
                   help="with --cold --checkpoint: continue after the "
                        "last completed batch of a matching checkpoint")
    p.add_argument("--cold", action="store_true",
                   help="one-shot batch-pipelined processing: staging of "
                        "the next slice batch overlaps device execution")
    p.add_argument("--schedule", default="reference",
                   choices=["reference", "fast", "fast_accurate",
                            "fast_throughput"],
                   help="optimizer step-size schedule: 'reference' is the "
                        "C++ parity divider schedule (default, bit-faithful "
                        "output); the fast presets trade documented, "
                        "gate-tested accuracy bands for fewer iterations "
                        "(fast_throughput is for translation-dominated "
                        "streams only)")
    p.add_argument("--scale", type=int, default=3)
    p.add_argument("--max-iter", type=int, default=-1)
    p.add_argument("--max-events", type=int, default=50000,
                   help="slice capacity (reference EVENT_WIDTH)")
    p.add_argument("--time-width", type=float, default=0.2,
                   help="slice time span seconds (reference TIME_WIDTH)")
    p.add_argument("--resolution", default="180x240",
                   help="sensor rows x cols (reference RES_X x RES_Y)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (the kernels; fails "
                        "without a CUDA device) or cpu (the plain twins)")
    return p


def config_from_args(args) -> PipelineConfig:
    rx, ry = (int(v) for v in args.resolution.lower().split("x"))
    return PipelineConfig(
        sensor=SensorConfig(res_x=rx, res_y=ry),
        slice=SliceConfig(
            max_events=args.max_events,
            span_ns=from_sec(args.time_width),
            refresh_events=args.refresh_event_count,
            refresh_time_ns=from_sec(args.refresh_time),
        ),
        optimizer={
            "reference": lambda **kw: OptimizerConfig(**kw),
            "fast": OptimizerConfig.fast,
            "fast_accurate": OptimizerConfig.fast_accurate,
            "fast_throughput": OptimizerConfig.fast_throughput,
        }[getattr(args, "schedule", "reference")](
            scale=args.scale, max_iter=args.max_iter),
        stm_disable=args.stm_disable,
        accumulate=args.outfile is not None,
        generate_pictures=args.img,
        img_prefix=args.img_prefix,
        generate_video=args.video,
        video_name=args.video_name,
        video_fps=args.video_fps,
        quiet=args.quiet,
    )


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(use --device cpu for the plain CPU twins)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: expected cuda or cpu")
    return dev


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        print("DVS flow estimator (better flow, PyTorch/CUDA port), "
              f"{__version__}")
        return 0
    if args.file is None:
        build_parser().print_help()
        return 1
    dev = resolve_device(args.device)

    from better_flow_tpu_torch.io.event_file import read_events, write_events_uv

    cfg = config_from_args(args)
    src = sys.stdin if args.file == "-" else args.file
    if not args.quiet:
        print(f"Reading from file... ({args.file})")
    rec = read_events(src)
    if not args.quiet:
        print(f"Read {len(rec['x'])} events, finished")
    out_path = sys.stdout if args.outfile == "-" else args.outfile

    if args.interactive:
        # OptimizerRolling::manual on the first slice window
        # (optimizer_rolling.h:128-233).
        from better_flow_tpu_torch.cli.manual_mode import NoDisplay, run_manual

        k = min(len(rec["x"]), cfg.slice.max_events)
        try:
            run_manual(rec["x"][:k], rec["y"][:k],
                       rec["t_ns"][:k] - rec["t_ns"][0], cfg.sensor,
                       scale=cfg.optimizer.scale, device=dev)
            return 0
        except NoDisplay as e:
            print(f"interactive mode unavailable ({e}); continuing batch run",
                  file=sys.stderr)

    if args.img or args.video:
        acc = _stream_with_frames(rec, cfg, args, dev)
    elif args.cold or args.scan:
        from better_flow_tpu_torch.runtime.scan_pipeline import (
            compensate_recording_cold, compensate_recording_scan,
        )

        if args.cold:
            out = compensate_recording_cold(
                rec["x"], rec["y"], rec["t_ns"], cfg,
                checkpoint_path=args.checkpoint, resume=args.resume,
                device=dev)
            st = out["stats"]
            if not args.quiet:
                resumed = (f" (resumed after batch {st['resumed_batches']})"
                           if st["resumed_batches"] else "")
                print(f"{st['n_slices']} slices in {st['n_batches']} "
                      f"batches{resumed}, {st['total_s']:.3f} s end to end, "
                      f"{st['events_per_s']:.0f} events/s, "
                      f"mean iters {st['mean_iters']:.1f}")
        else:
            out = compensate_recording_scan(rec["x"], rec["y"], rec["t_ns"],
                                            cfg, device=dev)
            st = out["stats"]
            if not args.quiet:
                print(f"{st['n_slices']} slices, {st['run_s']:.3f} s, "
                      f"{st['events_per_s']:.0f} events/s, mean iters "
                      f"{st['mean_iters']:.1f}")
        if args.outfile:
            write_events_uv(out_path, rec["x"], rec["y"], rec["t_ns"],
                            out["u"], out["v"])
        return 0
    else:
        from better_flow_tpu_torch.runtime.offline import compensate_recording

        acc = compensate_recording(
            rec["x"], rec["y"], rec["t_ns"], cfg,
            verbose=args.bufferize_file and not args.quiet,
            device=dev)["accumulated"]
    if args.outfile:
        write_events_uv(out_path, acc["x"], acc["y"], acc["timestamp"],
                        acc["u"], acc["v"])
        if not args.quiet:
            print(f"Written {len(acc['x'])} events, finished")
    return 0


def _stream_with_frames(rec, cfg: PipelineConfig, args, dev):
    """The stream (``DVSFlow``) with one HUD frame a slice, written as
    ``<img-prefix>/frame_<k>.jpg`` under ``--img`` and into the video under
    ``--video`` (dvs_flow.h:255-335).  Returns the accumulated events."""
    import cv2

    from better_flow_tpu_torch.runtime.dvs_flow import DVSFlow
    from better_flow_tpu_torch.viz.video import VideoSink, hud_frame

    cfg = cfg.replace(accumulate=True)
    engine = DVSFlow(cfg, device=dev)
    sink = VideoSink(args.video_name, args.video_fps, cfg.sensor.res_x,
                     cfg.sensor.res_y) if args.video else None
    frames = [0]

    def on_slice(r):
        frame = hud_frame(r, engine.last_model, cfg.sensor.res_x,
                          cfg.sensor.res_y, engine.time_diff,
                          cfg.slice.refresh_time_ns, engine.get_buf_size(),
                          r.n_events)
        if args.img:
            cv2.imwrite(f"{args.img_prefix}/frame_{frames[0]}.jpg", frame)
            frames[0] += 1
        if sink is not None:
            sink.write(frame)

    engine.on_slice = on_slice
    engine.add_events(rec["x"], rec["y"], rec["t_ns"])
    if len(engine.buffer):
        engine.recompute()
    if sink is not None:
        sink.close()
    return engine.get_accumulated()


if __name__ == "__main__":
    raise SystemExit(main())
