"""bf_motion_compensator on the PyTorch/CUDA port.

    python -m better_flow_tpu_torch.cli.motion_compensator file.txt -o out.txt

The flags are those of ``better_flow_tpu.cli.motion_compensator`` (its
``build_parser`` and ``config_from_args``, flag-compatible with the
reference binary, bf_motion_compensator.cpp:36-130), plus ``--device``
(default ``cuda``; it fails where no CUDA device is present rather than run
on the CPU).  Ported: the default streaming path, ``--bufferize-file``,
``--scan``, ``--schedule``, ``--stm-disable``, ``--quiet`` and ``-o``.
Not ported yet, each raising NotImplementedError with its ROADMAP item:
``--cold`` and ``--checkpoint``/``--resume`` (the cold path), ``-i`` (the
manual mode) and ``--img``/``--video`` (the HUD frames).
"""

from __future__ import annotations

import sys

import torch

from better_flow_tpu import __version__
from better_flow_tpu.cli.motion_compensator import (
    build_parser as _jax_parser, config_from_args,
)

_NOT_PORTED = (   # flag attribute, flag, ROADMAP item
    ("cold", "--cold", "A6 (the cold path)"),
    ("checkpoint", "--checkpoint", "A6 (the cold path's checkpoints)"),
    ("resume", "--resume", "A6 (the cold path's checkpoints)"),
    ("interactive", "-i/--interactive", "A8 (cli/manual_mode.py)"),
    ("img", "--img", "A8 (the HUD frames of viz/video.py)"),
    ("video", "--video", "A8 (the HUD frames of viz/video.py)"),
)


def build_parser():
    p = _jax_parser()
    p.prog = "bf_motion_compensator (PyTorch/CUDA port)"
    p.description = "DVS flow estimator (better flow, PyTorch/CUDA port)"
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (the kernels; fails "
                        "without a CUDA device) or cpu (the plain twins)")
    return p


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
    for attr, flag, item in _NOT_PORTED:
        if getattr(args, attr):
            raise NotImplementedError(f"{flag} is not ported yet: ROADMAP "
                                      f"{item}")
    dev = resolve_device(args.device)

    from better_flow_tpu.io.event_file import read_events, write_events_uv

    cfg = config_from_args(args)
    src = sys.stdin if args.file == "-" else args.file
    if not args.quiet:
        print(f"Reading from file... ({args.file})")
    rec = read_events(src)
    if not args.quiet:
        print(f"Read {len(rec['x'])} events, finished")
    out_path = sys.stdout if args.outfile == "-" else args.outfile

    if args.scan:
        from better_flow_tpu_torch.runtime.scan_pipeline import (
            compensate_recording_scan,
        )

        out = compensate_recording_scan(rec["x"], rec["y"], rec["t_ns"], cfg,
                                        device=dev)
        st = out["stats"]
        if not args.quiet:
            print(f"{st['n_slices']} slices, {st['run_s']:.3f} s, "
                  f"{st['events_per_s']:.0f} events/s, mean iters "
                  f"{st['mean_iters']:.1f}")
        if args.outfile:
            write_events_uv(out_path, rec["x"], rec["y"], rec["t_ns"],
                            out["u"], out["v"])
        return 0

    from better_flow_tpu_torch.runtime.offline import compensate_recording

    out = compensate_recording(rec["x"], rec["y"], rec["t_ns"], cfg,
                               verbose=args.bufferize_file and not args.quiet,
                               device=dev)
    acc = out["accumulated"]
    if args.outfile:
        write_events_uv(out_path, acc["x"], acc["y"], acc["timestamp"],
                        acc["u"], acc["v"])
        if not args.quiet:
            print(f"Written {len(acc['x'])} events, finished")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
