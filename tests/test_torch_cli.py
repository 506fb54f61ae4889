"""The port's CLI, ``python -m better_flow_tpu_torch.cli.motion_compensator``,
on the CPU (``--device cpu``): its output file is ``write_events_uv`` of
the library call it stands for (``--cold`` the ``--scan`` file), its flags
reach the configuration, ``--img``/``--video`` write a frame a slice,
``-i`` runs the manual mode or, with no display, the batch run, and
``--device cuda`` fails where there is no card."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from better_flow_tpu.cli.motion_compensator import (  # noqa: E402
    build_parser as jax_parser, config_from_args,
)
from better_flow_tpu.io.event_file import (  # noqa: E402
    read_events, write_events, write_events_uv,
)
from better_flow_tpu.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.cli import motion_compensator as cli  # noqa: E402
from better_flow_tpu_torch.runtime.offline import (  # noqa: E402
    compensate_recording,
)
from better_flow_tpu_torch.runtime.scan_pipeline import (  # noqa: E402
    compensate_recording_scan,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--resolution", "24x32", "--max-events", "4000", "--time-width",
         "0.1", "--refresh-event-count", "1500", "--refresh-time", "0.04",
         "--device", "cpu", "--quiet"]


@pytest.fixture(scope="module")
def rec_file(tmp_path_factory):
    d = synthetic_events(9000, duration_s=0.25, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    path = str(tmp_path_factory.mktemp("cli") / "rec.txt")
    write_events(path, d["x"], d["y"], d["t_ns"], d["polarity"])
    return path


def _cfg(flags, rec_file, out):
    return config_from_args(jax_parser().parse_known_args(
        [rec_file, "-o", out] + flags)[0])


def _library_file(rec_file, flags, out, scan=False):
    """write_events_uv of the library call the CLI stands for."""
    cfg = _cfg(flags, rec_file, out)
    r = read_events(rec_file)
    if scan:
        o = compensate_recording_scan(r["x"], r["y"], r["t_ns"], cfg,
                                      device="cpu")
        write_events_uv(out, r["x"], r["y"], r["t_ns"], o["u"], o["v"])
    else:
        acc = compensate_recording(r["x"], r["y"], r["t_ns"], cfg,
                                   device="cpu")["accumulated"]
        write_events_uv(out, acc["x"], acc["y"], acc["timestamp"], acc["u"],
                        acc["v"])
    with open(out) as f:
        return f.read()


@pytest.mark.parametrize("extra", [
    [], ["--bufferize-file"], ["--schedule", "fast"], ["--stm-disable"],
    ["--scan"], ["--scan", "--schedule", "fast"]])
def test_output_equals_library_call(rec_file, tmp_path, extra):
    out = str(tmp_path / "cli.txt")
    assert cli.main([rec_file, "-o", out] + SMALL + extra) == 0
    with open(out) as f:
        got = f.read()
    want = _library_file(rec_file, SMALL + extra, str(tmp_path / "lib.txt"),
                         scan="--scan" in extra)
    assert got == want
    assert len(got.splitlines()) > 1000


def test_flags_reach_the_configuration(rec_file):
    args = cli.build_parser().parse_args(
        [rec_file, "--schedule", "fast", "--stm-disable", "--scale", "1"])
    cfg = config_from_args(args)
    assert args.device == "cuda"
    assert cfg.optimizer.schedule == "fast" and cfg.optimizer.megastep_split
    assert cfg.stm_disable and cfg.optimizer.scale == 1
    assert config_from_args(cli.build_parser().parse_args(
        [rec_file])).optimizer.schedule == "reference"


def test_bufferize_prints_per_slice_lines(rec_file, tmp_path, capsys):
    flags = [f for f in SMALL if f != "--quiet"]
    assert cli.main([rec_file, "--bufferize-file", "-o",
                     str(tmp_path / "o.txt")] + flags) == 0
    text = capsys.readouterr().out
    n = len(read_events(rec_file)["x"])
    assert f"Read {n} events" in text and "Total flow elapsed" in text
    assert "slice_td" in text and "Written" in text


def _frames_in(path):
    cv2 = pytest.importorskip("cv2")
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


@pytest.mark.parametrize("flags", [
    ["--img"], ["--video"], ["--img", "--video", "--scan"]])
def test_frame_flags_write_a_frame_a_slice(rec_file, tmp_path, flags):
    """``--img`` writes one HUD frame a slice of the stream
    (``frame_<k>.jpg``), ``--video`` a video of as many frames; ``-o``
    writes the stream's file (also with ``--scan``: the frames come from
    the stream)."""
    cv2 = pytest.importorskip("cv2")
    out, img_dir = str(tmp_path / "cli.txt"), tmp_path / "img"
    img_dir.mkdir()
    video = str(tmp_path / "out.mp4")
    assert cli.main([rec_file, "-o", out, "--img-prefix", str(img_dir),
                     "--video-name", video] + SMALL + flags) == 0
    r = read_events(rec_file)
    n_slices = compensate_recording(r["x"], r["y"], r["t_ns"],
                                    _cfg(SMALL, rec_file, out),
                                    device="cpu")["stats"]["n_slices"]
    assert n_slices >= 5
    frames = sorted(os.listdir(img_dir))
    if "--img" in flags:
        assert frames == sorted(f"frame_{k}.jpg" for k in range(n_slices))
        img = cv2.imread(str(img_dir / frames[-1]))
        assert img.shape == (2 * 24 * 3, 2 * 32 * 3, 3) and img.any()
    else:
        assert frames == []
    assert os.path.exists(video) == ("--video" in flags)
    if "--video" in flags:
        assert _frames_in(video) == n_slices
    with open(out) as f:
        assert f.read() == _library_file(rec_file, SMALL,
                                         str(tmp_path / "lib.txt"))


@pytest.mark.parametrize("display", ["unset", "window_error"])
def test_interactive_without_a_display_runs_the_batch(
        rec_file, tmp_path, capsys, monkeypatch, display):
    """``-i`` with no display (no DISPLAY, or OpenCV's window error) says
    so and writes the batch run's file."""
    cv2 = pytest.importorskip("cv2")
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    if display == "unset":
        monkeypatch.delenv("DISPLAY", raising=False)
    else:
        monkeypatch.setenv("DISPLAY", ":99")

        def refuse(*a, **k):
            raise cv2.error("cannot open display")

        monkeypatch.setattr(cv2, "namedWindow", refuse)
    out = str(tmp_path / "cli.txt")
    assert cli.main([rec_file, "-i", "-o", out] + SMALL) == 0
    err = capsys.readouterr().err
    assert "interactive mode unavailable" in err
    assert "continuing batch run" in err
    with open(out) as f:
        assert f.read() == _library_file(rec_file, SMALL,
                                         str(tmp_path / "lib.txt"))


def _fake_display(monkeypatch, keys):
    """OpenCV's window calls answered without a display: ``waitKey``
    returns ``keys`` in turn, the trackbars their initial positions."""
    from better_flow_tpu_torch.cli.manual_mode import SLIDERS

    cv2 = pytest.importorskip("cv2")
    monkeypatch.setenv("DISPLAY", ":99")
    keys = list(keys)
    pos = {name: init for name, init, _ in SLIDERS}
    shown = []
    for name in ("namedWindow", "createTrackbar", "setTrackbarPos",
                 "destroyAllWindows"):
        monkeypatch.setattr(cv2, name, lambda *a, **k: None)
    monkeypatch.setattr(cv2, "waitKey", lambda ms: keys.pop(0))
    monkeypatch.setattr(cv2, "getTrackbarPos", lambda name, win: pos[name])
    monkeypatch.setattr(cv2, "imshow", lambda win, img: shown.append(win))
    return shown


def test_interactive_runs_the_manual_loop(rec_file, tmp_path, monkeypatch):
    """With a display, ``-i`` runs the manual mode (a tick, 'c', ESC) and
    no batch run."""
    shown = _fake_display(monkeypatch, [ord("x"), ord("c"), 27])
    out = str(tmp_path / "cli.txt")
    assert cli.main([rec_file, "-i", "-o", out] + SMALL) == 0
    assert len(shown) == 6 and not os.path.exists(out)


def test_interactive_errors_reach_the_caller(rec_file, tmp_path,
                                            monkeypatch):
    """An error inside the manual mode (here the optimizer's) is not taken
    for a missing display."""
    from better_flow_tpu_torch.cli import manual_mode

    _fake_display(monkeypatch, [ord("c"), 27])

    def fail(self):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(manual_mode.ManualSession, "optimize", fail)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        cli.main([rec_file, "-i", "-o", str(tmp_path / "o.txt")] + SMALL)


@pytest.mark.parametrize("extra", [
    [], ["--schedule", "fast"], ["--checkpoint", "CKPT"],
    ["--checkpoint", "CKPT", "--resume"]])
def test_cold_writes_the_scans_file(rec_file, tmp_path, capsys, extra):
    """``--cold -o`` writes what ``--scan -o`` writes (the cold path is
    bitwise the scan), with and without a checkpoint; ``--resume`` on the
    checkpoint of a complete run runs no batch again."""
    ckpt = str(tmp_path / "cold.npz")
    extra = [ckpt if f == "CKPT" else f for f in extra]
    flags = [f for f in SMALL if f != "--quiet"]
    out = str(tmp_path / "cold.txt")
    if "--resume" in extra:   # the same flags (the digest), no --resume
        assert cli.main([rec_file, "--cold", "-o", out, "--checkpoint",
                         ckpt] + flags) == 0
        capsys.readouterr()
    assert cli.main([rec_file, "--cold", "-o", out] + flags + extra) == 0
    text = capsys.readouterr().out
    assert " batches" in text and "s end to end" in text
    assert ("(resumed after batch " in text) == ("--resume" in extra)
    assert os.path.exists(ckpt) == ("--checkpoint" in extra)
    with open(out) as f:
        got = f.read()
    scan_extra = [f for f in extra if f in ("--schedule", "fast")]
    want = _library_file(rec_file, SMALL + scan_extra,
                         str(tmp_path / "lib.txt"), scan=True)
    assert got == want


def test_cuda_without_a_card_fails(rec_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([rec_file, "--device", "cuda"])
    out = subprocess.run(
        [sys.executable, "-m", "better_flow_tpu_torch.cli.motion_compensator",
         rec_file, "--quiet"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_version_and_usage(capsys):
    assert cli.main(["--version"]) == 0
    assert "PyTorch/CUDA port" in capsys.readouterr().out
    assert cli.main([]) == 1
    assert "--device" in capsys.readouterr().out
