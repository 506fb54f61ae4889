"""The PyTorch port stands alone: it imports nothing of JAX and nothing of
the JAX package, its ``config`` is a faithful copy, and it runs on the CPU
only when asked to."""

import dataclasses
import os
import pkgutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import better_flow_tpu.config as jcfg  # noqa: E402
import better_flow_tpu_torch  # noqa: E402
import better_flow_tpu_torch.config as tcfg  # noqa: E402
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_smoke_script_import_nothing_of_jax_or_the_jax_package():
    """Import every module of the port and ``chip_smoke`` in a fresh
    process: ``sys.modules`` then holds neither ``jax`` nor
    ``better_flow_tpu`` nor any submodule of either."""
    modules = sorted(m.name for m in pkgutil.walk_packages(
        better_flow_tpu_torch.__path__, "better_flow_tpu_torch."))
    assert {"better_flow_tpu_torch.config",
            "better_flow_tpu_torch.io.native",
            "better_flow_tpu_torch.viz.images",
            "better_flow_tpu_torch.parallel.comm",
            "better_flow_tpu_torch.parallel.multihost",
            "better_flow_tpu_torch.parallel.spatial",
            "better_flow_tpu_torch.parallel.temporal",
            "better_flow_tpu_torch.cli.motion_compensator",
            "better_flow_tpu_torch.cli.manual_mode",
            "better_flow_tpu_torch.cli.viewer",
            "better_flow_tpu_torch.viz.video",
            "better_flow_tpu_torch.models.local_flow",
            "better_flow_tpu_torch.models.score_search",
            "better_flow_tpu_torch.models.clustering",
            "better_flow_tpu_torch.viz.debug_images",
            "better_flow_tpu_torch.eval.metrics",
            "better_flow_tpu_torch.io.dvs_sim",
            "better_flow_tpu_torch.core.pixel_map",
            "better_flow_tpu_torch.profiling",
            "better_flow_tpu_torch.graft_entry"} <= set(modules)
    code = (
        "import sys, importlib\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'better_flow_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_line_of_the_port_imports_the_jax_package():
    """Only comments and docstrings that cite a counterpart name the JAX
    package."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.dirname(
            better_flow_tpu_torch.__file__)):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for path in files:
        with open(path) as f:
            for ln, line in enumerate(f, 1):
                code = line.split("#")[0].strip()
                if code.startswith(("import ", "from ")):
                    mods = code.replace(",", " ").split()
                    assert not any(
                        m == "jax" or m.startswith("jax.")
                        or m == "better_flow_tpu"
                        or m.startswith("better_flow_tpu.")
                        for m in mods), f"{path}:{ln}: {line.strip()}"


def _fields(cls):
    return [(f.name, f.type, None if f.default is dataclasses.MISSING
             else f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["SensorConfig", "SliceConfig",
                                  "OptimizerConfig", "PipelineConfig"])
def test_config_dataclass_is_the_jax_packages(name):
    """Same fields in the same order with the same defaults, and frozen."""
    t, j = getattr(tcfg, name), getattr(jcfg, name)
    assert _fields(t) == _fields(j)
    assert dataclasses.asdict(t()) == dataclasses.asdict(j())
    with pytest.raises(dataclasses.FrozenInstanceError):
        t().__setattr__(dataclasses.fields(t)[0].name, 0)
    assert hash(t()) == hash(t())


def test_config_presets_and_constants_are_the_jax_packages():
    for preset in ("fast", "fast_throughput", "fast_accurate"):
        for kw in ({}, dict(scale=1, max_iter=7, use_megastep=False)):
            assert dataclasses.asdict(getattr(tcfg.OptimizerConfig, preset)(
                **kw)) == dataclasses.asdict(getattr(
                    jcfg.OptimizerConfig, preset)(**kw)), preset
    assert dataclasses.asdict(tcfg.low_latency_config()) == \
        dataclasses.asdict(jcfg.low_latency_config())
    consts = [n for n in dir(jcfg) if n.isupper()]
    assert {"NZ", "T_DIVIDER", "WARP_TIME_DIV", "UV_FACTOR",
            "NONZERO_EPS"} <= set(consts)
    for n in consts:
        assert getattr(tcfg, n) == getattr(jcfg, n), n
    for v in (0.2, 0.033, 1.5):
        assert tcfg.from_sec(v) == jcfg.from_sec(v)
        assert tcfg.from_ms(v) == jcfg.from_ms(v)
    cfg = tcfg.PipelineConfig().replace(f64_totals=True)
    assert cfg.f64_totals and isinstance(cfg, tcfg.PipelineConfig)
    assert better_flow_tpu_torch.__version__


def test_cli_parser_copy_gives_the_jax_clis_config():
    """The port's ``build_parser``/``config_from_args`` against the JAX
    package's on the same arguments (the port adds ``--device``)."""
    from better_flow_tpu.cli import motion_compensator as jcli
    from better_flow_tpu_torch.cli import motion_compensator as tcli

    for argv in (["f.txt"], ["f.txt", "--schedule", "fast", "--scale", "1",
                             "--max-iter", "5", "-o", "o.txt"],
                 ["f.txt", "--resolution", "24x32", "--max-events", "4000",
                  "--time-width", "0.1", "--refresh-event-count", "1500",
                  "--refresh-time", "0.04", "--stm-disable", "--quiet",
                  "--schedule", "fast_throughput"]):
        t = tcli.config_from_args(tcli.build_parser().parse_args(argv))
        j = jcli.config_from_args(jcli.build_parser().parse_args(argv))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    jopts = {a.dest for a in jcli.build_parser()._actions}
    topts = {a.dest for a in tcli.build_parser()._actions}
    assert topts - jopts == {"device"} and jopts <= topts


def test_no_card_and_no_device_raises(monkeypatch):
    """With no card, an entry point raises unless its caller passes
    ``device="cpu"``: none runs on the CPU unasked."""
    from better_flow_tpu_torch.parallel.mesh import make_event_mesh
    from better_flow_tpu_torch.parallel.multihost import (
        compensate_recording_multihost,
    )
    from better_flow_tpu_torch.runtime.dvs_flow import DVSFlow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = synthetic_events(3000, duration_s=0.1, res_x=24, res_y=32, seed=1)
    cfg = tcfg.PipelineConfig(sensor=tcfg.SensorConfig(24, 32))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tscan.default_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DVSFlow(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_event_mesh(2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        compensate_recording_multihost(d["x"], d["y"], d["t_ns"], cfg)
    assert tscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg,
                                   device="cpu")["device"].type == "cpu"


def test_the_other_optimizers_and_views_raise_without_a_card(monkeypatch):
    """``flow_field_grid``, ``local_flow_field``'s gather,
    ``compute_flow_bruteforce``, ``cluster_events``, the four debug views
    and the manual mode's session run on the card by default: with no card
    and no ``device="cpu"`` they raise, and none moves to the CPU
    unasked."""
    import numpy as np

    from better_flow_tpu_torch.cli.manual_mode import ManualSession
    from better_flow_tpu_torch.models import clustering, local_flow
    from better_flow_tpu_torch.models import score_search
    from better_flow_tpu_torch.viz import debug_images

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = synthetic_events(2000, duration_s=0.1, res_x=48, res_y=48, seed=1)
    ev = (d["x"], d["y"], d["t_ns"])
    img = np.zeros((20, 24), np.float32)
    img[5:15, 4:20] = np.linspace(0.1, 0.9, 16, dtype=np.float32)
    mask = np.ones(len(d["x"]), bool)
    calls = [
        lambda: local_flow.flow_field_grid(*ev, 48, 48, step=16, wsz=15,
                                           scales=(3,), k=256),
        lambda: local_flow.gather_windows(*ev, mask, [24.0], [24.0], 15,
                                          64),
        lambda: score_search.compute_flow_bruteforce(
            *ev, res_x=48, res_y=48, x_range=(-0.01, 0.011),
            y_range=(0.0, 0.001), step=0.01, scale=1, wsize=3),
        lambda: clustering.cluster_events(d["x"], d["y"], d["u"], d["v"],
                                          mask, 1, 48, 48),
        lambda: debug_images.gradient_img(img, img, wsize=5),
        lambda: debug_images.gradient_img_color(img),
        lambda: debug_images.lr_gradient_img_color(img, wsize=5),
        lambda: debug_images.misalignment_img(img),
        lambda: ManualSession(*ev, tcfg.SensorConfig(48, 48)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    out = local_flow.flow_field_grid(*ev, 48, 48, step=16, wsz=15,
                                     scales=(3,), k=256, device="cpu")
    assert out["u"].shape == out["grid_x"].shape
    assert debug_images.misalignment_img(img, device="cpu").max() == 255
