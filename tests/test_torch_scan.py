"""``compensate_recording_scan`` of the PyTorch port against the JAX
package's, with ``OptimizerConfig.fast(scatter_mode="pallas")`` (the JAX
kernels in interpret mode), on the same recordings.

The port reproduces the JAX path's compiled f32 arithmetic (ops/warp.py);
what remains are the seven finish sums, which JAX takes in f32 in XLA's
order and the port in f64 (they agree to ~1e-7).  Near-tolerance exits can
turn such differences into a different iteration count, and the warm-start
chain carries that on (global_flow.py:570-576 of the JAX package).  On the
production geometry the two chains agree slice for slice; on 24x32 windows
(gradients from a few hundred pixels) about half of random streams drift
apart somewhere mid-chain, the structureless noise stream among them, so
that stream is held to the gates that do not depend on the chain.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from better_flow_tpu.config import (  # noqa: E402
    OptimizerConfig, PipelineConfig,
)
from better_flow_tpu.core.model import MotionModel as JaxModel  # noqa: E402
from better_flow_tpu.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu.runtime import scan_pipeline as jscan  # noqa: E402
from better_flow_tpu_torch.convert import (  # noqa: E402
    carry_from_numpy, carry_to_numpy,
)
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from torch_inputs import bench_stream as _bench_stream  # noqa: E402
from torch_inputs import flow_gates as _flow_gates  # noqa: E402
from torch_inputs import gate_stream as _gate_stream  # noqa: E402
from torch_inputs import small_cfg  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small_cfg():
    return small_cfg(scatter_mode="pallas")


def _prod_cfg():
    return PipelineConfig(
        optimizer=OptimizerConfig.fast(scatter_mode="pallas"))


def _all_gates(rt, rj, d):
    ok = _flow_gates(rt, rj)
    assert np.mean(rt["iters"] == rj["iters"]) >= 0.9, (rt["iters"],
                                                        rj["iters"])

    def aee(r):
        return float(np.median(np.hypot(r["u"][ok] - d["u"][ok],
                                        r["v"][ok] - d["v"][ok])))

    assert aee(rt) <= 1.05 * aee(rj), (aee(rt), aee(rj))


def _both(d, cfg, **kw):
    rj = jscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                         **kw.get("jax", {}))
    rt = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                         device="cpu", **kw.get("torch", {}))
    return rt, rj


def test_small_config_matches_jax():
    d = synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    rt, rj = _both(d, _small_cfg())
    assert len(rt["iters"]) > 10 and rt["ran"].all()
    _all_gates(rt, rj, d)
    st = rt["stats"]
    assert st["n_events"] == len(d["x"]) and st["n_slices"] == len(rt["iters"])
    assert st["host_syncs"] == int(rt["iters"].sum())
    assert st["mean_iters"] == pytest.approx(rt["iters"].mean())
    assert st["events_per_s"] > 0 and st["run_s"] > 0 and st["plan_s"] > 0
    assert st["launches"] == dict.fromkeys(st["launches"], 0)   # CPU: twins


def test_gate_firing_stream_matches_jax():
    d = _gate_stream()
    rt, rj = _both(d, _small_cfg())
    assert rt["noise"].any() and not rt["noise"].all()
    assert not rt["ran"].all() and rt["ran"].any()
    _flow_gates(rt, rj)


def test_production_geometry_matches_jax():
    """bench.py's configuration: 180x240, scale 3, 50k/20k slices."""
    d = _bench_stream(60_000)
    rt, rj = _both(d, _prod_cfg())
    assert len(rt["iters"]) == 3 and rt["ran"].all()
    _all_gates(rt, rj, d)
    np.testing.assert_array_equal(rt["iters"], rj["iters"])


def test_mid_chain_start_matches_jax():
    """Both packages continue the same warm-start chain: the JAX carry
    after the first 40k events (a non-zero model and seed) starts both on
    the next 60k events."""
    cfg = _prod_cfg()
    d = _bench_stream(100_000)
    a = {k: v[:40_000] for k, v in d.items()}
    b = {k: v[40_000:] for k, v in d.items()}
    ra = jscan.compensate_recording_scan(a["x"], a["y"], a["t_ns"], cfg)
    model_a, seed12 = ra["carry"][0], np.asarray(ra["carry"][1])
    assert abs(float(model_a.total_dx)) > 1e-3 and np.any(seed12[:4] != 0)
    hist_k = tscan.history_depth(tscan.plan_slices(b["t_ns"], cfg))
    carry_j = jscan.make_carry(model_a, hist_k, seed=ra["carry"][1])
    carry_t = carry_from_numpy([np.asarray(v) for v in model_a], seed12,
                               np.zeros(hist_k, bool),
                               np.zeros(hist_k, np.int32),
                               np.full(hist_k, -1, np.int32))
    rt, rj = _both(b, cfg, jax={"carry_in": carry_j},
                   torch={"carry_in": carry_t})
    _all_gates(rt, rj, b)
    for f, v in zip(JaxModel._fields, carry_to_numpy(rt["carry"])[0]):
        a_, b_ = float(getattr(rj["model"], f)), float(v)
        assert abs(a_ - b_) <= 1e-4 * max(1.0, abs(a_)), (f, a_, b_)


def test_carry_round_trip():
    d = synthetic_events(8000, duration_s=0.2, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    r = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"],
                                        _small_cfg(), device="cpu")
    vals, seed12, ws, st_h, en_h = carry_to_numpy(r["carry"])
    assert vals.shape == (15,) and seed12.shape == (12,)
    assert vals.dtype == seed12.dtype == np.float32
    assert ws.dtype == bool and st_h.dtype == en_h.dtype == np.int32
    assert np.any(vals != 0) and en_h[-1] == len(d["x"]) - 1
    back = carry_to_numpy(carry_from_numpy(vals, seed12, ws, st_h, en_h))
    for x, y in zip(back, (vals, seed12, ws, st_h, en_h)):
        np.testing.assert_array_equal(x, y)
    by_name = dict(zip(JaxModel._fields, vals))
    np.testing.assert_array_equal(
        carry_to_numpy(carry_from_numpy(by_name, seed12, ws, st_h, en_h))[0],
        vals)
    jm = JaxModel(*vals)     # the JAX package takes the same values back
    assert float(jm.total_dx) == float(vals[JaxModel._fields.index(
        "total_dx")])


def test_port_imports_no_jax():
    """Every module of the port imports without JAX, and the scan and the
    streaming path run without it."""
    import pkgutil

    import better_flow_tpu_torch

    modules = sorted(m.name for m in pkgutil.walk_packages(
        better_flow_tpu_torch.__path__, "better_flow_tpu_torch."))
    assert {"better_flow_tpu_torch.runtime.dvs_flow",
            "better_flow_tpu_torch.runtime.live",
            "better_flow_tpu_torch.cli.motion_compensator"} <= set(modules)
    code = (
        "import sys, importlib, numpy as np\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import better_flow_tpu_torch as p\n"
        "from better_flow_tpu_torch.runtime.offline import "
        "compensate_recording\n"
        "from better_flow_tpu_torch.config import PipelineConfig, "
        "SensorConfig, SliceConfig, OptimizerConfig\n"
        "from better_flow_tpu_torch.io.synthetic import synthetic_events\n"
        "d = synthetic_events(6000, duration_s=0.2, res_x=24, res_y=32, "
        "vx=20.0, vy=-14.0, seed=2)\n"
        "cfg = PipelineConfig(sensor=SensorConfig(24, 32), slice=SliceConfig("
        "max_events=4000, span_ns=int(0.1e9), refresh_events=1500, "
        "refresh_time_ns=int(0.04e9)), optimizer=OptimizerConfig.fast("
        "scale=3, min_events=500))\n"
        "r = p.compensate_recording_scan(d['x'], d['y'], d['t_ns'], cfg, "
        "device='cpu')\n"
        "assert r['ran'].any()\n"
        "o = compensate_recording(d['x'], d['y'], d['t_ns'], cfg.replace("
        "optimizer=OptimizerConfig(scale=3, min_events=500)), device='cpu')\n"
        "assert o['stats']['n_slices'] > 0\n"
        "print('jax' in sys.modules, any(m.startswith('jax') for m in "
        "sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


def test_f64_totals_raises():
    """f64 totals run under the reference schedule (test_torch_composed.py);
    with the ``fast`` schedule they raise, naming the JAX package's
    while-loop TypeError, which leaves that combination without a
    reference."""
    d = synthetic_events(3000, duration_s=0.1, res_x=24, res_y=32, seed=1)
    cfg = _small_cfg().replace(f64_totals=True)
    assert cfg.optimizer.schedule == "fast"
    with pytest.raises(NotImplementedError, match="fast.*TypeError"):
        tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                        device="cpu")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py fails, printing no result, where there is no CUDA
    device, and from a directory holding nothing else of the repository."""
    import shutil

    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    for script, cwd in ((os.path.join(ROOT, "chip_smoke.py"), ROOT),
                        (str(lone), str(tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
