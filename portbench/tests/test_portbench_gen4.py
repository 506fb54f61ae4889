"""The megapixel cell's files: its configuration is the DAVIS240 cell's
slicing and optimizer on the Gen4 sensor, its limits file keeps the
schema, its entry hands the program's counters of the traced recording
to the readers (on the CPU, at a tiny size), and its five readers read
numbers from a made-up layer."""

import copy
import dataclasses
import json
import time

import pytest

from conftest import ROOT, TINY_SEED
from portbench import compare, harness, roofline, tracing

CELL = "offline-fast-gen4"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = [m["name"] for m in BENCH["per_layer"]
           if CELL in m.get("workloads", [])]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(name):
    c = next(c for c in BENCH["configs"] if c["name"] == name)
    return json.loads((ROOT / c["file"]).read_text())


def _reader(name):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                               "m_" + name.replace(".", "_"))


def test_configuration_is_davis240s_on_the_gen4_sensor():
    from better_flow_tpu_torch.config import OptimizerConfig

    gen4 = _config("gen4-720p-offline-fast")
    davis = _config("davis240-offline-fast")
    assert set(gen4["optimizer"]) == \
        {f.name for f in dataclasses.fields(OptimizerConfig)}
    assert gen4["optimizer"] == davis["optimizer"]
    assert gen4["slice"] == davis["slice"]
    assert gen4["sensor"] == {"res_x": 720, "res_y": 1280}
    assert gen4["reduced"] == []
    for k in ("guarantees", "precision", "stm_disable", "f64_totals"):
        assert gen4[k] == davis[k]
    assert gen4["entry_args"] == davis["entry_args"]
    mix = json.loads((ROOT / "portbench" / "traffic" /
                      "gen4-long-64m.json").read_text())
    assert {k: mix["scene"][k] for k in ("res_x", "res_y")} == gen4["sensor"]


def test_limits_file_keeps_the_schema():
    want = json.loads((ROOT / "portbench" / "limits" /
                       "offline-fast-long.json").read_text())
    got = json.loads((ROOT / "portbench" / "limits" /
                      f"{CELL}.json").read_text())
    assert set(got) == set(want) and got["cell"] == CELL
    assert set(got["limits"]) == set(want["limits"])
    for name, v in got["limits"].items():
        assert set(v) == {"limit", "lower", "upper", "from"}, name
        assert v["lower"] <= v["limit"] <= v["upper"], name
        assert v["from"]
    assert got["limits"]["noise_mismatch"]["limit"] == 0


def _cpu_trace(monkeypatch):
    """The tracer's profiler replaced by one made-up B2 operation over the
    traced span, so that the traced branch runs on the CPU."""
    def start(self):
        self._t0_host = time.perf_counter()

    def stop(self):
        t1 = time.perf_counter()
        return tracing.reduce([(self._t0_host, t1, "iteration_kernel")],
                              self.spans, self._t0_host, t1)

    monkeypatch.setattr(tracing.Tracer, "start", start)
    monkeypatch.setattr(tracing.Tracer, "stop", stop)


def _tiny_gen4():
    """The cell at a size the CPU twins run in seconds: its configuration
    and entry on a 45x80 sensor, recordings of 120,000 events of its scene
    with the speeds scaled with the sides."""
    cell = harness.find_cell(BENCH, CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.mix = copy.deepcopy(cell.mix)
    cell.config["sensor"] = {"res_x": 45, "res_y": 80}
    cell.mix["scene"].update(res_x=45, res_y=80, vx=15.0, vy=-12.5,
                             n_points=300)
    cell.mix.update(recording_events=120_000, pool_recordings=2,
                    pool_segments=3, segment_s=0.1)
    return cell


def test_entry_hands_the_counters_to_the_readers(monkeypatch):
    _cpu_trace(monkeypatch)
    cell = _tiny_gen4()
    entry = harness.load_module(cell.entry_path, "portbench_entry_counted")
    run = harness.Run(cell=cell, seed=TINY_SEED, seconds=0.2, trace=True,
                      device="cpu", t_process=time.perf_counter(),
                      limits=compare.limits(CELL))
    out = entry.run(run)
    p = out["layer"]["program"]
    assert set(p["counters"]) == {"iters", "finish_px", "window_px"}
    assert p["scale"] == 3
    H, W = 45 * 3 + 3, 80 * 3 + 3
    c = p["counters"]
    assert c["iters"] > 0
    assert c["finish_px"] == c["iters"] * H * W
    assert 0 < c["window_px"] < c["finish_px"]
    assert out["attempted"] >= 1 and out["checks"]
    for name in READERS:
        assert _reader(name).read(out["layer"]) is not None, name


def test_the_cells_readers():
    assert sorted(READERS) == sorted(
        ["kernels_roofline.gen4", "device_idle_share.gen4",
         "iters_per_slice.gen4", "finish_roofline.gen4",
         "finish_sweep_ratio.gen4"])


@pytest.mark.parametrize("name,want", [
    ("kernels_roofline.gen4", 25.0),
    ("device_idle_share.gen4", 40.0),
    ("iters_per_slice.gen4", 4.0),
    ("finish_sweep_ratio.gen4", 2.0),
    ("finish_roofline.gen4", None)])
def test_readers_on_a_made_up_layer(name, want):
    px = 4_000_000 * 12_000
    layer = {
        "offline": {"iters": 12_000, "slices_ran": 3_000},
        "trace": {"least_s": 0.5, "device_s": 2.0, "busy_s": 1.8,
                  "window_s": 3.0,
                  "device_ops": [["iteration_kernel", 1.0],
                                 ["void warp_images_st_kernel", 0.5]]},
        "program": {"counters": {"iters": 12_000, "finish_px": 2 * px,
                                 "window_px": px}, "scale": 3}}
    if name == "finish_roofline.gen4":
        want = 100.0 * roofline.bound_s(12 * px, roofline.ops_finish(px, 3))
    assert _reader(name).read(layer) == pytest.approx(want)


@pytest.mark.parametrize("name", ["finish_roofline.gen4",
                                  "finish_sweep_ratio.gen4"])
def test_counter_readers_without_the_counters(name):
    """A program that takes no finish counters (the parent of the
    counters): the readers give nothing and do not raise."""
    layer = {"offline": {}, "trace": {"device_ops": [["iteration_kernel",
                                                       1.0]]},
             "program": {"counters": {"iters": 5}, "scale": 3}}
    assert _reader(name).read(layer) is None


def test_control_fails_the_cells_limits():
    """At the tiny size, the program's readings meet the cell's limits and
    the bfloat16 control's fail them (``portbench/control.py``'s sides)."""
    from portbench import control

    sides = control.offline(_tiny_gen4(), TINY_SEED, "cpu",
                            ("program", "control"))
    lim = compare.limits(CELL)
    assert all(r["ok"] for r in compare.judge(sides["program"], lim))
    assert not all(r["ok"] for r in compare.judge(sides["control"], lim))
