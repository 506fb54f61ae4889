"""The tiled pipeline of the PyTorch port against the JAX package on whole
recordings, and across two processes.

``compensate_recording_tiled`` of ``better_flow_tpu_torch/parallel/
spatial.py`` against the JAX package's on the same numpy-seeded recording:
a small-sensor cut (96x128, scale 1, slices of <= 6000 events) of the
720x1280 protocol of ``tests/test_spatial.py``.  The JAX side runs a 4x2
mesh under ``shard_map`` on the virtual CPU devices, with its XLA scatter
(``scatter_mode="xla"``) and with its Pallas kernels in interpret mode
(``"pallas"``); the port holds the eight tiles in one process and runs the
twins of B8 and B9.

Gates, those of ``tests/test_spatial.py``: noise identical; iterations equal
slice for slice under the reference schedule; per-event flow in the original
event order with median |du|, |dv| <= 0.5% of the mean speed, and a mean
speed that shows real flow.  Under the fast schedule a near-tolerance exit
turns an ulp into another iteration count and the warm-start chain carries
it on (``better_flow_tpu/models/global_flow.py:570-576``): the JAX package's
own two scatter modes part after four slices of this stream and end 2.2% of
the mean speed apart.  So against ``"pallas"`` (the port's arithmetic: the
chain holds for all 12 slices, median |du| 1e-5) the first half of the
slices must have equal counts, the sums agree within 10% and the flow
within 0.5%; against ``"xla"`` the first four slices, 15% (the JAX
package's own two runs count 176 and 156) and 3%.  Streams:
thin clusters at scale 1 (the first tried) never converge under the
reference schedule and part the port's own 4x2 from its 1x1 by 2% of the
speed; of six dense-cluster streams tried, the reference chain equals the
Pallas run's slice for slice on six and the XLA run's on five, the fast
chain the Pallas run's on one, the one used here.

One test spawns two CPU processes over gloo (a file store, the loopback
interface), one tile each of a 2x1 mesh and two tiles each of a 2x2 mesh, and
holds them bitwise against the same tiles in one process: the strips cross
the process boundary through ``comm.permute`` (on the 2x2 mesh beside the
copies between a rank's own two tiles), the escape lane and the tile sum
through ``all_gather``.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from better_flow_tpu.parallel import spatial as jsp  # noqa: E402
from better_flow_tpu_torch.config import OptimizerConfig  # noqa: E402
from better_flow_tpu_torch.core.model import FIELDS  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.parallel import spatial as tsp  # noqa: E402
from better_flow_tpu_torch.parallel.mesh import make_tiled_mesh  # noqa: E402
from better_flow_tpu_torch.runtime.scan_pipeline import (  # noqa: E402
    compensate_recording_scan,
)
from torch_inputs import tiled_cfg, tiled_stream  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HALO, ESC_CAP = 8, 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins work on small tensors; one intra-op thread keeps parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(schedule, **kw):
    if schedule == "fast":
        return OptimizerConfig.fast(scale=1, min_events=300, **kw)
    return OptimizerConfig(scale=1, max_iter=10, min_events=300, **kw)


def _stream():
    return tiled_stream(jitter_px=2.5, n_points=30)


def _port(d, cfg, mesh, **kw):
    return tsp.compensate_recording_tiled(
        d["x"], d["y"], d["t_ns"], cfg, make_tiled_mesh(mesh, device="cpu"),
        halo=HALO, esc_cap=ESC_CAP, **kw)


def _jax(d, cfg, mesh):
    nx, ny = mesh
    if len(jax.devices()) < nx * ny:
        pytest.skip(f"needs {nx * ny} virtual devices")
    jm = jax.make_mesh(mesh, ("tile_x", "tile_y"),
                       devices=jax.devices()[:nx * ny])
    return jsp.compensate_recording_tiled(d["x"], d["y"], d["t_ns"], cfg, jm,
                                          halo=HALO, esc_cap=ESC_CAP)


def _flow_agrees(a, b, min_speed=30.0, tol=0.005):
    """Noise identical; median |du|, |dv| <= ``tol`` (0.5%) of the mean
    speed."""
    np.testing.assert_array_equal(a["noise"], b["noise"])
    ok = ~b["noise"]
    speed = float(np.hypot(b["u"][ok], b["v"][ok]).mean())
    assert speed > min_speed, speed
    for k in ("u", "v"):
        assert np.median(np.abs(a[k][ok] - b[k][ok])) <= tol * speed, k
    return speed


@pytest.fixture(scope="module")
def port_runs():
    """The port's 4x2 run of the stream under each schedule (the scatter
    mode does not enter the port's path)."""
    d = _stream()
    return d, {s: _port(d, tiled_cfg(optimizer=_opt(s)), (4, 2))
               for s in ("reference", "fast")}


@pytest.mark.parametrize("mode", ["xla", "pallas"])
@pytest.mark.parametrize("schedule", ["reference", "fast"])
def test_recording_matches_jax(port_runs, schedule, mode):
    d, runs = port_runs
    rt = runs[schedule]
    rj = _jax(d, tiled_cfg(optimizer=_opt(schedule, scatter_mode=mode)),
              (4, 2))
    assert rt["stats"]["escaped_dropped"] == \
        rj["stats"]["escaped_dropped"] == 0
    for k in ("n_events", "n_slices", "n_tiles", "cap_per_tile"):
        assert rt["stats"][k] == rj["stats"][k], k
    ij = np.asarray(rj["iters"])
    S = len(ij)
    assert S == len(rt["iters"]) >= 10
    if schedule == "reference":
        np.testing.assert_array_equal(rt["iters"], ij)
        _flow_agrees(rt, rj)
    else:
        same, isum, tol = (S // 2, 0.1, 0.005) if mode == "pallas" \
            else (4, 0.15, 0.03)
        np.testing.assert_array_equal(rt["iters"][:same], ij[:same])
        assert abs(int(rt["iters"].sum()) - int(ij.sum())) <= isum * ij.sum()
        _flow_agrees(rt, rj, tol=tol)
    assert rt["stats"]["mean_iters"] == pytest.approx(rt["iters"].mean())
    total = int(rt["iters"].sum())
    # The exit test's read and the lane gate's, every iteration.
    assert rt["stats"]["host_syncs"] == 2 * total
    assert rt["stats"]["launches"]["splat_local"] == 0      # CPU: the twins


def _gate_recording(res=(96, 128)):
    """``tests/test_spatial.py``'s degenerate mid-recording segment at a
    smaller sensor: a moving scene, a burst at one pixel, the scene again."""
    rng = np.random.default_rng(1)
    a = tiled_stream(8000, res=res, seed=7, jitter_px=2.5, n_points=30,
                     duration_s=0.1)
    nb = 12_000
    bt = np.sort(rng.integers(0, int(0.12e9), nb)) + int(0.1e9)
    c = tiled_stream(8000, res=res, seed=8, jitter_px=2.5, n_points=30,
                     duration_s=0.1)
    x = np.concatenate([a["x"], np.full(nb, res[0] // 2), c["x"]])
    y = np.concatenate([a["y"], np.full(nb, res[1] // 2), c["y"]])
    t_ns = np.concatenate([a["t_ns"], bt, c["t_ns"] + int(0.22e9)])
    order = np.argsort(t_ns, kind="stable")
    return {"x": x[order].astype(np.float64), "y": y[order].astype(np.float64),
            "t_ns": np.ascontiguousarray(t_ns[order], np.int64)}


@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_recording_gates_and_noise_match_jax(mode):
    """The window gate fires mid-recording: the same slices are skipped, the
    same events are noise (the gated slices' own and, through the gate
    history, their copies in later slices), and processing goes on after
    it."""
    d = _gate_recording()
    cfg = tiled_cfg(optimizer=dataclasses.replace(_opt("reference"),
                                                  max_iter=8))
    rj = _jax(d, dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, scatter_mode=mode)), (4, 2))
    rt = _port(d, cfg, (4, 2))
    noise = np.asarray(rj["noise"])
    assert noise.any() and not noise.all()
    np.testing.assert_array_equal(rt["noise"], noise)
    np.testing.assert_array_equal(rt["iters"], np.asarray(rj["iters"]))
    assert (rt["iters"] == 0).any() and rt["iters"][-1] > 0
    _flow_agrees(rt, rj, min_speed=10.0)
    # The untiled port scan fires the same gates.
    ru = compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                   device="cpu")
    np.testing.assert_array_equal(rt["noise"], ru["noise"])
    np.testing.assert_array_equal(rt["iters"] > 0, ru["ran"])


def test_tiles_match_the_ports_1x1_and_untiled_scan(port_runs):
    """2x2 and 4x2 tiles against the port's own 1x1 run (noise and
    iterations identical, flow within the gates), a repeated run bitwise,
    staging reused, and the untiled port scan within the gates."""
    d, runs = port_runs
    cfg = tiled_cfg(optimizer=_opt("reference"))
    r1 = _port(d, cfg, (1, 1))
    r42 = runs["reference"]
    prep = tsp.prepare_recording_tiled(d["x"], d["y"], d["t_ns"], cfg, 2, 2)
    r22 = _port(d, cfg, (2, 2), prepared=prep)
    for r in (r22, r42):
        np.testing.assert_array_equal(r["iters"], r1["iters"])
        _flow_agrees(r, r1)
        assert r["stats"]["escaped_dropped"] == 0
    assert r1["stats"]["n_tiles"] == (1, 1) and r42["stats"]["n_tiles"] == (4, 2)
    assert r1["stats"]["host_syncs"] == 2 * int(r1["iters"].sum())
    assert r42["stats"]["cap_per_tile"] < r1["stats"]["cap_per_tile"]
    again = _port(d, cfg, (4, 2))
    for k in ("u", "v", "noise", "iters"):
        np.testing.assert_array_equal(again[k], r42[k])
    for f in FIELDS:
        assert torch.equal(getattr(again["model"], f),
                           getattr(r42["model"], f))
    ru = compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                   device="cpu")
    # The untiled scan sums in the megastep's order: a near-tolerance exit
    # may flip in a slice.
    assert np.mean(r42["iters"] == ru["iters"]) >= 0.9
    _flow_agrees(r42, ru)
    # A warm start from a given model, and independent slices.
    warm = _port(d, cfg, (2, 2), prepared=prep, init_model=r22["model"])
    assert not np.array_equal(warm["u"], r22["u"])
    cold = _port(d, dataclasses.replace(cfg, stm_disable=True), (2, 2),
                 prepared=prep)
    assert float(cold["model"].total_dx) != float(r22["model"].total_dx)
    assert cold["iters"][0] == r22["iters"][0]          # the first is cold
    np.testing.assert_array_equal(cold["noise"], r22["noise"])
    empty = _port({k: v[:0] for k, v in d.items()}, cfg, (2, 2))
    assert empty["u"].shape == (0,) and empty["stats"]["n_slices"] == 0


_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    sys.path.insert(0, os.environ["BF_REPO"])
    sys.path.insert(0, os.path.join(os.environ["BF_REPO"], "tests"))
    import torch
    torch.set_num_threads(2)
    from better_flow_tpu_torch.parallel import comm as pcomm
    from better_flow_tpu_torch.parallel.distributed import (
        initialize, shutdown,
    )
    from better_flow_tpu_torch.parallel.mesh import make_tiled_mesh
    from test_torch_tiled_recording import recording_runs, two_tile_runs

    assert initialize()                       # from the BF_* variables
    c = pcomm.world()
    assert c.size == 2
    t = torch.tensor([c.rank + 1, 10 * (c.rank + 1)])
    ring = [(0, 1), (1, 0)]
    assert c.permute([t], ring)[0].tolist() == [2 - c.rank, 10 * (2 - c.rank)]
    assert c.permute([t], [(0, 1)])[0].tolist() == ([0, 0], [1, 10])[c.rank]
    assert c.permute([t], [(0, 0), (1, 1)])[0].tolist() == t.tolist()
    mesh = make_tiled_mesh((2, 1), device="cpu")
    assert (mesh.n_tiles, mesh.n_local, mesh.first_tile) == (2, 1, c.rank)
    out = two_tile_runs(mesh)
    mesh = make_tiled_mesh((2, 2), device="cpu")
    assert (mesh.n_tiles, mesh.n_local, mesh.first_tile) == (4, 2, 2 * c.rank)
    out.update(recording_runs(mesh, "2x2_"))
    np.savez(os.environ["BF_OUT"], **out)
    shutdown()
    print(f"proc {c.rank} OK", flush=True)
""")


def recording_runs(mesh, prefix=""):
    """A tiled recording under both schedules, in the kernel branch and in
    the XLA branch (keys ``xla_...``), on ``mesh``: what a rank of the
    two-process run and the one-process run both compute."""
    d = tiled_stream(20_000, jitter_px=2.5, n_points=30)
    out = {}
    for mode, tag in (("auto", prefix), ("xla", f"{prefix}xla_")):
        for s in ("reference", "fast"):
            r = tsp.compensate_recording_tiled(
                d["x"], d["y"], d["t_ns"],
                tiled_cfg(optimizer=_opt(s, scatter_mode=mode)), mesh,
                halo=HALO, esc_cap=ESC_CAP)
            assert r["stats"]["escaped_dropped"] == 0
            for k in ("u", "v", "noise", "iters"):
                out[f"{tag}{s}_{k}"] = r[k]
            out[f"{tag}{s}_total_dx"] = r["model"].total_dx.numpy()
    return out


def two_tile_runs(mesh):
    """The 2x1 recording runs, and one slice whose warp drifts beyond the
    halo (the escape lane carries events between the two tiles), on
    ``mesh``."""
    from better_flow_tpu_torch.config import SensorConfig
    from better_flow_tpu_torch.core.model import MotionModel
    from better_flow_tpu_torch.io.synthetic import synthetic_events

    out = recording_runs(mesh)
    e = synthetic_events(6000, duration_s=0.1, res_x=48, res_y=64, vx=80.0,
                         vy=-50.0, n_points=100, seed=3)
    args = tsp.bucket_events(e["x"], e["y"], e["t_ns"].astype(np.float32), 48,
                             3, 2, 4096)
    for cap in (4096, 1):
        r = tsp.process_slice_tiled(
            *args, MotionModel.zero(),
            OptimizerConfig(scale=3, max_iter=16, min_events=100),
            SensorConfig(48, 64), mesh, halo=8, n_iters=16, esc_cap=cap)
        first = mesh.first_tile * 4096
        out[f"lane{cap}_u"] = np.zeros(2 * 4096, np.float32)
        out[f"lane{cap}_u"][first:first + mesh.n_local * 4096] = r.u.numpy()
        out[f"lane{cap}_dropped"] = np.array(r.escaped_dropped)
        out[f"lane{cap}_total_dx"] = r.model.total_dx.numpy()
    return out


def test_two_processes_over_gloo_equal_two_tiles_in_one_process(tmp_path):
    """A 2x1 mesh over two gloo processes, one tile each, bitwise two tiles
    in one process: the recording under both schedules and in both
    branches, the kernels' and the XLA branch's (every rank returns the
    whole recording's output), and the beyond-halo slice with a sized and a
    starved lane.  Then a 2x2 mesh, two tiles each (a strip exchange is
    part copy within a rank, part ``permute``), bitwise four tiles in one
    process.  Both processes are killed after 300 s."""
    store = tmp_path / "store"
    env = dict(os.environ, BF_REPO=ROOT, BF_COORDINATOR=f"file://{store}",
               BF_NUM_PROCESSES="2", GLOO_SOCKET_IFNAME="lo",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER],
        env=dict(env, BF_PROCESS_ID=str(r), BF_OUT=str(tmp_path / f"o{r}")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    deadline = time.monotonic() + 300
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                [0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail("the two-process run did not end within 300 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"proc {r} OK" in log, log[-3000:]

    want = two_tile_runs(make_tiled_mesh((2, 1), device="cpu"))
    want.update(recording_runs(make_tiled_mesh((2, 2), device="cpu"), "2x2_"))
    for k in ("2x2_reference_iters", "2x2_xla_reference_iters"):
        assert want[k].sum() > len(want[k])
    assert want["lane4096_dropped"] == 0 and want["lane1_dropped"] > 0
    assert want["reference_iters"].sum() > len(want["reference_iters"])
    outs = [np.load(str(tmp_path / f"o{r}.npz")) for r in range(2)]
    for r, o in enumerate(outs):
        for k, v in want.items():
            if k.startswith("lane") and k.endswith("_u"):
                # Each rank holds its own tile's slots.
                sl = slice(r * 4096, (r + 1) * 4096)
                np.testing.assert_array_equal(o[k][sl], v[sl], err_msg=k)
            else:
                np.testing.assert_array_equal(o[k], v, err_msg=k)
    assert tfm.LAUNCHES["finish_local"] == 0
