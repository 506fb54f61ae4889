"""The multi-process paths of the PyTorch port: slice ranges with a carry
hand-off (``parallel.multihost``), independent slices (``parallel.temporal``)
and real collectives between two processes.

The range machinery (global plan and per-range staging, the carry hand-off,
the gate history before a range, disjoint first-slice-wins claims) is pinned
BITWISE against the port's full scan in one process, as
``tests/test_multihost.py`` pins the JAX package's, and each result is also
held against the JAX package's run of the same recording
(``scatter_mode="pallas"``, the Pallas kernels in interpret mode) under the
scan's gates (``torch_inputs.flow_gates``: noise and ``ran`` identical, the
iteration sums within 10%, median |du| and |dv| under 1% of the mean speed),
with the iterations equal slice for slice on the production geometry.  One
test spawns two CPU processes over gloo (a file store, the loopback
interface) and holds the event-parallel scan across ranks and the chained
multihost run equal to the single-process results.
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from better_flow_tpu.core.model import MotionModel as JaxModel  # noqa: E402
from better_flow_tpu.parallel import multihost as jmh  # noqa: E402
from better_flow_tpu.runtime import scan_pipeline as jscan  # noqa: E402
from better_flow_tpu_torch.config import (  # noqa: E402
    OptimizerConfig, PipelineConfig,
)
from better_flow_tpu_torch.convert import (  # noqa: E402
    carry_from_jax, carry_to_jax,
)
from better_flow_tpu_torch.core.events import make_slice  # noqa: E402
from better_flow_tpu_torch.core.model import FIELDS, MotionModel  # noqa: E402
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.models.global_flow import (  # noqa: E402
    process_slice,
)
from better_flow_tpu_torch.ops.layout import (  # noqa: E402
    CHUNK, pack_act, prepare_chunk_layouts,
)
from better_flow_tpu_torch.parallel.distributed import (  # noqa: E402
    initialize, make_host_mesh, process_local_slice_range,
)
from better_flow_tpu_torch.parallel.mesh import (  # noqa: E402
    make_pipeline_mesh,
)
from better_flow_tpu_torch.parallel.multihost import (  # noqa: E402
    compensate_recording_multihost, slice_ranges,
)
from better_flow_tpu_torch.parallel.temporal import (  # noqa: E402
    process_slices_batch,
)
from better_flow_tpu_torch.runtime.scan_pipeline import (  # noqa: E402
    compensate_recording_scan, make_carry, plan_slices, prepare_recording,
)
from torch_inputs import (  # noqa: E402
    SENSOR, bench_stream, flow_gates, gate_stream, small_cfg,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins work on small tensors; one intra-op thread keeps parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _cfg(sched, **kw):
    opt = OptimizerConfig.fast(scatter_mode="pallas") if sched == "fast" \
        else OptimizerConfig(scatter_mode="pallas")
    return PipelineConfig(optimizer=opt, **kw)


@pytest.fixture(scope="module")
def rec():
    """bench.py's stream, 180x240: three slices."""
    d = bench_stream(60_000)
    d["t_ns"] = np.ascontiguousarray(d["t_ns"], np.int64)
    return d


def _scan(d, cfg, **kw):
    return compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                     device="cpu", **kw)


def _ranges(d, cfg, bounds, chain=True):
    """Each range staged on its own and run, from the previous range's
    carry (``chain``) or from its own initial carry."""
    outs, carry = [], None
    for lohi in bounds:
        p = prepare_recording(d["x"], d["y"], d["t_ns"], cfg, device="cpu",
                              slice_range=lohi)
        assert p["slice_range"] == lohi and len(p["plan"].ends) == \
            lohi[1] - lohi[0]
        outs.append(compensate_recording_scan(
            None, None, None, cfg, prepared=p,
            carry_in=carry if chain else None))
        carry = outs[-1]["carry"]
    return outs


def _assert_union_is(outs, full):
    claimed = sum((o["u"] != 0).astype(np.int32) for o in outs)
    assert int(claimed.max()) <= 1                      # disjoint claims
    np.testing.assert_array_equal(sum(o["u"] for o in outs), full["u"])
    np.testing.assert_array_equal(sum(o["v"] for o in outs), full["v"])
    np.testing.assert_array_equal(
        np.any([o["noise"] for o in outs], axis=0), full["noise"])
    np.testing.assert_array_equal(
        np.concatenate([o["iters"] for o in outs]), full["iters"])


@pytest.mark.parametrize("sched", ["reference", "fast"])
def test_range_chain_equals_full(rec, sched):
    """Two ranges chained through the carry hand-off reproduce the full
    warm-start scan bit for bit: disjoint claims, identical flow, noise and
    per-slice iteration counts; and the JAX package's full scan within the
    gates, slice for slice in the iterations."""
    cfg = _cfg(sched)
    full = _scan(rec, cfg)
    S = len(plan_slices(rec["t_ns"], cfg).ends)
    assert S == 3
    r1, r2 = _ranges(rec, cfg, [(0, 1), (1, S)])
    _assert_union_is([r1, r2], full)
    assert (r1["u"] != 0).any() and (r2["u"] != 0).any()
    for f in FIELDS:
        assert torch.equal(getattr(r2["model"], f), getattr(full["model"], f))
    rj = jscan.compensate_recording_scan(rec["x"], rec["y"], rec["t_ns"], cfg)
    union = dict(u=r1["u"] + r2["u"], v=r1["v"] + r2["v"],
                 noise=r1["noise"] | r2["noise"],
                 ran=np.concatenate([r1["ran"], r2["ran"]]),
                 iters=np.concatenate([r1["iters"], r2["iters"]]))
    flow_gates(union, rj)
    np.testing.assert_array_equal(union["iters"], np.asarray(rj["iters"]))


def test_range_cold_boundary_stm_disable(rec):
    """With ``stm_disable`` the ranges are independent, so concurrent
    cold-boundary processing is exact."""
    cfg = _cfg("reference", stm_disable=True)
    full = _scan(rec, cfg)
    S = len(full["iters"])
    outs = _ranges(rec, cfg, [(0, 1), (1, 2), (2, S)], chain=False)
    _assert_union_is(outs, full)
    rm = compensate_recording_multihost(rec["x"], rec["y"], rec["t_ns"], cfg,
                                        boundary="cold", n_ranges=3,
                                        device="cpu")
    _assert_union_is([rm], full)
    rj = jscan.compensate_recording_scan(rec["x"], rec["y"], rec["t_ns"], cfg)
    flow_gates(full, rj)
    np.testing.assert_array_equal(full["iters"], np.asarray(rj["iters"]))


def test_boundary_noise_history():
    """A range whose first slices overlap a window-gated slice before the
    boundary reproduces the full scan's noise flags: the gate history
    before the range (``hist0``) is rebuilt from the recording, with no
    communication."""
    d = gate_stream()
    cfg = small_cfg(scatter_mode="pallas")
    full = _scan(d, cfg)
    assert full["noise"].any() and not full["noise"].all()
    S = len(full["iters"])
    gated = np.nonzero(~full["ran"])[0]
    mid = min(max(int(gated[-1]) + 1, 1), S - 1)
    p2 = prepare_recording(d["x"], d["y"], d["t_ns"], cfg, device="cpu",
                           slice_range=(mid, S))
    ws_h, st_h, en_h = p2["hist0"]
    assert ws_h.any() and p2["prev_end"] == full["plan"].ends[mid - 1]
    assert len(ws_h) == p2["hist_k"] == prepare_recording(
        d["x"], d["y"], d["t_ns"], cfg, device="cpu")["hist_k"]
    assert en_h[-1] == p2["prev_end"] and (st_h <= en_h).all()
    r1, r2 = _ranges(d, cfg, [(0, mid), (mid, S)])
    _assert_union_is([r1, r2], full)
    # The flagged events lie before the boundary (the first range claims
    # them); in the second range's slices they are inactive.  Without the
    # history they would be splatted, and the flow of the range changes.
    bare = compensate_recording_scan(
        None, None, None, cfg, prepared=p2,
        carry_in=make_carry(r1["carry"][0], p2["hist_k"]))
    assert not np.array_equal(bare["u"], r2["u"])
    rj = jscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
    np.testing.assert_array_equal(full["noise"], np.asarray(rj["noise"]))
    np.testing.assert_array_equal(full["ran"], np.asarray(rj["ran"]))


def test_multihost_single_process_fallback(rec):
    """``compensate_recording_multihost`` with one process is the plain
    scan; with several ranges and local shards it still is, bitwise."""
    cfg = _cfg("reference")
    full = _scan(rec, cfg)
    out = compensate_recording_multihost(rec["x"], rec["y"], rec["t_ns"], cfg,
                                         ev_per_host=1, device="cpu")
    _assert_union_is([out], full)
    st = out["stats"]
    assert st["n_processes"] == 1 and st["slice_range"] == (0, 3)
    assert st["n_slices_total"] == 3 and st["boundary"] == "chain"
    out3 = compensate_recording_multihost(rec["x"], rec["y"], rec["t_ns"],
                                          cfg, ev_per_host=2, n_ranges=3,
                                          device="cpu")
    _assert_union_is([out3], full)
    assert out3["stats"]["n_ranges"] == 3 and out3["stats"]["ev_per_host"] == 2
    for f in FIELDS:
        assert torch.equal(getattr(out3["model"], f),
                           getattr(full["model"], f))
    rj = jmh.compensate_recording_multihost(rec["x"], rec["y"], rec["t_ns"],
                                            cfg, ev_per_host=1)
    flow_gates(out, dict(rj, ran=np.asarray(rj["iters"]) > 0))
    np.testing.assert_array_equal(out["iters"], np.asarray(rj["iters"]))
    with pytest.raises(ValueError, match="boundary"):
        compensate_recording_multihost(rec["x"], rec["y"], rec["t_ns"], cfg,
                                       boundary="warm", device="cpu")
    assert slice_ranges(5, 3) == [(0, 2), (2, 4), (4, 5)]
    assert slice_ranges(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert process_local_slice_range(10) == (0, 10)
    assert initialize() is False          # nothing configured
    mesh = make_host_mesh(ev_per_host=2, device="cpu")
    assert (mesh.comm.size, mesh.n_slices, mesh.ev.n_local) == (1, 1, 2)


@pytest.mark.parametrize("f64", [False, True])
def test_range_hand_off_between_the_packages(rec, f64):
    """The JAX package runs the first range, the port the second from the
    JAX carry (model, seed and gate history through ``convert``), against
    the JAX package's own second range; and the port's carry goes back in
    the JAX package's layout."""
    cfg = _cfg("reference", f64_totals=f64)
    args = (rec["x"], rec["y"], rec["t_ns"], cfg)
    ctx = jax.enable_x64() if f64 else None
    if ctx is not None:
        ctx.__enter__()
    try:
        p1 = jscan.prepare_recording(*args, slice_range=(0, 1))
        j1 = jscan.compensate_recording_scan(None, None, None, cfg,
                                             prepared=p1)
        carry_np = jax.tree_util.tree_map(np.asarray, j1["carry"])
        p2 = jscan.prepare_recording(*args, slice_range=(1, 3))
        j2 = jscan.compensate_recording_scan(None, None, None, cfg,
                                             prepared=p2,
                                             carry_in=j1["carry"])
        j2 = {k: np.asarray(v) for k, v in j2.items()
              if k in ("u", "v", "noise", "iters", "ran")}
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    carry = carry_from_jax(carry_np)
    want = torch.float64 if f64 else torch.float32
    assert carry[0].total_dx.dtype == carry[0].comp_rot.dtype == want
    assert carry[0].cx.dtype == torch.float32
    t2 = compensate_recording_scan(
        None, None, None, cfg, carry_in=carry, prepared=prepare_recording(
            *args, device="cpu", slice_range=(1, 3)))
    flow_gates(t2, j2)
    np.testing.assert_array_equal(t2["iters"], j2["iters"])
    assert np.array_equal(t2["u"] != 0, j2["u"] != 0)     # the same claims
    back = carry_to_jax(carry)
    for a, b in zip(back[0], tuple(carry_np[0])):
        assert a.dtype == b.dtype and a == b
    for a, b in zip(back[1:], carry_np[1:]):
        np.testing.assert_array_equal(a, b)
    assert len(back[0]) == len(JaxModel._fields)


def test_process_slices_batch_equals_per_slice():
    """A batch of independent slices over (2 slice lanes x 2 event shards)
    against ``process_slice`` on each slice alone: the same bits."""
    cap = 2 * CHUNK
    opt = OptimizerConfig(scale=3, max_iter=6, min_events=100)
    evs, models = [], []
    for s in range(4):
        d = synthetic_events(int(cap * 0.7), duration_s=0.1, res_x=24,
                             res_y=32, vx=18.0 - 3 * s, vy=-12.0 + 2 * s,
                             n_points=60, seed=20 + s)
        evs.append(make_slice(d["x"], d["y"],
                              d["t_ns"].astype(np.float64), capacity=cap))
        models.append(MotionModel.zero().replace(
            total_dx=torch.tensor(0.002 * s), cx=torch.tensor(12.0),
            cy=torch.tensor(16.0)))
    mesh = make_pipeline_mesh(2, 2, device="cpu")
    for warm in (False, True):
        res = process_slices_batch(evs, models, opt, SENSOR, mesh,
                                   warm_start=warm)
        assert len(res) == 4
        for ev, m, r in zip(evs, models, res):
            xi, yi = ev.x[ev.valid].int(), ev.y[ev.valid].int()
            bbox = (int(xi.min()), int(xi.max()), int(yi.min()),
                    int(yi.max()))
            one, _ = process_slice(
                prepare_chunk_layouts(ev.x, ev.y, ev.t), pack_act(ev.active),
                m, opt, SENSOR, bbox, int(ev.valid.sum()), warm_start=warm,
                ev=ev)
            assert r.iters == one.iters >= 2 and r.ran
            for f in ("pr_x", "pr_y", "u", "v", "noise", "seed"):
                assert torch.equal(getattr(r, f), getattr(one, f)), f
            assert torch.equal(r.model.total_dx, one.model.total_dx)
    assert not torch.equal(res[0].u, res[1].u)
    with pytest.raises(ValueError, match="do not divide"):
        process_slices_batch(evs[:3], models[:3], opt, SENSOR, mesh)


_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    sys.path.insert(0, os.environ["BF_REPO"])
    sys.path.insert(0, os.path.join(os.environ["BF_REPO"], "tests"))
    import torch
    torch.set_num_threads(2)
    from better_flow_tpu_torch.config import OptimizerConfig
    from better_flow_tpu_torch.io.synthetic import synthetic_events
    from better_flow_tpu_torch.parallel import comm as pcomm
    from better_flow_tpu_torch.parallel.distributed import (
        initialize, make_host_mesh, process_local_slice_range, shutdown,
    )
    from better_flow_tpu_torch.parallel.event_parallel import (
        compensate_recording_scan_sharded,
    )
    from better_flow_tpu_torch.parallel.mesh import make_event_mesh
    from better_flow_tpu_torch.parallel.multihost import (
        compensate_recording_multihost,
    )
    from torch_inputs import small_cfg

    assert initialize()                       # from the BF_* variables
    c = pcomm.world()
    assert c.size == 2 and c.rank == int(os.environ["BF_PROCESS_ID"])
    t = torch.tensor([c.rank + 1, 10 * (c.rank + 1)])
    assert c.all_reduce_sum([t])[0].tolist() == [3, 30]
    assert c.all_reduce_min([t])[0].tolist() == [1, 10]
    assert c.all_reduce_max([t])[0].tolist() == [2, 20]
    assert c.broadcast([t], src=1)[0].tolist() == [2, 20]
    assert c.all_gather(t).tolist() == [[1, 10], [2, 20]]
    assert t.tolist() == [c.rank + 1, 10 * (c.rank + 1)]   # not in place
    u = t.clone()
    assert c.all_reduce_sum_([u])[0] is u and u.tolist() == [3, 30]
    assert process_local_slice_range(10) == ((0, 5), (5, 10))[c.rank]
    host = make_host_mesh(ev_per_host=2, device="cpu")
    assert (host.comm.size, host.n_slices, host.ev.n_local) == (2, 2, 2)

    d = synthetic_events(12000, duration_s=0.3, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    out = {}
    for name, cfg in (("fast", small_cfg()), ("f64", small_cfg().replace(
            f64_totals=True,
            optimizer=OptimizerConfig(scale=3, min_events=500))),
            ("xla", small_cfg(scatter_mode="xla"))):
        mesh = make_event_mesh(4, device="cpu")        # 2 ranks x 2 shards
        assert (mesh.n_local, mesh.first_shard) == (2, 2 * c.rank)
        r = compensate_recording_scan_sharded(d["x"], d["y"], d["t_ns"], cfg,
                                              mesh)
        m = compensate_recording_multihost(d["x"], d["y"], d["t_ns"], cfg,
                                           boundary="chain", ev_per_host=2,
                                           device="cpu")
        assert m["stats"]["n_processes"] == 2
        for tag, res in (("ev", r), ("mh", m)):
            for k in ("u", "v", "noise", "iters"):
                out[f"{name}_{tag}_{k}"] = res[k]
        out[f"{name}_mh_lo"] = np.array(m["stats"]["slice_range"])
    np.savez(os.environ["BF_OUT"], **out)
    shutdown()
    print(f"proc {c.rank} OK", flush=True)
""")


def test_two_processes_over_gloo_equal_one_process(tmp_path):
    """Two CPU processes over gloo: the event-parallel scan with its shards
    on both ranks (the image sum crosses the process boundary, the outputs
    are gathered) and the chained multihost run (one carry broadcast, one
    gather of the claims), each equal to the single-process result, in the
    kernel branch and in the XLA branch (its exact integer image pair
    summed across the ranks).  Both processes are killed after 300 s."""
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

    d = synthetic_events(12000, duration_s=0.3, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    outs = [np.load(str(tmp_path / f"o{r}.npz")) for r in range(2)]
    for name, cfg in (("fast", small_cfg()), ("f64", small_cfg().replace(
            f64_totals=True,
            optimizer=OptimizerConfig(scale=3, min_events=500))),
            ("xla", small_cfg(scatter_mode="xla"))):
        full = _scan(d, cfg)
        S = len(full["iters"])
        per = (S + 1) // 2
        for r, o in enumerate(outs):
            for k in ("u", "v", "noise", "iters"):
                np.testing.assert_array_equal(o[f"{name}_ev_{k}"], full[k])
            for k in ("u", "v", "noise"):
                np.testing.assert_array_equal(o[f"{name}_mh_{k}"], full[k])
            lo, hi = o[f"{name}_mh_lo"]
            assert (lo, hi) == (r * per, min((r + 1) * per, S))
            np.testing.assert_array_equal(o[f"{name}_mh_iters"],
                                          full["iters"][lo:hi])
