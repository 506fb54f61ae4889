"""One slice through the PyTorch port's ``process_slice`` against the JAX
package's (kernel branch, Pallas kernels in interpret mode), from the same
numpy inputs: a spatially pre-sorted slice staged by the port, the same
model, seed and gate history."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.config import (  # noqa: E402
    OptimizerConfig, PipelineConfig,
)
from better_flow_tpu.core.events import EventSlice  # noqa: E402
from better_flow_tpu.core.model import MotionModel as JaxModel  # noqa: E402
from better_flow_tpu.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu.models.global_flow import (  # noqa: E402
    process_slice as jax_process_slice,
)
from better_flow_tpu.ops.pallas.fused_model import (  # noqa: E402
    act_rows_call as jax_act_rows,
)
from better_flow_tpu_torch.convert import carry_from_numpy  # noqa: E402
from better_flow_tpu_torch.models.global_flow import (  # noqa: E402
    check_supported, process_slice,
)
from better_flow_tpu_torch.ops.fused_model import act_rows_call  # noqa: E402
from better_flow_tpu_torch.runtime.scan_pipeline import (  # noqa: E402
    prepare_recording,
)
from torch_inputs import SENSOR, small_cfg  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**opt):
    return small_cfg(scatter_mode="pallas", **opt)


def _staged(d, cfg):
    return prepare_recording(d["x"], d["y"], d["t_ns"], cfg, device="cpu")


def _run_both(prep, s, cfg, model_vals=None, seed8=None, hist=None):
    """Slice ``s`` through both packages from the same state."""
    K = prep["hist_k"]
    ws, st_h, en_h = hist if hist is not None else (
        np.zeros(K, bool), np.zeros(K, np.int32), np.full(K, -1, np.int32))
    if model_vals is None:
        model_vals = np.zeros(len(JaxModel._fields), np.float32)
    seed8 = np.zeros(8, np.float32) if seed8 is None else seed8
    stat, sidx = prep["stat"][s], prep["sidx"][s]
    bbox, nv = prep["bbox"][s], int(prep["nval"][s])

    st_np, sidx_np = stat.numpy(), sidx.numpy()
    ev = EventSlice(x=jnp.asarray(st_np[:, 0].reshape(-1)),
                    y=jnp.asarray(st_np[:, 1].reshape(-1)),
                    t=jnp.asarray(st_np[:, 2].reshape(-1)),
                    valid=jnp.asarray(sidx_np >= 0),
                    noise=jnp.zeros(sidx_np.shape, bool))
    act_j = jax_act_rows(jnp.asarray(sidx_np), jnp.asarray(ws),
                         jnp.asarray(st_h), jnp.asarray(en_h))
    rj, uvn_j = jax_process_slice(
        ev, JaxModel(*(jnp.float32(v) for v in model_vals)), cfg.optimizer,
        SENSOR, presorted=True, stat3=jnp.asarray(st_np),
        seed=jnp.asarray(seed8), bbox=jnp.asarray(bbox), n_valid=nv,
        want_uvn=True, act3=act_j)

    carry = carry_from_numpy(model_vals, np.concatenate(
        [seed8, np.zeros(4, np.float32)]), ws, st_h, en_h)
    hist_t = torch.from_numpy(np.stack([ws.astype(np.int32), st_h, en_h]))
    rt, uvn_t = process_slice(stat, act_rows_call(sidx, hist_t), carry[0],
                              cfg.optimizer, SENSOR, bbox, nv,
                              seed=carry[1][:8])
    return rj, np.asarray(uvn_j), rt, uvn_t.numpy()


def _assert_slice_close(rj, uvn_j, rt, uvn_t):
    assert rt.iters == int(rj.iters)
    assert rt.ran == bool(rj.ran)
    assert rt.window_small == bool(rj.window_small)
    for f in ("total_dx", "total_dy", "total_rot", "total_div"):
        a, b = float(getattr(rj.model, f)), float(getattr(rt.model, f))
        assert abs(a - b) <= 1e-4 * max(1.0, abs(a)), (f, a, b)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(rt.v.numpy(), np.asarray(rj.v), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(uvn_t[:, 0:2], uvn_j[:, 0:2], rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_array_equal(uvn_t[:, 2], uvn_j[:, 2])


@pytest.fixture(scope="module")
def scene():
    d = synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32,
                         n_points=60, seed=3, vx=8.0, vy=-5.0, rot=0.05,
                         div=0.02)
    return _staged(d, _cfg())


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("s", [0, 5])
def test_process_slice_matches_jax(scene, s, seeded):
    cfg = _cfg()
    seed8 = (np.array([-2e3, -2e3, -40.0, -40.0, 0, 0, 0, 0], np.float32)
             if seeded else None)
    rj, uvn_j, rt, uvn_t = _run_both(scene, s, cfg, seed8=seed8)
    assert rt.ran and rt.iters >= 2
    _assert_slice_close(rj, uvn_j, rt, uvn_t)


def test_process_slice_warm_started_reference_schedule(scene):
    """A non-zero incoming model (warm start) under the parity schedule
    with the hi+lo time pair."""
    vals = np.zeros(len(JaxModel._fields), np.float32)
    f = {k: i for i, k in enumerate(JaxModel._fields)}
    vals[f["total_dx"]], vals[f["total_dy"]] = 0.008, -0.005
    vals[f["total_rot"]], vals[f["total_div"]] = 4e-4, 2e-4
    vals[f["cx"]], vals[f["cy"]] = 11.5, 16.0
    cfg = PipelineConfig(
        sensor=SENSOR, slice=_cfg().slice,
        optimizer=OptimizerConfig(scale=3, min_events=500,
                                  scatter_mode="pallas"))
    rj, uvn_j, rt, uvn_t = _run_both(scene, 3, cfg, model_vals=vals)
    assert rt.ran
    _assert_slice_close(rj, uvn_j, rt, uvn_t)


def _point_then_scene():
    rng = np.random.default_rng(3)
    n = 3000
    t = np.sort(rng.integers(0, int(0.15e9), n))
    d = synthetic_events(n, duration_s=0.15, res_x=24, res_y=32, vx=10.0,
                         vy=-6.0, n_points=60, seed=2)
    return {"x": np.concatenate([np.full(n, 7.0), d["x"]]),
            "y": np.concatenate([np.full(n, 9.0), d["y"]]),
            "t_ns": np.concatenate([t, d["t_ns"] + int(0.15e9)])}


def test_skip_branch_window_gate_matches_jax():
    """A slice of one pixel fires the window gate: the optimizer does not
    run, the warm-start warp of a non-zero model is the output, and every
    event is noise."""
    cfg = _cfg()
    prep = _staged(_point_then_scene(), cfg)
    s = 1
    assert prep["geoms"][s].window_small
    vals = np.zeros(len(JaxModel._fields), np.float32)
    vals[7:11] = [0.01, -0.02, 1e-3, 5e-4]
    vals[0:2] = [7.0, 9.0]
    rj, uvn_j, rt, uvn_t = _run_both(prep, s, cfg, model_vals=vals)
    assert not rt.ran and rt.iters == 0 and rt.window_small
    _assert_slice_close(rj, uvn_j, rt, uvn_t)
    valid = prep["sidx"][s].numpy().reshape(uvn_t.shape[0], -1) >= 0
    assert (uvn_t[:, 2][valid] == 1).all()
    assert float(rt.model.total_dx) == float(vals[7])


def test_skip_branch_too_few_events_matches_jax():
    """A slice with fewer than min_events events: skipped, but its events
    are not noise."""
    cfg = _cfg()
    d = synthetic_events(3000, duration_s=0.3, res_x=24, res_y=32, vx=8.0,
                         vy=-5.0, n_points=60, seed=4)
    prep = _staged(d, cfg)
    s = int(np.argmax(prep["nval"] < cfg.optimizer.min_events))
    assert prep["nval"][s] < cfg.optimizer.min_events
    assert not prep["geoms"][s].window_small
    rj, uvn_j, rt, uvn_t = _run_both(prep, s, cfg)
    assert not rt.ran and rt.iters == 0
    _assert_slice_close(rj, uvn_j, rt, uvn_t)
    valid = prep["sidx"][s].numpy().reshape(uvn_t.shape[0], -1) >= 0
    assert (uvn_t[:, 2][valid] == 0).all()


@pytest.mark.parametrize("field,value", [
    ("warm_extrapolate", 0.5), ("megastep_merged", True), ("splat_pair", 2),
    ("megastep_unroll", 2), ("scatter_mode", "xla"), ("scatter_mode", "rep")])
def test_unported_configurations_raise(field, value):
    """Every option of the list is ported now, and is accepted everywhere:
    ``megastep_merged``, ``warm_extrapolate``, ``splat_pair`` and
    ``megastep_unroll`` (an event group and the tiled path ignore the ones
    they do not run, as in the JAX package), and the XLA branch's modes,
    "xla" and "rep", which run on one device, under an event group and on
    the tiled path.  What still raises does so by name: an unknown value
    of the option."""
    opt = OptimizerConfig.fast(**{field: value})
    check_supported(opt)
    if field == "scatter_mode":
        with pytest.raises(NotImplementedError, match=field):
            check_supported(OptimizerConfig.fast(scatter_mode="segment"))


@pytest.mark.parametrize("schedule", ["fast", "reference"])
def test_use_megastep_off_takes_composed_loop(scene, schedule):
    """``use_megastep=False`` is supported under both schedules and runs
    the composed loop (B6 + the scalar update), whose result is the JAX
    package's composed loop's."""
    cfg = _cfg(use_megastep=False, schedule=schedule)
    check_supported(cfg.optimizer)
    rj, uvn_j, rt, uvn_t = _run_both(scene, 5, cfg)
    assert rt.ran and rt.iters >= 2
    _assert_slice_close(rj, uvn_j, rt, uvn_t)
