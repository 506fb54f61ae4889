"""The event-parallel paths of the PyTorch port against the JAX package's.

``process_slice_event_parallel`` (here) and
``compensate_recording_scan_sharded`` (``test_torch_sharded_scan.py``, which
states the gates for whole recordings) shard each slice's events, sum the
shards' pre-filter images once per optimizer iteration and finish on the
sum.  The JAX package runs them under ``shard_map`` on the 8 virtual CPU
devices of ``tests/conftest.py`` with ``scatter_mode="pallas"`` (the Pallas
kernels in interpret mode, as ``tests/test_sharded_pallas.py`` runs them);
the port holds its shards in one process on the CPU (the plain twins).

Gates.  Against the JAX package, one slice (those of
``tests/test_torch_slice.py``): ``ran``, ``window_small`` and the noise
flags identical, the iteration count equal, the totals within 1e-4
relative (of max(1, |total|)), per-event flow within rtol 1e-3 / atol 1e-2
px/s.  The port against itself: a sharded slice whose shards are whole
chunks is BITWISE the same for 1, 2 and 4 shards, because the summed images
are integers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.core import events as jev  # noqa: E402
from better_flow_tpu.core.model import MotionModel as JaxModel  # noqa: E402
from better_flow_tpu.parallel import event_parallel as jep  # noqa: E402
from better_flow_tpu.parallel.mesh import (  # noqa: E402
    make_event_mesh as jax_event_mesh,
)
from better_flow_tpu_torch.config import OptimizerConfig  # noqa: E402
from better_flow_tpu_torch.core import events as tev  # noqa: E402
from better_flow_tpu_torch.core.model import MotionModel  # noqa: E402
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.models import global_flow as tgf  # noqa: E402
from better_flow_tpu_torch.ops.layout import CHUNK  # noqa: E402
from better_flow_tpu_torch.parallel import event_parallel as tep  # noqa: E402
from better_flow_tpu_torch.parallel.comm import LocalComm, world  # noqa: E402
from better_flow_tpu_torch.parallel.mesh import (  # noqa: E402
    make_event_mesh, make_pipeline_mesh,
)
from torch_inputs import SENSOR  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins work on small tensors; one intra-op thread keeps parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def eight():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    return 8


def _events(cap=2048, seed=0, fill=0.9, **kw):
    kw = dict(dict(vx=18.0, vy=-12.0, n_points=60), **kw)
    d = synthetic_events(int(cap * fill), duration_s=0.1, res_x=24, res_y=32,
                         seed=seed, **kw)
    return d["x"], d["y"], d["t_ns"].astype(np.float64)


def _slices(cap=2048, seed=0, fill=0.9, **kw):
    x, y, t = _events(cap, seed, fill, **kw)
    return (jev.make_slice(x, y, t, capacity=cap),
            tev.make_slice(x, y, t, capacity=cap))


def _opt(**kw):
    return OptimizerConfig(**dict(dict(scale=3, max_iter=6, min_events=100,
                                       scatter_mode="pallas"), **kw))


def _assert_slice_close(rj, rt):
    assert rt.iters == int(rj.iters)
    assert rt.ran == bool(rj.ran)
    assert rt.window_small == bool(rj.window_small)
    np.testing.assert_array_equal(rt.noise.numpy(), np.asarray(rj.noise))
    for f in ("total_dx", "total_dy", "total_rot", "total_div"):
        a, b = float(getattr(rj.model, f)), float(getattr(rt.model, f))
        assert abs(a - b) <= 1e-4 * max(1.0, abs(a)), (f, a, b)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(rt.v.numpy(), np.asarray(rj.v), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(rt.pr_x.numpy(), np.asarray(rj.pr_x),
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------ one slice, against JAX


@pytest.mark.parametrize("drive", ["reference", "fast_composed"])
def test_process_slice_event_parallel_matches_jax(eight, drive):
    """8 shards in both packages: the megastep drive splits into B1, the
    sum, B2 (reference schedule); the composed drive into B7a, the sum, B7b
    (secant schedule)."""
    opt = {"reference": _opt(),
           "fast_composed": _opt(schedule="fast", use_megastep=False)}[drive]
    ev_j, ev_t = _slices(seed=3)
    rj = jep.process_slice_event_parallel(ev_j, JaxModel.zero(), opt, SENSOR,
                                          jax_event_mesh(8))
    rt = tep.process_slice_event_parallel(
        ev_t, MotionModel.zero(), opt, SENSOR,
        make_event_mesh(8, device="cpu"))
    assert rt.ran and rt.iters >= 2
    assert rt.u.shape == (2048,) and rt.noise.dtype == torch.bool
    _assert_slice_close(rj, rt)


def test_process_slice_event_parallel_warm_start_matches_jax(eight):
    """A non-zero incoming model, 4 shards."""
    ev_j, ev_t = _slices(seed=5)
    vals = dict(total_dx=0.008, total_dy=-0.005, total_rot=4e-4,
                total_div=2e-4, cx=11.5, cy=16.0)
    mj = JaxModel.zero()._replace(**{k: jnp.float32(v)
                                     for k, v in vals.items()})
    mt = MotionModel.zero().replace(**{k: torch.tensor(v)
                                       for k, v in vals.items()})
    opt = _opt()
    rj = jep.process_slice_event_parallel(ev_j, mj, opt, SENSOR,
                                          jax_event_mesh(4))
    rt = tep.process_slice_event_parallel(ev_t, mt, opt, SENSOR,
                                          make_event_mesh(4, device="cpu"))
    assert rt.ran and rt.iters >= 2
    _assert_slice_close(rj, rt)
    # The cold start drops the incoming model (the port against itself).
    cold = tep.process_slice_event_parallel(
        ev_t, mt, opt, SENSOR, make_event_mesh(4, device="cpu"),
        warm_start=False)
    zero = tep.process_slice_event_parallel(
        ev_t, MotionModel.zero(), opt, SENSOR,
        make_event_mesh(4, device="cpu"))
    assert cold.iters == zero.iters and torch.equal(cold.u, zero.u)
    assert not torch.equal(cold.u, rt.u)


@pytest.mark.parametrize("gate", ["too_few", "small_window"])
def test_event_parallel_gates_match_jax(eight, gate):
    """The skipped slice: too few events (not noise) and a degenerate
    window (every valid event noise), decided from the reduced bbox and
    count; the warm-start warp is applied and the model passes through."""
    if gate == "too_few":
        ev_j, ev_t = _slices(seed=2, fill=0.02)
    else:
        x, y, t = _events(seed=2)
        x, y = np.full_like(x, 7.0), np.full_like(y, 9.0)
        ev_j = jev.make_slice(x, y, t, capacity=2048)
        ev_t = tev.make_slice(x, y, t, capacity=2048)
    vals = dict(total_dx=0.01, total_dy=-0.02, cx=12.0, cy=15.0)
    mj = JaxModel.zero()._replace(**{k: jnp.float32(v)
                                     for k, v in vals.items()})
    mt = MotionModel.zero().replace(**{k: torch.tensor(v)
                                       for k, v in vals.items()})
    rj = jep.process_slice_event_parallel(ev_j, mj, _opt(), SENSOR,
                                          jax_event_mesh(8))
    rt = tep.process_slice_event_parallel(ev_t, mt, _opt(), SENSOR,
                                          make_event_mesh(8, device="cpu"))
    assert not rt.ran and rt.iters == 0
    assert rt.window_small == (gate == "small_window")
    assert bool(rt.noise.any()) == (gate == "small_window")
    _assert_slice_close(rj, rt)
    assert float(rt.model.total_dx) == pytest.approx(0.01)


def test_capacity_that_does_not_divide_raises():
    _, ev_t = _slices(cap=2050)
    with pytest.raises(ValueError, match="2050 not divisible"):
        tep.process_slice_event_parallel(
            ev_t, MotionModel.zero(), _opt(), SENSOR,
            make_event_mesh(4, device="cpu"))


def test_bounding_box_matches_jax():
    for seed, fill in ((1, 0.9), (2, 0.01), (3, 0.0)):
        ev_j, ev_t = _slices(seed=seed, fill=fill)
        want = tuple(int(v) for v in jev.bounding_box(ev_j))
        assert tev.bounding_box(ev_t) == want
        shards = tep.local_event_shards(ev_t, make_event_mesh(8,
                                                              device="cpu"))
        assert len(shards) == 8 and shards[0].capacity == 256
        assert tev.bounding_box(shards, LocalComm()) == want
        g = tgf.slice_geometry(shards, 3, SENSOR, 15, LocalComm())
        assert g == tgf.geometry_from_bbox(*want, 3, SENSOR, 15)


# ------------------------------------- sharded is bitwise unsharded


@pytest.mark.parametrize("drive", ["fast", "f64"])
def test_sharded_slice_is_bitwise_unsharded(drive):
    """``process_slice_event_parallel`` on a capacity of whole chunks per
    shard: 1, 2 and 4 shards give the same bits, per event and in the
    model."""
    cap = 4 * CHUNK
    _, ev = _slices(cap=cap, seed=7, fill=0.6)
    opt = _opt(schedule="fast") if drive == "fast" else _opt()
    m0 = MotionModel.zero(f64_totals=drive == "f64")
    runs = [tep.process_slice_event_parallel(
        ev, m0, opt, SENSOR, make_event_mesh(n, device="cpu"))
        for n in (1, 2, 4)]
    assert runs[0].ran and runs[0].iters >= 2
    for r in runs[1:]:
        assert r.iters == runs[0].iters
        for f in ("pr_x", "pr_y", "nx", "ny", "u", "v", "noise", "seed"):
            assert torch.equal(getattr(r, f), getattr(runs[0], f)), f
        assert torch.equal(r.model.total_rot, runs[0].model.total_rot)


# --------------------------------------------- groups and collectives


def test_local_comm_and_groups():
    c = world()
    assert isinstance(c, LocalComm) and (c.size, c.rank) == (1, 0)
    a, b = torch.arange(4), torch.ones(2, 3)
    for fn in (c.all_reduce_sum, c.all_reduce_min, c.all_reduce_max,
               c.broadcast):
        out = fn([a, b])
        assert torch.equal(out[0], a) and torch.equal(out[1], b)
    assert tuple(c.all_gather(b).shape) == (1, 2, 3)
    with pytest.raises(ValueError):
        c.broadcast([a], src=1)
    g = make_event_mesh(4, device="cpu")
    assert (g.n_shards, g.n_local, g.first_shard) == (4, 4, 0)
    assert g.device == torch.device("cpu")
    assert make_event_mesh(device="cpu").n_shards == 1
    with pytest.raises(ValueError):
        make_event_mesh(0, device="cpu")
    p = make_pipeline_mesh(2, 4, device="cpu")
    assert (p.n_slices, p.ev.n_local, p.comm.size) == (2, 4, 1)
    with pytest.raises(ValueError):
        make_pipeline_mesh(2, 0, device="cpu")
