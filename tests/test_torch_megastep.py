"""B5, the megastep: the PyTorch port's ``megastep_call`` (its plain twin on
the CPU) against the JAX package's ``megastep_call`` in interpret mode, and
the routing of the reference schedule through it.

Inputs are numpy-seeded (``torch_inputs.slice_inputs``) on a 24x32 sensor
at scale 3 and on the production 180x240 sensor at scales 1 and 3.  The new
positions are bit-identical; the state is held to the tolerances of the
finish kernel's test (the JAX kernel sums its f32 images in XLA's order,
the port its integer images in f64), with ST_FB left out: the TPU kernel
counts its splat-window fallbacks there, which the port does not have.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.config import OptimizerConfig  # noqa: E402
from better_flow_tpu.ops.pallas import fused_model as jfm  # noqa: E402
from better_flow_tpu_torch.models import global_flow as tgf  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.ops import layout  # noqa: E402
from torch_inputs import (  # noqa: E402
    assert_state_close, image_shape, slice_inputs,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

KEYS = ("stat", "act", "pr", "st", "geo")
GEOMETRIES = {            # name: (sensor, scale, chunks)
    "24x32_s3": ((24, 32), 3, 3),
    "180x240_s1": ((180, 240), 1, 2),
    "180x240_s3": ((180, 240), 3, 2),
}
SCHEDULES = {"reference": OptimizerConfig(), "fast": OptimizerConfig.fast()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(geometry, schedule, seed=0):
    res, scale, nch = GEOMETRIES[geometry]
    d = slice_inputs(seed, res=res, scale=scale, nch=nch)
    H, W = image_shape(res, scale)
    opt = SCHEDULES[schedule]
    kw = dict(scale=scale, H=H, W=W, **tgf.finish_statics(opt))
    return d, kw, opt.splat_time_lo or schedule != "fast"


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_megastep_matches_pallas(geometry, schedule):
    d, kw, time_lo = _case(geometry, schedule)
    npr_j, st_j = jfm.megastep_call(*(jnp.asarray(d[k]) for k in KEYS),
                                    time_lo=time_lo, **kw)
    npr, st = tfm.megastep_call(*(_t(d[k]) for k in KEYS), time_lo=time_lo,
                                **kw)
    np.testing.assert_array_equal(npr.numpy(), np.asarray(npr_j))
    assert_state_close(st.numpy()[0], np.asarray(st_j)[0],
                       skip=(layout.ST_FB,))
    assert st[0, layout.ST_ITERS] == 3.0
    assert tfm.LAUNCHES["megastep"] == 0          # CPU tensors: the twin


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_megastep_twin_is_the_split_chain(geometry, schedule):
    """The twin is B1's twin followed by B2's, bit for bit."""
    d, kw, time_lo = _case(geometry, schedule, seed=1)
    args = [_t(d[k]) for k in KEYS]
    npr, st = tfm.megastep_plain(*args, time_lo=time_lo, **kw)
    statics = {k: v for k, v in kw.items() if k not in ("scale", "H", "W")}
    geo_kw = dict(scale=kw["scale"], H=kw["H"], W=kw["W"])
    npr2, at, ac = tfm.warp_images_st_call(
        *args, *tfm.image_pair("cpu", kw["H"], kw["W"]), time_lo=time_lo,
        **geo_kw)
    st2 = tfm.megastep_finish_call(at, ac, args[3], args[4], **geo_kw,
                                   **statics)
    assert torch.equal(npr, npr2) and torch.equal(st, st2)


def test_megastep_converged_state_matches_pallas():
    """A state near convergence: both exits (CONT -> 0) agree, and the
    kernel still runs a full iteration (it is not predicated on CONT)."""
    d, kw, time_lo = _case("24x32_s3", "reference", seed=3)
    d["st"][0, 24:28] *= 1e-3
    d["st"][0, 18:22] = [1e-6, 1e-6, 1e-6, -1e-6]
    d["st"][0, layout.ST_CONT] = 0.0
    npr_j, st_j = jfm.megastep_call(*(jnp.asarray(d[k]) for k in KEYS),
                                    time_lo=time_lo, **kw)
    npr, st = tfm.megastep_call(*(_t(d[k]) for k in KEYS), time_lo=time_lo,
                                **kw)
    np.testing.assert_array_equal(npr.numpy(), np.asarray(npr_j))
    assert_state_close(st.numpy()[0], np.asarray(st_j)[0],
                       skip=(layout.ST_FB,))
    assert st[0, layout.ST_ITERS] == d["st"][0, layout.ST_ITERS] + 1
    assert not np.array_equal(npr.numpy(), d["pr"])


def test_megastep_checks_its_inputs():
    d, kw, _ = _case("24x32_s3", "reference")
    a = {k: _t(d[k]) for k in KEYS}
    with pytest.raises(TypeError, match="dtype"):
        tfm.megastep_call(a["stat"], a["act"], a["pr"], a["st"].double(),
                          a["geo"], **kw)
    with pytest.raises(ValueError, match="shape"):
        tfm.megastep_call(a["stat"], a["act"][:2], a["pr"], a["st"],
                          a["geo"], **kw)
    with pytest.raises(ValueError, match="no kernel"):
        tfm.megastep_call(*(v.to("meta") for v in a.values()), **kw)


@pytest.mark.parametrize("schedule,split", [("reference", False),
                                            ("fast", True)])
def test_schedule_routes_its_kernels(monkeypatch, schedule, split):
    """The reference schedule (megastep_split=False) runs one megastep per
    iteration; the fast presets run the B1 + B2 pair."""
    calls = {"megastep": 0, "warp_images_st": 0, "megastep_finish": 0}

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap

    for name in calls:
        monkeypatch.setattr(tgf, f"{name}_call",
                            counted(name, getattr(tfm, f"{name}_call")))
    d, kw, _ = _case("24x32_s3", schedule)
    opt = SCHEDULES[schedule]
    assert opt.megastep_split == split
    model = tgf.model_from_state(_t(d["st"]))
    _, _, _, iters, _, reads = tgf.run_fused_mega(
        _t(d["stat"]), _t(d["act"]), _t(d["geo"]), model, opt, 3, kw["H"],
        kw["W"])
    assert iters >= 2 and reads == iters
    if split:
        assert calls == dict(megastep=0, warp_images_st=iters,
                             megastep_finish=iters)
    else:
        assert calls == dict(megastep=iters, warp_images_st=0,
                             megastep_finish=0)
