"""The port's HUD frames, manual mode and viewer on the CPU, against the
JAX package's: ``f2str`` and ``hud_frame`` bitwise on the same slice
records, one manual-mode tick against the same steps through the JAX
functions, the 'c' key through the reference schedule's kernel twins, and
the viewer's outputs byte for byte (its copy imports nothing of either
package).  The CLI's ``-i``, ``--img`` and ``--video`` are in
``test_torch_cli.py``."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.cli import viewer as jviewer  # noqa: E402
from better_flow_tpu.config import SensorConfig as JaxSensor  # noqa: E402
from better_flow_tpu.core.events import make_slice  # noqa: E402
from better_flow_tpu.core.model import MotionModel as JaxModel  # noqa: E402
from better_flow_tpu.io.event_file import write_events  # noqa: E402
from better_flow_tpu.models import global_flow as jgf  # noqa: E402
from better_flow_tpu.ops.time_image import time_image as jtime  # noqa: E402
from better_flow_tpu.ops.warp import project_4param_reinit  # noqa: E402
from better_flow_tpu.viz import video as jvideo  # noqa: E402
from better_flow_tpu.viz.debug_images import (  # noqa: E402
    gradient_img_color as jgrad_color,
)
from better_flow_tpu.viz.images import color_time_img  # noqa: E402
from better_flow_tpu_torch.cli import viewer as tviewer  # noqa: E402
from better_flow_tpu_torch.cli.manual_mode import (  # noqa: E402
    DIVIDERS, ManualSession, slider_deltas,
)
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.runtime.dvs_flow import DVSFlow  # noqa: E402
from better_flow_tpu_torch.viz import video as tvideo  # noqa: E402
from better_flow_tpu_torch.viz.debug_images import (  # noqa: E402
    gradient_img_color,
)
from torch_inputs import SENSOR, small_cfg  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors; one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream():
    return synthetic_events(9000, duration_s=0.25, res_x=24, res_y=32,
                            vx=20.0, vy=-14.0, seed=2)


@pytest.mark.parametrize("v", [0.0, -0.0, 0.004, 0.05, 1.0, 3.14159,
                               -3.14159, -0.5, 12.3456, -0.019, 1e4 / 3])
def test_f2str_equals_jax(v):
    assert tvideo.f2str(v) == jvideo.f2str(v)


def test_hud_frame_equals_jax(stream):
    """Every slice record of a stream on the CPU twins, with the engine's
    state at that slice, gives the JAX ``hud_frame``'s image bit for
    bit."""
    cfg = small_cfg().replace(accumulate=True)
    engine = DVSFlow(cfg, device="cpu")
    frames = []

    def on_slice(r):
        args = (r, engine.last_model, 24, 32, engine.time_diff,
                cfg.slice.refresh_time_ns, engine.get_buf_size(),
                r.n_events)
        frames.append((tvideo.hud_frame(*args), jvideo.hud_frame(*args)))

    engine.on_slice = on_slice
    engine.add_events(stream["x"], stream["y"], stream["t_ns"])
    engine.recompute()
    assert len(frames) >= 5
    for got, want in frames:
        assert got.shape == (2 * 24 * 3, 2 * 32 * 3, 3)
        np.testing.assert_array_equal(got, want)
    assert frames[-1][0].any()


def _jax_tick(st, deltas, scale=3):
    """One tick of the JAX package's manual mode (manual_mode.py:56-80 of
    the JAX package), step for step."""
    ev, geom, H, W = st["ev"], st["geom"], st["H"], st["W"]
    dx, dy, rot, div = deltas
    model = st["model"]
    cx = (float(model.cx) - float(geom.x_shift)) / scale
    cy = (float(model.cy) - float(geom.y_shift)) / scale
    model = model._replace(
        dx=jnp.float32(dx), dy=jnp.float32(dy), rot=jnp.float32(rot),
        div=jnp.float32(div)).update_accumulators(*DIVIDERS)
    pr_x, pr_y, _, _ = project_4param_reinit(
        ev.x, ev.y, ev.t, st["pr_x"], st["pr_y"], -model.total_dx,
        -model.total_dy, cx, cy, model.total_div, -model.total_rot)
    timg = jtime(pr_x, pr_y, ev.t, ev.active, scale, geom.x_shift,
                 geom.y_shift, geom.w_dyn, geom.h_dyn, H, W)
    st.update(model=model, pr_x=pr_x, pr_y=pr_y)
    return timg


def test_manual_ticks_equal_the_jax_steps(stream):
    """Three ticks of slider positions: the model's totals and the warp
    bitwise the JAX steps; the time image with the same support and
    within 1e-5 relative (the JAX package sums it in f32 in scatter
    order, the port in exact fixed point); the colour-time view bitwise,
    and the gradient view of the JAX time image bitwise the JAX view."""
    k = 3000
    x, y = stream["x"][:k], stream["y"][:k]
    t = stream["t_ns"][:k] - stream["t_ns"][0]
    sess = ManualSession(x, y, t, SENSOR, scale=3, device="cpu")
    ev = make_slice(np.asarray(x, np.float64), np.asarray(y, np.float64),
                    np.asarray(t, np.float64))
    sensor = JaxSensor(24, 32)
    st = dict(ev=ev, geom=jgf.slice_geometry(ev, 3, sensor),
              model=JaxModel.zero(), pr_x=ev.x, pr_y=ev.y)
    st["H"], st["W"] = jgf.static_image_shape(3, sensor)
    for pos in [(140, 120, 200, 60, 3), (150, 100, 30, 250, 10),
                (127, 127, 127, 127, 500)]:
        deltas = slider_deltas(pos)
        want = np.asarray(_jax_tick(st, deltas))
        got = sess.tick(deltas).numpy()
        for f in ("total_dx", "total_dy", "total_rot", "total_div",
                  "comp_dx", "comp_rot"):
            assert float(getattr(sess.model, f)) == float(
                getattr(st["model"], f)), f
        np.testing.assert_array_equal(sess.pr_x.numpy(),
                                      np.asarray(st["pr_x"]))
        np.testing.assert_array_equal(sess.pr_y.numpy(),
                                      np.asarray(st["pr_y"]))
        np.testing.assert_array_equal(got != 0, want != 0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        grad, color = sess.views()
        np.testing.assert_array_equal(color, color_time_img(
            np.asarray(st["pr_x"]), np.asarray(st["pr_y"]),
            np.asarray(ev.t), scale=3, res_x=24, res_y=32))
        np.testing.assert_array_equal(
            gradient_img_color(want, device="cpu"), jgrad_color(want))
        assert grad.shape == want.shape + (3,) and grad.any()
    assert abs(float(sess.model.total_dx)) > 0


def test_manual_c_runs_the_reference_schedule(stream):
    """'c' after a tick: ``process_slice`` under ``OptimizerConfig(scale)``
    (the megastep twin on the CPU) moves the model towards the stream's
    flow, keeps the warp in the events' own order, and the next tick warps
    from the optimized totals."""
    k = 3000
    t = stream["t_ns"][:k] - stream["t_ns"][0]
    sess = ManualSession(stream["x"][:k], stream["y"][:k], t, SENSOR,
                         device="cpu")
    sess.tick(slider_deltas((127, 127, 127, 127, 500)))
    res = sess.optimize()
    assert res.ran and res.iters > 1
    assert sess.pr_x.shape == (k,)
    # The warp of an event at (x, y) after time t moved against its flow.
    moved = (sess.pr_x.numpy() - stream["x"][:k]).std()
    assert moved > 0.05
    before = float(sess.model.total_dx)
    sess.tick(slider_deltas((127, 127, 127, 127, 500)))
    assert float(sess.model.total_dx) == before
    grad, color = sess.views()
    assert grad.any() and color.any()


@pytest.fixture(scope="module")
def viewer_file(tmp_path_factory):
    """test_cli.py's viewer recording."""
    d = synthetic_events(15000, duration_s=0.3, res_x=24, res_y=32,
                         vx=20.0, vy=-14.0, seed=2)
    p = str(tmp_path_factory.mktemp("viewer") / "rec.txt")
    write_events(p, d["x"], d["y"], d["t_ns"], d["polarity"])
    return p


@pytest.mark.parametrize("case", ["analysis", "color_time", "empty"])
def test_viewer_copy_equals_the_jax_viewer(viewer_file, tmp_path, capsys,
                                           case):
    """test_cli.py's three viewer tests on the port's copy, and its files
    and printed lines byte for byte the JAX viewer's."""
    window = ["9.0", "9.5"] if case == "empty" else ["0.0", "0.25"]
    extra = ["--color-time"] if case == "color_time" else []
    runs = {}
    for name, mod in (("port", tviewer), ("jax", jviewer)):
        prefix = str(tmp_path / name / "v")
        os.makedirs(os.path.dirname(prefix))
        rc = mod.main([viewer_file, *window, "--out-prefix", prefix,
                       *extra])
        out = capsys.readouterr()
        files = {f: open(os.path.join(tmp_path, name, f), "rb").read()
                 for f in sorted(os.listdir(tmp_path / name))}
        runs[name] = (rc, out.out.replace(prefix, "P"), files)
    assert runs["port"] == runs["jax"]
    rc, text, files = runs["port"]
    if case == "empty":
        assert rc == 1 and not files
        return
    assert rc == 0 and "flow:" in text
    assert {"v_projected.png", "v_sobel.png"} <= set(files)
    if case == "color_time":
        img = cv2.imdecode(np.frombuffer(files["v_color_time.png"],
                                         np.uint8), cv2.IMREAD_COLOR)
        covered = img.any(axis=2)
        assert covered.any() and not covered.all()
        hues = np.unique(cv2.cvtColor(img, cv2.COLOR_BGR2HSV)[..., 0][
            covered])
        assert len(hues) > 8
