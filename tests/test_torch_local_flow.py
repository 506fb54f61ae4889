"""The local flow field of the PyTorch port against the JAX package's, on
the same numpy-seeded inputs (BASELINE configuration 3).

``models.local_flow``: the Gaussian kernel, the gathered windows, the
count image and its score, the batched descent (on the JAX package's own
gathered windows and on the port's), and ``flow_field_grid`` on the
two-object DAVIS 346x260 scene of ``tests/test_config3_local_field.py``.
Every comparison is bitwise: the count images hold integers, so the box
sum, the blur and the score are exact in any order, and the warp and the
scaled pixel repeat XLA's compiled arithmetic.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.convert import windows_from_numpy  # noqa: E402
from better_flow_tpu_torch.models import local_flow as tlf  # noqa: E402
from better_flow_tpu_torch.ops import warp as twarp  # noqa: E402
from test_config3_local_field import (  # noqa: E402
    DAVIS_X,
    DAVIS_Y,
    _two_object_scene,
)

jlf = importlib.import_module("better_flow_tpu.models.local_flow")

CENTRES = ([24.0, 20.0, 30.0, 17.5], [24.0, 30.0, 18.0, 26.25])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    """test_local_flow's 48x48 translating scene (6000 events)."""
    d = synthetic_events(6000, duration_s=0.1, res_x=48, res_y=48,
                         vx=90.0, vy=-60.0, n_points=60, seed=3,
                         margin=0.25)
    return d["x"], d["y"], d["t_ns"].astype(np.float64)


def _windows(k=6144):
    x, y, t = _scene()
    valid = np.ones(len(x), bool)
    j = jlf.gather_windows(x, y, t, valid, *CENTRES, wsz=31, k=k)
    p = tlf.gather_windows(x, y, t, valid, *CENTRES, wsz=31, k=k,
                           device="cpu")
    return j, p


def _same(a, b, what=""):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                       b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("ksize", range(1, 10))
def test_gaussian_kernel_is_the_jax_packages(ksize):
    np.testing.assert_array_equal(tlf.gaussian_kernel_1d(ksize),
                                  jlf.gaussian_kernel_1d(ksize))


@pytest.mark.parametrize("k", [6144, 700, 40])
def test_gather_windows_bitwise(k):
    """Every field, with K above the events (fewer than K kept), between
    the inside counts and below them; a fractional centre included."""
    j, p = _windows(k)
    for f in jlf.LocalWindow._fields:
        _same(getattr(j, f), getattr(p, f), f)
    assert 0 < int(np.asarray(j.valid).sum(1).min())


@pytest.mark.parametrize("scale", [1, 3])
def test_count_image_and_score_bitwise(scale):
    """The blurred count image and its nonzero mean at 8 (nx, ny) points,
    each window at its own point, against ``_count_image`` and ``_score``
    compiled under ``vmap``."""
    j, p = _windows()
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.05, 0.05, (8, 2, len(CENTRES[0]))).astype(np.float32)
    img = jax.jit(jax.vmap(lambda w, a, b: jlf._count_image(w, a, b, scale,
                                                            31)))
    score = jax.jit(jax.vmap(jlf._score))
    for nx, ny in pts:
        ji = img(j, jnp.asarray(nx), jnp.asarray(ny))
        ti = tlf._count_image(p, torch.from_numpy(nx), torch.from_numpy(ny),
                              scale, 31)
        _same(ji, ti)
        assert float(ti.sum()) > 0
        _same(score(ji), tlf._score(ti))


def test_the_scaled_pixel_is_one_fused_multiply_add():
    """``fx = prx * scale + x_sh`` rounds once, as XLA compiles it: on
    events chosen where the two roundings give another pixel, the port's
    count image is the JAX package's, and the product rounded on its own
    would not be."""
    F = np.float32
    fma = lambda a, b, c: (np.float64(a) * b + np.float64(c)).astype(F)
    rng = np.random.default_rng(1)
    n = 1_000_000
    cx, cy, nx, ny = F(300.0), F(200.0), F(0.0371), F(-0.0213)
    x = rng.uniform(cx - 15, cx + 15, n).astype(F)
    y = rng.uniform(cy - 15, cy + 15, n).astype(F)
    t = rng.uniform(0, 1e8, n).astype(F)
    k = F(twarp.K_NT)
    prx, pry = fma(-t, F(nx * k), x), fma(-t, F(ny * k), y)
    shx, shy = fma(-cx, F(3), F(46.5)), fma(-cy, F(3), F(46.5))
    moved = ((fma(prx, F(3), shx).astype(np.int32)
              != (F(prx * F(3)) + shx).astype(np.int32))
             | (fma(pry, F(3), shy).astype(np.int32)
                != (F(pry * F(3)) + shy).astype(np.int32)))
    sel = np.concatenate([np.nonzero(moved)[0][:64], np.arange(2000)])
    assert moved.sum() >= 4
    one = lambda a: np.asarray(a)[None]
    win = jlf.LocalWindow(one(x[sel]), one(y[sel]), one(t[sel]),
                          np.ones((1, len(sel)), bool), one(cx), one(cy))
    ji = jax.jit(jax.vmap(lambda w, a, b: jlf._count_image(w, a, b, 3, 31)))(
        win, jnp.asarray([nx]), jnp.asarray([ny]))
    pw = windows_from_numpy(tuple(win))
    args = (pw, torch.tensor([nx]), torch.tensor([ny]), 3, 31)
    _same(ji, tlf._count_image(*args))
    fused = tlf.fma
    try:
        tlf.fma = lambda a, b, c: a * b + c
        apart = tlf._count_image(*args)
    finally:
        tlf.fma = fused
    assert (np.asarray(ji) != apart.numpy()).any()


def test_local_flow_field_bitwise_on_either_gather():
    """(u, v, n_events, iters, nx, ny) on the JAX package's own gathered
    windows (``convert.windows_from_numpy``) and on the port's, from zero
    and from a seed."""
    j, p = _windows()
    fetched = windows_from_numpy(jax.tree_util.tree_map(np.asarray, j))
    seed = (np.float32([0.1, 0.05, -0.02, 0.0]),
            np.float32([-0.07, 0.0, 0.01, 0.03]))
    for kw in ({}, dict(init_nx=seed[0], init_ny=seed[1], dn0=0.02)):
        want = jlf.local_flow_field(j, scale=3, wsz=31, **kw)
        for w in (fetched, p):
            got = tlf.local_flow_field(w, 3, 31, **kw)
            for name, a, b in zip("u v n_events iters nx ny".split(), want,
                                  got):
                _same(a, b, name)
    assert int(np.asarray(want[3]).max()) > 3


def test_the_blocking_reads_do_not_change_the_descent(monkeypatch):
    """Reading "any window active" every round or every ``CHECK_EVERY``
    rounds gives the same result; the reads are counted."""
    _, p = _windows()
    runs = []
    for every in (1, tlf.CHECK_EVERY):
        monkeypatch.setattr(tlf, "CHECK_EVERY", every)
        st = {}
        runs.append((tlf.local_flow_field(p, 3, 31, stats=st), st))
    (a, sa), (b, sb) = runs
    for x, y in zip(a, b):
        _same(x.numpy(), y)
    iters = int(a[3].max())
    assert sa["reads"] == [iters] and sa["rounds"] == [iters]
    assert sb["reads"] == [-(-sb["rounds"][0] // tlf.CHECK_EVERY)]
    assert sb["rounds"][0] >= iters


def test_flow_field_grid_config3_bitwise_and_its_gates():
    """The two-object DAVIS 346x260 scene at step 32, k 3072, scales
    (1, 3, 3), dense: bitwise the JAX package's in every output, and the
    AEE gates of ``tests/test_config3_local_field.py`` hold on the port's
    own result."""
    x, y, t_ns, va, vb = _two_object_scene()
    kw = dict(step=32, wsz=31, k=3072, dense=True)
    want = jlf.flow_field_grid(x, y, t_ns, DAVIS_X, DAVIS_Y, **kw)
    st = {}
    out = tlf.flow_field_grid(x, y, t_ns, DAVIS_X, DAVIS_Y, device="cpu",
                              stats=st, **kw)
    assert set(out) == set(want)
    for k in want:
        _same(want[k], out[k], k)
    assert len(st["rounds"]) == 3 and len(st["reads"]) == 3

    gx, gy = out["grid_x"], out["grid_y"]
    u, v, n_ev = out["u"], out["v"], out["n_events"]
    in_a = (gx > 40) & (gx < 130) & (gy > 70) & (gy < 210) & (n_ev >= 200)
    in_b = (gx > 216) & (gx < 306) & (gy > 70) & (gy < 210) & (n_ev >= 200)
    assert in_a.sum() >= 3 and in_b.sum() >= 3
    speed = float(np.hypot(*va))
    assert np.median(np.hypot(u[in_a] - va[0], v[in_a] - va[1])) < \
        0.25 * speed
    assert np.median(np.hypot(u[in_b] - vb[0], v[in_b] - vb[1])) < \
        0.25 * speed
    assert np.median(u[in_a]) > 40 and np.median(u[in_b]) < -40
    assert out["u_dense"].shape == (DAVIS_X, DAVIS_Y)
    assert out["u_dense"][85, 130] > 40 and out["u_dense"][261, 130] < -40


def test_interpolate_grid_to_dense_is_the_jax_packages():
    rng = np.random.default_rng(2)
    cx, cy = np.meshgrid(np.arange(15, 331, 16), np.arange(15, 245, 16),
                         indexing="ij")
    f = rng.normal(size=cx.shape).astype(np.float32)
    np.testing.assert_array_equal(
        tlf.interpolate_grid_to_dense(f, cx, cy, 346, 260),
        jlf.interpolate_grid_to_dense(f, cx, cy, 346, 260))
