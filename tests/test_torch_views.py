"""Clustering, the debug views, the gradient window means, the sampled
model terms, the box sums and the warp API of the PyTorch port against the
JAX package's, on the same numpy-seeded inputs.

The JAX package computes the views op by op (eagerly): the port repeats
that arithmetic (each product rounded on its own), so the views, the
window means and the labels are held bitwise.  The warp API is held
bitwise against the JAX functions compiled (``jax.jit``), at angles whose
f32 cosine and sine XLA rounds as the port does; the gap elsewhere is
shown.  The sampled model terms sum in f64 where XLA sums in f32: rtol
1e-6.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.config import SensorConfig  # noqa: E402
from better_flow_tpu.core.events import make_slice  # noqa: E402
from better_flow_tpu.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu.models import global_flow as gf  # noqa: E402
from better_flow_tpu.ops.time_image import time_image  # noqa: E402
from better_flow_tpu_torch.models import clustering as tcl  # noqa: E402
from better_flow_tpu_torch.ops import gradient as tgr  # noqa: E402
from better_flow_tpu_torch.ops import reductions as tred  # noqa: E402
# The module (``ops`` exports the function under its name, as the JAX
# package's ``ops`` does).
tti = importlib.import_module("better_flow_tpu_torch.ops.time_image")
from better_flow_tpu_torch.ops import warp as twarp  # noqa: E402
from better_flow_tpu_torch.viz import debug_images as tdi  # noqa: E402

jcl = importlib.import_module("better_flow_tpu.models.clustering")
jdi = importlib.import_module("better_flow_tpu.viz.debug_images")
jgr = importlib.import_module("better_flow_tpu.ops.gradient")
jred = importlib.import_module("better_flow_tpu.ops.reductions")
jti = importlib.import_module("better_flow_tpu.ops.time_image")
jwarp = importlib.import_module("better_flow_tpu.ops.warp")

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*a):
    return [torch.from_numpy(np.array(v)) for v in a]


def _same(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                       b.shape, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@functools.lru_cache(maxsize=None)
def _slice_image():
    """test_debug_images' time image (24x32 sensor, scale 3) with its
    slice and geometry, and a seeded uint8-range projection image."""
    d = synthetic_events(2000, duration_s=0.1, res_x=24, res_y=32,
                         vx=18.0, vy=-12.0, n_points=60, seed=1)
    ev = make_slice(d["x"], d["y"], d["t_ns"].astype(np.float64))
    small = SensorConfig(24, 32)
    H, W = gf.static_image_shape(3, small)
    geom = gf.slice_geometry(ev, 3, small)
    img = time_image(ev.x, ev.y, ev.t, ev.active, 3, geom.x_shift,
                     geom.y_shift, geom.w_dyn, geom.h_dyn, H, W)
    pr = np.random.default_rng(0).integers(0, 256, img.shape).astype(
        np.float32)
    return np.asarray(img), pr, ev, geom


def _blobs():
    rng = np.random.default_rng(0)
    n = 400
    x = np.concatenate([rng.normal(6, 0.5, n), rng.normal(18, 0.5, n)])
    y = np.concatenate([rng.normal(6, 0.5, n), rng.normal(24, 0.5, n)])
    u = np.concatenate([np.full(n, 10.0), np.full(n, -5.0)])
    return x, y, u, np.zeros(2 * n)


# -- clustering ---------------------------------------------------------------

def test_label_components_bitwise():
    occ = np.zeros((16, 16), bool)
    occ[2:5, 2:5] = True
    occ[10:13, 10:14] = True
    occ[6:9, 0:16:2] = True
    for n in (64, 3):
        _same(jcl.label_components(jnp.asarray(occ), n_iters=n),
              tcl.label_components(torch.from_numpy(occ), n_iters=n))


@pytest.mark.parametrize("scale,min_count", [(1, 2), (3, 2), (3, 0)])
def test_cluster_events_bitwise(scale, min_count):
    """test_aux's two blobs: every output, and test_aux's gates on the
    port's own result."""
    x, y, u, v = _blobs()
    mask = np.ones(len(x), bool)
    mask[::17] = False
    kw = dict(scale=scale, res_x=24, res_y=32, min_count=min_count)
    want = jcl.cluster_events(x, y, u, v, mask, **kw)
    out = tcl.cluster_events(x, y, u, v, mask, device="cpu", **kw)
    assert set(out) == set(want) and out["n_clusters"] == want["n_clusters"]
    for k in ("cluster_id", "sizes", "mean_u", "mean_v", "label_img"):
        _same(want[k], out[k], k)
    if scale == 1:
        assert out["n_clusters"] == 2
        ms = sorted(out["mean_u"])
        assert abs(ms[0] + 5.0) < 1.0 and abs(ms[1] - 10.0) < 1.0
    _same(jcl.merge_clusters(out["cluster_id"], 0, 1),
          tcl.merge_clusters(out["cluster_id"], 0, 1))


# -- gradients, box sums ------------------------------------------------------

@pytest.mark.parametrize("wsize", [9, 5, 3])
def test_lr_sobel_and_fuse_bitwise(wsize):
    """``lr_sobel`` and ``lr_sobel_fuse`` as the JAX package's views call
    them (eagerly), and ``gradient_img_fuse`` eager and compiled."""
    img, pr, _, _ = _slice_image()
    ti, tp = _t(img, pr)
    for a, b in zip(jgr.lr_sobel(jnp.asarray(img), wsize),
                    tgr.lr_sobel(ti, wsize)):
        _same(a, b)
        assert np.count_nonzero(np.asarray(a)) > 100
    for a, b in zip(jgr.lr_sobel_fuse(jnp.asarray(img), jnp.asarray(pr),
                                      wsize),
                    tgr.lr_sobel_fuse(ti, tp, wsize)):
        _same(a, b)
    gx, gy = tgr.masked_scharr(ti, contract=False)
    for jfn in (jgr.gradient_img_fuse, jax.jit(jgr.gradient_img_fuse)):
        for a, b in zip(jfn(jnp.asarray(pr), jnp.asarray(gx.numpy()),
                            jnp.asarray(gy.numpy())),
                        tgr.gradient_img_fuse(tp, gx, gy)):
            _same(a, b)


def test_the_scharr_pair_eager_and_compiled():
    """Op by op (the views) against XLA's contracted sums (the XLA branch):
    each held bitwise by its own form, and the two forms differ."""
    img, _, _, _ = _slice_image()
    (ti,) = _t(img)
    eager = jgr.masked_scharr(jnp.asarray(img))
    for a, b in zip(eager, tgr.masked_scharr(ti, contract=False)):
        _same(a, b)
    for a, b in zip(jax.jit(jgr.masked_scharr)(img), tgr.masked_scharr(ti)):
        _same(a, b)
    assert (np.asarray(eager[0]) != tgr.masked_scharr(ti)[0].numpy()).any()


def test_hypot_is_jnp_hypot():
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(2, 50_000)) * 10.0 ** rng.integers(
        -6, 6, (2, 50_000))).astype(np.float32)
    a[:5], b[:5] = [0, np.inf, 0, -3, np.inf], [0, 1, -0.0, 4, np.inf]
    _same(jax.jit(jnp.hypot)(a, b), tgr.hypot(*_t(a, b)))


@pytest.mark.parametrize("wsize", [2, 50])
def test_an_even_window_raises_and_names_it(wsize):
    """The JAX package fails on a broadcast for an even window (its
    views' default of 50, ``viz/debug_images.py:27``); the port raises a
    ``ValueError`` that names it."""
    img, pr, _, _ = _slice_image()
    with pytest.raises(ValueError):
        jdi.gradient_img(img, pr, wsize=wsize)
    ti, tp = _t(img, pr)
    for call in (lambda: tgr.lr_sobel(ti, wsize),
                 lambda: tgr.lr_sobel_fuse(ti, tp, wsize),
                 lambda: tdi.gradient_img(img, pr, wsize=wsize,
                                          device="cpu"),
                 lambda: tdi.lr_gradient_img_color(img, wsize=wsize,
                                                   device="cpu")):
        with pytest.raises(ValueError, match=f"wsize={wsize} is even"):
            call()
    with pytest.raises(ValueError, match="wsize=50 is even"):
        tdi.gradient_img(img, pr, device="cpu")


@pytest.mark.parametrize("size", [1, 3, 5, 25])
def test_box_sums_batched_and_exact(size):
    """``box_filter`` over leading dims is the 2-D filter of each image,
    bitwise; ``box_sum_int`` on counts is ``reduce_window``'s f32 sum."""
    rng = np.random.default_rng(size)
    f = rng.uniform(0, 1, (2, 3, 40, 50)).astype(np.float32)
    got = tti.box_filter(torch.from_numpy(f), size)
    for i in range(2):
        for j in range(3):
            _same(tti.box_filter(torch.from_numpy(f[i, j]), size), got[i, j])
            if size <= 5:
                _same(jax.jit(jti.box_filter, static_argnums=1)(f[i, j],
                                                                 size),
                      got[i, j])
    cnt = np.minimum(rng.poisson(2.0, (3, 60, 70)) * 60, 255).astype(
        np.float32)
    got = tti.box_sum_int(torch.from_numpy(cnt), size)
    for i in range(3):
        _same(jax.jit(jti.box_filter, static_argnums=1)(cnt[i], size),
              got[i])


# -- the views ----------------------------------------------------------------

@pytest.mark.parametrize("wsize", [9, 5])
def test_the_four_views_equal(wsize):
    """``gradient_img``, ``gradient_img_color``, ``lr_gradient_img_color``
    and ``misalignment_img`` on test_debug_images' time image: equal."""
    img, pr, _, _ = _slice_image()
    prs = (pr, np.full(img.shape, 100, np.uint8))
    for p in prs:
        _same(jdi.gradient_img(img, p, wsize=wsize),
              tdi.gradient_img(img, p, wsize=wsize, device="cpu"))
    _same(jdi.gradient_img_color(img),
          tdi.gradient_img_color(img, device="cpu"))
    _same(jdi.lr_gradient_img_color(img, wsize=wsize),
          tdi.lr_gradient_img_color(img, wsize=wsize, device="cpu"))
    for steps in (64, 5):
        out = tdi.misalignment_img(img, max_steps=steps, device="cpu")
        _same(jdi.misalignment_img(img, max_steps=steps), out)
        assert out.max() == 255


def _ramp_and_plateau():
    ramp = np.zeros((16, 16), np.float32)
    ramp[4:12, 4:12] = np.linspace(0.1, 0.8, 8)[None, :].repeat(8, 0)
    plateau = np.zeros((16, 16), np.float32)
    plateau[3:13, 2:14] = 0.5
    bowl = np.zeros((24, 24), np.float32)
    r, c = np.mgrid[:24, :24]
    bowl[1:23, 1:23] = (0.1 + ((r - 11.3) ** 2 + (c - 12.6) ** 2) / 400.0
                        )[1:23, 1:23].astype(np.float32)
    return ramp, plateau, bowl


@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("max_steps", [64, 6, 1])
def test_walk_lengths_in_fixed_rounds(maximize, max_steps):
    """``max_steps - 1`` masked rounds give the JAX ``while_loop``'s walk
    lengths, on a ramp (walks run to the ramp's end or the bound), a
    plateau (no neighbour is better: every walk has length 1) and a bowl
    (walks of many lengths, some cut by the bound)."""
    for img in _ramp_and_plateau():
        want = np.asarray(jdi._walk_lengths(jnp.asarray(img), maximize,
                                            max_steps))
        _same(want, tdi._walk_lengths(torch.from_numpy(img), maximize,
                                      max_steps))
    ramp, plateau, _ = _ramp_and_plateau()
    got = tdi._walk_lengths(torch.from_numpy(plateau), maximize, max_steps)
    assert set(np.unique(got.numpy())) == {0, 1}
    got = tdi._walk_lengths(torch.from_numpy(ramp), maximize, max_steps)
    assert int(got.max()) == min(8, max_steps)


# -- the sampled model terms --------------------------------------------------

@pytest.mark.parametrize("seed,p", [(0, 0.5), (1, 0.1), (2, 1.0)])
def test_model_compute_sampled_on_jax_indices(seed, p):
    """The inner function fed ``jax.random.randint``'s own indices: rtol
    1e-6 (f64 sums against XLA's f32 sums); the count exactly."""
    img, _, ev, geom = _slice_image()
    jimg = jnp.asarray(img)
    cx, cy, _ = jred.center_of_mass(jimg)
    key = jax.random.key(seed)
    want = jred.model_compute_sampled(jimg, ev.x, ev.y, ev.valid, cx, cy, 3,
                                      geom.x_shift, geom.y_shift, key, p=p)
    n = ev.x.shape[0]
    idx = np.asarray(jax.random.randint(key, (max(int(n * p), 1),), 0, n))
    args = _t(img, ev.x, ev.y, ev.valid, cx, cy)
    got = tred.model_compute_sampled_at(
        *args[:6], 3, *_t(geom.x_shift, geom.y_shift),
        torch.from_numpy(idx.astype(np.int64)))
    assert float(got.cnt) == float(want.cnt) > 0
    for f in ("dx", "dy", "rot", "div"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=1e-6,
                                   err_msg=f)
    gen = torch.Generator().manual_seed(seed)
    a = tred.model_compute_sampled(*args[:6], 3,
                                   *_t(geom.x_shift, geom.y_shift), gen, p=p)
    gen.manual_seed(seed)
    b = tred.model_compute_sampled(*args[:6], 3,
                                   *_t(geom.x_shift, geom.y_shift), gen, p=p)
    assert float(a.cnt) > 0 and all(torch.equal(u, w) for u, w in zip(a, b))


# -- the warp API ------------------------------------------------------------

ANGLES = [0.0, 0.013, -0.2, 1.1]


def _warp_inputs():
    rng = np.random.default_rng(3)
    n = 50_000
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    frx, fry, t = f(0, 180), f(0, 240), f(0, 2e8)
    return (frx, fry, t, frx + f(-3, 3), fry + f(-3, 3), f(-1, 1), f(-1, 1),
            f(-0.1, 0.1), f(-0.1, 0.1))


@pytest.mark.parametrize("crl", ANGLES)
def test_warp_api_bitwise(crl):
    """``n_from_u``, ``project_dn``, ``project_divcrl`` and
    ``project_4param`` against the JAX functions compiled with their
    inputs as arguments."""
    frx, fry, t, prx, pry, nx, ny, dnx, dny = _warp_inputs()
    tt = _t(frx, fry, t, prx, pry, nx, ny, dnx, dny)
    _same(jax.jit(jwarp.n_from_u)(nx), twarp.n_from_u(tt[5]))
    for a, b in zip(jax.jit(jwarp.project_dn)(frx, fry, t, nx, ny, dnx, dny),
                    twarp.project_dn(*tt[:3], *tt[5:])):
        _same(a, b)
    sc = [np.float32(v) for v in (90.5, 120.25, 0.03, crl)]
    for a, b in zip(jax.jit(jwarp.project_divcrl)(frx, fry, t, prx, pry, nx,
                                                  ny, *sc),
                    twarp.project_divcrl(*tt[:7], *sc)):
        _same(a, b)
    sc = [np.float32(v) for v in (0.02, -0.01, 90.5, 120.25, 0.03, crl)]
    for a, b in zip(jax.jit(jwarp.project_4param)(frx, fry, t, prx, pry, nx,
                                                  ny, *sc),
                    twarp.project_4param(*tt[:7], *sc)):
        _same(a, b)


def test_the_cosine_gap():
    """The port's f32 cosine and sine are f64's rounded once; XLA's f32
    ones are not always correctly rounded: over 100,000 angles in
    [-pi, pi] they differ in about 1.3% of cases, each by one ulp.  The
    warp API is held bitwise at ``ANGLES``, where they agree."""
    a = np.random.default_rng(4).uniform(-3.2, 3.2, 100_000).astype(
        np.float32)
    c, s = twarp.cos_sin_f32(torch.from_numpy(a))
    for jfn, mine in ((jnp.cos, c), (jnp.sin, s)):
        j = np.asarray(jax.jit(jfn)(a))
        ulps = np.abs(j.view(np.int32) - mine.numpy().view(np.int32))
        assert ulps.max() <= 1 and 0.002 < (ulps > 0).mean() < 0.05
    ang = np.float32(ANGLES)
    c, s = twarp.cos_sin_f32(torch.from_numpy(ang))
    _same(jax.jit(jnp.cos)(ang), c)
    _same(jax.jit(jnp.sin)(ang), s)
