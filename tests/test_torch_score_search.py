"""The score search of the PyTorch port against the JAX package's, on the
same numpy-seeded inputs.

``models.score_search``: ``window_scores``, ``score_candidate``,
``sweep_candidates`` at chunk sizes 1, 7 and 63, a sweep with ties, and
``compute_flow_bruteforce``, on test_local_flow's 32x32 translation.
Bitwise throughout: the images hold integers (exact sums), and the warp
and the scaled pixel repeat XLA's compiled arithmetic.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from better_flow_tpu.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.models import score_search as tss  # noqa: E402

jss = importlib.import_module("better_flow_tpu.models.score_search")

SCALE, WSIZE = 3, 9
KW = dict(res_x=32, res_y=32, x_range=(-0.1, 0.11),
          y_range=(-0.01, 0.011), step=0.01, scale=SCALE, wsize=WSIZE)
STATIC = ("scale", "wsize", "w_img", "h_img")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(t_zero=False):
    """test_local_flow's 32x32 translation (vx 40 px/s), as f32, with its
    geometry (x_min, y_min, w_img, h_img) and 63 candidates."""
    d = synthetic_events(3000, duration_s=0.1, res_x=32, res_y=32, vx=40.0,
                         vy=0.0, n_points=50, seed=7, margin=0.25)
    x, y = d["x"].astype(np.float32), d["y"].astype(np.float32)
    t = d["t_ns"].astype(np.float32)
    if t_zero:
        t = np.zeros_like(t)
    x_min, y_min = float(np.floor(x.min())), float(np.floor(y.min()))
    geo = (x_min, y_min, int((x.max() - x_min + 1) * SCALE) + SCALE,
           int((y.max() - y_min + 1) * SCALE) + SCALE)
    cnx, cny = np.meshgrid(np.arange(-0.1, 0.11, 0.01),
                           np.arange(-0.01, 0.011, 0.01), indexing="ij")
    return (x, y, t, np.ones(len(x), bool), geo,
            cnx.ravel().astype(np.float32), cny.ravel().astype(np.float32))


def _t(*a):
    return [torch.from_numpy(np.array(v)) for v in a]


def _same(a, b, what=""):
    a, b = np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b
    assert a.shape == b.shape and a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)
    np.testing.assert_array_equal(np.signbit(a), np.signbit(b), err_msg=what)


@pytest.mark.parametrize("wsize", [1, 9, 25])
def test_window_scores_bitwise(wsize):
    rng = np.random.default_rng(wsize)
    cnt = np.minimum(rng.poisson(0.7, (2, 60, 80)) * 40, 255).astype(
        np.float32)
    want = [np.asarray(jax.jit(jss.window_scores, static_argnums=1)(c,
                                                                    wsize))
            for c in cnt]
    got = tss.window_scores(torch.from_numpy(cnt), wsize)
    _same(np.stack(want), got)


def test_score_candidate_bitwise():
    """Score, pr_x and pr_y of every event for candidates of the sweep
    and off it, one port call for all of them."""
    x, y, t, valid, geo, _, _ = _scene()
    cand = np.float32([[0.03, 0.0], [-0.05, 0.01], [0.0401, -0.0033],
                       [0.0, 0.0]])
    jit = jax.jit(jss.score_candidate, static_argnames=STATIC)
    got = tss.score_candidate(*_t(x, y, t, valid), *_t(cand[:, 0], cand[:, 1]),
                              SCALE, WSIZE, *geo)
    for c, (nx, ny) in enumerate(cand):
        want = jit(x, y, t, valid, nx, ny, scale=SCALE, wsize=WSIZE,
                   x_min=geo[0], y_min=geo[1], w_img=geo[2], h_img=geo[3])
        for name, a, b in zip(("score", "pr_x", "pr_y"), want, got):
            _same(a, b[c], name)
    assert (got[0] > 0).float().mean() > 0.5


def _sweep_both(scene, chunks, order=None):
    x, y, t, valid, geo, cnx, cny = scene
    if order is not None:
        cnx, cny = cnx[order], cny[order]
    want = jss.sweep_candidates(x, y, t, valid, cnx, cny, SCALE, WSIZE,
                                *geo)
    for c in chunks:
        got = tss.sweep_candidates(*_t(x, y, t, valid, cnx, cny), SCALE,
                                   WSIZE, *geo, chunk=c)
        for f in jss.BestFlow._fields:
            _same(getattr(want, f), getattr(got, f), f"{f}, chunk {c}")
    return want


def test_sweep_candidates_bitwise_at_any_chunk():
    """All five BestFlow fields at chunk sizes 1, 7 and 63 over the 63
    candidates."""
    want = _sweep_both(_scene(), (1, 7, 63))
    assert (np.asarray(want.max_score) > 0).mean() > 0.5


def test_the_first_best_candidate_wins_a_tie():
    """Candidates (0.04, -0.0) and, later, (0.04, +0.0) project every event
    to the same place, so they tie wherever they are best; the sweep keeps
    the first (signbit of best_ny set), across chunks (chunk 7: indices 5
    and 10) and inside one (chunk 63), as the scan does.  With every event
    at t = 0 all 63 candidates tie and the first one wins."""
    scene = list(_scene())
    cnx, cny = scene[5].copy(), scene[6].copy()
    cnx[5], cny[5] = np.float32(0.04), np.float32(-0.0)
    cnx[10], cny[10] = np.float32(0.04), np.float32(0.0)
    scene[5], scene[6] = cnx, cny
    want = _sweep_both(scene, (1, 3, 7, 63))
    won = np.asarray(want.best_nx) == np.float32(0.04)
    assert won.sum() > 100
    assert np.signbit(np.asarray(want.best_ny)[won]).all()

    flat = _scene(t_zero=True)
    want = _sweep_both(flat, (1, 7, 63))
    ok = np.asarray(want.max_score) > 0
    assert ok.mean() > 0.9
    assert (np.asarray(want.best_nx)[ok] == flat[5][0]).all()


def test_compute_flow_bruteforce_bitwise_and_finds_the_translation():
    """test_local_flow's sweep, every output bitwise, and its gate on the
    port's own result."""
    d = synthetic_events(3000, duration_s=0.1, res_x=32, res_y=32, vx=40.0,
                         vy=0.0, n_points=50, seed=7, margin=0.25)
    want = jss.compute_flow_bruteforce(d["x"], d["y"], d["t_ns"], **KW)
    out = tss.compute_flow_bruteforce(d["x"], d["y"], d["t_ns"],
                                      device="cpu", **KW)
    assert set(out) == set(want)
    for k in want:
        _same(want[k], out[k], k)
    ok = out["score"] > 0
    assert ok.sum() > len(d["x"]) * 0.5
    assert abs(np.median(out["u"][ok]) - 40.0) < 15.0


def test_the_scaled_pixel_is_one_fused_multiply_add():
    """``prx * scale - x_min * scale`` rounds once, as XLA compiles the
    scan: on events chosen where the two roundings give another pixel
    (x_min 97), the port's scores are the JAX package's, and the product
    rounded on its own would not be."""
    F = np.float32
    fma = lambda a, b, c: (np.float64(a) * b + np.float64(c)).astype(F)
    rng = np.random.default_rng(0)
    n = 1_000_000
    nx, ny, xm = F(0.0371), F(-0.0213), 97.0
    x = rng.uniform(100, 170, n).astype(F)
    y = rng.uniform(100, 170, n).astype(F)
    t = rng.uniform(0, 1e8, n).astype(F)
    from better_flow_tpu_torch.ops.warp import K_NT
    prx = fma(-t, F(nx * F(K_NT)), x)
    pry = fma(-t, F(ny * F(K_NT)), y)
    off = -F(F(xm) * F(SCALE))
    moved = ((fma(prx, F(SCALE), off).astype(np.int32)
              != (F(prx * F(SCALE)) + off).astype(np.int32))
             | (fma(pry, F(SCALE), off).astype(np.int32)
                != (F(pry * F(SCALE)) + off).astype(np.int32)))
    assert moved.sum() >= 4
    sel = np.concatenate([np.nonzero(moved)[0][:300], np.arange(4000)])
    ev = (x[sel], y[sel], t[sel], np.ones(len(sel), bool))
    geo = (xm, xm, 225, 225)
    want = jax.jit(jss.score_candidate, static_argnames=STATIC)(
        *ev, nx, ny, scale=SCALE, wsize=WSIZE, x_min=xm, y_min=xm,
        w_img=225, h_img=225)[0]
    args = (*_t(*ev), torch.tensor([nx]), torch.tensor([ny]), SCALE, WSIZE,
            *geo)
    _same(want, tss.score_candidate(*args)[0][0])
    fused = tss.fma
    try:
        tss.fma = lambda a, b, c: a * b + c
        apart = tss.score_candidate(*args)[0][0]
    finally:
        tss.fma = fused
    assert (np.asarray(want) != apart.numpy()).any()
