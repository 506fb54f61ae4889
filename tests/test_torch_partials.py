"""B10 and B11 of the PyTorch port against the Pallas kernels.

``fused_model_partials`` (B10) and ``fused_model_partials_windowed`` (B11)
compute the seven partial sums of the time image of already-warped events.
Their plain twins (what ``*_call`` runs on the CPU) are held against the
JAX package's kernels, which run in interpret mode off the TPU, on the
same numpy-seeded inputs (``torch_inputs.partials_inputs``: clustered
events, a ragged padded tail, inactive slots, sorted by ``sort_key_blocks``
or not).

Tolerances (the B6 rule, ROADMAP C): the count exactly; each of the other
sums within 1e-6 of the sum of its terms' magnitudes, because the TPU
kernel sums its f32 images in f32 in its own order and the port sums
integer images in f64 (the gradient sums cancel, so their own values can
be ~1e-5 apart relatively).  B11's twin is bitwise B10's on sorted and on
unsorted input: the windows of the TPU kernel are a way to scatter, and
the port's integer sums do not depend on it.

The card's kernel reads the flat (n,) inputs as they are, with no padded
copy: ``flat_partials`` repeats its indexing on the CPU (slot i < n, the
chunk's time base at slot ``i - i % CHUNK``) and is held bitwise against
the twin on the padded rows, and against the Pallas kernels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from better_flow_tpu.ops.pallas import fused_model as jfm  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.ops.layout import CHUNK  # noqa: E402
from better_flow_tpu_torch.ops.layout import padded_image_shape  # noqa: E402
from better_flow_tpu_torch.ops.warp import fma, mul_recip  # noqa: E402
from torch_inputs import SCALE, image_shape, partials_inputs  # noqa: E402

KEYS = ("pr_x", "pr_y", "t_ns", "active", "geo")
CASES = [((24, 32), 2 * CHUNK + 700), ((96, 128), 3 * CHUNK - 333)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(d):
    return [torch.from_numpy(np.ascontiguousarray(d[k])) for k in KEYS]


def flat_partials(pr_x, pr_y, t_ns, active, geo, *, scale, H, W):
    """The card kernel's indexing (csrc/iteration.cuh, positions_phase) in
    plain PyTorch: the splat of slots [0, n) of the flat inputs, slot i's
    time base ``t_ns[i - i % CHUNK] * f32(1e-9)``, no padded copy; then
    B7b's twin.  Tests only."""
    HP, WP = padded_image_shape(H, W)
    n = pr_x.shape[0]
    i = torch.arange(n)
    t_sec = mul_recip(t_ns, 1e9)
    t0 = t_sec[i - i % CHUNK]
    x_sh, y_sh, wd, hd = geo[0, 0], geo[0, 1], geo[0, 2], geo[0, 3]
    half = scale // 2
    fscale = torch.full((), float(scale))
    ix = fma(pr_x, fscale, x_sh).to(torch.int32)
    iy = fma(pr_y, fscale, y_sh).to(torch.int32)
    ok = (active & (ix >= half) & (ix.to(torch.float32) < wd + half)
          & (iy >= half) & (iy.to(torch.float32) < hd + half))
    tr = t_sec - t0
    w_hi = tfm._bf16(tr)
    fixed = (tfm.to_fixed(t0) + tfm.to_fixed(w_hi)
             + tfm.to_fixed(tfm._bf16(tr - w_hi)))
    lin = (ix.to(torch.int64) * WP + iy)[ok]
    acc_t = torch.zeros(HP * WP, dtype=torch.int64)
    acc_c = torch.zeros(HP * WP, dtype=torch.int32)
    acc_t.index_add_(0, lin, fixed[ok])
    acc_c.index_add_(0, lin, torch.ones_like(lin, dtype=torch.int32))
    return tfm.finish_partials_plain(acc_t.reshape(HP, WP),
                                     acc_c.reshape(HP, WP), scale=scale,
                                     H=H, W=W)


def _b10(*args, scale, H, W):
    return tfm.fused_model_partials_call(*args, scale=scale, H=H, W=W)


def _jax_partials(fn, d, H, W):
    g = d["geo"][0]
    p = fn(d["pr_x"], d["pr_y"], d["t_ns"], d["active"], SCALE,
           np.float32(g[0]), np.float32(g[1]), int(g[2]), int(g[3]), H, W)
    return np.array([float(p[k]) for k in ("cnt", "s_row", "s_col", "s_gx",
                                            "s_gy", "s_rg", "s_dg")])


def _magnitudes(args, H, W):
    """Each of the seven sums taken over its terms' magnitudes (f64)."""
    def abs_partial(img, gx, gy):
        f64 = torch.float64
        m = (img > 1e-6).to(f64)
        ax, ay = gx.abs().to(f64) * m, gy.abs().to(f64) * m
        ri = torch.arange(img.shape[0])[:, None].to(f64)
        ci = torch.arange(img.shape[1])[None, :].to(f64)
        return torch.stack([m.sum(), (m * ri).sum(), (m * ci).sum(),
                            ax.sum(), ay.sum(), (ay * ri + ax * ci).sum(),
                            (ax * ri + ay * ci).sum()])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfm, "model_compute_partial", abs_partial)
        mag = tfm.fused_model_partials_call(*args, scale=SCALE, H=H, W=W)
    return mag[:7].numpy().astype(np.float64)


def _assert_close(got, want, mag):
    got = got.numpy()
    assert got[0] == want[0] and want[0] > 100
    err = np.abs(got[:7].astype(np.float64) - want)
    assert np.all(err <= 1e-6 * mag), (got[:7], want, mag)
    assert got[7] == 0.0


@pytest.mark.parametrize("port", [_b10, flat_partials],
                         ids=["twin", "flat"])
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("res,n", CASES)
def test_fused_model_partials_twin_matches_pallas(res, n, sort, port):
    """B10's twin, and the card kernel's flat indexing, against
    ``fused_model_partials`` (interpret mode)."""
    H, W = image_shape(res, SCALE)
    d = partials_inputs(7, res=res, n=n, sort=sort)
    args = _torch(d)
    got = port(*args, scale=SCALE, H=H, W=W)
    want = _jax_partials(jfm.fused_model_partials, d, H, W)
    _assert_close(got, want, _magnitudes(args, H, W))


@pytest.mark.parametrize("spread", ["wide", "tight"])
@pytest.mark.parametrize("res,n", CASES)
def test_windowed_partials_twin_matches_pallas(res, n, spread):
    """B11's twin against ``fused_model_partials_windowed`` (interpret
    mode) on sorted events, spread wide or piled up."""
    H, W = image_shape(res, SCALE)
    d = partials_inputs(8, res=res, n=n, spread=spread, sort=True)
    args = _torch(d)
    got = tfm.fused_model_partials_windowed_call(*args, scale=SCALE, H=H, W=W)
    want = _jax_partials(jfm.fused_model_partials_windowed, d, H, W)
    _assert_close(got, want, _magnitudes(args, H, W))


def test_windowed_partials_escaping_warp_matches_pallas():
    """Positions warped ~40 px away from their sorted pixels: every chunk
    leaves the TPU kernel's window and takes its full-image fallback."""
    res, n = CASES[1]
    H, W = image_shape(res, SCALE)
    d = partials_inputs(9, res=res, n=n, sort=True)
    frac = d["t_ns"] / d["t_ns"].max()
    d["pr_x"] = (d["pr_x"] + 40.0 * frac).astype(np.float32)
    d["pr_y"] = (d["pr_y"] - 40.0 * frac).astype(np.float32)
    args = _torch(d)
    got = tfm.fused_model_partials_windowed_call(*args, scale=SCALE, H=H, W=W)
    want = _jax_partials(jfm.fused_model_partials_windowed, d, H, W)
    _assert_close(got, want, _magnitudes(args, H, W))


@pytest.mark.parametrize("spread", ["wide", "tight"])
@pytest.mark.parametrize("sort", [True, False])
def test_windowed_twin_is_b10_twin_bitwise(sort, spread):
    res, n = CASES[1]
    H, W = image_shape(res, SCALE)
    args = _torch(partials_inputs(10, res=res, n=n, spread=spread,
                                  sort=sort))
    b10 = tfm.fused_model_partials_call(*args, scale=SCALE, H=H, W=W)
    b11 = tfm.fused_model_partials_windowed_call(*args, scale=SCALE, H=H,
                                                 W=W)
    assert torch.equal(b10, b11) and float(b10[0]) > 100


def test_partials_rows_pad_to_inactive_chunks():
    """The flat inputs become (nch, CHUNK) rows: whole chunks (at least
    one), inactive zero slots after the events, times in seconds as the
    JAX wrapper makes them (``t_ns * f32(1 / 1e9)``)."""
    d = partials_inputs(11, n=CHUNK + 5)
    prx, pry, t_sec, act = tfm.partials_rows(*_torch(d)[:4])
    assert prx.shape == (2, CHUNK) and act.dtype == torch.float32
    flat = t_sec.reshape(-1).numpy()
    recip = np.float32(1.0) / np.float32(1e9)
    np.testing.assert_array_equal(flat[:CHUNK + 5], d["t_ns"] * recip)
    assert not act.reshape(-1)[CHUNK + 5:].any()
    assert not flat[CHUNK + 5:].any()


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("n", [0, 1, 700, CHUNK, 2 * CHUNK + 700,
                               3 * CHUNK - 333])
def test_flat_indexing_is_the_padded_rows_bitwise(n, sort):
    """The card kernel's flat indexing gives bitwise the sums of the twin
    on the rows padded to whole chunks (at least one) with inactive slots:
    a slot past n adds nothing, and every chunk's slot 0 is a real event.
    n = 0 gives the eight zeros of one padded chunk."""
    res = CASES[1][0]
    H, W = image_shape(res, SCALE)
    args = _torch(partials_inputs(12, res=res, n=n, sort=sort))
    rows = tfm.partials_rows(*args[:4])
    want = tfm.fused_model_partials_plain(*rows, args[4], scale=SCALE, H=H,
                                          W=W)
    got = flat_partials(*args, scale=SCALE, H=H, W=W)
    assert torch.equal(got, want)
    assert torch.equal(tfm.fused_model_partials_call(*args, scale=SCALE,
                                                     H=H, W=W), want)
    if n == 0:
        assert not want.any()
    if n >= 700:
        assert float(want[0]) > 100


@pytest.mark.parametrize("bad", ["float active", "strided active",
                                 "strided t_ns"])
def test_partials_refuse_inputs_the_kernel_does_not_read(bad):
    """The kernel reads ``active`` as one byte a slot and every input as a
    flat contiguous row: a non-bool or strided ``active`` and a strided
    time row are refused, on the CPU as on the card."""
    res, n = CASES[0]
    H, W = image_shape(res, SCALE)
    args = _torch(partials_inputs(13, res=res, n=n))
    if bad == "float active":
        args[3] = args[3].to(torch.float32)
    elif bad == "strided active":
        args[3] = torch.stack([args[3], args[3]], dim=1)[:, 0]
    else:
        args[2] = torch.stack([args[2], args[2]], dim=1)[:, 0]
    for fn in (tfm.fused_model_partials_call,
               tfm.fused_model_partials_windowed_call):
        with pytest.raises((TypeError, ValueError)):
            fn(*args, scale=SCALE, H=H, W=W)
