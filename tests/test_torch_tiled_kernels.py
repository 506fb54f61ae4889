"""The tiled pipeline's kernel pair of the PyTorch port against the JAX
package's Pallas kernels.

B8 (``splat_local_call``: precomputed local positions added into a batch of
tiles' time and count images, the caller's padded pair) and B9
(``finish_local_call``: the finish of that pair with the sums restricted to
the owned window, leaving the pair zero).  The twins (what the wrappers run
on CPU tensors) get the numpy-seeded inputs of ``torch_inputs.py`` and are
held against the Pallas kernels in interpret mode, against a numpy scatter
and against the JAX package's XLA image chain
(``parallel/spatial.py:318-329``); the padded pair is cropped to the H x W
image the JAX kernels work on.

Tolerances.  Count image: exact.  Time image: atol 5e-6 s against the
Pallas kernel (bf16 hi+lo or hi-only on both sides; it sums in f32, the port
in exact fixed point) and, with the hi+lo pair, against the f64 numpy
scatter, as ``tests/test_spatial.py`` holds the Pallas kernel.  The seven
sums: within 1e-6 of the sum of each sum's terms' magnitudes (JAX sums in f32
in XLA's order, the port in f64; the gradient sums cancel, so an rtol on
their own values fails).  The whole-image window is bitwise B7b's twin, and a
batch of tiles is bitwise tile by tile.  The padding outside the H x W image
stays zero; after B9 the whole pair is zero.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.ops.gradient import masked_scharr  # noqa: E402
from better_flow_tpu.ops.pallas import fused_model as jfm  # noqa: E402
from better_flow_tpu.ops.reductions import (  # noqa: E402
    model_compute_partial,
)
from better_flow_tpu.ops.time_image import box_filter  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.ops.layout import (  # noqa: E402
    CHUNK, padded_image_shape,
)
from torch_inputs import local_splat_inputs  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins work on small tensors; one intra-op thread keeps parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PARTS = ("cnt", "s_row", "s_col", "s_gx", "s_gy", "s_rg", "s_dg")
H, W = 250, 300
HP, WP = padded_image_shape(H, W)
OWN = (16, 230, 24, 270)      # strictly inside the image


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(n_tiles):
    return tfm.image_pair("cpu", H, W, n_tiles=n_tiles)


def _splat(lx, ly, t, **kw):
    """B8 into a zero pair of its own."""
    return tfm.splat_local_call(_t(lx), _t(ly), _t(t), *_pair(lx.shape[0]),
                                H=H, W=W, **kw)


def _padding_is_zero(a):
    return not a[:, H:].any() and not a[:, :, W:].any()


@pytest.mark.parametrize("time_lo", [True, False])
@pytest.mark.parametrize("sort", [True, False])
def test_b8_twin_matches_pallas_and_scatter(sort, time_lo):
    """One tile: sorted input (the Pallas kernel's windowed path) and
    unsorted (its full-joint fallback), the hi+lo pair and hi only; the
    second chunk's slot 0 is a rejected slot with t = 0."""
    lx, ly, t = local_splat_inputs(seed=3, n_tiles=1, sort=sort)
    assert lx[0, CHUNK] == -1 and t[0, CHUNK] == 0
    ts_j, cn_j = jfm.splat_local_call(jnp.asarray(lx[0]), jnp.asarray(ly[0]),
                                      jnp.asarray(t[0]), H, W,
                                      time_lo=time_lo)
    pair = _pair(1)
    at, ac = tfm.splat_local_call(_t(lx), _t(ly), _t(t), *pair, H=H, W=W,
                                  time_lo=time_lo)
    assert at is pair[0] and ac is pair[1]                  # in place
    assert at.dtype == torch.int64 and ac.dtype == torch.int32
    assert tuple(at.shape) == tuple(ac.shape) == (1, HP, WP)
    assert _padding_is_zero(at) and _padding_is_zero(ac)
    at, ac = at[:, :H, :W], ac[:, :H, :W]
    ok = lx[0] >= 0
    lin = (lx[0][ok] * W + ly[0][ok]).astype(np.int64)
    cnt_ref = np.zeros(H * W)
    np.add.at(cnt_ref, lin, 1.0)
    tsum_ref = np.zeros(H * W)
    np.add.at(tsum_ref, lin, t[0][ok].astype(np.float64))
    np.testing.assert_array_equal(ac[0].numpy().ravel(), cnt_ref)
    np.testing.assert_array_equal(np.asarray(cn_j).ravel(), cnt_ref)
    assert cnt_ref.sum() > 4000 and cnt_ref.max() > 3
    ts = tfm.time_image_f32(at[0].contiguous()).numpy()
    np.testing.assert_allclose(ts, np.asarray(ts_j), atol=5e-6)
    if time_lo:
        np.testing.assert_allclose(ts.ravel(), tsum_ref, atol=5e-6)
    else:
        # bf16 alone keeps 8 bits of each residual: the low part matters.
        assert np.abs(ts.ravel() - tsum_ref).max() > 5e-5
    assert tfm.LAUNCHES["splat_local"] == 0                 # CPU: the twin


def test_b8_batch_is_tile_by_tile_and_order_free():
    lx, ly, t = local_splat_inputs(seed=5, n_tiles=3, sort=False)
    at, ac = _splat(lx, ly, t)
    for k in range(3):
        a1, c1 = _splat(lx[k:k + 1], ly[k:k + 1], t[k:k + 1])
        assert torch.equal(a1[0], at[k]) and torch.equal(c1[0], ac[k])
    assert not torch.equal(ac[0], ac[1])
    # Slots already padded to whole chunks (as the tiled path passes them)
    # give the same images; a position outside the frame is dropped.
    pad = lambda a, v: np.pad(a, ((0, 0), (0, 3 * CHUNK - a.shape[1])),
                              constant_values=v)
    lxp, lyp, tp = pad(lx, -1), pad(ly, -1), pad(t, 0)
    a2, c2 = _splat(lxp, lyp, tp)
    assert torch.equal(a2, at) and torch.equal(c2, ac)
    lxp[:, -1], lyp[:, -1] = H, 0
    a3, c3 = _splat(lxp, lyp, tp)
    assert torch.equal(a3, at) and torch.equal(c3, ac)
    # Within a chunk the order of the slots other than slot 0 is free.
    perm = np.concatenate([[0], 1 + np.random.default_rng(0).permutation(
        CHUNK - 1)])
    for a in (lxp, lyp, tp):
        a[:, :CHUNK] = a[:, :CHUNK][:, perm]
    a4, c4 = _splat(lxp, lyp, tp)
    assert torch.equal(a4, at) and torch.equal(c4, ac)


def test_b8_adds_into_the_pair_it_is_given():
    """B8 adds into its caller's pair: two launches over halves of the
    slots (whole chunks each) give the images of one launch over all."""
    lx, ly, t = local_splat_inputs(seed=6, n_tiles=2, n=4 * CHUNK)
    at, ac = _splat(lx, ly, t)
    pair = _pair(2)
    half = 2 * CHUNK
    for cut in (slice(0, half), slice(half, None)):
        got = tfm.splat_local_call(_t(lx[:, cut]), _t(ly[:, cut]),
                                   _t(t[:, cut]), *pair, H=H, W=W)
    assert got[0] is pair[0]
    assert torch.equal(pair[0], at) and torch.equal(pair[1], ac)
    assert int(ac.sum()) > 7000 and _padding_is_zero(ac)


def _images(seed, n_tiles=1):
    lx, ly, t = local_splat_inputs(seed=seed, n_tiles=n_tiles, n=12000)
    return _splat(lx, ly, t)


def _finish(at, ac, **kw):
    """B9 on a copy of the pair (B9 leaves the pair it reads zero)."""
    return tfm.finish_local_call(at.clone(), ac.clone(), H=H, W=W, **kw)


def _term_scale(at, ac, scale, own):
    """Each of the seven sums over its terms' magnitudes (f64)."""
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
        mag = tfm.finish_local_plain(at.clone(), ac.clone(), scale=scale,
                                     H=H, W=W, own=own)
    return mag[0, :7].numpy()


@pytest.mark.parametrize("scale", [1, 3])
def test_b9_twin_matches_pallas_and_xla_chain(scale):
    """The owned-window sums of one local image against the Pallas kernel
    and against the XLA chain of the JAX tiled iteration (box filter,
    normalise, masked Scharr, ``where(own, ...)``, partial sums)."""
    at, ac = _images(7)
    tsum = jnp.asarray(tfm.time_image_f32(at[0, :H, :W].contiguous()).numpy())
    cnt = jnp.asarray(ac[0, :H, :W].numpy().astype(np.float32))
    r0, r1, c0, c1 = OWN
    pj = jfm.finish_local_call(tsum, cnt, scale, H, W, r0, r1, c0, c1)

    tb, cb = box_filter(tsum, scale), box_filter(cnt, scale)
    img = jnp.where(cb >= 1, tb / jnp.maximum(cb, 1), 0.0)
    gx, gy = masked_scharr(img)
    own = jnp.zeros((H, W), bool).at[r0:r1, c0:c1].set(True)
    px = model_compute_partial(jnp.where(own, img, 0.0),
                               jnp.where(own, gx, 0.0),
                               jnp.where(own, gy, 0.0))

    got = _finish(at, ac, scale=scale, own=OWN)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 8)
    mag = _term_scale(at, ac, scale, OWN)
    for p in (pj, px):
        want = np.array([float(p[k]) for k in PARTS], np.float64)
        err = np.abs(got.numpy()[0, :7].astype(np.float64) - want)
        assert np.all(err <= 1e-6 * mag), (got, want, mag)
    assert float(got[0, 0]) > 1000 and float(got[0, 7]) == 0.0
    assert abs(float(got[0, 3])) > 1e-3                    # gradients present
    # The window matters: the whole image's sums differ.
    whole = _finish(at, ac, scale=scale, own=(0, H, 0, W))
    assert float(whole[0, 0]) > float(got[0, 0])
    assert tfm.LAUNCHES["finish_local"] == 0                # CPU: the twin


@pytest.mark.parametrize("scale", [1, 3])
def test_b9_whole_image_is_b7b_and_batch_is_tile_by_tile(scale):
    at, ac = _images(9, n_tiles=3)
    got = _finish(at, ac, scale=scale, own=OWN)
    for k in range(3):
        one = _finish(at[k:k + 1], ac[k:k + 1], scale=scale, own=OWN)
        assert torch.equal(one[0], got[k])
    assert not torch.equal(got[0], got[1])
    # B7b's layout is the tiles' own: with the whole image as the window,
    # B7b tile by tile.
    whole = _finish(at, ac, scale=scale, own=(0, H, 0, W))
    for k in range(3):
        b7b = tfm.finish_partials_call(at[k].clone(), ac[k].clone(),
                                       scale=scale, H=H, W=W)
        assert torch.equal(whole[k], b7b)


def test_b8_b9_wrappers_check_their_tensors():
    lx, ly, t = local_splat_inputs(seed=1, n_tiles=2, n=100)
    pair = _pair(2)
    with pytest.raises(ValueError, match="lx"):
        tfm.splat_local_call(_t(lx[0]), _t(ly[0]), _t(t[0]), *pair, H=H,
                             W=W)
    with pytest.raises(ValueError, match="ly"):
        tfm.splat_local_call(_t(lx), _t(ly[:, :50]), _t(t), *pair, H=H, W=W)
    with pytest.raises(TypeError, match="t_sec"):
        tfm.splat_local_call(_t(lx), _t(ly), _t(t).double(), *pair, H=H,
                             W=W)
    # The pair: one a tile, padded, int64 and int32.
    with pytest.raises(ValueError, match="acc_t"):
        tfm.splat_local_call(_t(lx), _t(ly), _t(t), *_pair(3), H=H, W=W)
    with pytest.raises(ValueError, match="acc_c"):
        tfm.splat_local_call(_t(lx), _t(ly), _t(t), pair[0],
                             pair[1][:, :H, :W].contiguous(), H=H, W=W)
    with pytest.raises(TypeError, match="acc_t"):
        tfm.splat_local_call(_t(lx), _t(ly), _t(t), pair[0].double(),
                             pair[1], H=H, W=W)
    assert not pair[0].any() and not pair[1].any()
    at, ac = tfm.splat_local_call(_t(lx), _t(ly), _t(t), *pair, H=H, W=W)
    kw = dict(scale=1, H=H, W=W)
    with pytest.raises(TypeError, match="acc_t"):
        tfm.finish_local_call(at.to(torch.float32), ac, own=OWN, **kw)
    with pytest.raises(ValueError, match="acc_c"):
        tfm.finish_local_call(at, ac[:1], own=OWN, **kw)
    with pytest.raises(ValueError, match="acc_t"):
        tfm.finish_local_call(at[0], ac[0], own=OWN, **kw)
    with pytest.raises(ValueError, match="own"):
        tfm.finish_local_call(at, ac, own=(0, H + 1, 0, W), **kw)
    with pytest.raises(ValueError, match="acc_t"):
        tfm.finish_local_call(at[:, :H, :W].contiguous(),
                              ac[:, :H, :W].contiguous(), own=OWN, **kw)


@pytest.mark.parametrize("scale", [1, 3])
def test_b9_twin_leaves_the_pair_zero_and_keeps_the_pallas_sums(scale):
    """B9 (its twin on the CPU) reads the pair B8 filled and leaves it zero,
    as the kernel does; each tile's window sums stay those of the Pallas
    kernel on the same images, and a second B8 -> B9 on the same pair
    repeats the first bit for bit."""
    lx, ly, t = local_splat_inputs(seed=11, n_tiles=2, n=12000)
    pair = _pair(2)
    at, ac = tfm.splat_local_call(_t(lx), _t(ly), _t(t), *pair, H=H, W=W)
    assert int(ac.sum()) > 20000
    crop = [(tfm.time_image_f32(at[k, :H, :W].contiguous()).numpy(),
             ac[k, :H, :W].numpy().astype(np.float32)) for k in range(2)]
    mags = [_term_scale(at[k:k + 1], ac[k:k + 1], scale, OWN)
            for k in range(2)]
    got = tfm.finish_local_call(*pair, scale=scale, H=H, W=W, own=OWN)
    assert not pair[0].any() and not pair[1].any()
    for k, (ts, cn) in enumerate(crop):
        pj = jfm.finish_local_call(jnp.asarray(ts), jnp.asarray(cn), scale,
                                   H, W, *OWN)
        want = np.array([float(pj[p]) for p in PARTS], np.float64)
        err = np.abs(got.numpy()[k, :7].astype(np.float64) - want)
        assert np.all(err <= 1e-6 * mags[k]), (k, got, want)
        assert mags[k][0] > 1000
    tfm.splat_local_call(_t(lx), _t(ly), _t(t), *pair, H=H, W=W)
    again = tfm.finish_local_call(*pair, scale=scale, H=H, W=W, own=OWN)
    assert torch.equal(again, got)
    assert not pair[0].any() and not pair[1].any()
