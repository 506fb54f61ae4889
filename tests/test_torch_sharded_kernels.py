"""The event-parallel kernel pair of the PyTorch port against the JAX
package's Pallas kernels.

B7a (``fused_warp_splat_images``: warp + splat added into the caller's
pair of pre-filter images) and B7b (``finish_partials``: the finish down to
the seven sums, leaving the pair zero) are the composed iteration cut where
event shards sum their images.  The twins (what the wrappers run on CPU
tensors) get the numpy-seeded inputs of ``torch_inputs.py`` and are held
against the Pallas kernels in interpret mode, and hold the pair's contract
as the kernels do: B7a adds into it, B7b reads and clears it.

Tolerances.  New positions: rtol 1e-6 (they are in fact bitwise).  Count
image: exact.  Time image: rtol 1e-5, atol 1e-6, as ``test_torch_kernels.py``
holds B1's (the JAX kernel sums in f32, the port exact fixed point).  The
seven sums: within 1e-6 of the sum of each sum's terms' magnitudes (JAX sums
in f32 in XLA's order, the port in f64; the gradient sums cancel, so an rtol
on their own values fails).  The twin chain B7a -> B7b is bitwise B6's twin,
and n shards cut on chunk boundaries, launched one after another into one
pair, give exactly the unsharded images (B7a's and B1's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.ops.pallas import fused_model as jfm  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from torch_inputs import image_shape, slice_inputs  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins work on small tensors; one intra-op thread keeps parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PARTS = ("cnt", "s_row", "s_col", "s_gx", "s_gy", "s_rg", "s_dg")
CASES = [((24, 32), 3, 3), ((24, 32), 1, 2), ((180, 240), 3, 4)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(res, scale, nch, seed=6):
    """Numpy inputs, the warp scalars in the carry's sign pattern, the angle
    and the (1, 16) row as the JAX wrapper builds it."""
    d = slice_inputs(seed, res=res, scale=scale, nch=nch)
    st, geo = d["st"][0], d["geo"]
    warp = [np.float32(v) for v in (-st[0], -st[1], st[8], st[9], st[3])]
    crl = jnp.float32(-st[2])
    vals = [geo[0, 0], geo[0, 1], geo[0, 2], geo[0, 3], *warp,
            jnp.cos(crl), jnp.sin(crl)]
    row = np.concatenate([np.array([np.float32(v) for v in vals]),
                          np.zeros(5, np.float32)]).reshape(1, 16)
    return d, warp, crl, row


def _torch_args(d, row):
    return [_t(d[k]) for k in ("stat", "act", "pr")] + [_t(row)]


def _b7a(stat, act, pr, scal, **kw):
    """B7a into a new zero pair: (new_pr, acc_t, acc_c, fallback)."""
    return tfm.fused_warp_splat_images_call(
        stat, act, pr, scal, *tfm.image_pair(stat.device, kw["H"], kw["W"]),
        **kw)


@pytest.mark.parametrize("res,scale,nch", CASES)
def test_b7a_twin_matches_pallas(res, scale, nch):
    H, W = image_shape(res, scale)
    d, warp, crl, row = _inputs(res, scale, nch)
    geo = d["geo"]
    npr_j, at_j, ac_j, fb_j = jfm.fused_warp_splat_images(
        jnp.asarray(d["stat"]), jnp.asarray(d["act"]), jnp.asarray(d["pr"]),
        scale, geo[0, 0], geo[0, 1], geo[0, 2], geo[0, 3], *warp, crl, H, W)
    pair = tfm.image_pair("cpu", H, W)
    npr, at, ac, fb = tfm.fused_warp_splat_images_call(
        *_torch_args(d, row), *pair, scale=scale, H=H, W=W)
    assert at is pair[0] and ac is pair[1] and fb == 0
    assert at.dtype == torch.int64 and ac.dtype == torch.int32
    assert tuple(at.shape) == tuple(ac.shape) == np.asarray(at_j).shape
    np.testing.assert_allclose(npr.numpy(), np.asarray(npr_j), rtol=1e-6)
    np.testing.assert_array_equal(ac.numpy().astype(np.float32),
                                  np.asarray(ac_j))
    assert int(ac.sum()) > 2000
    np.testing.assert_allclose(tfm.time_image_f32(at).numpy(),
                               np.asarray(at_j), rtol=1e-5, atol=1e-6)
    # Two launches over the two halves of the chunks into one zero pair:
    # the same images and positions as the one launch.
    stat, act, pr, scal = _torch_args(d, row)
    half = tfm.image_pair("cpu", H, W)
    nprs = [tfm.fused_warp_splat_images_call(
        stat[c], act[c], pr[c], scal, *half, scale=scale, H=H, W=W)[0]
        for c in (slice(0, nch // 2), slice(nch // 2, nch))]
    assert torch.equal(half[0], at) and torch.equal(half[1], ac)
    assert torch.equal(torch.cat(nprs), npr)
    assert tfm.LAUNCHES["fused_warp_splat_images"] == 0     # CPU: the twin


def _term_scale(at, ac, scale, H, W):
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
        mag = tfm.finish_partials_plain(at, ac, scale=scale, H=H, W=W)
    return mag[:7].numpy()


@pytest.mark.parametrize("res,scale,nch", CASES)
def test_b7b_twin_matches_pallas(res, scale, nch):
    """B7b's twin on the port's integer images against the Pallas kernel on
    their f32 conversion."""
    H, W = image_shape(res, scale)
    d, _warp, _crl, row = _inputs(res, scale, nch, seed=9)
    _, at, ac, _ = _b7a(*_torch_args(d, row), scale=scale, H=H, W=W)
    p = jfm.finish_partials(jnp.asarray(tfm.time_image_f32(at).numpy()),
                            jnp.asarray(ac.numpy().astype(np.float32)),
                            scale, H, W)
    want = np.array([float(p[k]) for k in PARTS], np.float64)
    mag = _term_scale(at.clone(), ac.clone(), scale, H, W)
    got = tfm.finish_partials_call(at, ac, scale=scale, H=H, W=W)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8,)
    err = np.abs(got.numpy()[:7].astype(np.float64) - want)
    assert np.all(err <= 1e-6 * mag), (got, want, mag)
    assert want[0] > 500 and float(got[7]) == 0.0
    # B7b leaves the pair zero, ready for the next iteration's B7a.
    assert not at.any() and not ac.any()
    assert tfm.LAUNCHES["finish_partials"] == 0


@pytest.mark.parametrize("res,scale,nch", CASES)
def test_b7_twin_chain_is_bitwise_b6_twin(res, scale, nch):
    H, W = image_shape(res, scale)
    d, _warp, _crl, row = _inputs(res, scale, nch, seed=11)
    args = _torch_args(d, row)
    kw = dict(scale=scale, H=H, W=W)
    npr6, vals6 = tfm.fused_warp_splat_call(*args, **kw)
    npr, at, ac, _ = _b7a(*args, **kw)
    # Through B1's twin with the time pair, B2's finish: the images are
    # those of the state-driven warp on the same scalars.
    st, geo = _t(d["st"]), _t(d["geo"])
    _, at1, ac1 = tfm.warp_images_st_call(args[0], args[1], args[2], st, geo,
                                          *tfm.image_pair("cpu", H, W),
                                          time_lo=True, **kw)
    assert torch.equal(ac1, ac)
    np.testing.assert_allclose(tfm.time_image_f32(at1).numpy(),
                               tfm.time_image_f32(at).numpy(), rtol=1e-6)
    vals = tfm.finish_partials_call(at, ac, **kw)
    assert torch.equal(npr, npr6) and torch.equal(vals, vals6)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_summed_shard_images_are_the_unsharded_images(n_shards):
    """Shards cut on chunk boundaries keep every chunk and its time base;
    integer images add exactly in any order: launched one after another
    into one pair, B7a's and B1's are the unsharded launch's, and the seam
    with no other rank hands back that very pair."""
    res, scale, nch = (24, 32), 3, 8
    H, W = image_shape(res, scale)
    d, _warp, _crl, row = _inputs(res, scale, nch, seed=13)
    stat, act, pr, scal = _torch_args(d, row)
    kw = dict(scale=scale, H=H, W=W)
    npr, at, ac, _ = _b7a(stat, act, pr, scal, **kw)
    per = nch // n_shards
    cuts = [slice(a, a + per) for a in range(0, nch, per)]
    for order in (cuts, cuts[::-1]):
        pair = tfm.image_pair("cpu", H, W)
        nprs = {c.start: tfm.fused_warp_splat_images_call(
            stat[c], act[c], pr[c], scal, *pair, **kw)[0] for c in order}
        assert torch.equal(pair[0], at) and torch.equal(pair[1], ac)
        assert torch.equal(torch.cat([nprs[c.start] for c in cuts]), npr)
        sum_t, sum_c = tfm.sum_images(*pair)
        assert sum_t is pair[0] and sum_c is pair[1]
    # B1's images add the same way (the sharded megastep's splat).
    st, geo = _t(d["st"]), _t(d["geo"])
    npr1, at1, ac1 = tfm.warp_images_st_call(
        stat, act, pr, st, geo, *tfm.image_pair("cpu", H, W), time_lo=False,
        **kw)
    for order in (cuts, cuts[::-1]):
        pair = tfm.image_pair("cpu", H, W)
        nprs = {c.start: tfm.warp_images_st_call(
            stat[c], act[c], pr[c], st, geo, *pair, time_lo=False, **kw)[0]
            for c in order}
        assert torch.equal(pair[0], at1) and torch.equal(pair[1], ac1)
        assert torch.equal(torch.cat([nprs[c.start] for c in cuts]), npr1)


def test_b7_wrappers_check_their_tensors():
    """B7a's and B7b's tensors; the image pair for every wrapper that
    takes its caller's pair (B1, B2, B7a, B7b, B12)."""
    res, scale, nch = (24, 32), 3, 2
    H, W = image_shape(res, scale)
    d, _warp, _crl, row = _inputs(res, scale, nch)
    stat, act, pr, scal = _torch_args(d, row)
    kw = dict(scale=scale, H=H, W=W)
    at, ac = tfm.image_pair("cpu", H, W)
    with pytest.raises(ValueError, match="scal"):
        tfm.fused_warp_splat_images_call(stat, act, pr, scal[:, :8], at, ac,
                                         **kw)
    with pytest.raises(TypeError, match="pr"):
        tfm.fused_warp_splat_images_call(stat, act, pr.double(), scal, at, ac,
                                         **kw)
    # The pair: its dtype, shape, device and layout, for both kernels.
    meta = torch.empty(ac.shape, dtype=torch.int32, device="meta")
    bad = [(TypeError, "acc_t", (at.to(torch.float32), ac)),
           (TypeError, "acc_c", (at, ac.to(torch.int64))),
           (ValueError, "acc_c", (at, ac[:-1])),
           (ValueError, "acc_t", (at[:, :-4], ac)),
           (ValueError, "acc_c", (at, meta)),
           (ValueError, "acc_c", (at, ac.t().contiguous().t()))]
    st, geo = _t(d["st"]), _t(d["geo"])
    pr4 = torch.cat([pr, torch.zeros_like(pr)], dim=1)
    statics = dict(schedule="fast", rot_tol=1e-3, div_tol=1e-3,
                   dx_tol=1e-3, dy_tol=1e-3, xy_cap=1e6, rotdiv_cap=1e6,
                   max_iter=10, hard_cap=100)
    for err, name, pair in bad:
        with pytest.raises(err, match=name):
            tfm.fused_warp_splat_images_call(stat, act, pr, scal, *pair, **kw)
        with pytest.raises(err, match=name):
            tfm.finish_partials_call(*pair, **kw)
        with pytest.raises(err, match=name):
            tfm.warp_images_st_call(stat, act, pr, st, geo, *pair, **kw)
        with pytest.raises(err, match=name):
            tfm.megastep_finish_call(*pair, st, geo, **kw, **statics)
        with pytest.raises(err, match=name):
            tfm.megastep2_call(stat, act, pr4, st, *pair, geo, **kw,
                               **statics)
    _, at, ac, _ = tfm.fused_warp_splat_images_call(stat, act, pr, scal, at,
                                                    ac, **kw)
    assert ac.any()
    with pytest.raises(TypeError, match="acc_t"):
        tfm.finish_partials_call(at.to(torch.float32), ac, **kw)
    with pytest.raises(ValueError, match="acc_c"):
        tfm.finish_partials_call(at, ac[:-1], **kw)
    assert ac.any()   # a refused call leaves the pair as it was
