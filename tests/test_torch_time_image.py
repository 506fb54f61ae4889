"""The XLA branch's image operations of the PyTorch port against the JAX
package's, on the same numpy-seeded inputs.

``ops.time_image`` (``box_filter``, ``splat_indices``, ``scatter_images``,
``time_image``, ``count_image``), ``ops.gradient.masked_scharr``,
``ops.reductions`` (``nonzero_average``, ``center_of_mass``,
``model_compute``), ``ops.warp.apply_project`` and
``ops.layout.sort_key_blocks`` against their JAX counterparts, compiled
with the inputs traced as the JAX branch has them.

Where the port repeats XLA's arithmetic the result is held bitwise: the
acceptance and pixel of every event, the box filter, the Scharr pair, the
projection and the sort key.  The time sums are exact integer sums in the
port and f32 sums in event order in the JAX package; the whole-image
reductions f64 rounded once in the port and f32 in XLA's order: those are
held to the JAX tests' own tolerances (``tests/test_time_image.py``: rtol
1e-5, atol 1e-6; ``tests/test_reductions.py``: centroid rtol 1e-5, dx and
dy rtol 1e-4 atol 1e-6, rot and div rtol 1e-3 atol 1e-5, counts exact).
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from better_flow_tpu_torch.ops import gradient as tgr  # noqa: E402
from better_flow_tpu_torch.ops import layout  # noqa: E402
from better_flow_tpu_torch.ops import reductions as tred  # noqa: E402
# The module (``ops`` exports the function under its name, as the JAX
# package's ``ops`` does).
tti = importlib.import_module("better_flow_tpu_torch.ops.time_image")
from better_flow_tpu_torch.ops import warp as twarp  # noqa: E402

# (``better_flow_tpu.ops`` re-exports functions under these modules' names.)
jti = importlib.import_module("better_flow_tpu.ops.time_image")
jgr = importlib.import_module("better_flow_tpu.ops.gradient")
jred = importlib.import_module("better_flow_tpu.ops.reductions")
jwarp = importlib.import_module("better_flow_tpu.ops.warp")
jfm = importlib.import_module("better_flow_tpu.ops.pallas.fused_model")

SCALE = 3
H, W = 75, 99                       # a 24x32 sensor at scale 3
GEOM = (np.float32(1.5), np.float32(-0.75), 66, 90)   # x_sh, y_sh, w, h


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _events(seed=0, n=6000):
    """Warped positions around 40 clusters on the 24x32 sensor (some
    outside the window), slice-local times, ~5% masked."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 40, n)
    cx, cy = rng.uniform(0, 24, 40), rng.uniform(0, 32, 40)
    prx = (cx[c] + rng.normal(0, 1.5, n)).astype(np.float32)
    pry = (cy[c] + rng.normal(0, 1.5, n)).astype(np.float32)
    t = rng.uniform(0, 0.2e9, n).astype(np.float32)
    mask = rng.uniform(size=n) > 0.05
    return prx, pry, t, mask


def _image(seed=1):
    """A time-image-like f32 image: smooth positive blobs over zeros."""
    rng = np.random.default_rng(seed)
    img = np.zeros((H, W), np.float32)
    for _ in range(30):
        r, c = rng.integers(2, H - 2), rng.integers(2, W - 2)
        img[r - 2:r + 3, c - 2:c + 3] = rng.uniform(0.01, 0.2,
                                                   (5, 5)).astype(np.float32)
    return img


@pytest.mark.parametrize("size", [1, 3, 5])
def test_box_filter_bitwise(size):
    img = _image(2)
    j = np.asarray(jax.jit(jti.box_filter, static_argnums=1)(img, size))
    t = tti.box_filter(*_t(img), size).numpy()
    np.testing.assert_array_equal(t, j)


def test_splat_indices_bitwise():
    prx, pry, _, mask = _events(3)
    fn = jax.jit(jti.splat_indices, static_argnums=(3, 8, 9))
    lj, okj = fn(prx, pry, mask, SCALE, *GEOM, H, W)
    lt, okt = tti.splat_indices(*_t(prx, pry, mask), SCALE, *GEOM, H, W)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert 0 < okt.sum() < okt.numel()      # some events fall outside


def test_scatter_and_time_images_match():
    prx, pry, t, mask = _events(4)
    args = (SCALE, *GEOM, H, W)
    sj, cj = jax.jit(jti.scatter_images, static_argnums=(4, 9, 10))(
        prx, pry, t, mask, *args)
    st, ct = tti.scatter_images(*_t(prx, pry, t, mask), *args)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-6)
    ij = np.asarray(jax.jit(jti.time_image, static_argnums=(4, 9, 10))(
        prx, pry, t, mask, *args))
    it = tti.time_image(*_t(prx, pry, t, mask), *args).numpy()
    np.testing.assert_array_equal(it > 0, ij > 0)
    np.testing.assert_allclose(it, ij, rtol=1e-5, atol=1e-6)
    assert (it > 0).sum() > 500


def test_time_image_is_exact_in_any_order():
    """Integer sums: a permutation of the events gives the same image bit
    for bit (the JAX package's f32 scatter does not promise that)."""
    prx, pry, t, mask = _events(5)
    args = (SCALE, *GEOM, H, W)
    a = tti.time_image(*_t(prx, pry, t, mask), *args)
    p = np.random.default_rng(0).permutation(len(prx))
    b = tti.time_image(*_t(prx[p], pry[p], t[p], mask[p]), *args)
    assert torch.equal(a, b)


def test_count_image_matches_and_saturates():
    prx, pry, _, mask = _events(6)
    prx[:400], pry[:400], mask[:400] = 10.2, 12.1, True   # 400 on a pixel
    args = (SCALE, *GEOM, H, W)
    cj = np.asarray(jax.jit(jti.count_image, static_argnums=(3, 8, 9))(
        prx, pry, mask, *args))
    ct = tti.count_image(*_t(prx, pry, mask), *args).numpy()
    np.testing.assert_array_equal(ct, cj)
    assert ct.max() == 255.0


@pytest.mark.parametrize("mode", ["rep", "mxu"])
def test_scatter_modes_other_than_xla_raise(mode):
    """The JAX package's TPU scatter strategies, "rep" (8 f32 replicas)
    and "mxu" (a 3-way bf16 split of the time on the matrix unit), hold
    against the port's exact integer scatter as "xla" does: counts exact,
    time sums and the time image within the JAX tests' tolerance; the port
    gives the same images for every mode.  They run the XLA branch, on one
    device, under an event group and on the tiled path; an unknown mode
    raises."""
    from better_flow_tpu_torch.config import OptimizerConfig
    from better_flow_tpu_torch.models.global_flow import check_supported

    prx, pry, t, mask = _events(7)
    args = (SCALE, *GEOM, H, W)
    jfn = lambda f: jax.jit(functools.partial(f, scatter_mode=mode),
                            static_argnums=(4, 9, 10))
    sj, cj = jfn(jti.scatter_images)(prx, pry, t, mask, *args)
    st, ct = tti.scatter_images(*_t(prx, pry, t, mask), *args,
                                scatter_mode=mode)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-6)
    ij = np.asarray(jfn(jti.time_image)(prx, pry, t, mask, *args))
    it = tti.time_image(*_t(prx, pry, t, mask), *args, scatter_mode=mode)
    np.testing.assert_array_equal(it.numpy() > 0, ij > 0)
    np.testing.assert_allclose(it.numpy(), ij, rtol=1e-5, atol=1e-6)
    assert (it > 0).sum() > 500
    assert torch.equal(it, tti.time_image(*_t(prx, pry, t, mask), *args))
    opt = OptimizerConfig(scatter_mode=mode)
    check_supported(opt)
    with pytest.raises(NotImplementedError, match="scatter_mode"):
        check_supported(OptimizerConfig(scatter_mode="segment"))
    with pytest.raises(ValueError, match="scatter_mode"):
        tti.time_image(*_t(prx, pry, t, mask), *args, scatter_mode="bad")


def test_masked_scharr_bitwise():
    img = _image(8)
    img[10, 10] = 0.0                  # a hole: its neighbours get no gradient
    gj = jax.jit(jgr.masked_scharr)(img)
    gt = tgr.masked_scharr(*_t(img))
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (gt[0] != 0).sum() > 100 and float(gt[0][10, 10]) == 0.0


def test_reductions_match():
    img = _image(9)
    cj = [float(v) for v in jax.jit(jred.center_of_mass)(img)]
    ct = [float(v) for v in tred.center_of_mass(*_t(img))]
    np.testing.assert_allclose(ct[:2], cj[:2], rtol=1e-5)
    assert ct[2] == cj[2] > 100
    gx, gy = (np.asarray(g) for g in jax.jit(jgr.masked_scharr)(img))
    cx, cy = np.float32(cj[0]), np.float32(cj[1])
    tj = jax.jit(jred.model_compute)(img, gx, gy, cx, cy)
    tt = tred.model_compute(*_t(img, gx, gy), torch.tensor(cx),
                            torch.tensor(cy))
    for f, rtol, atol in (("dx", 1e-4, 1e-6), ("dy", 1e-4, 1e-6),
                          ("rot", 1e-3, 1e-5), ("div", 1e-3, 1e-5)):
        np.testing.assert_allclose(float(getattr(tt, f)),
                                   float(getattr(tj, f)), rtol=rtol,
                                   atol=atol)
    assert float(tt.cnt) == float(tj.cnt)
    u8 = np.floor(img * 1000).astype(np.float32)
    np.testing.assert_allclose(float(tred.nonzero_average(*_t(u8))),
                               float(jax.jit(jred.nonzero_average)(u8)),
                               rtol=1e-6)
    assert float(tred.nonzero_average(torch.zeros((4, 4)))) == 0.0


def test_empty_image_reductions_are_zero():
    z = torch.zeros((H, W))
    assert [float(v) for v in tred.center_of_mass(z)] == [0.0, 0.0, 0.0]
    terms = tred.model_compute(z, z, z, torch.tensor(0.0), torch.tensor(0.0))
    assert all(float(v) == 0.0 for v in terms)


def test_apply_project_bitwise():
    rng = np.random.default_rng(10)
    n = 5000
    frx, fry = (rng.uniform(0, 24, n).astype(np.float32) for _ in range(2))
    nx, ny = (rng.normal(0, 5, n).astype(np.float32) for _ in range(2))
    t = rng.uniform(0, 0.2e9, n).astype(np.float32)
    pj = jax.jit(jwarp.apply_project)(frx, fry, t, nx, ny)
    pt = twarp.apply_project(*_t(frx, fry, t, nx, ny))
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sort_key_blocks_bitwise():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 180, 3000).astype(np.float32)
    y = rng.integers(0, 240, 3000).astype(np.float32)
    valid = rng.uniform(size=3000) > 0.1
    kj = np.asarray(jax.jit(jfm.sort_key_blocks)(x, y, valid))
    kt = layout.sort_key_blocks(*_t(x, y, valid)).numpy()
    np.testing.assert_array_equal(kt, kj)
    assert (kt[~valid] == 1 << 30).all()
