"""The PyTorch port's kernel twins against the JAX package's Pallas kernels.

Each plain twin of ``better_flow_tpu_torch/ops/fused_model.py`` (what the
kernel wrappers run on CPU tensors) gets the same numpy-seeded inputs
(``torch_inputs.py``: 3 chunks, a 24x32 sensor at scale 3, images 128x256)
as the Pallas kernel it replaces, which runs in interpret mode.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.config import SensorConfig
from better_flow_tpu.core.model import MotionModel as JaxModel
from better_flow_tpu.models import global_flow as jgf
from better_flow_tpu.ops import warp as jwarp
from better_flow_tpu.ops.pallas import fused_model as jfm
from better_flow_tpu.runtime import scan_pipeline as jscan
from better_flow_tpu_torch.core.model import MotionModel
from better_flow_tpu_torch.models import global_flow as tgf
from better_flow_tpu_torch.ops import fused_model as tfm
from better_flow_tpu_torch.ops import layout
from better_flow_tpu_torch.ops import warp as twarp
from torch_inputs import CH, H, NCH, SCALE, SENSOR, W
from torch_inputs import assert_state_close as _assert_state_close
from torch_inputs import slice_inputs as _slice_inputs
from torch_inputs import statics as _statics


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- layout


def test_layout_constants_match_jax():
    assert layout.CHUNK == jfm.CHUNK
    assert layout.BAND_ROWS == jscan.BAND_ROWS
    assert layout.PERM_SENTINEL == int(jscan.PERM_SENTINEL)
    assert (layout.RH, layout.WC) == (jfm.RH, jfm.WC)
    names = [n for n in dir(jfm) if re.fullmatch(r"ST_[A-Z]+", n)]
    assert len(names) >= 20
    for name in names:
        assert getattr(layout, name) == getattr(jfm, name), name
    for hw in ((H, W), (543, 723), (1041, 780), (3, 5)):
        assert layout.padded_image_shape(*hw) == jfm.padded_image_shape(*hw)
    assert layout.padded_image_shape(543, 723) == (576, 768)


def test_cuda_header_constants_match_layout():
    src = (Path(tgf.__file__).parents[1] / "csrc" / "common.cuh").read_text()
    found = dict((k, int(v)) for k, v in
                 re.findall(r"\b(ST_[A-Z]+|CHUNK) = (\d+)", src))
    assert found["CHUNK"] == layout.CHUNK
    st_names = [n for n in dir(layout) if re.fullmatch(r"ST_[A-Z]+", n)]
    for name in st_names:
        assert found[name] == getattr(layout, name), name
    # The kernel template of B2, B5, B6, B7a, B7b and B12: its block size
    # and shared-memory budget, which ops/fused_model.band_rows mirrors.
    csrc = Path(tgf.__file__).parents[1] / "csrc"
    finish = (csrc / "finish.cuh").read_text()
    iteration = (csrc / "iteration.cuh").read_text()
    assert re.search(r"\bFINISH_THREADS = (\d+);", finish).group(1) == "256"
    assert '#include "finish.cuh"' in iteration
    assert "BAND_THREADS = FINISH_THREADS;" in iteration
    assert tfm.BAND_THREADS == 256
    budget = re.search(r"\bBAND_SMEM_BUDGET = (\d+);", iteration).group(1)
    assert int(budget) == tfm.BAND_SMEM_BUDGET
    leaf = re.search(r"\bBAND_LEAF_BYTES = NSUM \* BAND_THREADS \* 8;",
                     iteration)
    assert leaf is not None and tfm._BAND_LEAF_BYTES == 9 * 256 * 8
    # Its slots: the entry points count them in chunks of common.cuh's
    # CHUNK, which finish.cuh brings in.
    assert '#include "common.cuh"' in finish
    for entry in ("megastep.cu", "fused_warp_splat.cu",
                  "warp_splat_images.cu", "finish_partials.cu",
                  "megastep_finish.cu", "megastep2.cu", "finish_local.cu"):
        src = (csrc / entry).read_text()
        assert '#include "iteration.cuh"' in src
        assert ("nch * bf::CHUNK" in src) != (
            entry in ("finish_partials.cu", "megastep_finish.cu",
                      "finish_local.cu"))


# ----------------------------------------------------- small numpy ports


def test_geometry_and_image_shape_match_jax():
    for bbox in ((0, 23, 0, 31), (3, 9, 5, 30), (7, 7, 9, 9), (0, 1, 0, 1),
                 (2, 20, 11, 12)):
        j = jgf.geometry_from_bbox(*bbox, SCALE, SENSOR, 15)
        t = tgf.geometry_from_bbox(*bbox, SCALE, SENSOR, 15)
        assert t.x_shift == float(j.x_shift) and t.y_shift == float(j.y_shift)
        assert (t.w_dyn, t.h_dyn) == (int(j.w_dyn), int(j.h_dyn))
        assert t.window_small == bool(j.window_small)
    assert tgf.static_image_shape(3, SensorConfig()) == \
        jgf.static_image_shape(3, SensorConfig()) == (543, 723)


def test_project_4param_reinit_matches_jax():
    d = _slice_inputs(1)
    fr_x, fr_y, t = (d["stat"][:, k].reshape(-1) for k in range(3))
    pr_x, pr_y = (d["pr"][:, k].reshape(-1) for k in range(2))
    sc = [np.float32(v) for v in (-0.02, 0.015, 12.3, 15.7, 2e-3, -3e-3)]
    # Jitted, as the JAX pipeline runs it (XLA fuses multiply-adds; the
    # port reproduces the compiled arithmetic, see ops/warp.py).
    want = jax.jit(jwarp.project_4param_reinit)(fr_x, fr_y, t, pr_x, pr_y,
                                                *sc)
    got = twarp.project_4param_reinit(*(_t(a) for a in (fr_x, fr_y, t, pr_x,
                                                        pr_y)),
                                      *(torch.tensor(v) for v in sc))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    u, v = twarp.compute_uv(got[2], got[3])
    ju, jv = jwarp.compute_uv(want[2], want[3])
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6)


def test_kahan_add_totals_matches_jax():
    rng = np.random.default_rng(2)
    jm, tm = JaxModel.zero(), MotionModel.zero()
    for d in rng.normal(0, 1e-3, (200, 4)).astype(np.float32):
        jm = jm.add_totals(*d)
        tm = tm.add_totals(*(torch.tensor(v) for v in d))
    for f in JaxModel._fields:
        assert float(getattr(tm, f)) == float(getattr(jm, f)), f
    # Under f64 totals the totals and compensations are f64, the rest f32.
    m64 = MotionModel.zero(f64_totals=True)
    for f in JaxModel._fields:
        want = torch.float64 if f.startswith(("total_", "comp_")) \
            else torch.float32
        assert getattr(m64, f).dtype == want, f


# ------------------------------------------------------------ kernels


@pytest.mark.parametrize("K", [1, 3])
def test_act_rows_matches_pallas(K):
    rng = np.random.default_rng(K)
    n = NCH * CH
    sidx = np.where(rng.uniform(size=n) < 0.9, np.arange(n) + 1000, -1)
    sidx = sidx.astype(np.int32)
    ws = (np.arange(K) % 2 == 0)
    st_h = (1100 + 1500 * np.arange(K)).astype(np.int32)
    en_h = (st_h + 400).astype(np.int32)
    want = jfm.act_rows_call(jnp.asarray(sidx), jnp.asarray(ws),
                             jnp.asarray(st_h), jnp.asarray(en_h))
    hist = np.stack([ws.astype(np.int32), st_h, en_h])
    got = tfm.act_rows_call(_t(sidx), _t(hist))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < (sidx >= 0).sum()


@pytest.mark.parametrize("time_lo", [False, True])
def test_warp_images_st_matches_pallas(time_lo):
    d = _slice_inputs(0)
    args = [d[k] for k in ("stat", "act", "pr", "st", "geo")]
    npr_j, at_j, ac_j = jfm.warp_images_st_call(
        *(jnp.asarray(a) for a in args), scale=SCALE, H=H, W=W,
        time_lo=time_lo)
    npr, at, ac = tfm.warp_images_st_call(*(_t(a) for a in args),
                                          *tfm.image_pair("cpu", H, W),
                                          scale=SCALE, H=H, W=W,
                                          time_lo=time_lo)
    assert at.dtype == torch.int64 and ac.dtype == torch.int32
    np.testing.assert_allclose(npr.numpy(), np.asarray(npr_j), rtol=1e-6)
    np.testing.assert_array_equal(ac.numpy().astype(np.float32),
                                  np.asarray(ac_j))
    assert ac.sum() > 3000
    # f32 summation order differs (the JAX kernel sums t0 * count + the
    # chunk's bf16 residues in f32; the port sums exact fixed point).
    np.testing.assert_allclose(tfm.time_image_f32(at).numpy(),
                               np.asarray(at_j), rtol=1e-5, atol=1e-6)


def _finish_pair(d, statics):
    """Both finish kernels on the same images (the port's, which the JAX
    kernel gets as f32)."""
    _, at, ac = tfm.warp_images_st_call(
        *(_t(d[k]) for k in ("stat", "act", "pr", "st", "geo")),
        *tfm.image_pair("cpu", H, W), scale=SCALE, H=H, W=W, time_lo=False)
    want = jfm.megastep_finish_call(
        jnp.asarray(tfm.time_image_f32(at).numpy()),
        jnp.asarray(ac.numpy().astype(np.float32)), jnp.asarray(d["st"]),
        jnp.asarray(d["geo"]), scale=SCALE, H=H, W=W, **statics)
    got = tfm.megastep_finish_call(at, ac, _t(d["st"]), _t(d["geo"]),
                                   scale=SCALE, H=H, W=W, **statics)
    return got.numpy()[0], np.asarray(want)[0]


@pytest.mark.parametrize("schedule,exit_grad,exit_pred", [
    ("fast", 4.0, 0.0), ("fast", 0.0, 0.0), ("fast", 4.0, 4.0),
    ("reference", 0.0, 0.0)])
def test_megastep_finish_matches_pallas(schedule, exit_grad, exit_pred):
    got, want = _finish_pair(_slice_inputs(0),
                             _statics(schedule, exit_grad, exit_pred))
    _assert_state_close(got, want)
    assert got[layout.ST_ITERS] == 3.0


def test_megastep_finish_exit_paths_match_pallas():
    """States on both sides of the exit tests: a converged state (tiny
    deltas and gradients, CONT -> 0) and one stopped by the iteration cap;
    the gradient-qualified and predicted exits are on."""
    d = _slice_inputs(3)
    conv = d["st"].copy()
    conv[0, 24:28] = conv[0, 24:28] * 1e-3
    conv[0, 18:22] = [1e-6, 1e-6, 1e-6, -1e-6]
    for st, statics in ((conv, _statics("fast", 4.0, 4.0)),
                        (conv, _statics("reference", 0.0, 0.0)),
                        (d["st"], dict(_statics(), max_iter=2))):
        got, want = _finish_pair(dict(d, st=st), statics)
        _assert_state_close(got, want)


def test_finish_zero_padding_equals_circular_roll():
    """The TPU kernel rolls the padded image circularly and masks to H x W;
    the port reads zeros outside the image.  No accepted event lands in
    row/column 0 or at or beyond H/W, so both give the same sums."""
    d = _slice_inputs(4)
    _, at, ac = tfm.warp_images_st_call(
        *(_t(d[k]) for k in ("stat", "act", "pr", "st", "geo")),
        *tfm.image_pair("cpu", H, W), scale=SCALE, H=H, W=W)
    assert int(ac[0].sum()) == int(ac[:, 0].sum()) == 0
    assert int(ac[H:].sum()) == int(ac[:, W:].sum()) == 0
    roll = lambda a, d, axis: torch.roll(a, d, axis)
    zero = tfm.finish_values_plain(at, ac, scale=SCALE, H=H, W=W)
    circ = tfm.finish_values_plain(at, ac, scale=SCALE, H=H, W=W,
                                   shift=roll)
    assert torch.equal(zero, circ)
    assert zero[0] > 100


@pytest.mark.parametrize("window_small", [0.0, 1.0])
def test_warp_uv_matches_pallas(window_small):
    d = _slice_inputs(5)
    st = d["st"][0]
    out_j, uvn_j = jfm.warp_uv_call(
        jnp.asarray(d["stat"]), jnp.asarray(d["pr"]), jnp.asarray(d["act"]),
        jnp.float32(window_small), -st[0], -st[1], st[8], st[9], st[3],
        -st[2])
    out, uvn = tfm.warp_uv_call(*(_t(d[k]) for k in ("stat", "pr", "act",
                                                      "st")), window_small)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-6)
    np.testing.assert_allclose(uvn[:, 0:2].numpy(),
                               np.asarray(uvn_j)[:, 0:2], rtol=1e-6)
    np.testing.assert_array_equal(uvn[:, 2].numpy(), np.asarray(uvn_j)[:, 2])


def test_wrappers_check_their_inputs():
    d = {k: _t(v) for k, v in _slice_inputs(0).items() if k != "valid"}
    with pytest.raises(TypeError, match="dtype"):
        tfm.warp_uv_call(d["stat"].double(), d["pr"], d["act"], d["st"])
    pair = tfm.image_pair("cpu", H, W)
    with pytest.raises(ValueError, match="shape"):
        tfm.warp_images_st_call(d["stat"], d["act"], d["pr"][:2], d["st"],
                                d["geo"], *pair, scale=SCALE, H=H, W=W)
    with pytest.raises(ValueError, match="contiguous"):
        tfm.warp_uv_call(d["stat"], d["pr"].transpose(0, 1).contiguous()
                         .transpose(0, 1), d["act"], d["st"])
    with pytest.raises(ValueError, match="sidx"):
        tfm.act_rows_call(torch.zeros(100, dtype=torch.int32),
                          torch.zeros((3, 1), dtype=torch.int32))
    # Only CPU tensors take the plain twin; other devices get a kernel or
    # an error.
    with pytest.raises(ValueError, match="no kernel"):
        tfm.act_rows_call(torch.zeros(CH, dtype=torch.int32, device="meta"),
                          torch.zeros((3, 1), dtype=torch.int32,
                                      device="meta"))
    assert tfm.LAUNCHES == dict.fromkeys(tfm.LAUNCHES, 0)
