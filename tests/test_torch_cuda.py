"""The port's CUDA kernels against their plain twins, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports no JAX, so it also runs where JAX is not
installed, from the root of a checkout on a machine with the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)  Each kernel
gets the numpy-seeded inputs of ``torch_inputs.py`` on the card, and its
twin the same inputs on the CPU.  ``chip_smoke.py`` repeats the kernel
checks at the main path's shapes and drives the main path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from better_flow_tpu.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.ops import layout  # noqa: E402
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from torch_inputs import (  # noqa: E402
    CH, H, NCH, SCALE, W, slice_inputs, small_cfg, statics,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _both(d, keys, dev):
    """The inputs ``keys`` of ``d`` as CPU tensors and as card tensors."""
    cpu = [torch.from_numpy(np.ascontiguousarray(d[k])) for k in keys]
    return cpu, [t.to(dev) for t in cpu]


def _launched(name, fn):
    """``fn()`` and a check that it launched kernel ``name`` once."""
    before = tfm.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert tfm.LAUNCHES[name] == before + 1
    return out


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=rtol,
                               atol=atol)


def test_act_rows_kernel_matches_twin(cuda):
    rng = np.random.default_rng(1)
    n = NCH * CH
    sidx = np.where(rng.uniform(size=n) < 0.9, np.arange(n) + 1000, -1)
    st_h = (1100 + 1500 * np.arange(3)).astype(np.int32)
    hist = np.stack([np.array([1, 0, 1], np.int32), st_h, st_h + 400])
    (s_c, h_c), (s_g, h_g) = _both(dict(sidx=sidx.astype(np.int32),
                                        hist=hist), ("sidx", "hist"), cuda)
    got = _launched("act_rows", lambda: tfm.act_rows_call(s_g, h_g))
    want = tfm.act_rows_call(s_c, h_c)
    assert torch.equal(got.cpu(), want)
    assert 0 < float(want.sum()) < float((s_c >= 0).sum())


@pytest.mark.parametrize("time_lo", [False, True])
def test_warp_images_st_kernel_matches_twin(cuda, time_lo):
    keys = ("stat", "act", "pr", "st", "geo")
    cpu, gpu = _both(slice_inputs(0), keys, cuda)
    kw = dict(scale=SCALE, H=H, W=W, time_lo=time_lo)
    npr, at, ac = _launched("warp_images_st",
                            lambda: tfm.warp_images_st_call(*gpu, **kw))
    npr_p, at_p, ac_p = tfm.warp_images_st_call(*cpu, **kw)
    _close(npr, npr_p, rtol=1e-6)
    assert torch.equal(ac.cpu(), ac_p) and int(ac_p.sum()) > 3000
    _close(tfm.time_image_f32(at), tfm.time_image_f32(at_p), rtol=1e-5,
           atol=1e-6)


@pytest.mark.parametrize("schedule,exit_grad,exit_pred,converged", [
    ("fast", 4.0, 0.0, False), ("fast", 0.0, 0.0, False),
    ("fast", 4.0, 4.0, False), ("reference", 0.0, 0.0, False),
    ("fast", 4.0, 4.0, True), ("reference", 0.0, 0.0, True)])
def test_megastep_finish_kernel_matches_twin(cuda, schedule, exit_grad,
                                             exit_pred, converged):
    d = slice_inputs(3)
    if converged:                      # tiny deltas and gradients: CONT -> 0
        d["st"][0, 24:28] *= 1e-3
        d["st"][0, 18:22] = [1e-6, 1e-6, 1e-6, -1e-6]
    cpu, _ = _both(d, ("stat", "act", "pr", "st", "geo"), cuda)
    _, at, ac = tfm.warp_images_st_call(*cpu, scale=SCALE, H=H, W=W,
                                        time_lo=False)
    kw = dict(scale=SCALE, H=H, W=W, **statics(schedule, exit_grad,
                                               exit_pred))
    st, geo = cpu[3], cpu[4]
    got = _launched("megastep_finish", lambda: tfm.megastep_finish_call(
        at.to(cuda), ac.to(cuda), st.to(cuda), geo.to(cuda), **kw))
    got = got.cpu()[0]
    want = tfm.megastep_finish_call(at, ac, st, geo, **kw)[0]
    exact = [layout.ST_ITERS, layout.ST_CONT]
    assert torch.equal(got[exact], want[exact])
    # Kahan compensations are the totals' rounding residues: any ulp in a
    # delta moves them anywhere within an ulp of the total.
    comp = slice(layout.ST_CDX, layout.ST_CDIV + 1)
    tot = slice(layout.ST_TDX, layout.ST_TDIV + 1)
    assert bool(((got[comp] - want[comp]).abs()
                 <= want[tot].abs() * 2.0 ** -22).all())
    rest = [k for k in range(layout.ST_SIZE) if k not in exact
            and not layout.ST_CDX <= k <= layout.ST_CDIV]
    _close(got[rest], want[rest], rtol=1e-5)


@pytest.mark.parametrize("window_small", [0.0, 1.0])
def test_warp_uv_kernel_matches_twin(cuda, window_small):
    cpu, gpu = _both(slice_inputs(5), ("stat", "pr", "act", "st"), cuda)
    out, uvn = _launched("warp_uv",
                         lambda: tfm.warp_uv_call(*gpu, window_small))
    out_p, uvn_p = tfm.warp_uv_call(*cpu, window_small)
    _close(out, out_p, rtol=1e-6)
    _close(uvn[:, 0:2], uvn_p[:, 0:2], rtol=1e-6)
    assert torch.equal(uvn[:, 2].cpu(), uvn_p[:, 2])


def test_scan_on_card_matches_cpu_twins_and_repeats(cuda):
    """The whole scan on the card against the CPU twins (the gates of
    test_torch_scan.py), every kernel launched, and a second card run
    bitwise the same."""
    d = synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    cfg = small_cfg()
    run = lambda dev: tscan.compensate_recording_scan(
        d["x"], d["y"], d["t_ns"], cfg, device=dev)
    rg, rc, rg2 = run(cuda), run("cpu"), run(cuda)
    assert all(v > 0 for v in rg["stats"]["launches"].values())
    np.testing.assert_array_equal(rg["noise"], rc["noise"])
    np.testing.assert_array_equal(rg["ran"], rc["ran"])
    assert np.mean(rg["iters"] == rc["iters"]) >= 0.9
    assert abs(int(rg["iters"].sum()) - int(rc["iters"].sum())) \
        <= 0.1 * int(rc["iters"].sum())
    ok = ~rc["noise"]
    speed = float(np.hypot(rc["u"][ok], rc["v"][ok]).mean())
    assert np.median(np.abs(rg["u"][ok] - rc["u"][ok])) < 0.01 * speed
    assert np.median(np.abs(rg["v"][ok] - rc["v"][ok])) < 0.01 * speed
    for k in ("u", "v", "noise", "iters"):
        np.testing.assert_array_equal(rg[k], rg2[k])
