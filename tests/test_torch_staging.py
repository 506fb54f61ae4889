"""The scan's numpy staging route on the CPU: recordings whose coordinates
are not integers in [0, 65535) (sub-pixel, as rectified streams are) or
whose slices hold more than 65,535 events.

``materialize_slices`` and the staged tensors against the JAX package's
(bitwise), the numpy route against the native one on integer coordinates
(bitwise), the first-slice-wins claim against the JAX package's host claim,
the scan against the JAX scan (Pallas in interpret mode) under the scan
gates, and the cold path, event shards and ranges against the port's own
scan (bitwise).  Per-event outputs are compared in the original event
order.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from better_flow_tpu.runtime import scan_pipeline as jscan  # noqa: E402
from better_flow_tpu_torch.config import (  # noqa: E402
    PipelineConfig, SensorConfig, SliceConfig,
)
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.ops.layout import CHUNK  # noqa: E402
from better_flow_tpu_torch.parallel.event_parallel import (  # noqa: E402
    compensate_recording_scan_sharded,
)
from better_flow_tpu_torch.parallel.mesh import make_event_mesh  # noqa: E402
from better_flow_tpu_torch.parallel.multihost import (  # noqa: E402
    compensate_recording_multihost,
)
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from test_torch_scan import _all_gates  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import subpixel_stream  # noqa: E402
from torch_inputs import flow_gates, gate_stream, small_cfg  # noqa: E402

KEYS = ("u", "v", "noise", "iters")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors; one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return small_cfg(scatter_mode="pallas")


def _banded_cfg():
    """Three row bands (80 rows of 36), so that band padding and the band
    edge at x = 36 both show."""
    return PipelineConfig(
        sensor=SensorConfig(80, 64),
        slice=SliceConfig(max_events=4000, span_ns=int(0.1e9),
                          refresh_events=1500, refresh_time_ns=int(0.04e9)),
        optimizer=small_cfg().optimizer)


def _banded_stream():
    """Sub-pixel events on 80x64, with a run of x a hair below the band
    edge (35.9999999, 36.0 in f32) and just below 72."""
    d = subpixel_stream(synthetic_events(9000, duration_s=0.3, res_x=80,
                                         res_y=64, vx=20.0, vy=-14.0,
                                         seed=3), (80, 64))
    d["x"][100:400] = 35.9999999
    d["x"][400:500] = 71.99999999
    d["x"][500:600] = 35.99
    return d


@pytest.fixture(scope="module")
def flow():
    """12,000 sub-pixel events of the 24x32 test configuration."""
    d = synthetic_events(12000, duration_s=0.3, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    return subpixel_stream(d, (24, 32))


@pytest.fixture(scope="module")
def flow_scan(flow):
    return tscan.compensate_recording_scan(flow["x"], flow["y"],
                                           flow["t_ns"], _cfg(), device="cpu")


# ------------------------------------------------- staging, bitwise


@pytest.mark.parametrize("sort,pad,indices_only", [
    (True, True, False), (True, False, False), (False, False, False),
    (True, True, True)])
def test_materialize_slices_equals_jax(sort, pad, indices_only):
    """Every output of ``materialize_slices`` on float64 coordinates, some
    a hair below a band edge (they band by their f32 value)."""
    cfg, d = _banded_cfg(), _banded_stream()
    plan_t = tscan.plan_slices(d["t_ns"], cfg)
    plan_j = jscan.plan_slices(d["t_ns"], cfg)
    kw = dict(spatial_sort=sort, band_pad=pad, res_x=80,
              indices_only=indices_only)
    got = tscan.materialize_slices(d["x"], d["y"], d["t_ns"], plan_t, 4000,
                                   **kw)
    want = jscan.materialize_slices(d["x"], d["y"], d["t_ns"], plan_j, 4000,
                                    **kw)
    for name, g, w in zip(("xs", "ys", "ts", "idx", "lens"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    if pad:
        idx = got[3]
        assert idx.shape[1] == tscan.padded_capacity(cfg)
        # Padding inside a slice, not only at its tail.
        s = 1
        pads = np.flatnonzero(idx[s] < 0)
        assert pads[0] < np.flatnonzero(idx[s] >= 0)[-1]
    if sort and not indices_only:
        xs, idx = got[0], got[3]
        edge = (idx >= 100) & (idx < 400)
        assert edge.any() and (xs[edge] == 36.0).all()


def _jax_staged(d, cfg, **kw):
    """The JAX package's numpy-route slabs as (S, capp) numpy arrays."""
    p = jscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg, **kw)
    assert not p["compact"]
    return p, {k: np.asarray(p[k]) for k in ("xs", "ys", "ts", "idx",
                                             "bbox", "nval")}


def _port_slabs(p):
    """The port's staged ``stat``/``sidx`` as (S, capp) numpy arrays."""
    st = p["stat"].numpy()
    S = st.shape[0]
    return {k: st[:, :, i, :].reshape(S, -1)
            for i, k in enumerate(("xs", "ys", "ts"))} | {
        "idx": p["sidx"].numpy()}


RANGE_CASES = {
    "whole": {},
    "range": dict(slice_range=(7, 12)),
    "pad_quantum": dict(slice_range=(3, 9), pad_quantum=3 * CHUNK),
    "chunk_range": dict(pad_quantum=2 * CHUNK, chunk_range=(2, 4)),
}


@pytest.mark.parametrize("case", list(RANGE_CASES))
def test_prepare_recording_equals_jax(case):
    """stat, sidx, bbox, counts and the gate history before a range, on
    the sub-pixel gate stream (its one-pixel phase fires the gate): the
    JAX slabs (whose numpy route ignores ``pad_quantum``) are the port's,
    the extra slots are padding, and ``chunk_range`` keeps those
    columns."""
    cfg = _cfg()
    d = subpixel_stream(gate_stream(), (24, 32))
    kw = RANGE_CASES[case]
    pt = tscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg,
                                 device="cpu", **kw)
    assert pt["compact"] is False
    assert "numpy_staging" in pt["plan_breakdown"]
    assert "native_sort" not in pt["plan_breakdown"]
    pj, j = _jax_staged(d, cfg, **{k: v for k, v in kw.items()
                                   if k != "chunk_range"})
    t = _port_slabs(pt)
    capj = j["idx"].shape[1]
    c0, c1 = kw.get("chunk_range", (0, pt["chunks_total"]))
    for k in ("xs", "ys", "ts", "idx"):
        full = np.full((len(j[k]), pt["chunks_total"] * CHUNK),
                       -1 if k == "idx" else 0, j[k].dtype)
        full[:, :capj] = j[k]
        np.testing.assert_array_equal(t[k], full[:, c0 * CHUNK:c1 * CHUNK],
                                      err_msg=k)
    np.testing.assert_array_equal(pt["bbox"], j["bbox"])
    np.testing.assert_array_equal(pt["nval"], j["nval"])
    for g, w in zip(pt["hist0"], pj["hist0"]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert pt["prev_end"] == pj["prev_end"]
    if case == "range":
        assert pt["hist0"][0].any()   # the gate fired just before


@pytest.mark.parametrize("kw", [{}, dict(slice_range=(7, 12),
                                         pad_quantum=3 * CHUNK)])
def test_numpy_route_is_bitwise_native_on_integers(monkeypatch, kw):
    """Integer coordinates through the numpy route (the native
    coordinate check forced to refuse) give the native route's tensors,
    and stay compact, as in the JAX package."""
    cfg = _cfg()
    d = gate_stream()
    native = tscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg,
                                     device="cpu", **kw)
    assert native["compact"] and "native_sort" in native["plan_breakdown"]
    monkeypatch.setattr(tscan.native, "coords_u16", lambda x, y: None)
    fallback = tscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg,
                                       device="cpu", **kw)
    assert fallback["compact"]
    assert "numpy_staging" in fallback["plan_breakdown"]
    for k in ("stat", "sidx", "geo"):
        assert torch.equal(native[k], fallback[k]), k
    for k in ("bbox", "nval"):
        np.testing.assert_array_equal(native[k], fallback[k])
    for g, w in zip(native["hist0"], fallback["hist0"]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("lo", [0, 6])
def test_first_wins_equals_jax_host_claim(lo):
    """The device claim (``accumulate_device`` by ``sidx``) against the
    JAX package's host claim (``_accumulate_first_wins`` by ``idx``) on
    random per-slot outputs of a numpy-staged range."""
    cfg = _cfg()
    d = subpixel_stream(gate_stream(), (24, 32))
    rng_kw = {} if lo == 0 else dict(slice_range=(lo, 11))
    pj, _ = _jax_staged(d, cfg, **rng_kw)
    pt = tscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg,
                                 device="cpu", **rng_kw)
    rng = np.random.default_rng(lo)
    uvn = rng.normal(0, 30, tuple(pt["stat"].shape)).astype(np.float32)
    uvn[:, :, 2] = rng.uniform(size=uvn[:, :, 2].shape) < 0.3
    want = jscan._accumulate_first_wins(pj, uvn)
    got = tscan.accumulate_device(torch.from_numpy(uvn), pt["sidx"],
                                  pt["n"], claim_from=pt["prev_end"] + 1)
    for g, w, name in zip(got, want, ("u", "v", "noise")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert (got[0] != 0).any()
    if lo:
        assert (got[0][:pt["prev_end"] + 1] == 0).all()


# ------------------------------------------------ runs on the route


def test_subpixel_scan_meets_the_gates_against_jax(flow, flow_scan):
    rj = jscan.compensate_recording_scan(flow["x"], flow["y"], flow["t_ns"],
                                         _cfg())
    rt = flow_scan
    assert len(rt["iters"]) >= 8 and rt["ran"].all()
    _all_gates(rt, rj, flow)
    st = rt["stats"]
    assert st["host_syncs"] == int(rt["iters"].sum()) and st["plan_s"] > 0


def test_large_slices_against_jax():
    """``max_events`` 70,000 (past the u16 offsets) on integer events, two
    slices of 36 chunks: iterations equal, u and v within 1% of the mean
    speed everywhere (the scan gates hold the medians)."""
    cfg = _cfg().replace(slice=SliceConfig(
        max_events=70_000, span_ns=int(0.5e9), refresh_events=70_000,
        refresh_time_ns=int(1e9)))
    d = synthetic_events(75_000, duration_s=0.3, res_x=24, res_y=32,
                         vx=20.0, vy=-14.0, seed=2)
    rt = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                         device="cpu")
    rj = jscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
    assert len(rt["iters"]) == 2 and rt["ran"].all()
    np.testing.assert_array_equal(rt["iters"], np.asarray(rj["iters"]))
    ok = flow_gates(rt, rj)
    speed = float(np.hypot(rj["u"][ok], rj["v"][ok]).mean())
    for k in ("u", "v"):
        assert np.abs(rt[k] - rj[k]).max() <= 0.01 * speed, k
    prep = tscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg,
                                   device="cpu")
    assert prep["sidx"].shape == (2, 36 * CHUNK) and not prep["compact"]
    assert "coords_u16" not in prep["plan_breakdown"]


@pytest.mark.parametrize("compact", [False, True])
def test_cold_is_bitwise_the_scan(compact):
    """The cold path in three batches on the sub-pixel gate stream:
    bitwise the scan also under ``compact_results`` (numpy-staged batches
    stay f32), u of exactly 0 kept in a later batch's claim: without the
    warm start, the events first held by the slice the gate stopped."""
    d = subpixel_stream(gate_stream(), (24, 32))
    cfg = _cfg().replace(stm_disable=True)
    scan = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                           device="cpu")
    cold = tscan.compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                           n_batch=3,
                                           compact_results=compact,
                                           device="cpu")
    for k in KEYS:
        np.testing.assert_array_equal(cold[k], scan[k], err_msg=k)
    assert not scan["ran"].all() and scan["ran"].any()
    first_claim = int(scan["plan"].ends[-(-len(scan["iters"]) // 3) - 1])
    assert (scan["u"][first_claim + 1:] == 0).any()
    assert (scan["u"][first_claim + 1:] != 0).any()
    assert cold["stats"]["n_batches"] == 3


def test_cold_packs_and_checkpoints_integers_on_the_numpy_route(
        tmp_path, monkeypatch):
    """Integer coordinates staged by numpy (the native coordinate check
    forced to refuse) are compact, as in the JAX package: the cold path
    packs them and checkpoints them, bitwise the native route's run."""
    d = gate_stream()
    cfg = _cfg().replace(stm_disable=True)
    kw = dict(n_batch=3, compact_results=True, device="cpu")
    native = tscan.compensate_recording_cold(
        d["x"], d["y"], d["t_ns"], cfg,
        checkpoint_path=tmp_path / "native.npz", **kw)
    monkeypatch.setattr(tscan.native, "coords_u16", lambda x, y: None)
    fallback = tscan.compensate_recording_cold(
        d["x"], d["y"], d["t_ns"], cfg,
        checkpoint_path=tmp_path / "numpy.npz", **kw)
    for k in KEYS:
        np.testing.assert_array_equal(fallback[k], native[k], err_msg=k)
    assert (tmp_path / "numpy.npz").exists()


def test_tiny_budget_routes_a_subpixel_scan_bitwise(flow, flow_scan,
                                                    monkeypatch):
    """The scan routed to the cold path (either route leaves the same
    resident tensors, which the estimate counts) is bitwise the
    one-program scan on sub-pixel coordinates too."""
    monkeypatch.setenv("BF_SCAN_DEVICE_BUDGET_GB", "1e-6")
    r = tscan.compensate_recording_scan(flow["x"], flow["y"], flow["t_ns"],
                                        _cfg(), device="cpu")
    assert r["stats"]["routed_cold"] is True
    for k in KEYS:
        np.testing.assert_array_equal(r[k], flow_scan[k], err_msg=k)


def test_cold_checkpoint_refuses_the_numpy_route(flow, tmp_path,
                                                monkeypatch):
    """A sub-pixel recording under ``checkpoint_path`` is refused before
    any batch is staged."""
    def no_staging(*a, **k):
        raise AssertionError("staged a batch")

    monkeypatch.setattr(tscan, "_stage_batch", no_staging)
    ckpt = tmp_path / "cold.npz"
    with pytest.raises(ValueError, match="requires the compact staging"):
        tscan.compensate_recording_cold(flow["x"], flow["y"], flow["t_ns"],
                                        _cfg(), n_batch=2,
                                        checkpoint_path=ckpt, device="cpu")
    assert not ckpt.exists()


def test_two_shards_are_bitwise_the_scan(flow, flow_scan):
    r = compensate_recording_scan_sharded(flow["x"], flow["y"],
                                          flow["t_ns"], _cfg(),
                                          make_event_mesh(2, device="cpu"))
    assert r["stats"]["n_devices"] == 2
    for k in KEYS + ("ran",):
        np.testing.assert_array_equal(r[k], flow_scan[k], err_msg=k)


def test_two_ranges_of_two_shards_are_bitwise_the_scan(flow, flow_scan):
    r = compensate_recording_multihost(flow["x"], flow["y"], flow["t_ns"],
                                       _cfg(), n_ranges=2, ev_per_host=2,
                                       device="cpu")
    assert r["stats"]["n_ranges"] == 2
    for k in KEYS + ("ran",):
        np.testing.assert_array_equal(r[k], flow_scan[k], err_msg=k)


@pytest.mark.parametrize("mode", ["--scan", "--cold"])
def test_cli_on_a_subpixel_file(flow, tmp_path, mode):
    """``--scan``/``--cold -o`` on a text recording with sub-pixel
    coordinates writes ``write_events_uv`` of the scan of what it read."""
    from better_flow_tpu_torch.cli import motion_compensator as cli
    from better_flow_tpu_torch.io.event_file import (
        read_events, write_events_uv,
    )

    rec = tmp_path / "rec.txt"
    rec.write_text("".join(
        f"{t:.9f} {y:.4f} {x:.4f} 1\n"
        for t, x, y in zip(flow["t_ns"] / 1e9, flow["x"], flow["y"])))
    flags = ["--resolution", "24x32", "--max-events", "4000",
             "--time-width", "0.1", "--refresh-event-count", "1500",
             "--refresh-time", "0.04", "--device", "cpu", "--quiet"]
    out, lib = tmp_path / "cli.txt", tmp_path / "lib.txt"
    assert cli.main([str(rec), mode, "-o", str(out)] + flags) == 0
    r = read_events(str(rec))
    assert (r["x"] != np.floor(r["x"])).mean() > 0.9
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        [str(rec)] + flags))
    s = tscan.compensate_recording_scan(r["x"], r["y"], r["t_ns"], cfg,
                                        device="cpu")
    write_events_uv(str(lib), r["x"], r["y"], r["t_ns"], s["u"], s["v"])
    assert out.read_bytes() == lib.read_bytes()
    assert s["ran"].any()
