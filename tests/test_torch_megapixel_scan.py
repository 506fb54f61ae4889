"""The benchmark's megapixel configuration on the CPU twins: a 1280x720
Gen4 sensor at scale 3 (a 2163x3843 scaled image, one-row bands on the
card) with the upstream offline tool's slicing and ``fast()``, as
``portbench/configs/gen4-720p-offline-fast.json`` states them, through
``compensate_recording_scan``, against the benchmark's plain reference
(``portbench/reference/flow.py``) under the kinds of the cell's limits;
the run is not vacuous; and the program's finish counters.

One CPU thread runs an iteration of the whole image in ~2.7 s (the
reference in ~1.1 s), so the recording is three slices (50,000 events)
and both start from the scene's own motion (``torch_inputs.gen4_start``):
from a zero model the first slice alone takes ~75 iterations.  Imports no
JAX."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from better_flow_tpu_torch import profiling  # noqa: E402
from better_flow_tpu_torch.config import SensorConfig  # noqa: E402
from better_flow_tpu_torch.models import global_flow as tgf  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from portbench import compare  # noqa: E402
from portbench.reference import flow as ref  # noqa: E402
from torch_inputs import (  # noqa: E402
    GEN4_CONFIG as CONFIG, gen4_cfg as _cfg, gen4_model,
    gen4_start, gen4_stream, small_cfg,
)

CELL = "offline-fast-gen4"
N_EVENTS = 50_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(d, st, tot, cx, cy):
    """``ref.compensate``'s loop from the model (tot, cx, cy) in place of
    a zero one: every slice in order, first slice wins."""
    prep = ref.prepare(d["x"], d["y"], d["t_ns"], st, flush=True)
    n, S = len(prep.t_ns), prep.n_slices
    u, v = np.zeros(n, np.float32), np.zeros(n, np.float32)
    noise, iters = np.zeros(n, bool), np.zeros(S, np.int32)
    model = ref.Model.from_numbers(tot, [0.0] * 4, cx, cy, "cpu",
                                   torch.float32)
    seed = None
    for s in range(S):
        r = ref.run_one(prep, s, model, seed, st, "cpu")
        model, seed, iters[s] = r.out.model, r.out.seed, r.out.iters
        a, b = prep.window(s)
        first = max(a, int(prep.plan.ends[s - 1]) + 1) if s else a
        k = first - a
        u[first:b], v[first:b], noise[first:b] = \
            r.u[k:], r.v[k:], r.noise[k:]
    return prep, ref.Result(u=u, v=v, noise=noise, iters=iters)


@pytest.fixture(scope="module")
def megapixel():
    """The port (its spans recorded) and the reference on one seeded
    recording of the cell's scene, and the comparison's numbers."""
    d = gen4_stream(N_EVENTS, seed=2 ** 31 + 23)
    w = tscan.plan_slices(d["t_ns"], _cfg())
    tot, cx, cy = gen4_start(d["x"][:w.ends[0] + 1], d["y"][:w.ends[0] + 1])
    with profiling.program_spans() as rec:
        out = tscan.compensate_recording_scan(
            d["x"], d["y"], d["t_ns"], _cfg(),
            init_model=gen4_model(tot, cx, cy), device="cpu")
    st = ref.Settings.from_config(CONFIG)
    prep, r = _reference(d, st, tot, cx, cy)
    numbers = compare.flow_numbers(
        out["u"], out["v"], out["noise"], r.u, r.v, r.noise,
        compare.claimed(prep.plan.starts, prep.plan.ends),
        compare.mean_speed(r.u, r.v), np.asarray(out["iters"]), r.iters)
    return dict(d=d, out=out, rec=rec, prep=prep, ref=r, st=st,
                numbers=numbers)


@pytest.mark.parametrize("number", ["noise_mismatch", "flow_gap_p50",
                                    "flow_gap_p90"])
def test_megapixel_scan_is_the_reference(megapixel, number):
    """The outputs against the reference's under the cell's limit of each
    number (``portbench/limits/offline-fast-gen4.json``): the noise flags
    exactly, the flow gaps' event quantiles."""
    out, n = megapixel["out"], megapixel["numbers"]
    assert megapixel["prep"].n_slices == 3 == len(out["iters"])
    assert n["nonfinite"] == 0
    assert n[number] <= compare.limits(CELL)[number], n


@pytest.mark.parametrize("reading", ["speed", "iterations"])
def test_megapixel_run_is_not_vacuous(megapixel, reading):
    """The reference recovers the scene's speed (a sparse megapixel scene
    can exit at once with zero flow) and iterates: mean speed over 0.8 of
    the scene's true flow, more than one iteration a slice."""
    r, d = megapixel["ref"], megapixel["d"]
    if reading == "speed":
        truth = float(np.mean(np.hypot(d["u"], d["v"])))
        assert float(np.mean(np.hypot(r.u, r.v))) > 0.8 * truth
    else:
        assert r.iters.mean() > 1 and np.asarray(
            megapixel["out"]["iters"]).mean() > 1


def test_megapixel_bands_are_one_row():
    """B2's band pass at the cell's image: one row a band, 200,096 B of
    the shared-memory budget."""
    H, W = tgf.static_image_shape(3, SensorConfig(720, 1280))
    assert (H, W) == (2163, 3843)
    assert tfm.band_rows(H, W, 3) == (1, 200096)
    assert tfm.band_rows(H, W, 3)[1] <= tfm.BAND_SMEM_BUDGET


def test_finish_counters_sum_the_image_and_the_window(megapixel):
    """With the recorder on, each iteration's finish adds the whole scaled
    image to ``finish_px`` and the slice's dynamic window (the reference's
    own geometry of its bbox) to ``window_px``."""
    counters = megapixel["rec"].counters
    iters = np.asarray(megapixel["out"]["iters"], np.int64)
    prep, st = megapixel["prep"], megapixel["st"]
    window = [ref.geometry(*prep.bbox[s], st) for s in range(len(iters))]
    assert counters["iters"] == iters.sum() > 0
    assert counters["finish_px"] == iters.sum() * 2163 * 3843
    assert counters["window_px"] == sum(
        int(k) * g.w_dyn * g.h_dyn for k, g in zip(iters, window))
    assert 1.5 < counters["finish_px"] / counters["window_px"] < 2.5


@pytest.mark.parametrize("route", ["carried", "per_slice"])
def test_finish_counters_off_record_nothing(monkeypatch, route):
    """On a small sensor, both slice loops: off, the count is never taken
    and the outputs are bitwise those of a run with it on, which counts a
    finish each iteration that ran."""
    from better_flow_tpu_torch.io.synthetic import synthetic_events

    d = synthetic_events(12000, duration_s=0.2, res_x=24, res_y=32,
                         vx=20.0, vy=-14.0, seed=5)
    cfg = small_cfg()
    if route == "per_slice":      # the extrapolated start keeps that loop
        cfg = small_cfg(warm_extrapolate=0.5)
    calls = []
    orig = tgf.count_finishes
    monkeypatch.setattr(tgf, "count_finishes",
                        lambda *a: calls.append(a) or orig(*a))
    run = lambda: tscan.compensate_recording_scan(
        d["x"], d["y"], d["t_ns"], cfg, device="cpu")
    off = run()
    assert calls == []
    with profiling.program_spans() as rec:
        on = run()
    for k in ("u", "v", "noise", "iters"):
        np.testing.assert_array_equal(on[k], off[k])
    H, W = tgf.static_image_shape(3, cfg.sensor)
    ran = int(np.count_nonzero(on["iters"]))
    assert len(calls) == ran > 0
    assert rec.counters["finish_px"] == int(on["iters"].sum()) * H * W
