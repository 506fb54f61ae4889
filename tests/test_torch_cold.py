"""The port's cold path on the CPU: ``compensate_recording_cold`` against
the port's own scan (bitwise) and the JAX package's cold path (the flow
gates, Pallas in interpret mode), the range accumulation and the packed
wire format against the JAX package's, the offline checkpoints in both
directions, and the scan's route to the cold path.

The port's results are compared in the original event order: every
batch's claimed events go back through its slices' sort permutation.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu import config as jcfg  # noqa: E402
from better_flow_tpu.runtime import scan_pipeline as jscan  # noqa: E402
from better_flow_tpu_torch.convert import carry_to_jax  # noqa: E402
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.ops.layout import PERM_SENTINEL  # noqa: E402
from better_flow_tpu_torch.parallel import multihost as tmh  # noqa: E402
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from torch_inputs import CH, flow_gates, gate_stream, small_cfg  # noqa: E402

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


def _jax_cfg():
    """The JAX package's own configuration object, equal field for field
    to ``_cfg()``."""
    return jcfg.PipelineConfig(
        sensor=jcfg.SensorConfig(24, 32),
        slice=jcfg.SliceConfig(max_events=4000, span_ns=int(0.1e9),
                               refresh_events=1500,
                               refresh_time_ns=int(0.04e9)),
        optimizer=jcfg.OptimizerConfig.fast(scale=3, min_events=500,
                                            scatter_mode="pallas"))


STREAMS = {
    "flow": lambda: synthetic_events(30000, duration_s=0.5, res_x=24,
                                     res_y=32, vx=20.0, vy=-14.0, seed=2),
    "gate": gate_stream,
}


@pytest.fixture(scope="module")
def streams():
    return {k: f() for k, f in STREAMS.items()}


@pytest.fixture(scope="module")
def scans(streams):
    return {k: tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"],
                                               _cfg(), device="cpu")
            for k, d in streams.items()}


@pytest.fixture(scope="module")
def jax_cold(streams, tmp_path_factory):
    """The JAX package's cold path on the flow stream, 3 batches, with a
    checkpoint (complete after the run)."""
    d = streams["flow"]
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "cold.npz")
    r = jscan.compensate_recording_cold(d["x"], d["y"], d["t_ns"], _cfg(),
                                        n_batch=3, checkpoint_path=path)
    return r, path


def _cold(d, **kw):
    return tscan.compensate_recording_cold(d["x"], d["y"], d["t_ns"], _cfg(),
                                           device="cpu", **kw)


def _assert_same(a, b, keys=KEYS):
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("stream,n_batch", [
    ("flow", 1), ("flow", 3), ("flow", 4), ("gate", 3)])
def test_cold_equals_scan_bitwise(streams, scans, stream, n_batch):
    r = _cold(streams[stream], n_batch=n_batch)
    _assert_same(r, scans[stream])
    st = r["stats"]
    S = len(scans[stream]["iters"])
    assert st["n_slices"] == S and st["resumed_batches"] == 0
    assert st["n_batches"] == len(st["batches"]) == min(n_batch, S)
    assert st["host_syncs"] == int(r["iters"].sum())
    assert st["mean_iters"] == pytest.approx(r["iters"].mean())
    assert st["launches"] == dict.fromkeys(st["launches"], 0)   # CPU: twins
    assert all(b["stage_s"] > 0 and b["run_s"] > 0 and b["fetch_s"] > 0
               for b in st["batches"])
    assert set(r) == {"u", "v", "noise", "model", "carry", "iters", "stats"}
    for f in ("total_dx", "total_dy", "total_rot", "total_div"):
        assert torch.equal(getattr(r["model"], f),
                           getattr(scans[stream]["model"], f)), f


def test_empty_and_sub_slice_recordings():
    """tests/test_scan_pipeline.py's degenerate inputs: an empty recording
    gives zero slices, one shorter than a slice its flush slice."""
    cfg = _cfg()
    for fn in (tscan.compensate_recording_scan,
               tscan.compensate_recording_cold):
        r = fn(np.zeros(0), np.zeros(0), np.zeros(0, np.int64), cfg,
               device="cpu")
        assert r["stats"]["n_slices"] == 0 and len(r["u"]) == 0
        assert r["stats"]["mean_iters"] == 0.0
    rng = np.random.default_rng(0)
    n = 800
    x = rng.integers(0, 24, n).astype(np.float64)
    y = rng.integers(0, 32, n).astype(np.float64)
    t = np.sort(rng.integers(0, int(0.05e9), n)).astype(np.int64)
    scan = tscan.compensate_recording_scan(x, y, t, cfg, device="cpu")
    cold = tscan.compensate_recording_cold(x, y, t, cfg, device="cpu")
    assert cold["stats"]["n_slices"] >= 1 and len(cold["u"]) == n
    _assert_same(cold, scan)


def test_cold_meets_the_gates_against_jax_cold(streams, jax_cold):
    """The port's cold run against the JAX package's on the same input:
    noise identical, iteration sums within 10%, median |du|, |dv| under 1%
    of the mean speed (the JAX cold result has no ``ran``)."""
    rj, _ = jax_cold
    rt = _cold(streams["flow"], n_batch=3)
    assert rt["stats"]["n_batches"] == rj["stats"]["n_batches"] == 3
    flow_gates(rt, rj, ran=False)
    assert rt["stats"]["n_slices"] == rj["stats"]["n_slices"]


def _range_inputs(seed=0, S=6, nch=2, n=9000):
    """S overlapping slices of nch chunks over n events: each slice's
    window, spatially shuffled into its slots with padding, and random
    [u, v, noise] rows."""
    rng = np.random.default_rng(seed)
    capp = nch * CH
    starts = np.sort(rng.integers(0, n - capp // 2, S)).astype(np.int32)
    perm = np.full((S, capp), PERM_SENTINEL, np.uint16)
    for s in range(S):
        k = int(rng.integers(capp // 4, capp // 2))
        k = min(k, n - int(starts[s]))
        slots = rng.choice(capp, k, replace=False)
        perm[s, slots] = rng.permutation(k)
    uvn = rng.normal(0, 30, (S, nch, 3, CH)).astype(np.float32)
    uvn[:, :, 2] = rng.uniform(size=(S, nch, CH)) < 0.3
    sidx = np.where(perm != PERM_SENTINEL,
                    starts[:, None] + perm.astype(np.int32), -1)
    return uvn, perm, starts, sidx.astype(np.int32)


@pytest.mark.parametrize("claim_from,claim_to", [
    (0, 9000), (2500, 6000), (4000, 4001)])
def test_accumulate_device_range_equals_jax(claim_from, claim_to):
    uvn, perm, starts, sidx = _range_inputs()
    cap = claim_to - claim_from + 7
    got = tscan.accumulate_device_range(
        torch.from_numpy(uvn), torch.from_numpy(sidx), claim_from, claim_to,
        cap)
    want = jscan._accumulate_device_range(
        jnp.asarray(uvn), jnp.asarray(perm), jnp.asarray(starts),
        jnp.int32(claim_from), jnp.int32(claim_to), cap)
    for g, w, name in zip(got, want, ("u", "v", "noise")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got[2].dtype == torch.bool and got[2].any()


def _pack_inputs(m, seed=1):
    """u, v with +-0, f16 subnormals, values that overflow f16 and
    ordinary flow values; noise flags."""
    rng = np.random.default_rng(seed)
    special = np.array([0.0, -0.0, 3e-6, -5.96e-8, 2e-5, 65504.0, 65520.0,
                        -1e6, 1e-30, 1.0009765625], np.float32)
    u = rng.normal(0, 80, m).astype(np.float32)
    v = rng.normal(0, 80, m).astype(np.float32)
    u[: min(m, len(special))] = special[:m]
    v[-min(m, len(special)):] = special[:m][::-1]
    return u, v, rng.random(m) < 0.3


@pytest.mark.parametrize("m", [1, 8, 13, 1000])
def test_pack_and_unpack_results_equal_jax(m):
    u, v, nz = _pack_inputs(m)
    got = tscan.pack_results(torch.from_numpy(u), torch.from_numpy(v),
                             torch.from_numpy(nz))
    want = np.asarray(jscan._pack_results(jnp.asarray(u), jnp.asarray(v),
                                          jnp.asarray(nz)))
    assert got.dtype == torch.uint8 and got.shape == (4 * m + -(-m // 8),)
    np.testing.assert_array_equal(got.numpy(), want)
    for g, w in zip(tscan.unpack_results(want, m),
                    jscan._unpack_results(want, m)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    u2, v2, n2 = tscan.unpack_results(got.numpy(), m)
    with np.errstate(over="ignore"):   # beyond f16's range: inf
        for a, a2 in ((u, u2), (v, v2)):
            np.testing.assert_array_equal(
                a.astype(np.float16).astype(np.float32).view(np.uint32),
                a2.view(np.uint32))
    np.testing.assert_array_equal(nz, n2)


def test_compact_results_within_f16_rounding(streams, scans):
    exact = scans["flow"]
    comp = _cold(streams["flow"], n_batch=3, compact_results=True)
    np.testing.assert_array_equal(exact["noise"], comp["noise"])
    np.testing.assert_array_equal(exact["iters"], comp["iters"])
    for k in ("u", "v"):
        assert np.all(np.abs(comp[k] - exact[k])
                      <= 2.0 ** -11 * np.abs(exact[k]) + 2.0 ** -25), k
        np.testing.assert_array_equal(
            comp[k], exact[k].astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("compact", [False, True])
def test_kill_and_resume_bitwise(streams, tmp_path, monkeypatch, compact):
    """Kill the run while its worker stages the third batch: the caller
    gets that very exception, no staging thread is left, and the
    checkpoint holds the batches before; the resumed run is bitwise the
    uninterrupted one, model included."""
    d = streams["flow"]
    ckpt = str(tmp_path / "cold.ckpt.npz")
    clean = _cold(d, n_batch=4, compact_results=compact)
    calls, raised = [], []
    orig = tscan.stage_range

    def dying_stage(*a, **k):
        calls.append(threading.current_thread() is threading.main_thread())
        if len(calls) == 3:
            raised.append(RuntimeError("simulated mid-run kill"))
            raise raised[-1]
        return orig(*a, **k)

    monkeypatch.setattr(tscan, "stage_range", dying_stage)
    with pytest.raises(RuntimeError, match="simulated") as info:
        _cold(d, n_batch=4, checkpoint_path=ckpt, compact_results=compact)
    monkeypatch.setattr(tscan, "stage_range", orig)
    assert info.value is raised[0] and calls == [False] * 3
    assert not any(t.name.startswith("bf-stage")
                   for t in threading.enumerate())
    with np.load(ckpt) as z:
        assert int(z["done_batches"]) == 1

    resumed = _cold(d, n_batch=4, checkpoint_path=ckpt, resume=True,
                    compact_results=compact)
    assert resumed["stats"]["resumed_batches"] == 1
    assert len(resumed["stats"]["batches"]) == 3
    _assert_same(resumed, clean)
    for f in ("total_dx", "total_dy", "total_rot", "total_div", "comp_dx"):
        assert torch.equal(getattr(clean["model"], f),
                           getattr(resumed["model"], f)), f


def test_fully_complete_checkpoint_short_circuits(streams, tmp_path):
    d = streams["flow"]
    ckpt = str(tmp_path / "done.ckpt.npz")
    full = _cold(d, n_batch=3, checkpoint_path=ckpt)
    again = _cold(d, n_batch=3, resume=True)   # no path: a fresh run
    _assert_same(again, full)
    resumed = _cold(d, n_batch=3, checkpoint_path=ckpt, resume=True)
    assert resumed["stats"]["resumed_batches"] == 3
    assert resumed["stats"]["batches"] == []
    _assert_same(resumed, full)


@pytest.fixture(scope="module")
def two_batch_ckpt(streams, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt2") / "two.npz")
    _cold(streams["flow"], n_batch=2, checkpoint_path=path)
    return path


def test_checkpoint_mismatch_raises(streams, two_batch_ckpt):
    with pytest.raises(ValueError, match="n_batch"):
        _cold(streams["flow"], n_batch=3, checkpoint_path=two_batch_ckpt,
              resume=True)


def test_checkpoint_config_digest_rejects_different_config(streams,
                                                           two_batch_ckpt):
    d = streams["flow"]
    cfg2 = small_cfg(scatter_mode="pallas", dx_tol=3e-4)
    with pytest.raises(ValueError, match="config"):
        tscan.compensate_recording_cold(
            d["x"], d["y"], d["t_ns"], cfg2, n_batch=2,
            checkpoint_path=two_batch_ckpt, resume=True, device="cpu")


def test_checkpoint_truncated_results_rejected(streams, two_batch_ckpt,
                                               tmp_path):
    z = dict(np.load(two_batch_ckpt, allow_pickle=False))
    assert int(z["done_batches"]) == 2
    z["acc_u_0"] = z["acc_u_0"][:-5]
    path = str(tmp_path / "trunc.npz")
    np.savez(path, **z)
    with pytest.raises(ValueError, match="length"):
        _cold(streams["flow"], n_batch=2, checkpoint_path=path, resume=True)


def test_checkpoint_with_f32_totals_rejected_under_f64_totals(
        streams, two_batch_ckpt, tmp_path):
    """Without its digest, an f32-totals checkpoint still cannot resume
    an f64-totals run."""
    z = dict(np.load(two_batch_ckpt, allow_pickle=False))
    del z["config_digest"]
    path = str(tmp_path / "nodigest.npz")
    np.savez(path, **z)
    cfg = _cfg()
    cfg64 = type(cfg)(sensor=cfg.sensor, slice=cfg.slice,
                      optimizer=cfg.optimizer, f64_totals=True)
    plan = tscan.plan_slices(streams["flow"]["t_ns"], cfg)
    with pytest.raises(ValueError, match="f64"):
        tscan.load_offline_checkpoint(
            path, n=int(z["n"]), S=len(plan.ends), n_batch=2,
            hist_k=tscan.history_depth(plan), cfg=cfg64)


def _claims_and_hist(d, n_batch):
    plan = tscan.plan_slices(d["t_ns"], _cfg())
    S = len(plan.ends)
    per = -(-S // n_batch)
    bounds = [(b * per, min((b + 1) * per, S)) for b in range(n_batch)
              if b * per < S]
    claims = [(int(plan.ends[lo - 1]) + 1 if lo > 0 else 0,
               int(plan.ends[hi - 1]) + 1 if hi < S else len(d["t_ns"]))
              for lo, hi in bounds]
    return dict(n=len(d["t_ns"]), S=S, n_batch=n_batch,
                hist_k=tscan.history_depth(plan), claims=claims)


def _assert_same_checkpoint(a, b):
    """Two loaders' (done, carry, batch_results), each carry as the JAX
    package's numpy tuple: equal values in equal dtypes."""
    assert a[0] == b[0]
    for x, y in zip(a[1][0], b[1][0]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for x, y in zip(a[1][1:], b[1][1:]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for ra, rb in zip(a[2], b[2]):
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(x, y)


def test_jax_checkpoint_resumes_in_the_port(streams, jax_cold):
    """The JAX package's checkpoint of a complete run loads through the
    port's loader as through its own, and the port's resume from it is
    the JAX run bitwise."""
    rj, path = jax_cold
    d = streams["flow"]
    spec = _claims_and_hist(d, 3)
    mine = tscan.load_offline_checkpoint(path, cfg=_cfg(), **spec)
    theirs = jscan.load_offline_checkpoint(path, cfg=_jax_cfg(), **spec)
    _assert_same_checkpoint(
        (mine[0], carry_to_jax(mine[1]), mine[2]),
        (theirs[0], (tuple(np.asarray(f) for f in theirs[1][0]),)
         + tuple(np.asarray(a) for a in theirs[1][1:]), theirs[2]))
    r = _cold(d, n_batch=3, checkpoint_path=path, resume=True)
    assert r["stats"]["resumed_batches"] == 3
    _assert_same(r, rj)


def test_port_checkpoint_resumes_in_jax(streams, tmp_path):
    """The port's checkpoint loads through the JAX package's loader (the
    digests of equal configurations are equal), and the JAX resume from
    a complete one is the port's run bitwise."""
    assert jscan.config_digest(_jax_cfg()) == tscan.config_digest(_cfg())
    d = streams["flow"]
    path = str(tmp_path / "port.npz")
    rt = _cold(d, n_batch=3, checkpoint_path=path)
    spec = _claims_and_hist(d, 3)
    theirs = jscan.load_offline_checkpoint(path, cfg=_jax_cfg(), **spec)
    mine = tscan.load_offline_checkpoint(path, cfg=_cfg(), **spec)
    _assert_same_checkpoint(
        (mine[0], carry_to_jax(mine[1]), mine[2]),
        (theirs[0], (tuple(np.asarray(f) for f in theirs[1][0]),)
         + tuple(np.asarray(a) for a in theirs[1][1:]), theirs[2]))
    rj = jscan.compensate_recording_cold(d["x"], d["y"], d["t_ns"],
                                         _jax_cfg(), n_batch=3,
                                         checkpoint_path=path, resume=True)
    assert rj["stats"]["resumed_batches"] == 3
    _assert_same(rj, rt)


def test_tiny_budget_routes_the_scan_bitwise(streams, scans, monkeypatch):
    d = streams["flow"]
    assert "routed_cold" not in scans["flow"]["stats"]
    monkeypatch.setenv("BF_SCAN_DEVICE_BUDGET_GB", "0.001")
    r = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], _cfg(),
                                        device="cpu")
    st = r["stats"]
    assert st["routed_cold"] is True and st["n_batches"] >= 4
    est = tscan.estimate_scan_device_bytes(d["t_ns"], _cfg())
    assert st["est_device_gb"] == round(est / 1e9, 2)
    assert st["plan_s"] == 0.0 and st["run_s"] == st["total_s"]
    _assert_same(r, scans["flow"])


@pytest.fixture
def derivations(monkeypatch):
    """Calls of ``plan_slices`` and ``native.coords_u16``, counted where
    staging looks them up."""
    calls = {"plan_slices": 0, "coords_u16": 0}

    def spy(owner, name):
        orig = getattr(owner, name)

        def counted(*a, **k):
            calls[name] += 1
            return orig(*a, **k)

        monkeypatch.setattr(owner, name, counted)

    spy(tscan, "plan_slices")
    spy(tscan.native, "coords_u16")
    return calls


ONCE = {"plan_slices": 1, "coords_u16": 1}


@pytest.mark.parametrize("n_batch", [1, 2, 4])
def test_a_cold_call_derives_the_plan_and_coordinates_once(
        streams, scans, derivations, n_batch):
    r = _cold(streams["flow"], n_batch=n_batch)
    assert r["stats"]["n_batches"] == n_batch
    assert derivations == ONCE
    _assert_same(r, scans["flow"])


def test_a_routed_scan_derives_the_plan_and_coordinates_once(
        streams, scans, derivations, monkeypatch):
    d = streams["flow"]
    monkeypatch.setenv("BF_SCAN_DEVICE_BUDGET_GB", "1e-6")
    r = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], _cfg(),
                                        device="cpu")
    assert r["stats"]["routed_cold"] is True
    assert r["stats"]["n_batches"] > 4
    assert derivations == ONCE
    _assert_same(r, scans["flow"])


def test_multihost_ranges_derive_the_plan_and_coordinates_once(
        streams, scans, derivations):
    d = streams["flow"]
    r = tmh.compensate_recording_multihost(d["x"], d["y"], d["t_ns"],
                                           _cfg(), n_ranges=3, device="cpu")
    assert r["stats"]["n_ranges"] == 3
    assert derivations == ONCE
    _assert_same(r, scans["flow"])


@pytest.mark.parametrize("given", ["carry_in", "init_model"])
def test_a_given_carry_or_model_is_not_routed(streams, scans, monkeypatch,
                                              given):
    """A caller continuing a chain chose the one-program scan."""
    d = streams["flow"]
    cfg = _cfg()
    plan = tscan.plan_slices(d["t_ns"], cfg)
    model0 = tscan.initial_model(cfg, "cpu")
    kw = {"init_model": model0} if given == "init_model" else {
        "carry_in": tscan.make_carry(model0, tscan.history_depth(plan))}
    monkeypatch.setenv("BF_SCAN_DEVICE_BUDGET_GB", "0.001")
    r = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                        device="cpu", **kw)
    assert "routed_cold" not in r["stats"] and "ran" in r
    _assert_same(r, scans["flow"])


def test_estimate_counts_resident_bytes(streams):
    """32 B a staged slot (stat, sidx, B3's rows, uvn) and 13 B an event;
    ``pad_quantum`` rounds the slots up as ``prepare_recording`` does."""
    d = streams["flow"]
    cfg = _cfg()
    S = len(tscan.plan_slices(d["t_ns"], cfg).ends)
    n = len(d["t_ns"])
    capp = tscan.padded_capacity(cfg)
    assert tscan.estimate_scan_device_bytes(d["t_ns"], cfg) == \
        S * capp * 32 + n * 13
    q = 4 * CH
    capq = -(-capp // q) * q
    assert capq > capp
    assert tscan.estimate_scan_device_bytes(d["t_ns"], cfg, pad_quantum=q) \
        == S * capq * 32 + n * 13
    prep = tscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg,
                                   device="cpu", pad_quantum=q)
    assert prep["sidx"].shape == (S, capq)
