"""The event-parallel scan of the PyTorch port against the JAX package's and
against the port's unsharded scan.

``compensate_recording_scan_sharded`` shards each slice's events, sums the
shards' pre-filter images once per optimizer iteration and finishes on the
sum.  The JAX package runs it under ``shard_map`` on the 8 virtual CPU
devices of ``tests/conftest.py`` with ``scatter_mode="pallas"`` (the Pallas
kernels in interpret mode); the port holds its shards in one process on the
CPU (the plain twins).

Gates.  Against the JAX package (``torch_inputs.flow_gates``, the scan's
gates of ``tests/test_torch_scan.py``): noise and ``ran`` identical, the
iteration sums within 10%, median |du| and |dv| under 1% of the mean speed;
the iteration counts equal over the first five slices on 24x32 recordings
(the chains drift later, see ``test_sharded_scan_matches_jax``) and over
every slice on the production geometry, where the median flow error against
the ground truth is also held within 1.05x of the JAX package's.  The port
against itself: a sharded run is BITWISE the unsharded run staged with the
same padding, for 1, 2, 4 and 8 shards on all four drives, because the
shards are cut on chunk boundaries and the summed images are integers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from better_flow_tpu.parallel import event_parallel as jep  # noqa: E402
from better_flow_tpu.parallel.mesh import (  # noqa: E402
    make_event_mesh as jax_event_mesh,
)
from better_flow_tpu_torch.config import (  # noqa: E402
    OptimizerConfig, PipelineConfig, SliceConfig,
)
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.ops.layout import CHUNK  # noqa: E402
from better_flow_tpu_torch.parallel import event_parallel as tep  # noqa: E402
from better_flow_tpu_torch.parallel.mesh import make_event_mesh  # noqa: E402
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from torch_inputs import (  # noqa: E402
    SENSOR, bench_stream, flow_gates, small_cfg,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins work on small tensors; one intra-op thread keeps parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    """The JAX scans stage through ``native/libbf_native.so``.  The JAX
    package's loader compiles it in place and remembers a failed load for
    the process, so a test worker that imported it while another was still
    writing the file runs the JAX sharded scan on its numpy staging
    fallback, which fails there (ROADMAP C).  Once the port's loader holds
    a whole library, forget that failure so that the JAX loader loads
    again.  This resets module state of the JAX package inside the test
    process; it changes none of its files."""
    from better_flow_tpu.io import native as jax_native
    from better_flow_tpu_torch.io import native as torch_native

    if (jax_native._TRIED and jax_native._LIB is None
            and torch_native.get_lib() is not None):
        jax_native._TRIED = False
    yield


@pytest.fixture
def eight():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    return 8


# ------------------------------------------- a recording, against JAX


def _small_cfg(opt=None, **kw):
    return PipelineConfig(
        sensor=SENSOR,
        slice=SliceConfig(max_events=4096, span_ns=int(0.1e9),
                          refresh_events=1500, refresh_time_ns=int(0.04e9)),
        optimizer=opt or OptimizerConfig(scale=3, min_events=500,
                                         scatter_mode="pallas"), **kw)


DRIVES = {
    "fast": lambda: _small_cfg(OptimizerConfig.fast(
        scale=3, min_events=500, scatter_mode="pallas")),
    "reference": lambda: _small_cfg(),
    "nomega": lambda: _small_cfg(OptimizerConfig(
        scale=3, min_events=500, scatter_mode="pallas", use_megastep=False)),
    "f64": lambda: _small_cfg(f64_totals=True),
}


@pytest.fixture(scope="module")
def stream():
    return synthetic_events(5000, duration_s=0.125, res_x=24, res_y=32,
                            vx=20.0, vy=-14.0, seed=2)


@pytest.mark.parametrize("drive,seed,n", [("fast", 2, 30000),
                                          ("reference", 4, 20000)])
def test_sharded_scan_matches_jax(eight, drive, seed, n):
    """The 8-shard scan of both packages on 24x32 recordings (the
    configuration of ``tests/test_torch_scan.py``), under the scan's gates.
    On such small windows the warm-start chains part company after some
    slices through ~1e-7 differences in the finish sums (f32 in XLA's order
    against f64), as the unsharded scans do, so the slice-for-slice
    iteration count is held only over the first five slices here and over
    every slice on the production geometry below."""
    d = synthetic_events(n, duration_s=0.5, res_x=24, res_y=32,
                         vx=20.0, vy=-14.0, seed=seed)
    cfg = small_cfg(scatter_mode="pallas")
    if drive == "reference":
        cfg = cfg.replace(optimizer=OptimizerConfig(
            scale=3, min_events=500, scatter_mode="pallas"))
    rj = jep.compensate_recording_scan_sharded(d["x"], d["y"], d["t_ns"],
                                               cfg, jax_event_mesh(8))
    rt = tep.compensate_recording_scan_sharded(
        d["x"], d["y"], d["t_ns"], cfg, make_event_mesh(8, device="cpu"))
    assert rt["stats"]["n_devices"] == rj["stats"]["n_devices"] == 8
    assert rt["stats"]["n_slices"] == rj["stats"]["n_slices"] > 10
    flow_gates(rt, rj)
    np.testing.assert_array_equal(rt["iters"][:5], np.asarray(rj["iters"])[:5])


@pytest.mark.parametrize("drive", ["fast", "reference"])
def test_sharded_scan_production_geometry_matches_jax(eight, drive):
    """bench.py's configuration (180x240, scale 3, 50k/20k slices) on two
    shards in both packages: the scan's gates, and the iterations equal
    slice for slice."""
    d = bench_stream(60_000)
    opt = OptimizerConfig.fast(scatter_mode="pallas") if drive == "fast" \
        else OptimizerConfig(scatter_mode="pallas")
    cfg = PipelineConfig(optimizer=opt)
    rj = jep.compensate_recording_scan_sharded(d["x"], d["y"], d["t_ns"],
                                               cfg, jax_event_mesh(2))
    rt = tep.compensate_recording_scan_sharded(
        d["x"], d["y"], d["t_ns"], cfg, make_event_mesh(2, device="cpu"))
    assert len(rt["iters"]) == 3 and rt["ran"].all()
    flow_gates(rt, rj)
    np.testing.assert_array_equal(rt["iters"], np.asarray(rj["iters"]))
    ok = ~rt["noise"]
    aee = lambda r: float(np.median(np.hypot(r["u"][ok] - d["u"][ok],
                                             r["v"][ok] - d["v"][ok])))
    assert aee(rt) <= 1.05 * aee(rj)


def test_sharded_scan_noise_persistence_matches_jax(eight):
    """A single-pixel burst fires the window gate; its events stay noise
    in later slices, identically in both packages' sharded scans and in
    the port's unsharded scan."""
    n1, n2 = 2000, 8000
    d = synthetic_events(n2, duration_s=0.2, res_x=24, res_y=32, vx=18.0,
                         vy=-8.0, seed=5)
    x = np.concatenate([np.full(n1, 5.0), d["x"]])
    y = np.concatenate([np.full(n1, 6.0), d["y"]])
    t = np.concatenate([np.linspace(0, 0.05e9, n1, dtype=np.int64),
                        d["t_ns"] + int(0.06e9)])
    cfg = DRIVES["reference"]()
    rj = jep.compensate_recording_scan_sharded(x, y, t, cfg,
                                               jax_event_mesh(8))
    rt = tep.compensate_recording_scan_sharded(
        x, y, t, cfg, make_event_mesh(8, device="cpu"))
    ru = tscan.compensate_recording_scan(x, y, t, cfg, device="cpu")
    np.testing.assert_array_equal(rt["noise"], np.asarray(rj["noise"]))
    np.testing.assert_array_equal(rt["noise"], ru["noise"])
    np.testing.assert_array_equal(rt["ran"], np.asarray(rj["ran"]))
    assert rt["noise"][:n1].any() and not rt["noise"].all()


# ------------------------------------- sharded is bitwise unsharded


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("drive", list(DRIVES))
def test_sharded_scan_is_bitwise_unsharded(stream, drive, n_shards):
    d, cfg = stream, DRIVES[drive]()
    mesh = make_event_mesh(n_shards, device="cpu")
    prep = tep.prepare_recording_sharded(d["x"], d["y"], d["t_ns"], cfg, mesh)
    assert prep["stat"].shape[1] % n_shards == 0
    assert prep["chunks_total"] * CHUNK % (n_shards * CHUNK) == 0
    ru = tscan.compensate_recording_scan(None, None, None, cfg, prepared=prep)
    rs = tep.compensate_recording_scan_sharded(None, None, None, cfg, mesh,
                                               prepared=prep)
    assert rs["ran"].all() and int(rs["iters"].sum()) > len(rs["iters"])
    for k in ("u", "v", "noise", "iters", "ran"):
        np.testing.assert_array_equal(rs[k], ru[k], err_msg=k)
    for f in ("total_dx", "total_rot", "comp_dx", "cx"):
        assert torch.equal(getattr(rs["model"], f), getattr(ru["model"], f))
    assert rs["model"].total_dx.dtype == (torch.float64 if drive == "f64"
                                          else torch.float32)
    st = rs["stats"]
    assert st["n_devices"] == n_shards
    assert st["host_syncs"] == int(rs["iters"].sum())
    # ... and the unpadded unsharded run: the extra chunks are padding.
    r0 = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                         device="cpu")
    for k in ("u", "v", "noise", "iters"):
        np.testing.assert_array_equal(rs[k], r0[k], err_msg=k)


def test_staging_for_another_group_raises(stream):
    d, cfg = stream, DRIVES["fast"]()
    prep = tscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg,
                                   device="cpu", pad_quantum=3 * CHUNK)
    with pytest.raises(ValueError, match="do not\\s+divide|divide"):
        tep.compensate_recording_scan_sharded(
            None, None, None, cfg, make_event_mesh(4, device="cpu"),
            prepared=prep)
    with pytest.raises(ValueError, match="chunk_range"):
        tscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg, device="cpu",
                                chunk_range=(2, 99))
    with pytest.raises(NotImplementedError, match="fast.*TypeError"):
        tep.compensate_recording_scan_sharded(
            d["x"], d["y"], d["t_ns"], DRIVES["fast"]().replace(
                f64_totals=True), make_event_mesh(2, device="cpu"))
