"""The tiled pipeline at its full width (720x1280, scale 1) against the JAX
package, on the CPU.

The first 300,000 events (12 slices) of ``chip_smoke.py``'s megapixel stream
under its tiled protocol (halo 32, ``esc_cap`` 32768, the reference
schedule, at most 10 iterations), through

- the JAX package's untiled scan and its 2x2 and 4x2 tiled runs in both
  scatter modes (``"xla"``, and ``"pallas"`` with the kernels in interpret
  mode),
- the port's untiled scan, its 1x1 and 4x2 tiled runs on the CPU twins and
  its 2x2 tiled run in both branches (the kernels' twins, and ``"xla"``).

From the seventh slice on, this stream's optimizer exits within an ulp of
its tolerance or not at all, so the order in which an implementation sums
the image decides the iteration count: the JAX package's own three runs
count differently in some of the twelve slices (``chip_smoke.py``'s
``TILED_FRAGILE_SLICES``).  The tests hold the port to that: its 4x2 tiled
run counts what the JAX package's ``"pallas"`` run counts, and its tiled
and untiled runs, and its 2x2 ``"xla"`` and kernel runs, part only in
slices where the JAX package's own runs part, with the flow inside the
gates of ``tests/test_spatial.py`` (median |du|, |dv| <= 0.5% and max
|du| <= 5% of a mean speed above 50; between the two scatter modes 0.1%
and 5% of a speed above 20) throughout.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from better_flow_tpu.parallel import spatial as jsp  # noqa: E402
from better_flow_tpu.runtime import scan_pipeline as jscan  # noqa: E402
from better_flow_tpu_torch.parallel import spatial as tsp  # noqa: E402
from better_flow_tpu_torch.parallel.mesh import make_tiled_mesh  # noqa: E402
from better_flow_tpu_torch.runtime.scan_pipeline import (  # noqa: E402
    compensate_recording_scan,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

N_EVENTS = 300_000


@pytest.fixture(scope="module")
def runs():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    d = cs.tiled_stream(cs.N_TILED)
    x, y, t = (d[k][:N_EVENTS] for k in ("x", "y", "t_ns"))
    cfg = cs.tiled_cfg()
    kw = dict(halo=cs.TILED_HALO, esc_cap=cs.TILED_ESC_CAP)
    out = {"jax untiled": jscan.compensate_recording_scan(x, y, t, cfg)}
    for shape in ((4, 2), (2, 2)):
        mesh = jax.make_mesh(shape, ("tile_x", "tile_y"),
                             devices=jax.devices()[:shape[0] * shape[1]])
        for mode in ("xla", "pallas"):
            c = dataclasses.replace(cfg, optimizer=dataclasses.replace(
                cfg.optimizer, scatter_mode=mode))
            out[f"jax {shape[0]}x{shape[1]} {mode}"] = \
                jsp.compensate_recording_tiled(x, y, t, c, mesh, **kw)
    out["port untiled"] = compensate_recording_scan(x, y, t, cfg,
                                                    device="cpu")
    for shape in ((1, 1), (4, 2), (2, 2)):
        out[f"port {shape[0]}x{shape[1]}"] = tsp.compensate_recording_tiled(
            x, y, t, cfg, make_tiled_mesh(shape, device="cpu"), **kw)
    out["port 2x2 xla"] = tsp.compensate_recording_tiled(
        x, y, t, cs.tiled_cfg(mode="xla"), make_tiled_mesh((2, 2),
                                                           device="cpu"),
        **kw)
    torch.set_num_threads(n_threads)
    return {k: {f: np.asarray(r[f]) for f in ("u", "v", "noise", "iters")}
            | {"dropped": r["stats"].get("escaped_dropped", 0)}
            for k, r in out.items()}


def _within_gates(a, b, median=0.005, min_speed=50.0):
    np.testing.assert_array_equal(a["noise"], b["noise"])
    ok = ~b["noise"]
    speed = float(np.hypot(b["u"][ok], b["v"][ok]).mean())
    assert speed > min_speed
    du, dv = (np.abs(a[k][ok] - b[k][ok]) for k in ("u", "v"))
    assert np.median(du) <= median * speed
    assert np.median(dv) <= median * speed
    assert du.max() <= 0.05 * speed


def test_port_tiled_run_counts_what_the_jax_pallas_run_counts(runs):
    rt, rj = runs["port 4x2"], runs["jax 4x2 pallas"]
    assert len(rj["iters"]) == 12 and rt["dropped"] == rj["dropped"] == 0
    np.testing.assert_array_equal(rt["iters"], rj["iters"])
    _within_gates(rt, rj)
    _within_gates(rt, runs["jax 4x2 xla"])


def test_port_4x2_tiles_equal_its_1x1_run(runs):
    np.testing.assert_array_equal(runs["port 4x2"]["iters"],
                                  runs["port 1x1"]["iters"])
    _within_gates(runs["port 4x2"], runs["port 1x1"])
    assert runs["port 1x1"]["dropped"] == 0


def test_tiled_and_untiled_part_only_where_the_jax_runs_part(runs):
    """The port's untiled scan against its tiled run: the iteration counts
    differ (so the tiled-equals-untiled gate of ``tests/test_spatial.py``
    does not hold on this stream), but only in slices where the JAX
    package's untiled scan and its two tiled runs do not agree among
    themselves, in no more slices than those, and never in the flow."""
    ju, jx, jp = (runs[k]["iters"] for k in
                  ("jax untiled", "jax 4x2 xla", "jax 4x2 pallas"))
    jax_part = (ju != jx) | (ju != jp)
    port_part = runs["port untiled"]["iters"] != runs["port 4x2"]["iters"]
    assert port_part.any() and jax_part.any()           # not vacuous
    assert not (port_part & ~jax_part).any(), (port_part, jax_part)
    assert port_part.sum() <= jax_part.sum()
    assert not jax_part[:6].any()
    # Where every run of the JAX package agrees, so does the port's scan.
    np.testing.assert_array_equal(runs["port untiled"]["iters"][~jax_part],
                                  ju[~jax_part])
    _within_gates(runs["port 4x2"], runs["port untiled"])
    _within_gates(runs["port untiled"], runs["jax untiled"])


def _jax_part(runs):
    """The slices where any two of the JAX package's runs count
    differently."""
    its = [r["iters"] for k, r in runs.items() if k.startswith("jax ")]
    return np.any([i != its[0] for i in its[1:]], axis=0)


def test_the_jax_runs_part_in_the_smokes_fragile_slices(runs):
    """``chip_smoke.py`` gates its card runs with the slices where the
    JAX package's own runs part; they are these runs' (its five: untiled,
    2x2 and 4x2 in both scatter modes), and its 2x2 ``"xla"`` and
    ``"pallas"`` runs part among them."""
    part = _jax_part(runs)
    np.testing.assert_array_equal(np.flatnonzero(part),
                                  cs.TILED_FRAGILE_SLICES)
    j22 = runs["jax 2x2 xla"]["iters"] != runs["jax 2x2 pallas"]["iters"]
    assert j22.any() and not (j22 & ~part).any()


def test_port_2x2_xla_and_kernel_runs_part_only_where_the_jax_runs_part(
        runs):
    """The port's 2x2 ``"xla"`` run (the exact scatter and the JAX
    package's image chain, no kernel) against its 2x2 kernel run: the
    iteration counts part only in slices where the JAX package's own runs
    part, in no more slices than its 2x2 ``"xla"`` and ``"pallas"`` runs
    part, and the flow holds ``tests/test_spatial.py:350-354``'s gate
    between the scatter modes (median 0.1%, max 5% of a speed above 20).
    Where every JAX run agrees, the port's 2x2 ``"xla"`` run counts what
    they count, and its flow is the JAX package's 2x2 ``"xla"`` flow
    under the same gate."""
    part = _jax_part(runs)
    rx, rk = runs["port 2x2 xla"], runs["port 2x2"]
    j22 = runs["jax 2x2 xla"]["iters"] != runs["jax 2x2 pallas"]["iters"]
    port_part = rx["iters"] != rk["iters"]
    assert not (port_part & ~part).any(), (port_part, part)
    assert port_part.sum() <= j22.sum()
    np.testing.assert_array_equal(rx["iters"][~part],
                                  runs["jax 2x2 xla"]["iters"][~part])
    assert rx["dropped"] == rk["dropped"] == 0
    _within_gates(rx, rk, median=0.001, min_speed=20.0)
    _within_gates(rx, runs["jax 2x2 xla"], median=0.001, min_speed=20.0)
