"""The production-sensor gates of ``tests/test_fast_schedule.py`` (:29, :93,
:112, :141, :407) on the port's kernel route: ``scatter_mode="auto"``,
which on the CPU runs the kernels' plain twins and on the card the kernels
(B3, B1, B2, B4 under the fast presets, B5 under the reference schedule),
bf16 time weights included.  The XLA branch's cases are in
``test_torch_fast_gates_xla.py``.

The scenes, seeds, event counts and bounds are the JAX tests' own
(``chip_smoke.FAST_GATES``).  Off the TPU the JAX package resolves "auto"
to its XLA branch, so its tests never ran these gates on the kernel path
that the fast presets were measured on.  Run there (``scatter_mode=
"pallas"``, interpret mode), the JAX package misses two of them on its own
noisy stream (:112, dvs_sim seed 31): fast() at 1.218 against 1.2 and
fast_accurate() at 1.093 against 1.02.  Those two gates
(``chip_smoke.SHARED_MISSES``) hold the port at the larger of the gate and
the JAX kernel path's ratio on the same stream; every other gate is held
as the JAX test writes it.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from fast_gate_runs import cs, hold, jax_runs, port_runs, scene  # noqa: E402

ROUTE = "auto"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fast_matches_reference_production_sensor():
    """test_fast_schedule.py:29: the production scene, seed 42: fast()
    lands on the reference schedule's warp (median |du|, |dv| below 1% of
    the speed) at no AEE cost (1.02) in at most 0.7 of its iterations."""
    hold(cs.gates_29(port_runs(ROUTE), scene))


def test_fast_offbench_rotdiv_scene():
    """test_fast_schedule.py:93: the rotdiv scene, seed 777: fast()'s AEE
    within 1.05 of the reference schedule's, no more iterations."""
    hold(cs.gates_93(port_runs(ROUTE), scene))


def test_fast_offbench_noisy_stream():
    """test_fast_schedule.py:112: the noisy dvs_sim stream, seed 31.  The
    iteration gates as written; the two AEE gates, which the JAX package's
    Pallas path misses on this stream, at the larger of the gate and that
    path's ratio (computed here, interpret mode)."""
    jax_gates = {g["label"]: g for g in cs.gates_112(jax_runs("pallas"),
                                                     scene)}
    limits = {}
    for label in cs.SHARED_MISSES:
        g = jax_gates[label]
        assert not cs.gate_held(g), (label, g["value"] / g["base"])
        limits[label] = max(g["limit"], g["value"] / g["base"])
    for label, g in jax_gates.items():
        assert label in cs.SHARED_MISSES or cs.gate_held(g), label
    hold(cs.gates_112(port_runs(ROUTE), scene), limits)


def test_fast_rotdiv_margin_canary():
    """test_fast_schedule.py:141: the rotdiv scene, seed 777: fast() at
    exit_grad_factor 4 within 1.03 of the reference schedule's AEE, at 6
    within 1.3."""
    hold(cs.gates_141(port_runs(ROUTE), scene))


def test_fast_throughput_domain_gates():
    """test_fast_schedule.py:407: fast_throughput() on the production
    scene, seeds 42, 101, 202 (each within 1.12, their mean within 1.05,
    at most 0.9 of fast()'s iterations), and on the rotdiv scene within
    1.5."""
    hold(cs.gates_407(port_runs(ROUTE), scene))
