"""The production-sensor gates of ``tests/test_fast_schedule.py`` (:29, :93,
:112, :141, :407) on the port's XLA branch (``scatter_mode="xla"``, the
route the JAX package's own tests take off the TPU), every bound as the
JAX test writes it; and the reference schedule's drift between the two
packages on the noisy stream, on both routes.  The kernel route's gates
are in ``test_torch_fast_gates.py``.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from fast_gate_runs import (  # noqa: E402
    cs, hold, iteration_parts, jax_runs, port_runs, scene,
)

ROUTE = "xla"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fast_matches_reference_production_sensor():
    """test_fast_schedule.py:29 on the XLA branch (see
    test_torch_fast_gates.py)."""
    hold(cs.gates_29(port_runs(ROUTE), scene))


def test_fast_offbench_rotdiv_scene():
    """test_fast_schedule.py:93 on the XLA branch."""
    hold(cs.gates_93(port_runs(ROUTE), scene))


def test_fast_offbench_noisy_stream():
    """test_fast_schedule.py:112 on the XLA branch, both AEE gates as
    written (1.2 and 1.02)."""
    hold(cs.gates_112(port_runs(ROUTE), scene))


def test_fast_rotdiv_margin_canary():
    """test_fast_schedule.py:141 on the XLA branch."""
    hold(cs.gates_141(port_runs(ROUTE), scene))


def test_fast_throughput_domain_gates():
    """test_fast_schedule.py:407 on the XLA branch."""
    hold(cs.gates_407(port_runs(ROUTE), scene))


@pytest.mark.parametrize("route,jax_route", [("auto", "pallas"),
                                             ("xla", "xla")])
def test_reference_schedule_drift_on_the_noisy_stream(route, jax_route):
    """Under the reference schedule the noisy stream (dvs_sim seed 31, the
    stream of test_fast_schedule.py:112) parts the two packages' warm-start
    chains: the port's route against the JAX package's on the same route
    (the kernel twins against its Pallas path, or XLA against XLA).  The
    noise flags are identical and the first two slices take equal
    iterations; later slices may part in no more slices than the JAX
    package's own two routes part from each other on this stream."""
    port = port_runs(route)("noisy", 31, "reference")
    ref = jax_runs(jax_route)("noisy", 31, "reference")
    jax_parts = iteration_parts(jax_runs("pallas")("noisy", 31, "reference"),
                                jax_runs("xla")("noisy", 31, "reference"))
    assert (port["noise"] == ref["noise"]).all()
    parts = iteration_parts(port, ref)
    assert not {0, 1} & set(parts), (port["iters"], ref["iters"])
    assert len(parts) <= len(jax_parts), (parts, jax_parts)
