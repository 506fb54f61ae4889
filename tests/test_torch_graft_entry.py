"""The port's entry hooks (``better_flow_tpu_torch.graft_entry``) on the
CPU: ``entry`` is one slice of ``__graft_entry__.entry``'s example, and
``dryrun`` runs the four stages of ``__graft_entry__.dryrun_multichip``
(the temporal batch under "auto" and "xla", the event-parallel scan on the
kernel branch, the tiled recording under "xla" and "pallas", two chained
ranges) to their end over shards resident on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import __graft_entry__ as jentry  # noqa: E402
from better_flow_tpu_torch import graft_entry  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_runs_one_slice_of_the_jax_hooks_example():
    pytest.importorskip("jax")
    fn, (ev, model) = graft_entry.entry(device="cpu")
    want = jentry._example_slice()
    for f in ev._fields:
        np.testing.assert_array_equal(getattr(ev, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    res = fn(ev, model)
    assert res.ran and 0 < res.iters <= 9
    assert res.u.shape == (2048,) and np.isfinite(res.u.numpy()).all()
    assert res.model.total_dx.device == torch.device("cpu")


def test_the_hooks_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        graft_entry.dryrun(2)
    with pytest.raises(ValueError, match="n_shards"):
        graft_entry.dryrun(0, device="cpu")


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_dryrun_runs_all_four_stages(capsys, n_shards):
    graft_entry.dryrun(n_shards, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    stages = ["[1/4 temporal, auto]", "[1/4 temporal, xla]",
              "[2/4 event-parallel scan, kernel branch]",
              "[3/4 tiled recording, xla]", "[3/4 tiled recording, pallas]",
              "[4/4 chained ranges]"]
    assert len(lines) == len(stages)
    for line, stage in zip(lines, stages):
        assert line.startswith(f"dryrun {stage} OK"), line
    assert f"over {n_shards} shards" in lines[2]
    assert "bitwise the whole scan" in lines[5]


def test_main_runs_entry_and_dryrun(capsys):
    assert graft_entry.main(["2", "--cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("entry OK, iters = ") and len(out) == 7
