"""B3 over a whole staged range and B4 into the caller's rows, on the CPU.

``act_rows_call`` takes a leading slice axis, (S, capp) index slabs and
(S, 3, K) gate histories, so that the scan builds every slice's activity
rows in one launch before its loop; each slice must be bitwise the JAX
package's per-slice ``act_rows_call`` (Pallas in interpret mode).
``warp_uv_call(..., uvn_out)`` writes its [u, v, noise] rows into the
caller's tensor, and ``process_slice`` threads that tensor through every
branch, so ``run_slices`` writes each slice straight into its output: the
result must be bitwise the one-slice-at-a-time loop's, on the megastep,
merged, composed and XLA branches and on skipped slices.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.ops.pallas import fused_model as jfm  # noqa: E402
from better_flow_tpu_torch.models import global_flow as tgf  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from torch_inputs import CH, NCH, gate_stream, slice_inputs  # noqa: E402
from torch_inputs import small_cfg  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors; one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _range_inputs(K, S=5, seed=0):
    """S slices of NCH chunks: index slabs with padding, and per slice a
    (3, K) history [fired, start, end] of its own; slice 1's gate never
    fired (its ranges would cover most events)."""
    rng = np.random.default_rng(seed)
    n = NCH * CH
    sidx = np.stack([np.where(rng.uniform(size=n) < 0.9,
                              rng.permutation(n) + 1000 * s, -1)
                     for s in range(S)]).astype(np.int32)
    hist = np.zeros((S, 3, K), np.int32)
    for s in range(S):
        st_h = rng.integers(0, n, K) + 1000 * s
        hist[s] = [rng.uniform(size=K) < 0.7, st_h,
                   st_h + rng.integers(100, 2000, K)]
        hist[s, 0, 0] = 1
    hist[1, 0] = 0
    hist[1, 1], hist[1, 2] = 0, n + 10_000
    return sidx, hist


@pytest.mark.parametrize("K", [1, 3])
def test_batched_act_rows_is_the_stacked_pallas_calls(K):
    sidx, hist = _range_inputs(K)
    want = np.stack([np.asarray(jfm.act_rows_call(
        jnp.asarray(sidx[s]), jnp.asarray(hist[s, 0] > 0),
        jnp.asarray(hist[s, 1]), jnp.asarray(hist[s, 2])))
        for s in range(len(sidx))])
    got = tfm.act_rows_call(_t(sidx), _t(hist))
    assert got.shape == (len(sidx), NCH, 1, CH) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    for s in range(len(sidx)):      # and the one-slice form, slice by slice
        assert torch.equal(got[s], tfm.act_rows_call(_t(sidx[s]),
                                                     _t(hist[s])))
    # the never-fired slice keeps every event; the others gate some
    assert np.array_equal(want[1].reshape(-1), sidx[1] >= 0)
    assert all(0 < want[s].sum() < (sidx[s] >= 0).sum() for s in (0, 2))


def test_batched_act_rows_refuses_mismatched_inputs():
    sidx, hist = (_t(a) for a in _range_inputs(3))
    with pytest.raises(ValueError, match="hist: shape"):
        tfm.act_rows_call(sidx, hist[:-1])          # S differs
    with pytest.raises(ValueError, match="hist: shape"):
        tfm.act_rows_call(sidx, hist[0])            # no slice axis
    with pytest.raises(ValueError, match="hist: shape"):
        tfm.act_rows_call(sidx[0], hist)            # one slice, S histories
    with pytest.raises(TypeError, match="dtype"):
        tfm.act_rows_call(sidx.long(), hist)
    with pytest.raises(ValueError, match="contiguous"):
        tfm.act_rows_call(sidx, hist.transpose(1, 2).contiguous()
                          .transpose(1, 2))
    with pytest.raises(ValueError, match="sidx: shape"):
        tfm.act_rows_call(sidx[:, :100], hist)
    assert tfm.act_rows_call(sidx[:0], hist[:0]).shape == (0, NCH, 1, CH)


def test_warp_uv_writes_into_the_given_rows():
    d = {k: _t(slice_inputs(5)[k]) for k in ("stat", "pr", "act", "st")}
    args = (d["stat"], d["pr"], d["act"], d["st"], 1.0)
    out_w, uvn_w = tfm.warp_uv_call(*args)
    run = torch.zeros((3, NCH, 3, CH))
    out, uvn = tfm.warp_uv_call(*args, run[1])
    assert uvn.data_ptr() == run[1].data_ptr() and torch.equal(run[1], uvn_w)
    assert torch.equal(out, out_w)
    assert not run[0].any() and not run[2].any()
    rows = torch.zeros((NCH, 3, CH))
    assert tfm.warp_uv_call(*args, rows)[1] is rows
    strided = torch.zeros((NCH, CH, 3)).transpose(1, 2)
    with pytest.raises(ValueError, match="uvn_out: not contiguous"):
        tfm.warp_uv_call(*args, strided)
    with pytest.raises(ValueError, match="uvn_out: shape"):
        tfm.warp_uv_call(*args, run[1, :2])
    with pytest.raises(TypeError, match="uvn_out: dtype"):
        tfm.warp_uv_call(*args, rows.double())


def _one_slice_at_a_time(prepared, cfg, carry0):
    """The scan's loop as it ran before the batched B3 and ``uvn_out``: B3
    a slice, ``process_slice`` returning its own rows, copied into the
    run's output."""
    hist = torch.from_numpy(tscan.staged_histories(prepared, carry0)[0])
    stat, sidx, geo = prepared["stat"], prepared["sidx"], prepared["geo"]
    model, sd = carry0[:2]
    opt = cfg.optimizer
    uvn, iters, ran = [], [], []
    for s in range(len(sidx)):
        ev = stat_s = act = None
        if opt.scatter_mode == "xla":
            ev = tscan.slice_events(stat[s], sidx[s], hist[s])
        else:
            stat_s, act = stat[s], tfm.act_rows_call(sidx[s], hist[s])
        cur_tot = model.totals4().to(torch.float32)
        res, uvn_s = tgf.process_slice(
            stat_s, act, model, opt, cfg.sensor, prepared["bbox"][s],
            int(prepared["nval"][s]), warm_start=not cfg.stm_disable,
            seed=sd[:8], geo=geo[s], ev=ev)
        model, sd = res.model, torch.cat([res.seed, cur_tot])
        uvn.append(uvn_s)
        iters.append(res.iters)
        ran.append(res.ran)
    return torch.stack(uvn), np.array(iters), np.array(ran), model


@pytest.mark.parametrize("branch", ["megastep", "merged", "composed", "xla"])
def test_run_slices_writes_every_branch_into_its_output(monkeypatch, branch):
    """Bitwise the one-slice-at-a-time loop, with skipped and run slices;
    one B3 call for the range (none on the XLA branch), and on the
    megastep drive B4 writing each run slice's rows in place."""
    cfg = small_cfg(**{"megastep": {}, "merged": dict(megastep_merged=True),
                       "composed": dict(use_megastep=False),
                       "xla": dict(scatter_mode="xla")}[branch])
    d = gate_stream()
    prepared = tscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg,
                                       device="cpu")
    carry0 = tscan.initial_carry(prepared, cfg)
    uvn_w, iters_w, ran_w, model_w = _one_slice_at_a_time(prepared, cfg,
                                                          carry0)
    b3, b4 = [], []
    monkeypatch.setattr(tscan, "act_rows_call", lambda *a: b3.append(a)
                        or tfm.act_rows_call(*a))
    monkeypatch.setattr(tgf, "warp_uv_call", lambda *a, **k: b4.append(
        a[5].data_ptr()) or tfm.warp_uv_call(*a, **k))
    carry, uvn, iters, ran, _ = tscan.run_slices(prepared, cfg, carry0)
    assert ran.any() and not ran.all()          # skipped slices among them
    np.testing.assert_array_equal(iters, iters_w)
    np.testing.assert_array_equal(ran, ran_w)
    assert torch.equal(uvn, uvn_w)
    assert torch.equal(carry[0].totals4(), model_w.totals4())
    assert len(b3) == (0 if branch == "xla" else 1)
    if branch == "megastep":
        assert b4 == [uvn[s].data_ptr() for s in np.flatnonzero(ran)]
    else:
        assert b4 == []
