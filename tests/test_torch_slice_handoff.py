"""The scan's slice loop with the carry on the device, on the CPU.

On the megastep drives ``run_slices`` keeps the optimizer's carry as the
(1, 32) start state on the device: B4 (``warp_uv_call``'s ``handoff``)
writes the next slice's start state and seed row while it warps, and
nothing between two slices unpacks or rebuilds the model.  The results
must be bitwise those of the per-slice loop that rebuilt them
(``torch_inputs.per_slice_run_slices``: ``initial_state`` and
``model_from_state`` around ``process_slice``, the seed ``cat``), on
skipped slices and across the carry that one staged range hands the
next, as the cold path's batches do; and the hand-off's twin must be
``initial_state`` and the seed ``cat`` by bits.
"""

import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from better_flow_tpu_torch import profiling  # noqa: E402
from better_flow_tpu_torch.config import OptimizerConfig  # noqa: E402
from better_flow_tpu_torch.models import global_flow as tgf  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.ops import layout  # noqa: E402
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from torch_inputs import (  # noqa: E402
    carry_bits, gate_stream, per_slice_run_slices, slice_inputs, small_cfg,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors; one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(case):
    """fast(): B1 + B2; unrolled: predicated pairs; the reference schedule
    on B5; fast() with a count gate that skips the first slices."""
    cfg = small_cfg()
    opt = {"fast": cfg.optimizer,
           "unrolled": dataclasses.replace(cfg.optimizer, megastep_unroll=2),
           "reference": OptimizerConfig(scale=3, min_events=500),
           "count_gate": dataclasses.replace(cfg.optimizer,
                                             min_events=1000)}[case]
    return dataclasses.replace(cfg, optimizer=opt)


def _ranges(d, cfg, split):
    """The recording staged whole, or as two slice ranges."""
    S = len(tscan.plan_slices(d["t_ns"], cfg).ends)
    bounds = [(0, S)] if split == "whole" else [(0, S // 2), (S // 2, S)]
    return [tscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg,
                                    device="cpu", slice_range=r)
            for r in bounds]


def _chain(run, preps, cfg):
    """``run`` over the ranges, each from the previous range's carry."""
    carry = tscan.initial_carry(preps[0], cfg)
    outs = []
    for prep in preps:
        carry, uvn, iters, ran, syncs = run(prep, cfg, carry)
        outs.append((uvn, iters, ran, syncs))
    return carry, outs


@pytest.mark.parametrize("split", ["whole", "ranges"])
@pytest.mark.parametrize("case", ["fast", "unrolled", "reference",
                                  "count_gate"])
def test_device_carry_is_the_per_slice_loop_bitwise(monkeypatch, case,
                                                    split):
    cfg = _cfg(case)
    preps = _ranges(gate_stream(), cfg, split)
    # Each run slice's start state, as the drive receives it.
    real, starts = tgf.run_fused_mega, []
    sig = inspect.signature(real)

    def drive(*a, **k):
        b = sig.bind(*a, **k).arguments
        h = b.get("handoff")
        starts.append((tgf.initial_state(b["model0"], b["cfg"], b["seed"])
                       if h is None else h.st0).clone())
        return real(*a, **k)

    monkeypatch.setattr(tgf, "run_fused_mega", drive)
    want_carry, want = _chain(per_slice_run_slices, preps, cfg)
    want_starts, starts[:] = starts[:], []
    with profiling.program_spans() as rec:
        got_carry, got = _chain(tscan.run_slices, preps, cfg)
    assert len(starts) == len(want_starts)
    for st, st_w in zip(starts, want_starts):
        assert torch.equal(_bits(st), _bits(st_w))
    ran_all = np.concatenate([o[2] for o in got])
    assert ran_all.any() and not ran_all.all()      # skipped slices too
    if case == "count_gate":
        assert not ran_all[0]
    for (uvn, iters, ran, syncs), (uvn_w, iters_w, ran_w, syncs_w) in zip(
            got, want):
        assert torch.equal(uvn.view(torch.int32), uvn_w.view(torch.int32))
        np.testing.assert_array_equal(iters, iters_w)
        np.testing.assert_array_equal(ran, ran_w)
        assert syncs == syncs_w
    assert carry_bits(got_carry) == carry_bits(want_carry)
    for k in (2, 3, 4):
        np.testing.assert_array_equal(got_carry[k], want_carry[k])
    # Every slice that ran took the device hand-off.
    assert rec.counters["handoff"] == int(ran_all.sum())
    assert rec.counters["iters"] == int(sum(o[1].sum() for o in got))


def test_a_range_of_skipped_slices_returns_its_carry():
    """No slice runs: the carry comes back as it went in."""
    cfg = _cfg("count_gate")
    prep = _ranges(gate_stream(), cfg, "whole")[0]
    prep = dict(prep, nval=np.zeros_like(prep["nval"]))
    carry0 = tscan.initial_carry(prep, cfg)
    carry, _, iters, ran, syncs = tscan.run_slices(prep, cfg, carry0)
    assert not ran.any() and not iters.any() and syncs == 0
    assert carry[0] is carry0[0]
    want = per_slice_run_slices(prep, cfg, carry0)[0]
    assert carry_bits(carry) == carry_bits(want)


def _state(rng):
    """A (1, 32) f32 state of random values, with a negative zero and a
    NaN among the copied slots."""
    st = rng.normal(0, 3, (1, layout.ST_SIZE)).astype(np.float32)
    st[0, layout.ST_CDY] = -0.0
    st[0, layout.ST_SL + 1] = np.nan
    return torch.from_numpy(st)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("schedule", ["fast", "reference"])
def test_warp_uv_handoff_is_initial_state_and_the_seed_row(schedule):
    rng = np.random.default_rng(11)
    d = slice_inputs(4)
    stat, pr, act = (torch.from_numpy(d[k]) for k in ("stat", "pr", "act"))
    st, st_in = _state(rng), _state(rng)
    opt = OptimizerConfig.fast(schedule=schedule, init_xy_divider=3.3,
                               init_rotdiv_divider=0.7)
    st_next = torch.full((1, layout.ST_SIZE), 5.0)
    seed_next = torch.full((12,), 5.0)
    h = tfm.Handoff(st_next, seed_next, st_in, opt.init_xy_divider,
                    opt.init_rotdiv_divider, schedule == "fast")
    st0, st_in0 = st.clone(), st_in.clone()
    out, uvn = tfm.warp_uv_call(stat, pr, act, st, 0.0, None, handoff=h)
    seed_out = torch.cat([st[0, layout.ST_SL:layout.ST_SL + 4],
                          st[0, layout.ST_PD:layout.ST_PD + 4]])
    want_st = tgf.initial_state(tgf.model_from_state(st), opt, seed_out)
    cur_tot = tgf.model_from_state(st_in).totals4().to(torch.float32)
    assert torch.equal(_bits(st_next), _bits(want_st))
    assert torch.equal(_bits(seed_next),
                       _bits(torch.cat([seed_out, cur_tot])))
    # The inputs are left alone, and the warp is the one without the
    # hand-off: today's projection of every slot.
    assert torch.equal(_bits(st), _bits(st0))
    assert torch.equal(_bits(st_in), _bits(st_in0))
    plain = tfm.warp_uv_plain(stat, pr, act, st, 0.0)
    assert torch.equal(out, plain[0]) and torch.equal(uvn, plain[1])
    prx, pry, nx, ny = tfm.project_4param_reinit(
        stat[:, 0], stat[:, 1], stat[:, 2], pr[:, 0], pr[:, 1],
        *tfm._warp_args(st))
    assert torch.equal(plain[0], torch.stack([prx, pry, nx, ny], dim=1))
    assert torch.equal(plain[1], torch.stack(
        [nx * tfm.UV_K, ny * tfm.UV_K, torch.clamp(1.0 - act[:, 0], min=0.0)],
        dim=1))


@pytest.mark.parametrize("bad", ["st_next", "seed_next", "st_in"])
def test_warp_uv_refuses_a_handoff_of_another_shape(bad):
    d = slice_inputs(4)
    stat, pr, act, st = (torch.from_numpy(d[k])
                         for k in ("stat", "pr", "act", "st"))
    parts = dict(st_next=torch.zeros(1, layout.ST_SIZE),
                 seed_next=torch.zeros(12), st_in=st.clone())
    parts[bad] = torch.zeros(13)
    with pytest.raises(ValueError, match=bad):
        tfm.warp_uv_call(stat, pr, act, st, handoff=tfm.Handoff(
            **parts, xy_div=1.0, rotdiv_div=1.0, slope=True))
