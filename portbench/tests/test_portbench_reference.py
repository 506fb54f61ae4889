"""The plain reference against the port on the CPU at a tiny size (this
test may import the port; the reference may not), and the control: the
same reference in bfloat16 fails the limits that the port's outputs meet.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import TINY_SEED, tiny_cell
from portbench import compare, control, traffic
from portbench.reference import flow as ref


def _port_config(cell):
    from better_flow_tpu_torch.config import (
        OptimizerConfig, PipelineConfig, SensorConfig, SliceConfig,
    )

    c = cell.config
    return PipelineConfig(sensor=SensorConfig(**c["sensor"]),
                          slice=SliceConfig(**c["slice"]),
                          optimizer=OptimizerConfig(**c["optimizer"]))


def test_settings_state_what_the_port_runs():
    """The configuration file holds every field of the port's options, and
    the reference reads the ones that change its results."""
    from better_flow_tpu_torch.config import OptimizerConfig

    for name in ("offline-fast-long", "live-ros-steady"):
        c = tiny_cell(name).config
        fields = {f.name for f in dataclasses.fields(OptimizerConfig)}
        assert set(c["optimizer"]) == fields
        st = ref.Settings.from_config(c)
        assert st.scale == c["optimizer"]["scale"]


def test_trigger_plan_matches_the_port():
    from better_flow_tpu_torch.runtime.scan_pipeline import plan_slices

    cell = tiny_cell("offline-fast-long")
    rec = traffic.recordings(cell.mix, TINY_SEED)[0]
    st = ref.Settings.from_config(cell.config)
    mine = ref.plan_slices(rec["t_ns"], st, flush=True)
    port = plan_slices(rec["t_ns"], _port_config(cell))
    for a, b in zip((mine.starts, mine.ends, mine.slice_start_ns), port):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route", ["scan", "scan-subpixel", "cold"])
def test_reference_meets_the_port_and_the_control_does_not(route,
                                                           monkeypatch):
    from better_flow_tpu_torch.runtime.scan_pipeline import (
        compensate_recording_scan,
    )

    if route == "cold":
        monkeypatch.setenv("BF_SCAN_DEVICE_BUDGET_GB", "0.001")
    name = "offline-fast-long"
    cell = tiny_cell(name, route.endswith("subpixel"))
    rec = traffic.recordings(cell.mix, TINY_SEED)[0]
    out = compensate_recording_scan(rec["x"], rec["y"], rec["t_ns"],
                                    _port_config(cell), device="cpu")
    st = ref.Settings.from_config(cell.config)
    prep = ref.prepare(rec["x"], rec["y"], rec["t_ns"], st, flush=True)
    r = ref.compensate(prep, st, "cpu")
    lim = compare.limits(name)
    sp = compare.mean_speed(r.u, r.v)
    slices = compare.claimed(prep.plan.starts, prep.plan.ends)
    nums = compare.flow_numbers(out["u"], out["v"], out["noise"], r.u, r.v,
                                r.noise, slices, sp, out["iters"], r.iters)
    assert all(row["ok"] for row in compare.judge(nums, lim)), nums
    assert nums["noise_mismatch"] == 0
    c = ref.compensate(prep, st, "cpu", dtype=torch.bfloat16)
    ctl = compare.flow_numbers(c.u, c.v, c.noise, r.u, r.v, r.noise, slices,
                               sp, c.iters, r.iters)
    assert not all(row["ok"] for row in compare.judge(ctl, lim)), ctl


def test_live_control_fails_the_limits():
    cell = tiny_cell("live-ros-steady")
    rows = control.live(cell, TINY_SEED, "cpu", 0.3)
    assert any(not r["ok"] for r in
               compare.judge({r["name"]: r["value"] for r in rows},
                             compare.limits("live-ros-steady"))), rows


@pytest.mark.parametrize("route", ["scan", "cold"])
def test_offline_control_fails_the_limits(route, monkeypatch):
    """The control's readings fail the cell's limits, and the program's,
    read by the same script from the cell's own call, meet them."""
    if route == "cold":
        monkeypatch.setenv("BF_SCAN_DEVICE_BUDGET_GB", "0.001")
    name = "offline-fast-long"
    sides = control.offline(tiny_cell(name), TINY_SEED, "cpu",
                            ("program", "control"))
    lim = compare.limits(name)
    assert all(r["ok"] for r in compare.judge(sides["program"], lim))
    assert not all(r["ok"] for r in compare.judge(sides["control"], lim))
