"""Runs of the harness on the CPU (past its look for a card) with the timed
path broken underneath: ``correct`` has to come out false for each fault
a cell can have, and true for the program as it is.

The faults, planted in the program's own functions: a slice step that
returns its state unchanged (every slice's optimizer skipped, the model
handed on as it came); half of the batch left out (every second event's
answer never written); an answer altered where it is produced (every
fifth slice's u negated as the slice writes it).  The cells run on one
card, so there is no exchange between cards to leave out.
"""

import dataclasses
import time

import pytest

from conftest import TINY_SEED, tiny_cell
from portbench import harness

# The offline cell at a tiny size: the one-program scan, the scan after the
# numpy staging route (sub-pixel coordinates), and the cold path, which the
# call takes under a budget that the tiny recording passes.
OFFLINE = ["scan", "scan-subpixel", "cold"]


def _run(cell, seconds):
    return harness.execute(cell, TINY_SEED, seconds, False, "cpu",
                           time.perf_counter())


def _skip_optimizer(module, monkeypatch):
    orig = module.process_slice

    def step(stat, act, last_model, cfg, *a, **k):
        return orig(stat, act, last_model,
                    dataclasses.replace(cfg, min_events=10 ** 9), *a, **k)

    monkeypatch.setattr(module, "process_slice", step)


def _alter_slices(module, monkeypatch):
    orig = module.process_slice
    calls = []

    def step(*a, **k):
        res, uvn = orig(*a, **k)
        calls.append(1)
        if len(calls) % 5 == 3:
            uvn[:, 0, :] *= -1.0
            res = res._replace(u=-res.u)
        return res, uvn

    monkeypatch.setattr(module, "process_slice", step)


def _offline_cell(kind, monkeypatch):
    if kind == "cold":
        monkeypatch.setenv("BF_SCAN_DEVICE_BUDGET_GB", "0.001")
    return tiny_cell("offline-fast-long", kind.endswith("subpixel"))


@pytest.mark.parametrize("kind", OFFLINE)
def test_offline_sound_run_is_correct(kind, monkeypatch):
    res = _run(_offline_cell(kind, monkeypatch), 0.5)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("kind", OFFLINE)
def test_offline_fault_is_caught(kind, fault, monkeypatch):
    from better_flow_tpu_torch.runtime import scan_pipeline as sp

    cell = _offline_cell(kind, monkeypatch)
    if fault == "unchanged":
        _skip_optimizer(sp, monkeypatch)
    elif fault == "altered":
        _alter_slices(sp, monkeypatch)
    else:
        orig = sp.compensate_recording_scan

        def half(*a, **k):
            out = orig(*a, **k)
            for key in ("u", "v"):
                out[key][1::2] = 0.0
            out["noise"][1::2] = False
            return out

        monkeypatch.setattr(sp, "compensate_recording_scan", half)
    res = _run(cell, 0.5)
    assert res["correct"] is False, res["checks"]


def test_live_sound_run_is_correct():
    res = _run(tiny_cell("live-ros-steady"), 0.5)
    assert res["attempted"] > 0
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_live_fault_is_caught(fault, monkeypatch):
    from better_flow_tpu_torch.runtime import dvs_flow

    if fault == "unchanged":
        _skip_optimizer(dvs_flow, monkeypatch)
    elif fault == "altered":
        _alter_slices(dvs_flow, monkeypatch)
    else:
        orig = dvs_flow.DVSFlow._process

        def half(self, inp, n, bbox):
            res, packed, ready = orig(self, inp, n, bbox)
            packed[0:2, 1::2] = 0.0
            return res, packed, ready

        monkeypatch.setattr(dvs_flow.DVSFlow, "_process", half)
    res = _run(tiny_cell("live-ros-steady"), 0.5)
    assert res["correct"] is False, res["checks"]
