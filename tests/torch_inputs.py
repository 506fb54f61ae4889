"""Numpy-seeded inputs for the PyTorch port's kernel tests.

Shared by the CPU tests against the JAX package (``test_torch_kernels.py``)
and the card tests (``test_torch_cuda.py``); imports no JAX.  Shapes are
small: 3 chunks, a 24x32 sensor at scale 3 (images 128x256).
"""

import numpy as np

from better_flow_tpu.config import (
    OptimizerConfig, PipelineConfig, SensorConfig, SliceConfig,
)
from better_flow_tpu_torch.models import global_flow as tgf
from better_flow_tpu_torch.ops import layout

CH = layout.CHUNK
RES_X, RES_Y, SCALE = 24, 32, 3
SENSOR = SensorConfig(RES_X, RES_Y)
H, W = RES_X * SCALE + SCALE, RES_Y * SCALE + SCALE
NCH = 3


def slice_inputs(seed=0):
    """A 3-chunk slice: integer pixels, f32 ns times, padding slots (slot 0
    of chunk 1 among them, so that chunk's time base is a padding slot's
    t = 0), a few inactive events, positions one warp away from the pixels,
    the full-sensor geometry and a mid-optimization state."""
    rng = np.random.default_rng(seed)
    n = NCH * CH
    x = rng.integers(0, RES_X, n).astype(np.float32)
    y = rng.integers(0, RES_Y, n).astype(np.float32)
    t = rng.uniform(0, 0.1e9, n).astype(np.float32)
    valid = np.ones(n, bool)
    valid[CH:CH + 100] = False
    valid[-500:] = False
    x[~valid] = y[~valid] = t[~valid] = 0
    stat = np.stack([x, y, t]).reshape(3, NCH, CH).transpose(1, 0, 2).copy()
    act = (valid & (rng.uniform(size=n) > 0.05)).astype(np.float32)
    act = act.reshape(NCH, 1, CH)
    pr = (stat[:, 0:2] + rng.normal(0, 0.3, (NCH, 2, CH))).astype(np.float32)
    g = tgf.geometry_from_bbox(0, RES_X - 1, 0, RES_Y - 1, SCALE, SENSOR)
    geo = tgf.geo_row(g)
    st = np.zeros((1, 32), np.float32)
    st[0, 0:4] = [0.02, -0.015, 3e-3, 2e-3]           # totals dx dy rot div
    st[0, 8:10] = [12.3, 15.7]                        # centroid
    st[0, 10:14] = [1.0, 2.0, 1e4, 2e4]               # dividers
    st[0, 14:18] = [-2e3, -1e3, -40.0, -35.0]         # slope memory
    st[0, 18:22] = [1e-4, 2e-4, 1e-3, -1e-3]          # last deltas
    st[0, layout.ST_ITERS] = 2.0
    st[0, layout.ST_CONT] = 1.0
    st[0, 24:28] = [0.3, -0.2, 0.5, 0.4]              # last gradient
    return dict(stat=stat, act=act, pr=pr, geo=geo, st=st, valid=valid)


def statics(schedule="fast", exit_grad=4.0, exit_pred=0.0):
    """``megastep_finish_call``'s static arguments for a schedule and its
    exit options."""
    return tgf.finish_statics(OptimizerConfig.fast(
        schedule=schedule, exit_grad_factor=exit_grad,
        exit_predict_cap=exit_pred))


def small_cfg(**opt):
    """The 24x32 scan configuration of tests/test_fast_schedule.py."""
    return PipelineConfig(
        sensor=SENSOR,
        slice=SliceConfig(max_events=4000, span_ns=int(0.1e9),
                          refresh_events=1500, refresh_time_ns=int(0.04e9)),
        optimizer=OptimizerConfig.fast(scale=3, min_events=500, **opt))
