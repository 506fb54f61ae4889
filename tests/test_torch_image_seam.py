"""The image seam of the port's event-parallel drives.

Under an event group the composed drive (``models.global_flow.
run_fused_composed``) runs one B7a launch over all of a process's shards
into an image pair it owns for the slice, sums that pair across the ranks in
place (``ops.fused_model.sum_images``), and runs B7b, which reads the pair
and leaves it zero for the next iteration; the megastep drive
(``run_fused_mega``) does the same with B1 and B2.  Here a stand-in
communicator of two ranks lives in one process: its rank 0 holds every
event and the other rank's share of each sum is zero, so each drive must
give the unsharded drive's bits (B6's twin; B5's) over every iteration, and
the finish must get the very tensors that the splat filled.  A seam that
reduces a copy (as the copying ``all_reduce_sum`` does) leaves the drive's
pair holding one iteration's counts in the next: the test of that seam
fails both checks.  The plain twins hold the pair's contract as the kernels
do (JAX-free: the JAX package's kernels are held against them in
``test_torch_sharded_kernels.py`` and ``test_torch_kernels.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from better_flow_tpu_torch.config import OptimizerConfig  # noqa: E402
from better_flow_tpu_torch.core.model import MotionModel  # noqa: E402
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.models import global_flow as tgf  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.ops import layout  # noqa: E402
from better_flow_tpu_torch.ops.layout import (  # noqa: E402
    pack_act, prepare_chunk_layouts,
)
from better_flow_tpu_torch.parallel.mesh import EventGroup  # noqa: E402
from torch_inputs import SENSOR  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins work on small tensors; one intra-op thread keeps parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class HalfComm:
    """Two ranks in one process: this one (rank 0) and another whose
    images are zero.  ``all_reduce_sum_`` adds the other rank's zeros in
    place; ``all_reduce_sum`` returns sums in new tensors."""

    size, rank = 2, 0

    def all_reduce_sum_(self, tensors):
        for t in tensors:
            t += torch.zeros_like(t)
        return list(tensors)

    def all_reduce_sum(self, tensors):
        return [t + torch.zeros_like(t) for t in tensors]


def _slice(seed=5):
    """A 24x32 slice of 4 chunks (2 local shards of 2 chunks)."""
    d = synthetic_events(5000, duration_s=0.1, res_x=24, res_y=32,
                         n_points=60, seed=seed, vx=9.0, vy=-6.0, rot=0.05,
                         div=0.02)
    x, y = (torch.from_numpy(d[k].astype(np.float32)) for k in ("x", "y"))
    t = torch.from_numpy((d["t_ns"] - d["t_ns"][0]).astype(np.float32))
    cap = 4 * layout.CHUNK
    pad = lambda a: torch.nn.functional.pad(a, (0, cap - len(a)))
    valid = pad(torch.ones(len(x), dtype=torch.bool))
    bbox = (int(x.min()), int(x.max()), int(y.min()), int(y.max()))
    return (prepare_chunk_layouts(pad(x), pad(y), pad(t)), pack_act(valid),
            bbox, len(x))


CFGS = {"reference": OptimizerConfig(scale=3, min_events=500,
                                     use_megastep=False),
        "fast": OptimizerConfig.fast(scale=3, min_events=500,
                                     use_megastep=False)}
MEGA_CFGS = {"reference": OptimizerConfig(scale=3, min_events=500),
             "fast": OptimizerConfig.fast(scale=3, min_events=500)}
# The splat and the finish of each drive under a group.
COMPOSED = ("fused_warp_splat_images_call", "finish_partials_call")
MEGASTEP = ("warp_images_st_call", "megastep_finish_call")


def _run(monkeypatch, cfg, seam=None, shards=2, kernels=COMPOSED):
    """The slice through ``process_slice`` under a two-rank group of
    ``shards`` local shards, with the image pairs of the drive's splat
    (B7a or B1: "b7a") and finish (B7b or B2: "b7b") recorded per call."""
    stat, act, bbox, n = _slice()
    calls = {"b7a": [], "b7b": []}
    splat, finish = (getattr(tgf, k) for k in kernels)

    def rec_splat(*a, **k):
        out = splat(*a, **k)
        calls["b7a"].append((out[1].data_ptr(), out[2].data_ptr()))
        return out

    def rec_finish(acc_t, acc_c, *a, **k):
        calls["b7b"].append((acc_t.data_ptr(), acc_c.data_ptr()))
        out = finish(acc_t, acc_c, *a, **k)
        assert not acc_t.any() and not acc_c.any()   # left zero
        return out

    monkeypatch.setattr(tgf, kernels[0], rec_splat)
    monkeypatch.setattr(tgf, kernels[1], rec_finish)
    if seam is not None:
        monkeypatch.setattr(tgf, "sum_images", seam)
    group = EventGroup(comm=HalfComm(), n_local=shards, device=stat.device)
    res, uvn = tgf.process_slice(stat, act, MotionModel.zero(), cfg, SENSOR,
                                 bbox, n, group=group)
    monkeypatch.undo()
    return res, uvn, calls


def _unsharded(cfg):
    stat, act, bbox, n = _slice()
    return tgf.process_slice(stat, act, MotionModel.zero(), cfg, SENSOR, bbox,
                             n)


@pytest.mark.parametrize("schedule", ["reference", "fast"])
def test_group_drive_is_the_unsharded_drive_through_one_pair(monkeypatch,
                                                             schedule):
    """Over every iteration: one B7a call into the drive's pair, B7b on that
    very pair, the pair zero after each B7b, and the unsharded bits."""
    cfg = CFGS[schedule]
    want, uvn_w = _unsharded(cfg)
    got, uvn, calls = _run(monkeypatch, cfg)
    assert got.iters == want.iters >= 2
    assert len(calls["b7a"]) == len(calls["b7b"]) == got.iters
    assert calls["b7b"] == calls["b7a"]
    assert len(set(calls["b7a"])) == 1       # one pair for the slice
    for f in ("pr_x", "pr_y", "nx", "ny", "u", "v", "seed"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(uvn, uvn_w)
    for f in ("total_dx", "total_dy", "total_rot", "total_div"):
        assert torch.equal(getattr(got.model, f), getattr(want.model, f)), f


def test_one_range_or_one_tensor_per_shard_give_the_same_bits(monkeypatch):
    """The local shards' chunks as one range, or built one tensor per shard
    and joined by the caller (as ``process_slice_event_parallel`` does):
    the same calls and bits, whatever the number of local shards.  The
    megastep drive refuses a range that does not divide into the local
    shards."""
    stat, act, bbox, n = _slice()
    cfg = CFGS["reference"]
    group = EventGroup(comm=HalfComm(), n_local=1, device=stat.device)
    one, _ = tgf.process_slice(stat, act, MotionModel.zero(), cfg, SENSOR,
                               bbox, n, group=group)
    join = lambda a: torch.cat([a[:2].clone(), a[2:].clone()])
    joined, _ = tgf.process_slice(join(stat), join(act), MotionModel.zero(),
                                  cfg, SENSOR, bbox, n,
                                  group=group._replace(n_local=2))
    split, _, calls = _run(monkeypatch, cfg)
    assert one.iters == joined.iters == split.iters
    assert len(calls["b7a"]) == split.iters
    for f in ("pr_x", "u", "v", "seed"):
        assert torch.equal(getattr(one, f), getattr(split, f)), f
        assert torch.equal(getattr(joined, f), getattr(split, f)), f
    with pytest.raises(ValueError, match="local shards"):
        tgf.process_slice(stat, act, MotionModel.zero(),
                          OptimizerConfig(scale=3, min_events=500), SENSOR,
                          bbox, n,
                          group=group._replace(n_local=3))


def test_a_seam_that_reduces_a_copy_is_caught(monkeypatch):
    """A seam that sums a copy across ranks hands B7b another pair than the
    one B7a filled; B7b clears the copy, the drive's pair keeps the first
    iteration's images, and the next iterations differ from the unsharded
    drive."""
    cfg = CFGS["reference"]
    want, _ = _unsharded(cfg)
    got, _, calls = _run(monkeypatch, cfg, seam=_copying_seam)
    assert calls["b7b"][0] != calls["b7a"][0]
    assert got.iters != want.iters or not torch.equal(got.u, want.u)


def _copying_seam(acc_t, acc_c, comm=None):
    return tuple(comm.all_reduce_sum([acc_t, acc_c]))


@pytest.mark.parametrize("schedule", ["reference", "fast"])
def test_megastep_group_drive_is_unsharded_with_one_b1_an_iteration(
        monkeypatch, schedule):
    """The megastep drive under the two-rank group, two local shards: over
    every iteration one B1 call for both shards into the drive's pair, B2 on
    that very pair, the pair zero after each B2, and the bits of the
    unsharded drive (B5's twin under the reference schedule, the B1 + B2
    twins under ``fast()``)."""
    cfg = MEGA_CFGS[schedule]
    want, uvn_w = _unsharded(cfg)
    got, uvn, calls = _run(monkeypatch, cfg, kernels=MEGASTEP)
    assert got.iters == want.iters >= 2
    assert len(calls["b7a"]) == len(calls["b7b"]) == got.iters
    assert calls["b7b"] == calls["b7a"]
    assert len(set(calls["b7a"])) == 1       # one pair for the slice
    for f in ("pr_x", "pr_y", "nx", "ny", "u", "v", "seed"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(uvn, uvn_w)


def test_megastep_seam_that_reduces_a_copy_is_caught(monkeypatch):
    """The megastep drive with a seam that sums a copy: B2 clears the copy,
    the drive's pair keeps the first iteration's splat, the next B1 adds to
    it, and the result leaves the unsharded drive's."""
    cfg = MEGA_CFGS["reference"]
    want, _ = _unsharded(cfg)
    got, _, calls = _run(monkeypatch, cfg, seam=_copying_seam,
                         kernels=MEGASTEP)
    assert calls["b7b"][0] != calls["b7a"][0]
    assert got.iters != want.iters or not torch.equal(got.u, want.u)


@pytest.mark.parametrize("schedule", ["reference", "fast"])
def test_megastep_group_drive_warps_every_shard_in_one_b4_call(monkeypatch,
                                                               schedule):
    """The megastep drive under the two-rank group, two local shards: one
    B4 call over both shards' chunks, into the caller's rows, and its
    ``out`` and ``uvn`` bitwise the concatenation of one call a shard (the
    warp is slot-wise, under the one state that the image sum gives every
    shard)."""
    stat, act, bbox, n = _slice()
    calls = []

    def rec(*a, **k):
        calls.append((a, tfm.warp_uv_call(*a, **k)))
        return calls[-1][1]

    monkeypatch.setattr(tgf, "warp_uv_call", rec)
    rows = torch.zeros((stat.shape[0], 3, layout.CHUNK))
    group = EventGroup(comm=HalfComm(), n_local=2, device=stat.device)
    res, uvn = tgf.process_slice(stat, act, MotionModel.zero(),
                                 MEGA_CFGS[schedule], SENSOR, bbox, n,
                                 group=group, uvn_out=rows)
    monkeypatch.undo()
    assert res.iters >= 2 and len(calls) == 1
    (stat_b4, pr, act_b4, st, ws, rows_b4), (out, uvn_b4) = calls[0]
    assert stat_b4 is stat and act_b4 is act and rows_b4 is rows
    assert uvn is rows and uvn_b4 is rows
    shards = [tfm.warp_uv_call(*parts, st, ws) for parts in zip(
        stat.chunk(2), pr.chunk(2), act.chunk(2))]
    assert torch.equal(out, torch.cat([o for o, _ in shards]))
    assert torch.equal(uvn, torch.cat([u for _, u in shards]))
    assert torch.equal(res.pr_x, out[:, 0].reshape(-1))
