"""The split drive's launch plan (``ops.fused_model.TripPlan``,
``csrc/trip.cu``): a trip of the single-device split drive on the card is
one native call, and its exit read one wait on an event and a read of a
pinned slot.

On the CPU: the ctypes mirrors against the C sources, the route (the CPU's
twins, an event group, the unsplit and merged drives never build a plan),
and the planned drive end to end through a stand-in for the kernel library
that runs the plain twins from the plan's own arguments, bitwise the
wrapper drive, one plan a drive call or slice range, one trip call and one
wait a trip, ``planned_trips`` counting the trips.  On the card (marker
``cuda``, skips without one): the planned drive bitwise the wrapper drive
at the DAVIS240 and 1280x720 shapes, ``megastep_unroll`` 1, 2 and 4, one
drive call and the scan's carried slice loop.  Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_trip_plan.py
"""

import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from better_flow_tpu_torch import profiling  # noqa: E402
from better_flow_tpu_torch.config import (  # noqa: E402
    OptimizerConfig, PipelineConfig,
)
from better_flow_tpu_torch.core.model import FIELDS  # noqa: E402
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.models import global_flow as tgf  # noqa: E402
from better_flow_tpu_torch.ops import _build  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.ops import layout  # noqa: E402
from better_flow_tpu_torch.parallel.event_parallel import (  # noqa: E402
    compensate_recording_scan_sharded,
)
from better_flow_tpu_torch.parallel.mesh import make_event_mesh  # noqa: E402
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from torch_inputs import (  # noqa: E402
    bench_stream, carry_bits, gen4_cfg, gen4_model, gen4_start, gen4_stream,
    image_shape, per_slice_run_slices, slice_inputs, small_cfg,
)

CSRC = Path(tgf.__file__).parents[1] / "csrc"
CPU = torch.device("cpu")
OUT_KEYS = ("u", "v", "noise", "iters")


# ------------------------------------------------------ the C sources


_CTYPES = {"const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
           "long long*": ctypes.c_void_p, "int*": ctypes.c_void_p,
           "double*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float,
           "bf::UpdateParams": _build.UpdateParams}


def _c_struct(src: str, name: str):
    """The fields of ``struct name { ... };`` in ``src``: (name, ctypes
    type) in order, ``x[n]`` as an array, one field a declarator."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if not decl:
            continue
        m = re.fullmatch(r"((?:const )?[\w:]+(?: \w+)?\*?) (.+);", decl)
        ctype = _CTYPES[m.group(1)]
        for d in m.group(2).split(","):
            n = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", d.strip())
            fields.append((n.group(1), ctype * int(n.group(2))
                           if n.group(2) else ctype))
    return fields


@pytest.mark.parametrize("struct,header", [("TripArgs", "trip.cu"),
                                           ("UpdateParams", "finish.cuh")])
def test_ctypes_mirrors_the_c_struct(struct, header):
    """``_build``'s ctypes mirrors of the structs that the planned trip
    passes to the library (``TripArgs`` holds ``UpdateParams`` by value):
    the same fields in the same order, of the same types and sizes, so the
    same offsets and the same size."""
    fields = _c_struct((CSRC / header).read_text(), struct)
    mirror = getattr(_build, struct)
    assert [n for n, _ in fields] == [n for n, _ in mirror._fields_]
    for (n, want), (_, got) in zip(fields, mirror._fields_):
        assert ctypes.sizeof(want) == ctypes.sizeof(got), n
        assert getattr(want, "_type_", want) == getattr(got, "_type_", got), n
    parsed = type("Parsed", (ctypes.Structure,), {"_fields_": fields})
    assert ctypes.sizeof(parsed) == ctypes.sizeof(mirror)
    for n, _ in fields:
        assert getattr(parsed, n).offset == getattr(mirror, n).offset, n


def _signature(src: str, fn: str) -> list:
    """The parameter types of ``extern "C" int fn(...)`` in ``src``."""
    params = re.search(r'extern "C" int %s\((.*?)\)' % fn, src, re.S)
    return [re.sub(r"\s+", " ", p).strip().rsplit(" ", 1)[0]
            .replace(" *", "*") for p in params.group(1).split(",")]


@pytest.mark.parametrize("fn,source", [
    ("bf_warp_images_st", "warp_images_st.cu"),
    ("bf_megastep_finish", "megastep_finish.cu")])
def test_the_trip_calls_the_wrappers_entry_points(fn, source):
    """``bf_trip`` launches B1 and B2 through the wrappers' own entry
    points: its declarations of them are their definitions' signatures,
    and it calls each once a pair."""
    trip = (CSRC / "trip.cu").read_text()
    assert _signature(trip, fn) == _signature(
        (CSRC / source).read_text(), fn)
    body = trip[trip.index('extern "C" int bf_trip(const'):]
    assert body.count(f"{fn}(") == 1


# ------------------------------------------------- a stand-in library


def _params(p) -> dict:
    """``model_update_plain``'s parameters from a ``bf::UpdateParams``."""
    return dict(fast=bool(p.fast), use_grad=bool(p.use_grad),
                use_pred=bool(p.use_pred), max_iter=p.max_iter,
                hard_cap=p.hard_cap, tol=tuple(p.tol), tol4=tuple(p.tol4),
                grad_tol=tuple(p.grad_tol), pred_tol=tuple(p.pred_tol),
                xy_cap=p.xy_cap, rotdiv_cap=p.rotdiv_cap)


class StandIn:
    """The kernel library's ``bf_trip`` and ``bf_trip_wait`` on CPU
    tensors: a trip runs B1's and B2's plain twins from what the plan's
    ``TripArgs`` points at (csrc/trip.cu's order of buffers), then copies
    [ITERS, CONT] into the slot.  Counts the plans made, the trips and the
    waits."""

    STREAM, EVENT = 0x5EED, 0xE7E7

    def __init__(self):
        self.plans = {}
        self.trips = self.waits = 0
        self.slot = torch.zeros(2, dtype=torch.float32)

    def made(self, plan):
        self.plans[ctypes.addressof(plan._args)] = plan

    def bf_trip(self, ref, done):
        a = ref._obj
        plan = self.plans[ctypes.addressof(a)]
        assert (a.stream, a.event, a.slot) == (
            self.STREAM, self.EVENT, self.slot.data_ptr())
        assert (a.HP, a.WP) == layout.padded_image_shape(a.H, a.W)
        assert (a.rows, a.smem) == tfm.band_rows(a.H, a.W, a.scale)
        assert a.predicated == int(a.unroll > 1)
        acc_t, acc_c, partials = plan._keep[:3]
        assert (a.acc_t, a.acc_c, a.partials) == tuple(
            t.data_ptr() for t in (acc_t, acc_c, partials))
        at = {t.data_ptr(): t for t in (*plan.pr, *plan.st, *plan._slice)}
        geo, stat, act = at[a.geo], at[a.stat], at[a.act]
        assert stat.shape[0] == a.nch
        for k in range(done, done + a.unroll):
            pr = at[a.pr[(k - 1) & 1] if k else a.pr0]
            st = at[a.st[(k - 1) & 1] if k else a.st0]
            npr, _, _ = tfm.warp_images_st_plain(
                stat, act, pr, st, geo, acc_t, acc_c, scale=a.scale, H=a.H,
                W=a.W, time_lo=bool(a.time_lo), predicated=a.predicated)
            at[a.pr[k & 1]].copy_(npr)
            if tfm._passes_through(st, a.predicated):
                out = st.clone()
            else:
                vals = tfm.finish_values_plain(acc_t, acc_c, scale=a.scale,
                                               H=a.H, W=a.W)
                acc_t.zero_()
                acc_c.zero_()
                out = tfm.model_update_plain(vals, st, geo, scale=a.scale,
                                             params=_params(a.params))
            at[a.st[k & 1]].copy_(out)
        last = at[a.st[(done + a.unroll - 1) & 1]]
        self.slot.copy_(last[0, layout.ST_ITERS:layout.ST_CONT + 1])
        self.trips += 1
        return 0

    def bf_trip_wait(self, ref):
        self.waits += 1
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    """The planned route on CPU tensors: ``plans_trips`` true, the library,
    the stream, the slot and event, and the SM count stood in for.  The
    planned trips count their launches in the process-wide ``LAUNCHES``,
    which the CPU's twins never touch: the counts are put back after the
    test."""
    launches = dict(tfm.LAUNCHES)
    lib = StandIn()
    made = tfm.TripPlan.__init__

    def init(self, *a, **kw):
        made(self, *a, **kw)
        lib.made(self)

    monkeypatch.setattr(tfm.TripPlan, "__init__", init)
    monkeypatch.setattr(tgf, "plans_trips", lambda dev: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(tfm, "_stream",
                        lambda dev: ctypes.c_void_p(StandIn.STREAM))
    monkeypatch.setattr(tfm, "_trip_sync",
                        lambda dev: (lib.slot, StandIn.EVENT))
    monkeypatch.setitem(tfm._SMS, CPU, tfm.H100_SMS)
    yield lib
    tfm.LAUNCHES.update(launches)


@pytest.fixture
def plans_made(monkeypatch):
    """The plans made, counted without changing the route."""
    made = []
    init = tfm.TripPlan.__init__

    def spy(self, *a, **kw):
        made.append(self)
        init(self, *a, **kw)

    monkeypatch.setattr(tfm.TripPlan, "__init__", spy)
    return made


@pytest.fixture(scope="module")
def stream24():
    return synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32,
                            vx=20.0, vy=-14.0, seed=2)


def _scan(d, cfg, dev="cpu"):
    return tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                           device=dev)


def _assert_same_run(got, want, uncounted=()):
    """Bitwise the same outputs, reads, carry and launches (but those of
    ``uncounted``)."""
    for k in OUT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["stats"]["host_syncs"] == want["stats"]["host_syncs"]
    drop = lambda lc: {k: v for k, v in lc.items() if k not in uncounted}
    assert drop(got["stats"]["launches"]) == drop(want["stats"]["launches"])
    assert carry_bits(got["carry"]) == carry_bits(want["carry"])


@pytest.fixture(scope="module")
def wrapper_runs(stream24):
    """The CPU scan on the wrappers (no plan) at unroll 1, 2 and 4, with
    the spans on, and through the per-slice loop (no hand-off)."""
    out = {}
    for u in (1, 2, 4):
        cfg = small_cfg(megastep_unroll=u)
        with profiling.program_spans() as rec:
            out[u] = (_scan(stream24, cfg), rec)
    return out


# ---------------------------------------------------------- the route


def test_the_cpu_route_builds_no_plan(plans_made):
    """On CPU tensors ``trip_plan`` gives None for every drive, so the
    wrappers run their twins."""
    pair = tfm.image_pair(CPU, *image_shape())
    for opt in (OptimizerConfig.fast(), OptimizerConfig.fast(
            megastep_unroll=4), OptimizerConfig()):
        assert tgf.trip_plan(3, pair, opt, 3, *image_shape()) is None
    assert plans_made == []


@pytest.mark.parametrize("drive", ["group", "unsplit", "merged"])
def test_other_drives_build_no_plan_where_plans_are_taken(
        stand_in, wrapper_runs, stream24, drive):
    """Where the device takes plans, an event group (its sum sits between
    B1 and B2), the unsplit drive (B5) and the merged drive (B12) still
    take the wrappers: their scans make no plan and give the wrappers'
    results (bitwise the split drive's, and under a group the unsharded
    scan's)."""
    want, _ = wrapper_runs[1]
    if drive == "group":
        got = compensate_recording_scan_sharded(
            stream24["x"], stream24["y"], stream24["t_ns"], small_cfg(),
            make_event_mesh(2, device="cpu"))
    else:
        got = _scan(stream24, small_cfg(**{
            "unsplit": dict(megastep_split=False),
            "merged": dict(megastep_merged=True)}[drive]))
    for k in OUT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert stand_in.plans == {} and stand_in.trips == 0
    pair = tfm.image_pair(CPU, *image_shape())
    assert tgf.trip_plan(3, pair, OptimizerConfig.fast(), 3,
                         *image_shape()) is not None


@pytest.mark.parametrize("unroll", [1, 2, 4])
def test_the_cpu_scan_counts_no_planned_trips(wrapper_runs, unroll):
    """The CPU route records no ``planned_trips`` and still its drive
    spans: a ``drive.read`` a blocking read, a ``drive.launch`` a trip."""
    r, rec = wrapper_runs[unroll]
    assert "planned_trips" not in rec.counters
    assert rec.counts["drive.read"] == r["stats"]["host_syncs"]
    assert rec.counts["drive.launch"] == r["stats"]["host_syncs"]


@pytest.mark.parametrize("loop", ["carried", "per_slice"])
@pytest.mark.parametrize("unroll", [1, 2, 4])
def test_planned_drive_through_a_stand_in_is_the_wrapper_drive(
        stand_in, wrapper_runs, stream24, monkeypatch, unroll, loop):
    """The planned route on CPU tensors, its trips run by ``StandIn`` from
    the plan's arguments: bitwise the wrappers' scan (u, v, noise,
    iterations, reads, launches, the carry).  The carried loop makes one
    plan for its slice range, the per-slice loop (``process_slice``, no
    hand-off) one a drive call; one trip call and one wait a blocking
    read; ``planned_trips`` counts the trips, and the drive spans are as
    many.  The wrappers' twins count no launch; the plan counts the
    kernels a trip launches on the card."""
    want, _ = wrapper_runs[unroll]
    cfg = small_cfg(megastep_unroll=unroll)
    if loop == "per_slice":
        monkeypatch.setattr(tscan, "run_slices", per_slice_run_slices)
        with monkeypatch.context() as m:
            m.setattr(tgf, "plans_trips", lambda dev: False)
            want = _scan(stream24, cfg)
    with profiling.program_spans() as rec:
        got = _scan(stream24, cfg)
    _assert_same_run(got, want, ("warp_images_st", "megastep_finish"))
    syncs = got["stats"]["host_syncs"]
    n_ran = int(got["ran"].sum())
    assert len(stand_in.plans) == (1 if loop == "carried" else n_ran)
    assert stand_in.trips == stand_in.waits == syncs >= n_ran > 0
    assert rec.counters["planned_trips"] == syncs
    assert rec.counts["drive.read"] == rec.counts["drive.launch"] == syncs
    lc = got["stats"]["launches"]
    assert lc["warp_images_st"] == lc["megastep_finish"] == unroll * syncs


def test_a_plan_never_writes_the_start(stand_in):
    """A planned drive call reads its start positions and state and writes
    only the plan's two buffers of each, in turn: the hand-off's start
    state, which B4 reads, survives; the final state is the last buffer
    written."""
    d = slice_inputs(0)
    t = {k: torch.from_numpy(np.ascontiguousarray(d[k]))
         for k in ("stat", "act", "pr", "st", "geo")}
    H, W = image_shape()
    opt = OptimizerConfig.fast(megastep_unroll=2)
    pair = tfm.image_pair(CPU, H, W)
    plan = tgf.trip_plan(t["stat"].shape[0], pair, opt, 3, H, W)
    st0, pr0 = t["st"].clone(), t["pr"].clone()
    plan.start(t["stat"], t["act"], t["geo"], t["pr"], t["st"])
    plan.trip()
    plan.trip()
    assert plan.done == 4 and stand_in.trips == 2
    assert torch.equal(t["st"], st0) and torch.equal(t["pr"], pr0)
    pr, st = plan.final()
    assert pr is plan.pr[1] and st is plan.st[1]
    assert plan.wait() == (float(st[0, layout.ST_ITERS]),
                           float(st[0, layout.ST_CONT]))
    with pytest.raises(ValueError, match="shape"):
        plan.start(t["stat"][:2], t["act"], t["geo"], t["pr"], t["st"])


# ------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _bits(t):
    return t.detach().contiguous().view(torch.int32).cpu()


SHAPES = {"davis240": ((180, 240), 30), "gen4": ((720, 1280), 45)}


@pytest.mark.cuda
@pytest.mark.parametrize("handoff", [True, False])
@pytest.mark.parametrize("unroll", [1, 2, 4])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_planned_drive_call_is_the_wrapper_drive_on_card(
        cuda, monkeypatch, plans_made, shape, unroll, handoff):
    """One ``run_fused_mega`` call on the card at scale 3 (a DAVIS240
    slice of 30 chunks, a 1280x720 one of 45), planned and on the
    wrappers: bitwise the same final state, positions, B4's rows,
    hand-off (next state and seed row) or model and seed row, iterations
    and reads, and the same launches; a plan a call."""
    res, nch = SHAPES[shape]
    d = slice_inputs(1, res=res, scale=3, nch=nch)
    d["st"][0, layout.ST_ITERS] = 0.0
    H, W = image_shape(res, 3)
    opt = OptimizerConfig.fast(megastep_unroll=unroll)
    t = {k: torch.from_numpy(np.ascontiguousarray(d[k])).to(cuda)
         for k in ("stat", "act", "pr", "st", "geo")}

    def run(planned):
        pair = tfm.image_pair(cuda, H, W)
        uvn = torch.full((nch, 3, layout.CHUNK), 7.0, device=cuda)
        before = dict(tfm.LAUNCHES)
        if handoff:
            plan = tgf.trip_plan(nch, pair, opt, 3, H, W) \
                if planned else None
            assert (plan is None) != planned
            h = tgf.SliceHandoff(
                t["st"], t["pr"], torch.full_like(t["st"], 9.0),
                torch.full((12,), 9.0, device=cuda), pair,
                torch.empty((nch, 4, layout.CHUNK), device=cuda), plan)
            st, out, uvn, iters, seed, reads = tgf.run_fused_mega(
                t["stat"], t["act"], t["geo"], None, opt, 3, H, W,
                uvn_out=uvn, handoff=h)
            rows = [st, out, uvn, h.st_next, seed]
        else:
            model = tgf.model_from_state(t["st"])
            sl = layout.ST_SL
            m, out, uvn, iters, seed, reads = tgf.run_fused_mega(
                t["stat"], t["act"], t["geo"], model, opt, 3, H, W,
                seed=t["st"][0, sl:sl + 8].clone(), uvn_out=uvn)
            rows = [torch.stack([getattr(m, f) for f in FIELDS]), out, uvn,
                    seed]
        torch.cuda.synchronize()
        launched = {k: tfm.LAUNCHES[k] - before[k] for k in before}
        return [_bits(r) for r in rows], iters, reads, launched

    got = run(True)
    assert len(plans_made) == 1
    monkeypatch.setattr(tgf, "plans_trips", lambda dev: False)
    want = run(False)
    assert len(plans_made) == 1
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    assert got[1:] == want[1:]
    iters, reads, launched = got[1:]
    assert iters >= 1 and reads == -(-iters // unroll)
    assert launched["warp_images_st"] == launched["megastep_finish"] == \
        unroll * reads
    assert launched["warp_uv"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [1, 2, 4])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_carried_scan_planned_is_the_wrapper_scan_on_card(
        cuda, monkeypatch, plans_made, shape, unroll):
    """The scan's carried slice loop (``_run_carried``) on the card over
    at least 8 slices, planned (one plan for the range) and on the
    wrappers: bitwise the same u, v, noise, iterations, reads, launches
    and carry; with the spans on, ``planned_trips`` equals the trips."""
    if shape == "davis240":
        d = bench_stream(400_000)
        cfg = PipelineConfig(optimizer=OptimizerConfig.fast(
            megastep_unroll=unroll))
        run = lambda: _scan(d, cfg, cuda)
    else:
        d = gen4_stream(400_000, seed=2 ** 31 + 29)
        base = gen4_cfg()
        cfg = dataclasses.replace(base, optimizer=dataclasses.replace(
            base.optimizer, megastep_unroll=unroll))
        first = tscan.plan_slices(d["t_ns"], cfg).ends[0] + 1
        tot, cx, cy = gen4_start(d["x"][:first], d["y"][:first])
        run = lambda: tscan.compensate_recording_scan(
            d["x"], d["y"], d["t_ns"], cfg, device=cuda,
            init_model=gen4_model(tot, cx, cy, cuda))
    with profiling.program_spans() as rec:
        got = run()
    monkeypatch.setattr(tgf, "plans_trips", lambda dev: False)
    want = run()
    assert len(got["iters"]) >= 8 and int(got["ran"].sum()) >= 8
    _assert_same_run(got, want)
    assert len(plans_made) == 1
    syncs = got["stats"]["host_syncs"]
    assert rec.counters["planned_trips"] == syncs == rec.counts["drive.read"]
    lc = got["stats"]["launches"]
    assert lc["warp_images_st"] == lc["megastep_finish"] == unroll * syncs
