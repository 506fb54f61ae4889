#!/usr/bin/env python3
"""The benchmark's control: the plain reference put in the program's place
and computed one precision below the float32 the configurations state
(bfloat16), read by the same comparison as the program, on a cell's own
traffic and size.  Its readings are the upper ends from which
``portbench/limits/<cell>.json`` was set.  The benchmark's runs do not run
it.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 30] [--sides control,program] [--bench <file>]

Offline cells: the recording that a run of that seed compares, every
slice, through the bfloat16 reference, against the float32 reference;
the side ``program`` reads the program's outputs of that recording from
the cell's own call by the same comparison: the lower ends, without a
window's wait.  The live cell: the bfloat16 reference as the session (a
chain over ``--seconds`` of the stream), its first slices and a seeded
sample compared as a run compares the program's, each sampled slice of
the float32 reference started from the control's own model.  Prints one
JSON line a seed.
"""

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import compare, harness, traffic  # noqa: E402
from portbench.reference import flow as ref  # noqa: E402


def offline(cell, seed, dev, sides=("control",)):
    """The numbers of each of ``sides`` ("control", "program") on the
    recording a run of ``seed`` compares, as {side: numbers}."""
    pool = traffic.recordings(cell.mix, seed)
    pick = int(np.random.default_rng([seed, 11]).integers(len(pool)))
    rec = pool[pick]
    st = ref.Settings.from_config(cell.config)
    prep = ref.prepare(rec["x"], rec["y"], rec["t_ns"], st, flush=True)
    r = ref.compensate(prep, st, dev)
    slices = compare.claimed(prep.plan.starts, prep.plan.ends)
    speed = compare.mean_speed(r.u, r.v)
    out = {}
    if "program" in sides:
        from better_flow_tpu_torch.runtime import scan_pipeline

        run = harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False,
                          device=dev, t_process=0.0)
        fn = getattr(scan_pipeline, cell.config["entry_args"]["function"])
        o = fn(rec["x"], rec["y"], rec["t_ns"], run.pipeline_config(),
               device=dev)
        out["program"] = compare.flow_numbers(
            o["u"], o["v"], o["noise"], r.u, r.v, r.noise, slices, speed,
            np.asarray(o["iters"]), r.iters)
    if "control" in sides:
        c = ref.compensate(prep, st, dev, dtype=torch.bfloat16)
        out["control"] = compare.flow_numbers(c.u, c.v, c.noise, r.u, r.v,
                                              r.noise, slices, speed,
                                              c.iters, r.iters)
    return out


class Rec:
    """A slice record of the control's session, as ``DVSFlow`` gives."""

    def __init__(self, res, t_last):
        m = res.out.model
        tot = m.tot.float().cpu().numpy()
        comp = m.comp.float().cpu().numpy()
        self.total_rot, self.total_div, self.total_dx, self.total_dy = tot
        self.comp_rot, self.comp_div, self.comp_dx, self.comp_dy = comp
        self.cx, self.cy = float(m.cx), float(m.cy)
        self.model = self
        self.u, self.v, self.noise = res.u, res.v, res.noise
        self.iters = res.out.iters
        self.timestamp = np.array([t_last])
        self.n_events = len(res.u)
        self.wall_s = 0.0


def live(cell, seed, dev, seconds):
    from portbench.entries import live_stream as ls

    stream = traffic.stream(cell.mix, seed, seconds + 1.0)
    x, y, t = stream.events(int(seconds * 1e9))
    st = ref.Settings.from_config(cell.config)
    prep = ref.prepare(x, y, t, st, flush=False)
    exp = ls.expected_slices(cell.mix, cell.config, seconds)
    every = max(1, int(exp // ls.N_SAMPLED))
    salt = int(np.random.default_rng([seed, 13]).integers(every))
    session = ls.Session(lambda k: k < ls.N_START or (k % every) == salt)
    model, sd = ref.Model.zero(dev, torch.bfloat16), None
    for k in range(prep.n_slices):
        r = ref.run_one(prep, k, model, sd, st, dev, torch.bfloat16)
        model, sd = r.out.model, r.out.seed
        session.on_slice(Rec(r, int(prep.t_ns[prep.plan.ends[k]])))
    return ls.compare_slices(session, prep, st, dev, prep.n_slices, {})


def main(argv):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--bench", default="BENCHMARK.json",
                   help="the file that holds the cell, from the checkout's "
                        "root (portbench/kept_out.json: cells kept out)")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--sides", default="control")
    a = p.parse_args(argv)
    cell = harness.find_cell(harness.read_json(ROOT / a.bench),
                             a.workload)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        if cell.config["entry"] == "live_stream":
            rows = live(cell, seed, dev, a.seconds)
            sides = {"control": {r["name"]: r["value"] for r in rows}}
        else:
            sides = offline(cell, seed, dev, a.sides.split(","))
        print(json.dumps({"workload": a.workload, "seed": seed, **sides,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
