#!/usr/bin/env python3
"""The live cell's knee: the live entry at a list of rates, one process,
each rate a fresh session of ``--seconds``, to find the highest rate at
which the feed keeps up (no backlog: how late the feed runs stays flat
over the window).  The benchmark's runs do not run it; its output is the
record behind the rate in ``portbench/traffic/steady-live.json``.

    python3 portbench/sweep.py --workload live-ros-steady \\
        --bench portbench/kept_out.json --rates 1e6,2e6,3e6 --seconds 10
"""

import json
import pathlib
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--bench", default="BENCHMARK.json",
                   help="the file that holds the cell, from the checkout's "
                        "root (portbench/kept_out.json: cells kept out)")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)
    bench = harness.read_json(ROOT / a.bench)
    for rate in (float(r) for r in a.rates.split(",")):
        cell = harness.find_cell(bench, a.workload)
        cell.mix = dict(cell.mix, rate_eps=rate)
        entry = harness.load_module(cell.entry_path, "portbench_sweep_entry")
        run = harness.Run(cell=cell, seed=a.seed, seconds=a.seconds,
                          trace=False, device="cuda",
                          t_process=time.perf_counter())
        out = entry.run(run)
        w = np.array(out["layer"]["live"]["queue_wait_ms"])
        q = len(w) // 4
        row = {"rate_eps": rate, "slices": out["attempted"],
               **{k: v for k, v in out["e2e"].items()},
               "queue_wait_ms_p95": float(np.percentile(w, 95)),
               "queue_wait_ms_first_quarter_mean": float(w[:q].mean()),
               "queue_wait_ms_last_quarter_mean": float(w[-q:].mean()),
               "slice_wall_ms_mean": float(np.mean(
                   out["layer"]["live"]["wall_ms"])),
               "correct": all(c["ok"] for c in out["checks"])}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
