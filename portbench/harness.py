"""The benchmark's runner: one run of one cell.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` finds the cell in ``BENCHMARK.json``, its configuration's
file, its traffic mix (``portbench/traffic/<traffic>.json``), the entry
that drives the configuration's kind of call
(``portbench/entries/<entry>.py``) and, in a traced run, the reader of
each per-layer metric (``portbench/metrics/<metric>.py``), all by name, so
that a cell, a mix, an entry or a metric is added by adding files.  The
last line of standard output is the run's result as one JSON object; the
numbers that decide ``correct`` are printed beside their limits as the last
lines of standard error and, last, in the result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys
from dataclasses import dataclass, field
from typing import Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that no run may hold once its window has closed:
# the JAX package and JAX itself.  Compared whole: the port's name begins
# with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "better_flow_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


@dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with everything its run reads."""

    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list
    root: pathlib.Path = ROOT

    @property
    def entry_path(self) -> pathlib.Path:
        return self.root / "portbench" / "entries" / \
            f"{self.config['entry']}.py"

    def metric_path(self, name: str) -> pathlib.Path:
        return self.root / "portbench" / "metrics" / f"{name}.py"


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of the benchmark ``bench``, its files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(sorted(cells))}")
    w = cells[name]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = read_json(root / files[w["config"]])
    mix = read_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, name)],
                root=root)


@dataclass
class Run:
    """What an entry gets: the cell, the run's arguments and the device;
    ``t_process`` is the host clock when the process started."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_process: float
    limits: dict = field(default_factory=dict)

    def pipeline_config(self):
        """The port's ``PipelineConfig`` of the configuration's file."""
        from better_flow_tpu_torch.config import (
            OptimizerConfig, PipelineConfig, SensorConfig, SliceConfig,
        )

        c = self.cell.config
        return PipelineConfig(
            sensor=SensorConfig(**c["sensor"]),
            slice=SliceConfig(**c["slice"]),
            optimizer=OptimizerConfig(**c["optimizer"]),
            stm_disable=c.get("stm_disable", False),
            f64_totals=c.get("f64_totals", False))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str, t_process: float) -> dict:
    """One run of ``cell`` on ``device``: the entry's window, then the
    metrics and the checks.  Returns the result object (without the device
    description, which ``main`` adds)."""
    from portbench import compare

    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
              device=device, t_process=t_process,
              limits=compare.limits(cell.name))
    entry = load_module(cell.entry_path,
                        f"portbench_entry_{cell.config['entry']}")
    out = entry.run(run)
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            reader = load_module(cell.metric_path(m["name"]),
                                 "portbench_metric_" +
                                 m["name"].replace(".", "_").replace("-", "_"))
            v = reader.read(out["layer"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = out["checks"]
    result = {
        "correct": bool(checks) and all(c["ok"] for c in checks),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": {"memory_peak_bytes": int(out["memory_peak_bytes"])},
    }
    if trace and out.get("trace"):
        t = out["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = checks
    return result


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv, t_process: float) -> int:
    args = parse(argv)
    bench_path = ROOT / "BENCHMARK.json"
    if not bench_path.exists():
        log("BENCHMARK.json not found beside portbench/")
        return 2
    cell = find_cell(read_json(bench_path), args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            ": no result")
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", t_process)
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell.chips, **result["device"]}
    log(f"card: {power_limit()}")
    found = forbidden_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: no result")
        return 4
    for c in result["checks"]:
        log(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0
