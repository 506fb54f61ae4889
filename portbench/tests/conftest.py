"""Shared pieces of the benchmark's CPU tests: the benchmark's own cells
cut to sizes the CPU runs in seconds (``tiny_cell``), which the tests drive
through the harness on the port's plain CPU twins.

Run them from the repository root: ``python -m pytest portbench/tests``
(the tests marked ``cuda`` run the harness on the card and skip without
one: ``python -m pytest portbench/tests -m cuda`` on the card).
"""

import copy
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

TINY_SEED = 2 ** 31 + 4321


def tiny_cell(name: str, subpixel: bool = False) -> harness.Cell:
    """A cell of BENCHMARK.json, or of ``portbench/kept_out.json`` (cells
    kept out of the benchmark), at a size the CPU twins run in seconds:
    offline recordings of 120,000 events at 1 M events/s with the
    configuration's slicing (``subpixel``: with the sub-pixel coordinates
    of rectified events, which take the port's numpy staging); a live
    stream at 500,000 events/s with 10,000-event slices."""
    bench = harness.read_json(ROOT / "BENCHMARK.json")
    kept_out = harness.read_json(ROOT / "portbench" / "kept_out.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + kept_out[key]
    cell = harness.find_cell(bench, name)
    cell.config = copy.deepcopy(cell.config)
    cell.mix = copy.deepcopy(cell.mix)
    if cell.config["entry"] == "offline_recording":
        cell.mix.update(recording_events=120_000, pool_recordings=2,
                        pool_segments=3, segment_s=0.1, subpixel=subpixel)
    else:
        cell.config["slice"].update(max_events=10_000, refresh_events=10_000)
        cell.mix.update(rate_eps=500_000, pool_segments=2, segment_s=0.5)
    return cell

