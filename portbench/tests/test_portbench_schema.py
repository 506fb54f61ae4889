"""The result line's schema, the refusal without a card, and what the
benchmark's modules import: no top-level ``jax``, ``jaxlib``, ``flax`` or
``better_flow_tpu`` (compared whole: the port's name begins with the JAX
package's), and nothing of the program in the reference."""

import ast
import json
import subprocess
import sys

import pytest

from conftest import ROOT, TINY_SEED, tiny_cell
from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "better_flow_tpu"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in (ROOT / "portbench").rglob("*.py") if ".cache" not in p.parts))
def test_no_jax_imports(path):
    names = _imports(ROOT / path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if path.startswith(("portbench/reference/", "portbench/gen/")):
        assert "better_flow_tpu_torch" not in names


def test_run_modules_load_no_jax():
    """In a fresh process, the harness, every entry, the reference and the
    port's modules that the entries call leave no forbidden top-level
    module behind."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness, compare, traffic, tracing, roofline\n"
        "from portbench.reference import flow\n"
        "from portbench.entries import offline_recording, live_stream\n"
        "import better_flow_tpu_torch.runtime.scan_pipeline\n"
        "import better_flow_tpu_torch.runtime.dvs_flow\n"
        "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the run exits non-zero and prints nothing on
    standard output."""
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['run.py', '--workload', 'offline-fast-long',\n"
            "            '--seed', '1', '--seconds', '1', '--trace', '0']\n"
            "runpy.run_path(%r, run_name='__main__')\n"
            % str(ROOT / "portbench" / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ gives no result,
    even where a card is found: the program is missing."""
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "sys.argv = ['run.py', '--workload', 'offline-fast-long',\n"
            "            '--seed', '1', '--seconds', '1', '--trace', '0']\n"
            "runpy.run_path('portbench/run.py', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "better_flow_tpu_torch" in out.stderr


def test_result_schema():
    """A run's result object: the keys a reader of the line takes, the
    checks last, and the cell's end-to-end metrics with their units."""
    import time

    cell = tiny_cell("offline-fast-long")
    res = harness.execute(cell, TINY_SEED, 0.5, False, "cpu",
                          time.perf_counter())
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {"events_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert res["attempted"] >= 1 and res["failed"] == 0
    for c in res["checks"]:
        assert set(c) == {"name", "value", "limit", "ok"}
    json.dumps(res)
