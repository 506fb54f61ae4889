"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, entry and per-layer metric resolves to its file, the file
keeps to the contract's limits, and a new cell is added by adding files
only."""

import json
import re
import shutil

import pytest

from conftest import ROOT
from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
# The cells kept out of the benchmark, in its form, with the benchmark's
# own: their files are checked alike.
KEPT_OUT = json.loads((ROOT / "portbench" / "kept_out.json").read_text())
ALL = {k: BENCH[k] + KEPT_OUT[k]
       for k in ("configs", "workloads", "end_to_end", "per_layer")}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_metric_keys():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in WORKLOADS
            # every listed cell reports the metric it moves
            mv = next(e for e in BENCH["end_to_end"]
                      if e["name"] == m["moves"])
            assert harness.applies(mv, w)


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_cell_resolves(cell):
    c = harness.find_cell(ALL, cell)
    assert c.chips == 1
    assert c.entry_path.exists()
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert c.metric_path(m["name"]).exists(), m["name"]
    w = next(w for w in ALL["workloads"] if w["name"] == cell)
    assert len(w["why"]) <= 200
    assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
    assert (ROOT / "portbench" / "limits" / f"{cell}.json").exists()


@pytest.mark.parametrize("conf", [c["name"] for c in ALL["configs"]])
def test_config_files(conf):
    c = next(c for c in ALL["configs"] if c["name"] == conf)
    assert c["file"].startswith("portbench/")
    data = json.loads((ROOT / c["file"]).read_text())
    assert data["reduced"] == c["reduced"]
    assert data["entry"] and "source" in data and "assumed" in data
    assert any(w["config"] == conf for w in ALL["workloads"])


def test_kept_out_cells_are_not_run():
    """A kept-out cell shares no name with the benchmark's, and the runner,
    which reads only BENCHMARK.json, does not find it."""
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert not ({e["name"] for e in BENCH[k]}
                    & {e["name"] for e in KEPT_OUT[k]})
    for w in KEPT_OUT["workloads"]:
        with pytest.raises(SystemExit):
            harness.find_cell(BENCH, w["name"])


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A throwaway configuration, mix, entry, metric and cell, added as new
    files and entries in a copy of the benchmark: the harness finds and
    runs them without an edit to any file that was there."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    (root / "portbench/configs/toy.json").write_text(json.dumps(
        {"entry": "toy_entry", "entry_args": {}, "source": "test",
         "assumed": [], "reduced": []}))
    (root / "portbench/traffic/toy-mix.json").write_text(json.dumps(
        {"generator": "synthetic", "n": 3}))
    (root / "portbench/entries/toy_entry.py").write_text(
        "def run(run):\n"
        "    n = run.cell.mix['n']\n"
        "    return {'attempted': n, 'failed': 0,\n"
        "            'e2e': {'toy_rate': 2.0 * n, 'setup_s': 0.5},\n"
        "            'layer': {'toy': n}, 'trace': None,\n"
        "            'checks': [{'name': 'toy_gap', 'value': 0.0,\n"
        "                        'limit': 0.0, 'ok': True}],\n"
        "            'memory_peak_bytes': 1}\n")
    (root / "portbench/metrics/toy_count.x.py").write_text(
        "def read(layer):\n    return float(layer['toy'])\n")
    bench["configs"].append({"name": "toy", "source": "test",
                             "file": "portbench/configs/toy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "toy.cell", "config": "toy",
                               "traffic": "toy-mix", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "toy_rate", "unit": "x/s",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["toy.cell"]})
    bench["per_layer"].append({"name": "toy_count.x", "unit": "x",
                               "better": "lower", "source": "host_clock",
                               "layer": "toy", "moves": "toy_rate",
                               "workloads": ["toy.cell"]})
    cell = harness.find_cell(bench, "toy.cell", root=root)
    res = harness.execute(cell, 1, 1.0, False, "cpu", 0.0)
    assert res["metrics"] == {"toy_rate": {"value": 6.0, "unit": "x/s"},
                              "setup_s": {"value": 0.5, "unit": "s"}}
    res = harness.execute(cell, 1, 1.0, True, "cpu", 0.0)
    assert res["metrics"] == {"toy_count.x": {"value": 3.0, "unit": "x"}}
    assert res["correct"] is True
    for p, data in before.items():
        assert p.read_bytes() == data, p
