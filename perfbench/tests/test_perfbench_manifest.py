"""BENCHMARK.json against the benchmark's contract, and every file it names.

    python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s: 2 + 14 runs a cell, each
    # run_seconds + 60, two 90 s compiles a cell, 1200 s spare
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for key, lo, hi in (("configs", 1, 24), ("workloads", 1, 24), ("end_to_end", 1, 16),
                        ("per_layer", 1, 128)):
        assert lo <= len(MANIFEST[key]) <= hi


def test_names_units_and_lines():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        names.append(("config", c["name"]))
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and _line(w["why"])
        names.append(("cell", w["name"]))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(("metric", m["name"]))
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}) == len(CELLS)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert {"setup_s", "fit_s", "predict_p95_ms", "ess_per_s", "peak_gb"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.config_name
    assert set(c.config["reduced"]) == set(
        next(x for x in MANIFEST["configs"] if x["name"] == c.config_name)["reduced"])
    kind = harness.kind_module(c.traffic["kind"])
    for fn in ("setup", "call", "end_to_end", "counters", "release", "check"):
        assert callable(getattr(kind, fn))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e - {"setup_s", "peak_gb"}) >= 1
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, which {cell} does not report"
        assert callable(harness.metric_reader(m["name"]))


def test_per_layer_metrics():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["source"] == "device_trace"
    assert {"factorization", "triangular solves", "inference", "GP core", "device"} <= set(layers)


def test_layer_table_parses():
    table = harness.layer_table()
    assert table and all(isinstance(keys, list) and keys for _, keys in table)


def test_readers_return_nothing_without_readings():
    run = harness.TraceRun(cell=None, window_s=0.0, busy_s=0.0, device_s=0.0, by_layer={},
                           counters={})
    for m in MANIFEST["per_layer"]:
        assert harness.metric_reader(m["name"])(run) is None
