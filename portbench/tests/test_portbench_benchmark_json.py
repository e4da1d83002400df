"""``BENCHMARK.json`` against the shape the harness and the checks read:
names, units, keys, files, and every cell and configuration found by its
name."""
from __future__ import annotations

import json
import os
import re

from portbench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def bench():
    return json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert b["paths"] == ["portbench"]
    assert all(TEXT.match(w) for w in b["command"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert json.load(open(os.path.join(ROOT, c["file"])))["source"] \
            == c["source"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        cell, _ = harness.load_cell(w["name"])
        assert (cell["config"], cell["chips"], cell["why"]) == (
            w["config"], w["chips"], w["why"])
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [x["name"] for x in metrics + b["workloads"] + b["configs"]]
    assert len(names) == len(set(names))
    assert {c["name"] for c in b["configs"]} == {w["config"]
                                                for w in b["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)


def test_metrics_and_their_cells():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert os.path.isfile(os.path.join(HERE, "metrics",
                                           f"{m['name']}.py"))
    for w in b["workloads"]:
        got, layer = harness.cell_metrics(b, w["name"])
        assert len(got) >= 2 and "setup_s" in {m["name"] for m in got}
        assert layer
        for m in layer:
            assert m["moves"] in {x["name"] for x in got}
        cell, _ = harness.load_cell(w["name"])
        assert os.path.isfile(os.path.join(
            HERE, "traffic", f"{cell['traffic']['kind']}.py"))


def test_layers_are_named_in_perf_md():
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    for m in bench()["per_layer"]:
        assert m["layer"] in perf
