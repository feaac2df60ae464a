"""BENCHMARK.json against the benchmark's contract, and every name in it
found: configurations, traffic files, job drivers and metric readers."""

import ast
import json
import os
import re

import pytest

from perfbench.harness import PKG, ROOT, Names

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_keys_and_names():
    b = _bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["perfbench"] and b["command"][1] == "perfbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["name"] for m in b["end_to_end"]] == [
        "run_seqs_per_s", "check_device_peak_mib", "setup_s"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        # each cell of a per-layer metric reports the metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_file_and_reader_is_found():
    b = _bench()
    names = Names()
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert key in cfg and "published" in cfg["reduced"][key]
        assert cfg["guarantee"] and cfg["assumed"]
    for w in b["workloads"]:
        tr = names.data("traffic", w["traffic"])
        job = names.module("jobs", tr["job"])
        for fn in ("setup", "run_one", "check"):
            assert callable(getattr(job, fn))
        assert job.TRACE
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] != "setup_s":
            assert callable(names.module("metrics", m["name"]).read)


@pytest.mark.parametrize("folder", ["configs", "traffic", "metrics",
                                    "jobs", "generators"])
def test_file_names_are_names(folder):
    for f in os.listdir(os.path.join(PKG, folder)):
        if f.startswith("__"):
            continue
        stem, ext = os.path.splitext(f)
        assert NAME.match(stem) and ext in (".json", ".py")


def test_the_harness_names_no_cell():
    """Adding a cell or a metric needs no edit of the harness: no cell,
    configuration, traffic or metric name appears in it."""
    b = _bench()
    with open(os.path.join(PKG, "harness.py")) as f:
        src = f.read()
    for entry in b["configs"] + b["workloads"] + b["per_layer"]:
        assert entry["name"] not in src
    for w in b["workloads"]:
        assert w["traffic"] not in src
