"""BENCHMARK.json and the files it names: every name found, every name
and unit of the allowed characters, every cell's metrics readable."""

import json
import os
import re

from conftest import ROOT

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_spec_keys_and_names():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"]
    assert s["command"] == ["python3", "benchmark/run.py"]
    names = [c["name"] for c in s["configs"]] + [
        w["name"] for w in s["workloads"]] + [
        m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in s["workloads"]]:
        assert NAME.match(n), n
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= s["run_seconds"] <= 51
    assert len(json.dumps(s)) < 64 * 1024


def test_files_exist_and_load():
    s = spec()
    configs = {c["name"] for c in s["configs"]}
    for c in s["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(harness.HERE, "scenes",
                                           cfg["scene"]["kind"] + ".py"))
    for w in s["workloads"]:
        wl = harness.load_json("workloads", w["name"] + ".json")
        assert wl["config"] == w["config"] and w["config"] in configs
        assert os.path.exists(os.path.join(harness.HERE, "drivers",
                                           wl["kind"] + ".py"))
        assert w["chips"] == 1
        assert set(wl["limits"]) and all(v >= 0 for v in
                                         wl["limits"].values())
    cells = {w["name"] for w in s["workloads"]}
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py")), m["name"]
        assert m["moves"] in e2e and set(m["workloads"]) <= cells


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    s = spec()
    for w in s["workloads"]:
        def has(m):
            return "workloads" not in m or w["name"] in m["workloads"]
        e2e = [m["name"] for m in s["end_to_end"] if has(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(has(m) for m in s["per_layer"])


def test_metric_readers_find_nothing_in_an_empty_run():
    s = spec()
    for m in s["per_layer"]:
        mod = harness.load_module(os.path.join(harness.HERE, "metrics",
                                               m["name"] + ".py"), "m")
        assert mod.read({}) is None, m["name"]
