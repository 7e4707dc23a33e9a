"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""

import json
import os
import re
import shutil

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as fh:
        return json.load(fh)


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["command"][:2] == ["python3", "portbench/run.py"] and len(b["command"]) <= 32
    assert b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    # 2 + 14 runs per cell, each run_seconds + 60 s, 2 x 90 s per cell to
    # compile, 1200 s spare: at 24 cells within 43,200 s
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    b = bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    from portbench import harness

    b = bench()
    for w in b["workloads"]:
        e2e = harness.metric_names(b, w["name"], "end_to_end")
        layer = harness.metric_names(b, w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]
        for m in b["per_layer"]:
            if w["name"] in m.get("workloads", []):
                assert m["moves"] in e2e, (m["name"], w["name"])


def test_every_name_resolves_to_its_files():
    from portbench import harness

    b = bench()
    for w in b["workloads"]:
        wl, config, traffic, driver = harness.resolve(b, w["name"])
        assert config["name"] == w["config"]
        for fn in ("setup", "call", "window", "tally", "check"):
            assert callable(getattr(driver, fn)), (w["name"], fn)
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] != "setup_s":
            assert callable(harness.module("metrics", m["name"]).read), m["name"]


def test_a_cell_added_as_new_files_is_picked_up(tmp_path, monkeypatch):
    from portbench import harness

    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    b = bench()
    b["workloads"].append({"name": "shortarc.stream_small", "config": "shortarc", "traffic": "stream_small",
                           "chips": 1, "why": "a new cell"})
    b["per_layer"].append({"name": "calls_in_window", "unit": "1", "better": "higher", "source": "host_clock",
                           "layer": "stream scheduler", "moves": "fits_per_s", "workloads": ["shortarc.stream_small"]})
    for m in b["end_to_end"]:
        if m["name"] in ("fits_per_s", "converged_frac"):
            m["workloads"].append("shortarc.stream_small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    traffic = json.loads((tmp_path / "portbench/workloads/shortarc.stream.json").read_text())
    traffic["pool"] = 2
    (tmp_path / "portbench/workloads/shortarc.stream_small.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/metrics/calls_in_window.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    monkeypatch.setattr(harness, "HERE", str(tmp_path / "portbench"))
    nb = harness.load_benchmark()
    wl, config, traffic, driver = harness.resolve(nb, "shortarc.stream_small")
    assert traffic["pool"] == 2 and wl["traffic"] == "stream_small"
    assert harness.metric_names(nb, "shortarc.stream_small", "per_layer") == ["calls_in_window"]
    mod = harness.module("metrics", "calls_in_window")
    assert mod.read(type("R", (), {"records": [1, 2]})()) == 2


@pytest.mark.parametrize("path", ["portbench/workloads", "portbench/configs"])
def test_data_files_are_json(path):
    for name in os.listdir(os.path.join(ROOT, path)):
        with open(os.path.join(ROOT, path, name), encoding="utf-8") as fh:
            json.load(fh)
