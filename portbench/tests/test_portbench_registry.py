"""BENCHMARK.json keeps to the benchmark's contract, each cell finds its
files by name, and a configuration, traffic mix or metric added as new
files is picked up without an edit."""

import json
import os
import re
import shutil

import pytest

from portbench import registry

ROOT = registry.ROOT
BENCH = os.path.join(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(BENCH) as f:
        return json.load(f)


def test_top_level_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(BENCH) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and 1 <= len(b["command"]) <= 32
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    for word in b["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")


def test_names_units_and_text():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for c in b["configs"]:
        assert 1 <= len(c["source"]) <= 200 and len(c["reduced"]) <= 16


def test_entry_keys_bounds_and_reports():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in b["workloads"]:
        cell = registry.Cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported


def test_every_cell_finds_its_files():
    for w in bench()["workloads"]:
        cell = registry.Cell(w["name"])
        assert cell.config["tasks"] and cell.traffic["driver"]
        assert cell.driver().run
        for m in cell.per_layer:
            reader = cell.reader(m["name"])
            assert reader.UNIT == m["unit"] and reader.MOVES == m["moves"]
            assert reader.LAYER == m["layer"]
            assert reader.SOURCE == m["source"]
        assert cell.limits


def test_configs_file_and_reduced():
    b = bench()
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        used = [w for w in b["workloads"] if w["config"] == c["name"]]
        assert used


def test_one_layer_name_per_layer():
    layers = {}
    for m in bench()["per_layer"]:
        module = m["layer"].split(" (")[0]
        layers.setdefault(module, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    data = tmp_path / "data"
    shutil.copytree(os.path.join(ROOT, "portbench"), data,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    with open(data / "configs" / "rgb.json") as f:
        cfg = json.load(f)
    cfg["conv_channels"] = 192
    (data / "configs" / "rgb192.json").write_text(json.dumps(cfg))
    with open(data / "traffic" / "stream64.json") as f:
        tr = json.load(f)
    tr["batch"] = 8
    (data / "traffic" / "stream8.json").write_text(json.dumps(tr))
    (data / "limits" / "rgb192.stream8.json").write_text(
        json.dumps({"ambiguity": 1e-4, "bytes_candidates": 16,
                    "answer_gap": 1e-4}))
    (data / "metrics" / "gdn_launches.stream.py").write_text(
        'LAYER = "Kernel GDN (ops/gdn.py, csrc/gdn.cu)"\nUNIT = "count"\n'
        'MOVES = "stream_mps"\nSOURCE = "device_trace"\n\n\n'
        'def read(r):\n    return len(r.launches["gdn"])\n')
    b["workloads"].append({"name": "rgb192.stream8", "config": "rgb192",
                           "traffic": "stream8", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "gdn_launches.stream", "unit": "count",
                           "better": "lower", "source": "device_trace",
                           "layer": "Kernel GDN (ops/gdn.py, csrc/gdn.cu)",
                           "moves": "stream_mps",
                           "workloads": ["rgb192.stream8"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(b))
    cell = registry.Cell("rgb192.stream8", bench_path=str(path),
                         data_dir=str(data))
    assert cell.config["conv_channels"] == 192
    assert cell.traffic["batch"] == 8
    assert "gdn_launches.stream" in [m["name"] for m in cell.per_layer]

    class R:
        launches = {"gdn": [1.0] * 11}
    assert cell.reader("gdn_launches.stream").read(R) == 11


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        registry.Cell("no.such.cell")
