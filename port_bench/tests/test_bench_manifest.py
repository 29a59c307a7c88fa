"""BENCHMARK.json against the benchmark's contract, and discovery by name:
a cell, a configuration, a traffic mix and a per-layer metric added as
files and entries alone, from a copy in a temporary directory."""

import json
import re
import shutil
from pathlib import Path

import pytest

from port_bench.harness import run_cell
from port_bench.manifest import Manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
        assert ".." not in word
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("port_bench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in names
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert {pair for pair in ((w["config"], w["traffic"])
                              for w in BENCH["workloads"])} and len(
        {(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == \
        len(BENCH["workloads"])


def test_every_cell_reports_what_it_must():
    man = Manifest()
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in man.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = man.per_layer(w["name"])
        assert per_layer
        for m in per_layer:
            assert m["moves"] in e2e
        assert (ROOT / "port_bench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "port_bench/limits" / f"{w['name']}.json").is_file()
    for m in BENCH["per_layer"]:
        assert (ROOT / "port_bench/metrics" / f"{m['name']}.py").is_file()


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric need
    new files and manifest entries only: the harness finds them by name."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "port_bench"
    shutil.copytree(ROOT / "port_bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((bench / "configs/custom_b64.json").read_text())
    cfg.update(name="custom_tiny", image=[32, 32], seq_len=2)
    cfg["model"]["base_ch"] = 4
    (bench / "configs/custom_tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic/train_tiny.json").write_text(json.dumps(
        {"kind": "train", "batch": 2, "pool": 6, "trace_seconds": 0.3}))
    (bench / "metrics/steps_seen.train.py").write_text(
        "def read(view):\n    return float(view.units)\n")
    data = json.loads((tmp_path / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "custom_tiny", "source": "a test",
                            "file": "port_bench/configs/custom_tiny.json",
                            "reduced": [], "why": "a test"})
    data["workloads"].append({"name": "custom_tiny.train_tiny",
                              "config": "custom_tiny",
                              "traffic": "train_tiny", "chips": 1,
                              "why": "a test"})
    data["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "model step",
                              "moves": "setup_s",
                              "workloads": ["custom_tiny.train_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    man = Manifest(root=tmp_path, bench_dir=bench)
    unjudged = run_cell("custom_tiny.train_tiny", 3, 0.2, False,
                        device="cpu", manifest=man)
    assert unjudged["correct"] is False       # no limits file: not correct
    assert unjudged["checks"]["update_gap"]["limit"] is None
    (bench / "limits/custom_tiny.train_tiny.json").write_text(json.dumps(
        {"limits": {"update_gap": 1.0, "bn_gap": 1.0,
                    "bn_gap_median": 1.0}}))
    traced = run_cell("custom_tiny.train_tiny", 3, 0.5, True, device="cpu",
                      manifest=man)
    assert traced["metrics"]["steps_seen.train"]["value"] >= 1
    assert traced["checks"]["update_gap"]["limit"] == 1.0
    assert traced["correct"] is True
    plain = run_cell("custom_tiny.train_tiny", 3, 0.5, False, device="cpu",
                     manifest=man)
    assert set(plain["metrics"]) == {"setup_s"}
    assert list(plain)[-1] == "checks"


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        Manifest().workload("no_such.cell")
