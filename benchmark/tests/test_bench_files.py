"""Everything BENCHMARK.json names is found by name, and the file keeps to
the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.harness import spec
from benchmark.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_everything_it_names(cell):
    loaded = spec.load_cell(cell, ROOT)
    assert loaded.phase in spec.PHASES
    assert loaded.end_to_end and loaded.per_layer
    assert "setup_s" in [m.name for m in loaded.end_to_end]
    assert len(loaded.end_to_end) >= 2
    assert loaded.limits


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["reduced"] == config["reduced"] == []
    assert (spec.BENCH_DIR / "models" / f"{body['model']}.py").exists()
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_found_by_name(metric):
    reader, phase = spec.metric_reader(metric["name"])
    assert callable(reader.read)
    assert NAME.match(metric["name"])
    assert metric["better"] in ("lower", "higher")
    if "layer" in metric:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert phase is None or f".{phase}" in metric["name"]
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25


def test_reader_of_a_tagged_name():
    reader, phase = spec.metric_reader("trainer.loop_ms_per_batch.train.grids")
    assert phase == "train" and reader is not None
    assert spec.metric_reader("train_samples_per_s.grids")[1] is None
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric.train")


def test_names_and_workload_lists():
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert (spec.BENCH_DIR / "workloads" / f"{w['traffic']}.json").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in layer for layer in layers)
