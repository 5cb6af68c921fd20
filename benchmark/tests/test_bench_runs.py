"""The harness end to end on the CPU at tiny sizes, through the port's
plain paths: the result line's keys, the metrics of each kind of run, and
``correct`` true on the unbroken program."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT, run_tiny

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    out = run_tiny(cell, trace=trace)
    result = out["result"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"} and check["value"] <= check["limit"]
    names = set(result["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        phase = "train" if cell.endswith("train") else "score"
        assert {"trainer.loop_ms_per_batch", "trainer.drain_ms_per_batch", "step.mfu"} <= {n.split(f".{phase}")[0] for n in names}
    else:
        assert "setup_s" in names
        assert any(n.startswith("train_samples_per_s" if cell.endswith("train") else "score_samples_per_s") for n in names)
    json.dumps(result)


def test_refuses_without_cuda():
    """On a machine without a card the command prints no result and fails."""
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=False,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_fails_without_the_program(tmp_path):
    """With only BENCHMARK.json and the benchmark's files, a run cannot import
    the system under test and fails before any result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache", "out"))
    code = (
        "import sys, torch; sys.path.insert(0, '.');"
        "from benchmark.tests.conftest import tiny_cell; from benchmark.harness import core;"
        f"print(core.run_cell(tiny_cell({CELLS[0]!r}, root=__import__('pathlib').Path('.'), bench_dir=__import__('pathlib').Path('benchmark')), 3, 0.1, False, torch.device('cpu')))"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300, check=False, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert "deeprank2_tpu_torch" in proc.stderr
