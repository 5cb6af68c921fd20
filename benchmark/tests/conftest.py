"""Tiny sizes for running the harness on the CPU through the port's plain
paths (its CUDA kernels need the card)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "residue_graphs": {"batch_size": 8, "batches": 2, "graphs": {"sizes": [[12, 30], [7, 12], [16, 50]]}, "epochs_per_call": 2},
    "grids": {"batch_size": 2, "batches": 2, "epochs_per_call": 1, "warmup_calls": 1},
}


def tiny_cell(name: str, root: Path = ROOT, bench_dir: Path | None = None):
    import json

    from benchmark.harness import spec

    bench_dir = bench_dir or spec.BENCH_DIR
    bench = json.loads((root / "BENCHMARK.json").read_text())
    traffic = next(w["traffic"] for w in bench["workloads"] if w["name"] == name)
    kind = json.loads((bench_dir / "workloads" / f"{traffic}.json").read_text())["inputs"]
    return spec.load_cell(name, root, bench_dir, traffic_override=TINY[kind])


def run_tiny(name: str, trace: bool = False, seconds: float = 0.2, seed: int = 2**31 + 11, **kwargs):
    import torch

    from benchmark.harness import core

    return core.run_cell(tiny_cell(name, **kwargs), seed, seconds, trace, torch.device("cpu"))


@pytest.fixture
def cpu_cell():
    return run_tiny
