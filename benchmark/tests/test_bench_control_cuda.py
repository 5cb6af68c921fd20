"""The control on the card: the reference computed in TF32 (the precision
below the configurations' f32 with TF32 off), put in the program's place,
comes out as not correct under each cell's limits; at a size a test run
holds. Needs the card (``-m cuda``); run from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda benchmark/tests/test_bench_control_cuda.py -q
"""

from __future__ import annotations

import json

import pytest

from benchmark.tests.conftest import ROOT

SMALL = {
    "residue_graphs": {"batch_size": 256, "batches": 2, "epochs_per_call": 1, "warmup_calls": 0},
    "grids": {"batch_size": 32, "batches": 2, "epochs_per_call": 1, "warmup_calls": 0},
}
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark.harness import core, gate, spec

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = next(w["traffic"] for w in bench["workloads"] if w["name"] == cell)
    kind = json.loads((spec.BENCH_DIR / "workloads" / f"{traffic}.json").read_text())["inputs"]
    loaded = spec.load_cell(cell, ROOT, traffic_override=SMALL[kind])
    for seed in (31, 32, 33):
        out = core.run_cell(loaded, seed, 0.5, False, torch.device("cuda"), controls=True)
        control_correct, checks = gate.judge(out["extras"]["readings"]["control_tf32"], loaded.limits)
        assert control_correct is False, checks
