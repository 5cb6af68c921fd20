"""A configuration, a traffic mix, an input kind, a cell and a per-layer
metric added by new files and new entries alone: the harness runs the new
cell and reports the new metric without an edit to any file it had."""

from __future__ import annotations

import json
import shutil

import torch

from benchmark.harness import core, spec
from benchmark.tests.conftest import ROOT

# a new input kind: star graphs (a hub and its leaves), in the residue graphs' layout
STARS = '''
import numpy as np
import torch

from benchmark.inputs.residue_graphs import DATASET, Graphs, entries  # noqa: F401


def make(count, traffic, config, seed, device):
    leaves = int(traffic["leaves"])
    gen = torch.Generator(device=device).manual_seed(seed)
    nodes = np.full(count, leaves + 1)
    edges = np.tile(np.stack([np.zeros(leaves, dtype=np.int64), np.arange(1, leaves + 1)], axis=1), (count, 1))
    x = torch.randn(count * (leaves + 1), int(config["node_features"]), generator=gen, device=device)
    pos = torch.randn(count * (leaves + 1), 3, generator=gen, device=device)
    attr = torch.randn(count * leaves, int(config["edge_features"]), generator=gen, device=device)
    y = (np.arange(count) % 2).astype(np.float32)
    return Graphs(x.cpu().numpy(), pos.cpu().numpy(), edges, attr.cpu().numpy(), nodes, np.full(count, leaves), y)
'''


def _bench_copy(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench_dir, ignore=shutil.ignore_patterns("__pycache__", ".cache", "out"))
    return bench_dir, json.loads((ROOT / "BENCHMARK.json").read_text())


def test_new_cell_and_metric_from_files(tmp_path):
    bench_dir, bench = _bench_copy(tmp_path)
    config = json.loads((ROOT / "benchmark/configs/vanilla_residue.json").read_text())
    (bench_dir / "configs/vanilla_small_edges.json").write_text(json.dumps({**config, "edge_features": 3}))
    (bench_dir / "workloads/train_b4_small.json").write_text(
        json.dumps({"phase": "train", "inputs": "residue_graphs", "graphs": {"sizes": [[10, 20], [6, 9]]}, "batch_size": 4, "batches": 3, "epochs_per_call": 1, "warmup_calls": 1})
    )
    (bench_dir / "limits/vanilla_small_edges.train.json").write_text(json.dumps({"limits": {"forward_loss_gap": 1e-4, "change_gap": 1e-2}}))
    (bench_dir / "metrics/trainer.passes_per_call.py").write_text(
        "def read(ctx, phase):\n    return len(ctx.passes) / ctx.calls if phase == ctx.phase else None\n"
    )
    bench["configs"].append({"name": "vanilla_small_edges", "source": "https://github.com/DeepRank/deeprank2", "file": "benchmark/configs/vanilla_small_edges.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "vanilla_small_edges.train", "config": "vanilla_small_edges", "traffic": "train_b4_small", "chips": 1, "why": "test"})
    next(m for m in bench["end_to_end"] if m["name"] == "train_samples_per_s")["workloads"].append("vanilla_small_edges.train")
    bench["per_layer"].append(
        {"name": "trainer.passes_per_call.train", "unit": "passes", "better": "lower", "source": "program_span", "layer": "Trainer", "moves": "train_samples_per_s", "workloads": ["vanilla_small_edges.train"]}
    )
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("vanilla_small_edges.train", tmp_path, bench_dir)
    result = core.run_cell(cell, 9, 0.2, True, torch.device("cpu"))["result"]
    assert result["correct"] is True
    assert result["metrics"]["trainer.passes_per_call.train"]["value"] == 2.0  # the epoch-0 forward and one epoch


def test_shuffled_traffic_and_new_input_kind_from_files(tmp_path):
    """The users' default ``shuffle=True`` and trainer and dataset arguments
    from the files, on graphs of an input kind that only a new file
    defines; the reference follows the train pass in the order it took."""
    bench_dir, bench = _bench_copy(tmp_path)
    (bench_dir / "inputs/star_graphs.py").write_text(STARS)
    config = json.loads((ROOT / "benchmark/configs/vanilla_residue.json").read_text())
    config.update(trainer_args={"class_weights": False}, dataset_args={"edge_features": ["attributes"]})
    (bench_dir / "configs/vanilla_stars.json").write_text(json.dumps(config))
    (bench_dir / "workloads/train_b4_stars_shuffled.json").write_text(
        json.dumps({"phase": "train", "inputs": "star_graphs", "leaves": 5, "batch_size": 4, "batches": 3, "epochs_per_call": 1, "warmup_calls": 1, "train_args": {"shuffle": True}})
    )
    limits = {"forward_loss_gap": 1e-4, "step_loss_gap": 1e-4, "step1_effect_gap": 1e-3, "change_gap": 1e-2}
    (bench_dir / "limits/vanilla_stars.train_shuffled.json").write_text(json.dumps({"limits": limits}))
    bench["configs"].append({"name": "vanilla_stars", "source": "https://github.com/DeepRank/deeprank2", "file": "benchmark/configs/vanilla_stars.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "vanilla_stars.train_shuffled", "config": "vanilla_stars", "traffic": "train_b4_stars_shuffled", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("vanilla_stars.train_shuffled", tmp_path, bench_dir)
    seen = []
    from deeprank2_tpu_torch.trainer import Trainer

    original = Trainer._iter_batches

    def spy(self, dataset, batch_size, shuffle, rng, prefetch=2):
        seen.append(shuffle)
        return original(self, dataset, batch_size, shuffle, rng, prefetch)

    try:
        Trainer._iter_batches = spy
        out = core.run_cell(cell, 2**31 + 17, 0.2, False, torch.device("cpu"))
    finally:
        Trainer._iter_batches = original
    assert True in seen  # the train passes ran shuffled
    result = out["result"]
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == set(limits)
