"""The per-layer metrics that read the Trainer's span counters
(``Trainer.pass_stats``: ``wait_s``, ``forward_s``, ``backward_s``,
``readback_s``, ``export_s``, ``collate_s``, ``pin_s``), and the shuffled
cell ``vanilla_residue.train_shuffled``, whose traffic, limits and readers
are files while ``BENCHMARK.json`` holds it back (its rate spreads wider
than ``train_samples_per_s``'s bound admits): every metric read in a traced
run of each cell that lists it, on the CPU at tiny sizes; nothing read, and
nothing raised, on pass statistics from before the counters."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark.harness import spec
from benchmark.tests.conftest import ROOT, run_tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
STEMS = (
    "loader.wait_ms_per_batch",
    "step.forward_host_ms_per_batch",
    "step.backward_host_ms_per_batch",
    "trainer.readback_ms_per_batch",
    "trainer.export_ms_per_batch",
    "loader.collate_ms_per_batch",
    "loader.pin_ms_per_batch",
)
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["name"].startswith(STEMS)]
SHUFFLED = "vanilla_residue.train_shuffled"
SHUFFLED_METRICS = [
    {"name": f"{stem}.train.shuffled", "unit": "ms", "better": "lower", "source": "program_span", "layer": "test", "moves": "train_samples_per_s", "workloads": [SHUFFLED]}
    for stem in STEMS
]


def _with_shuffled(root) -> object:
    """``root`` with ``BENCHMARK.json`` and the shuffled cell's entries:
    the cell, listed by its rate and the vanilla train cell's metrics, and
    a span metric of each counter."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": SHUFFLED, "config": "vanilla_residue", "traffic": "train_b1024_ppi_shuffled", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m.get("workloads") == ["vanilla_residue.train"] and not m["name"].startswith(STEMS):
            m["workloads"].append(SHUFFLED)
    bench["per_layer"] += SHUFFLED_METRICS
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark").symlink_to(ROOT / "benchmark")  # the configurations' files
    return root


def _stem(name: str) -> str:
    return next(s for s in STEMS if name.startswith(f"{s}."))


def _listed(cell: str) -> set[str]:
    return {m["name"] for m in SPAN_METRICS + SHUFFLED_METRICS if cell in m["workloads"]}


def test_the_span_metrics_and_their_cells():
    assert len(SPAN_METRICS) == 14
    assert all(m["source"] == "program_span" and m["unit"] == "ms" and len(m["workloads"]) == 1 for m in SPAN_METRICS)
    assert {m["name"].rsplit("_per_batch.", 1)[1] for m in SPAN_METRICS} == {"train", "train.grids", "score"}
    assert SHUFFLED not in {w["name"] for w in BENCH["workloads"]}
    assert {_stem(n) for n in _listed("cnn_grid.score")} == set(STEMS[:5]) - {"step.backward_host_ms_per_batch"}
    for cell in ("vanilla_residue.train", "cnn_grid.train"):
        assert {_stem(n) for n in _listed(cell)} == set(STEMS[:5])


@pytest.mark.parametrize("cell", ["vanilla_residue.train", "cnn_grid.train", "cnn_grid.score", SHUFFLED])
def test_span_metrics_read_in_a_traced_run(cell, tmp_path):
    result = run_tiny(cell, trace=True, root=_with_shuffled(tmp_path) if cell == SHUFFLED else ROOT)["result"]
    assert result["correct"] is True, result["checks"]
    want = _listed(cell)
    if cell == SHUFFLED:
        want.discard("loader.pin_ms_per_batch.train.shuffled")  # a card's: nothing is pinned on the CPU
    assert want <= set(result["metrics"])
    assert all(result["metrics"][n]["value"] >= 0 for n in want)


def test_the_shuffled_cell_loads_with_its_limits_and_metrics(tmp_path):
    cell = spec.load_cell(SHUFFLED, _with_shuffled(tmp_path))
    assert cell.phase == "train" and cell.chips == 1
    assert cell.traffic["train_args"] == {"shuffle": True}
    base = spec.load_cell("vanilla_residue.train", ROOT)
    assert cell.config == base.config
    assert {k: v for k, v in cell.traffic.items() if k not in ("train_args", "why")} == {k: v for k, v in base.traffic.items() if k != "why"}
    assert set(cell.limits) == set(base.limits)
    assert [m.name for m in cell.end_to_end] == ["train_samples_per_s", "peak_device_mem_gib", "setup_s"]
    names = {m.name for m in cell.per_layer}
    assert _listed(SHUFFLED) <= names
    assert {"trainer.loop_ms_per_batch.train", "trainer.drain_ms_per_batch.train", "device.idle_share.train"} <= names


def _ctx(passes, phase="train"):
    return SimpleNamespace(phase=phase, passes=passes)


def _read(stem: str, ctx, phase="train"):
    reader, _ = spec.metric_reader(f"{stem}.{phase}")
    return reader.read(ctx, phase)


def test_readers_on_counters():
    new = {"pass": "training", "epoch": 1, "kind": "train", "seconds": 0.05, "loop_s": 0.03, "batches": 2, "wait_s": 0.002, "forward_s": 0.008,
           "backward_s": 0.01, "readback_s": 0.006, "export_s": 0.01, "collate_s": [0.1, 0.3], "pin_s": [0.02, 0.04], "cache_hits": 0}
    cached = {**new, "collate_s": [], "pin_s": [], "cache_hits": 2}
    eval_pass = {**new, "kind": "eval", "wait_s": 9.0}
    ctx = _ctx([eval_pass, new, cached])
    assert _read("loader.wait_ms_per_batch", ctx) == pytest.approx(1e3 * 0.004 / 4)  # train passes alone
    assert _read("step.forward_host_ms_per_batch", ctx) == pytest.approx(1e3 * 0.016 / 4)
    assert _read("step.backward_host_ms_per_batch", ctx) == pytest.approx(1e3 * 0.02 / 4)
    assert _read("trainer.readback_ms_per_batch", ctx) == pytest.approx(1e3 * 0.012 / 4)
    assert _read("trainer.export_ms_per_batch", ctx) == pytest.approx(1e3 * 0.02 / 4)
    assert _read("loader.collate_ms_per_batch", ctx) == pytest.approx(200.0)  # over the fresh batches alone
    assert _read("loader.pin_ms_per_batch", ctx) == pytest.approx(30.0)
    assert _read("loader.collate_ms_per_batch", _ctx([cached])) is None  # every batch from the cache
    assert _read("loader.wait_ms_per_batch", ctx, "score") is None  # another phase


def test_readers_on_pass_statistics_from_before_the_counters():
    """The parent program's passes (``collate_s`` repeating a cached
    batch's first time, no other counter): every reader returns None."""
    old = {"pass": "training", "epoch": 1, "kind": "train", "seconds": 0.05, "loop_s": 0.03, "batches": 2, "collate_s": [0.1, 0.1], "batch_bytes": [8, 8]}
    for stem in STEMS:
        assert _read(stem, _ctx([old, old])) is None, stem
