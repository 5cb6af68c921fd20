"""The port Trainer's spans and counters (deeprank2_tpu_torch/trainer.py):
each span in a CPU ``torch.profiler`` trace of ``Trainer.train``, once a
batch or once a pass; the counters of ``pass_stats`` and how they nest in
the coarse ``loop_s`` and ``seconds``; a cached batch reporting no collate
time (it repeated the first collate's before); and the drain's readback,
moved ahead of the export loop, leaving the exporters' outputs bit for bit
as the per-batch reads gave them.

The Trainer runs VanillaNetwork on synthetic graphs held in memory
(``parallel/probes.py:in_memory_dataset``), 24 graphs in batches of 8."""

from __future__ import annotations

import copy
import json
from collections import Counter

import numpy as np
import pytest
import torch

from deeprank2_tpu_torch import trainer as port_trainer
from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetwork
from deeprank2_tpu_torch.ops.synthetic import synthetic_entries
from deeprank2_tpu_torch.parallel.probes import in_memory_dataset
from deeprank2_tpu_torch.trainer import Trainer

GRAPHS, BATCH = 24, 8
BATCHES = GRAPHS // BATCH
COUNTERS = ("wait_s", "forward_s", "backward_s", "readback_s", "export_s")
MAIN_SPANS = ("trainer.wait_batch", "trainer.forward", "trainer.backward", "trainer.readback", "trainer.export")


class Outputs:
    """An output exporter that keeps each pass's names and outputs."""

    def __init__(self):
        self.passes = []

    def __enter__(self):
        return self

    def __exit__(self, *exc_info) -> None:
        pass

    def is_compatible_with(self, output_data_shape, target_data_shape=None) -> bool:  # noqa: ARG002
        return True

    def process(self, pass_name, epoch_number, entry_names, output_values, target_values, loss) -> None:
        self.passes.append((pass_name, epoch_number, list(entry_names), output_values, target_values, loss))


def _trainer(exporter=None) -> Trainer:
    dataset = in_memory_dataset(synthetic_entries(GRAPHS, 12, 5, 3, seed=3))
    return Trainer(VanillaNetwork, dataset_train=dataset, device="cpu", seed=5, output_exporters=[exporter] if exporter else None)


def _all_threads() -> dict:
    """``torch.profiler.profile``'s option that records the loader's thread too."""
    from torch._C._profiler import _ExperimentalConfig

    return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}


def test_trace_holds_each_span_once_a_batch_or_a_pass():
    from torch.profiler import ProfilerActivity, profile

    trainer = _trainer()
    with profile(activities=[ProfilerActivity.CPU], **_all_threads()) as prof:
        trainer.train(nepoch=2, batch_size=BATCH, shuffle=True, filename=None)
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith(("trainer.", "loader."))]
    counts = Counter(e.name() for e in events)
    passes = 3  # the epoch-0 forward and two shuffled train passes
    assert counts["trainer.wait_batch"] == counts["trainer.forward"] == passes * BATCHES
    assert counts["trainer.backward"] == 2 * BATCHES
    assert counts["trainer.readback"] == counts["trainer.export"] == passes
    # every batch is collated afresh: the epoch-0 forward's fill the cache, the shuffled passes' bypass it
    assert counts["loader.collate"] == passes * BATCHES
    assert "loader.pin" not in counts and "loader.stage" not in counts  # pinning and staging are a card's
    main = {e.start_thread_id() for e in events if e.name() in MAIN_SPANS}
    loader = {e.start_thread_id() for e in events if e.name().startswith("loader.")}
    assert len(main) == 1 and loader and not loader & main  # a producer thread a pass
    # no span is a device event, nor adds one
    assert all(str(e.device_type()).endswith("CPU") for e in events)


def test_profile_dir_trace_holds_the_spans(tmp_path):
    trainer = _trainer()
    trainer.train(nepoch=1, batch_size=BATCH, shuffle=True, filename=None, profile_dir=str(tmp_path))
    trace = json.loads((tmp_path / "epoch1.trace.json").read_text())
    counts = Counter(e["name"] for e in trace["traceEvents"] if e.get("name", "").startswith(("trainer.", "loader.")))
    assert counts == {"trainer.wait_batch": BATCHES, "trainer.forward": BATCHES, "trainer.backward": BATCHES, "trainer.readback": 1, "trainer.export": 1, "loader.collate": BATCHES}


@pytest.mark.parametrize("shuffle", [False, True], ids=["cached", "shuffled"])
def test_counters_nest_in_the_pass(shuffle):
    trainer = _trainer()
    trainer.train(nepoch=2, batch_size=BATCH, shuffle=shuffle, filename=None)
    assert [(p["pass"], p["epoch"]) for p in trainer.pass_stats] == [("training", 0), ("training", 1), ("training", 2)]
    for p in trainer.pass_stats:
        assert p["batches"] == BATCHES
        assert all(p[k] >= 0 for k in COUNTERS)
        assert p["wait_s"] + p["forward_s"] + p["backward_s"] <= p["loop_s"]
        assert p["readback_s"] + p["export_s"] <= p["seconds"] - p["loop_s"]
        assert all(v >= 0 for v in p["collate_s"]) and p["pin_s"] == []  # no pinning without a card
        assert len(p["batch_bytes"]) == BATCHES and min(p["batch_bytes"]) > 0
    assert trainer.pass_stats[0]["backward_s"] == 0.0  # the epoch-0 forward runs no backward
    assert all(p["forward_s"] > 0 for p in trainer.pass_stats)
    assert all(p["backward_s"] > 0 for p in trainer.pass_stats[1:])


def test_cache_hits_report_no_collate_time():
    """A batch from the collate cache counts one hit and no collate or pin
    time (the cached stats once repeated the first collate's time)."""
    trainer = _trainer()
    trainer.train(nepoch=2, batch_size=BATCH, shuffle=False, filename=None)
    first, *cached = trainer.pass_stats
    assert first["cache_hits"] == 0 and len(first["collate_s"]) == BATCHES
    for p in cached:
        assert p["cache_hits"] == p["batches"] == BATCHES
        assert p["collate_s"] == [] and p["pin_s"] == []
        assert p["batch_bytes"] == first["batch_bytes"]  # a property of the batch, kept with it


def test_shuffled_passes_collate_every_batch():
    trainer = _trainer()
    trainer.train(nepoch=2, batch_size=BATCH, shuffle=True, filename=None)
    for p in trainer.pass_stats[1:]:
        assert p["cache_hits"] == 0
        assert len(p["collate_s"]) == p["batches"] == BATCHES
        assert all(v > 0 for v in p["collate_s"])
    fresh = trainer.pass_stats[1]["collate_s"]
    assert trainer.pass_stats[2]["collate_s"] != fresh  # timed afresh, not repeated


def test_counters_stay_put_outside_a_pass():
    """A step called outside a pass (as a checkpoint reload's check does)
    adds to no reported pass."""
    trainer = _trainer()
    trainer.train(nepoch=1, batch_size=BATCH, shuffle=False, filename=None)
    before = copy.deepcopy(trainer.pass_stats[-1])
    batch, _, _ = next(iter(trainer._iter_batches(trainer.dataset_train, BATCH, False, None)))
    trainer._eval_step(batch)
    assert trainer.pass_stats[-1] == before


def test_exports_are_the_per_batch_reads_bit_for_bit(monkeypatch):
    """The drain reads every batch's predictions in one copy before the
    export loop; the exporters get, bit for bit and in the same types, what
    the per-batch reads inside the loop gave."""
    per_batch = []
    read_back = port_trainer._read_back

    def both(pending):
        losses, preds = read_back(pending)
        old = [p[1].float().cpu().numpy() for p in pending]
        per_batch.append((torch.stack([p[0].float() for p in pending]).cpu().numpy(), old, [p[2] for p in pending], [p[3] for p in pending]))
        assert len(preds) == len(old)
        for new, was in zip(preds, old):
            assert new.dtype == was.dtype == np.float32 and new.shape == was.shape
            assert np.array_equal(new.view(np.uint32), was.view(np.uint32))
        return losses, preds

    monkeypatch.setattr(port_trainer, "_read_back", both)
    exporter = Outputs()
    trainer = _trainer(exporter)
    trainer.train(nepoch=2, batch_size=BATCH, shuffle=True, filename=None)
    assert len(exporter.passes) == len(per_batch) == 3
    for (_, _, names, outputs, targets, loss), (losses, old, batch_names, stats) in zip(exporter.passes, per_batch):
        want_out, want_tgt, want_names = [], [], []
        for pred, nm, st in zip(old, batch_names, stats):
            out, tgt, kept = trainer._export_outputs(pred, st["y_host"], st["y_mask_host"], nm)
            want_out += out
            want_tgt += tgt
            want_names += kept
        assert names == want_names and outputs == want_out and targets == want_tgt
        assert all(type(v) is float for row in outputs for v in row)
        n_valid = [st["n_valid"] for st in stats]
        assert loss == sum(float(v) * n for v, n in zip(losses, n_valid)) / sum(n_valid)


@pytest.mark.parametrize("shapes", [[(8, 2), (8, 2), (5, 2)], [(8,), (3,)], [(8, 1)]], ids=["classif", "regress", "one_batch"])
def test_read_back_splits_by_batch(shapes):
    gen = torch.Generator().manual_seed(0)
    pending = [(torch.rand((), generator=gen), torch.randn(s, generator=gen), [], {}) for s in shapes]
    losses, preds = port_trainer._read_back(pending)
    assert losses.dtype == np.float32 and np.array_equal(losses, np.array([float(p[0]) for p in pending], dtype=np.float32))
    assert [p.shape for p in preds] == shapes
    for got, (_, pred, _, _) in zip(preds, pending):
        assert np.array_equal(got, pred.numpy())
    assert port_trainer._read_back([])[1] == []
