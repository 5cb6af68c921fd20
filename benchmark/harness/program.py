"""The system under test, ``deeprank2_tpu_torch``, driven as a user drives
it: the inputs laid out in a ``utils/store.py:MemoryStore`` in the deeprank
layout, read by the port's own ``GraphDataset``/``GridDataset``, and a
``Trainer`` whose ``train``/``test`` the window calls. Weights reach it by
public routes: ``trainer.model.load_state_dict`` before training, a
checkpoint written with ``utils/checkpoint.py:save_checkpoint`` and passed
as ``pretrained_model`` for scoring. The port is imported here alone, inside
functions, never when the harness is imported."""

from __future__ import annotations

import math
import os
from pathlib import Path

import torch

TARGET = "binary"


def _store(entries) -> object:
    from deeprank2_tpu_torch.utils.store import MemoryStore

    store = MemoryStore()
    for name, datasets in entries:
        for path, value in datasets.items():
            store.create_dataset(f"{name}/{path}", data=value)
    return store


def entry_names(count: int) -> list[str]:
    """Names that the store lists in the order the inputs were made."""
    width = max(5, len(str(count)))
    return [f"entry_{i:0{width}d}" for i in range(count)]


def dataset(kind, inputs, args: dict | None = None):
    """The port's dataset of the input kind (its ``DATASET``) over the
    inputs, held in a ``MemoryStore``; ``args``: the configuration's
    ``dataset_args``."""
    from deeprank2_tpu_torch import dataset as datasets

    store = _store(kind.entries(inputs, entry_names(inputs.count)))
    return getattr(datasets, kind.DATASET)(hdf5_path=store, target=TARGET, task="classif", use_tqdm=False, **(args or {}))


def capture_exporter(directory: str, seed: int, sample: int = 16):
    """An output exporter of the benchmark's own. While ``keep`` is
    ``"all"`` it keeps references to every pass's outputs and reported loss;
    while it is ``"sample"``, to a sample of ``sample`` passes drawn from
    ``seed`` (a reservoir) and the last pass; otherwise it only counts
    passes and non-finite pass losses."""
    import random

    from deeprank2_tpu_torch.utils.exporters import OutputExporter

    class Capture(OutputExporter):
        def __init__(self):
            super().__init__(directory)
            self.keep: str | None = None
            self.passes: list[tuple] = []
            self.count = 0
            self.sampled = 0
            self.nonfinite = 0
            self.last: tuple | None = None
            self._draw = random.Random(seed)

        def process(self, pass_name, epoch_number, entry_names, output_values, target_values, loss):  # noqa: ARG002
            self.count += 1
            if loss is None or not math.isfinite(loss):
                self.nonfinite += 1
            item = (pass_name, epoch_number, entry_names, output_values, loss)
            if self.keep == "all":
                self.passes.append(item)
            elif self.keep == "sample":
                self.sampled += 1
                if len(self.passes) < sample:
                    self.passes.append(item)
                else:
                    slot = self._draw.randrange(self.sampled)
                    if slot < sample:
                        self.passes[slot] = item
                self.last = item

        def kept(self) -> list[tuple]:
            return self.passes + ([self.last] if self.last is not None and self.last not in self.passes else [])

    return Capture()


def port_class(name: str):
    """A model class of the port by its dotted path under ``neuralnets``."""
    import importlib

    module, _, cls = name.rpartition(".")
    return getattr(importlib.import_module(f"deeprank2_tpu_torch.neuralnets.{module}"), cls)


def train_trainer(model_cls, data, weights: dict, exporter, seed: int, device: torch.device, args: dict | None = None):
    """A Trainer on the training set (``args``: the configuration's
    ``trainer_args``), its model's weights replaced by the benchmark's, with
    the default optimizer (Adam, lr 1e-3, weight decay 1e-5) configured on
    them."""
    from deeprank2_tpu_torch.trainer import Trainer

    trainer = Trainer(model_cls, dataset_train=data, output_exporters=[exporter], seed=seed, device=device, **(args or {}))
    trainer.model.load_state_dict({k: v.to(device) for k, v in weights.items()})
    trainer.configure_optimizers()
    return trainer


def score_trainer(model_cls, data, weights: dict, exporter, config: dict, tmpdir: Path, device: torch.device, args: dict | None = None):
    """A Trainer that scores the test set with a pretrained model: the
    benchmark's weights in a checkpoint under ``tmpdir``, in the Trainer's
    checkpoint schema (its clustering method the dataset's);
    ``args``: the configuration's ``trainer_args``."""
    from deeprank2_tpu_torch.ops import losses, optim
    from deeprank2_tpu_torch.trainer import Trainer
    from deeprank2_tpu_torch.utils.checkpoint import save_checkpoint

    path = tmpdir / "pretrained.pth.tar"
    features = getattr(data, "features", None)
    state = {
        "data_type": type(data).__name__,
        "model_state": {k: v.cpu() for k, v in weights.items()},
        "optimizer": optim.Adam,
        "optimizer_state": None,
        "lossfunction": losses.CrossEntropyLoss(),
        "target": TARGET,
        "target_transform": False,
        "task": "classif",
        "classes": [0, 1],
        "classes_to_index": {0: 0, 1: 1},
        "class_weights": False,
        "batch_size_train": None,
        "batch_size_test": None,
        "val_size": None,
        "test_size": None,
        "lr": float(config["optimizer"]["lr"]),
        "weight_decay": float(config["optimizer"]["weight_decay"]),
        "epoch_saved_model": 0,
        "subset": None,
        "shuffle": False,
        "clustering_method": getattr(data, "clustering_method", None),
        "node_features": getattr(data, "node_features", None),
        "edge_features": getattr(data, "edge_features", None),
        "features": features,
        "features_transform": None,
        "means": None,
        "devs": None,
        "cuda": device.type == "cuda",
        "ngpu": int(device.type == "cuda"),
    }
    save_checkpoint(state, str(path))
    return Trainer(model_cls, dataset_test=data, pretrained_model=str(path), output_exporters=[exporter], device=device, **(args or {}))


def snapshot(trainer) -> dict:
    """Host copies of the model's parameters and the optimizer's first and
    second moments, by parameter name."""
    names = [n for n, _ in trainer.model.named_parameters()]
    params = [p for g in trainer.optimizer.param_groups for p in g["params"]]
    by_id = {id(p): n for n, p in trainer.model.named_parameters()}
    state = trainer.optimizer.state
    out = {"params": {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()}, "m": {}, "v": {}}
    for p in params:
        s = state.get(p, {})
        if "m" in s:
            out["m"][by_id[id(p)]] = s["m"].detach().cpu().clone()
            out["v"][by_id[id(p)]] = s["v"].detach().cpu().clone()
    out["names"] = names
    return out


def set_cache_dirs(root: Path) -> None:
    """The port keeps its kernel cache inside the checkout
    (``deeprank2_tpu_torch/_kernels``); torch's extension builder and Triton
    get fixed directories inside the checkout too."""
    cache = root / "benchmark" / ".cache"
    os.environ.update({"TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"), "TRITON_CACHE_DIR": str(cache / "triton")})


def build_kernels(sources: list[str]) -> float:
    """Build (or load from the port's cache) the CUDA sources a cell runs;
    the seconds it took."""
    import time

    if not sources:
        return 0.0
    from deeprank2_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(list(sources))
    return time.perf_counter() - t0
