"""Training runtime (port of ``deeprank2_tpu/trainer.py``; reference:
deeprank2/trainer.py).

The same public surface: ``Trainer(neuralnet, dataset_train, dataset_val,
dataset_test, ...)``, ``train()``, ``test()``, ``configure_optimizers()``,
``set_lossfunction()``, checkpoint save/load, pretrained-model inference,
pre-clustering, class weights, early stopping, output exporters and
mid-training resume, on the port's models, collates and kernels:

- the Trainer runs on one device, CUDA unless ``device="cpu"``
  (:func:`deeprank2_tpu_torch.device.resolve_device`); the model is built
  there from a CPU generator seeded with ``seed``, and dropout draws from
  one generator on the device, seeded with ``seed`` too;
- a background thread reads and collates batches on the host (the port's
  collates with ``device="cpu"``) into pinned memory and copies the next
  batches to the card on a side stream; the compute stream waits on the
  copy's event, so the epoch never waits for the host on a copy;
- losses and predictions stay on the device during a pass and are read
  after it; the per-batch statistics come from the host arrays at collate
  time, so a train pass makes no host sync;
- the host work of a pass is cut into named spans (``_span``: a profiler
  range, on the clock of a ``torch.profiler`` trace, whose length is also
  added to the pass's ``pass_stats`` entry): the loader's ``loader.collate``,
  ``loader.pin`` and ``loader.stage`` on its thread, and on the caller's
  ``trainer.wait_batch``, ``trainer.forward``, ``trainer.backward``,
  ``trainer.readback`` and ``trainer.export``;
- checkpoints are ``torch.save`` files with the reference's 28-key schema
  (utils/checkpoint.py), which the JAX package reads as reference
  checkpoints; the port reads those, its own and the JAX package's.

Dispatch on the dataset and the model's class attributes, as in the JAX
package: a ``GridDataset`` trains a CNN (``neuralnet(num_features,
box_shape)``) on grid batches (``collate_grids``); on a ``GraphDataset``
every single-device graph layout is ported, the clustered block-sparse
(``clustered_blocksparse_batches``), graph-diagonal clustered
(``diag_clustered_batches``), block-sparse (``blocksparse_batches``),
blocked-edge (``blocked_edge_batches``), dense (``dense_batches``, with
clusters and edge weights where the model's markers ask for them) and COO
(the default) batches. Their tensors, those of the nested structures
included, are pinned, copied on the side stream and kept alive for the
compute stream alike.

Inside an initialized ``torch.distributed`` process group of more than one
rank (one process a rank, each on its own card: ``parallel/cluster.py``,
``parallel/launch.py``), two more modes run, as the JAX Trainer's on a mesh:

- ``data_parallel=True``: every rank shuffles with the same generator and
  collates its own shard of the sharded batch (per-shard capacity
  ``ceil(batch_size / D)``, the other capacities from every shard's
  requirements, ``ops/batch.py:collate_graphs_*_sharded``); the
  step is ``parallel/dp.py``'s (gradients and loss pmean'ed in one
  all-reduce, predictions gathered). Outside such a group the flag runs
  one device, as JAX's with one device;
- a ``graph_parallel`` model (``GINetBlockSparseGP``, ``GINetBlockSparseRing``)
  splits each batch's row tiles across the ranks (each builds its own part
  of the partitioned or ring collates, under the JAX Trainer's grow-only
  bucket keys); its replicated
  parameters' gradients are pmean'ed before the step. It cannot be combined
  with ``data_parallel`` (``ValueError``).

Rank 0 alone writes the exporters' files, the checkpoints and the
training-state snapshots; the other ranks compute the same losses.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import inspect
import logging
import os
import re
import warnings
from time import perf_counter
from typing import Any

import numpy as np
import torch

from deeprank2_tpu_torch.dataset import GraphDataset, GridDataset, _divide_dataset
from deeprank2_tpu_torch.device import resolve_device
from deeprank2_tpu_torch.domain import losstypes as losses
from deeprank2_tpu_torch.domain import targetstorage as targets
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax
from deeprank2_tpu_torch.ops import losses as loss_nn
from deeprank2_tpu_torch.ops import optim
from deeprank2_tpu_torch.ops import batch as batches
from deeprank2_tpu_torch.ops.batch import _auto_min_slot_nodes
from deeprank2_tpu_torch.parallel import cluster, comm, dp
from deeprank2_tpu_torch.utils.checkpoint import load_checkpoint, load_snapshot, save_checkpoint, save_snapshot, to_cpu
from deeprank2_tpu_torch.utils.community_pooling import community_detection, community_pooling_host
from deeprank2_tpu_torch.utils.earlystopping import EarlyStopping
from deeprank2_tpu_torch.utils.exporters import HDF5OutputExporter, OutputExporter, OutputExporterCollection
from deeprank2_tpu_torch.utils.store import open_store

_log = logging.getLogger(__name__)
_COLLATE_UID = iter(range(1 << 62))  # collate-cache dataset ids (never reused)

# the model markers that pick a layout, in the JAX Trainer's order of dispatch
_LAYOUTS = (
    ("clustered_blocksparse_batches", "clustered_blocksparse"),
    ("diag_clustered_batches", "diag_clustered"),
    ("blocksparse_batches", "blocksparse"),
    ("blocked_edge_batches", "blocked"),
    ("dense_batches", "dense"),
)

@contextlib.contextmanager
def _span(name: str, counters: dict | None = None, key: str | None = None):
    """A profiler range ``name`` (on the clock of a ``torch.profiler``
    trace's device events) whose host seconds (``perf_counter``) are added
    to ``counters[key]``, or appended where that is a list. It adds no
    device work, event or synchronisation."""
    # torch's RecordFunction through its C++ context: a fraction of the cost
    # of torch.profiler.record_function, and no annotation on the device's
    # timeline
    with torch._C._profiler._RecordFunctionFast(name):
        t0 = perf_counter()
        yield
        seconds = perf_counter() - t0
    if counters is not None:
        if isinstance(counters[key], list):
            counters[key].append(seconds)
        else:
            counters[key] += seconds


def _trim_lambda_source(candidate: str) -> str | None:
    """Trim trailing context (``}``, ``,``, enclosing ``)`` …) off a lambda
    source captured by regex from its defining line: the longest prefix that
    parses as a *pure lambda expression* (as the JAX package's)."""
    import ast

    for end in range(len(candidate), 6, -1):
        trimmed = candidate[:end].rstrip(", \t")
        try:
            tree = ast.parse(trimmed, mode="eval")
        except SyntaxError:
            continue
        if isinstance(tree.body, ast.Lambda):
            return trimmed
    return None


def _param_family(neuralnet) -> str | None:
    """The ``neuralnets/param_interop.py`` family of a model class."""
    from deeprank2_tpu_torch.neuralnets.cnn.model3d import CnnClassification, CnnRegression
    from deeprank2_tpu_torch.neuralnets.gnn.foutnet import FoutNet
    from deeprank2_tpu_torch.neuralnets.gnn.sgat import SGAT
    from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetwork

    for cls, family in ((VanillaNetwork, "vanilla"), (FoutNet, "foutnet"), (SGAT, "sgat"), (CnnClassification, "cnn"), (CnnRegression, "cnn")):
        if issubclass(neuralnet, cls):
            return family
    return None


def _is_structures(value) -> bool:
    """A tuple of nested dataclasses (the ring's off-diagonal buckets)."""
    return isinstance(value, tuple) and bool(value) and dataclasses.is_dataclass(value[0])


def _tensor_fields(batch) -> list[torch.Tensor]:
    """Every tensor of a batch dataclass, those of its nested dataclasses
    (the block-sparse and blocked-edge structures, the ring's tuple of
    buckets) included."""
    found = []
    for f in dataclasses.fields(batch):
        value = getattr(batch, f.name)
        if isinstance(value, torch.Tensor):
            found.append(value)
        elif dataclasses.is_dataclass(value):
            found += _tensor_fields(value)
        elif _is_structures(value):
            for v in value:
                found += _tensor_fields(v)
    return found


def _map_tensors(batch, fn):
    """A copy of a batch dataclass with ``fn`` applied to every tensor, in
    its nested dataclasses too (``dataclasses.replace`` builds the frozen
    structures anew); the static ints stay as they are."""
    changes = {}
    for f in dataclasses.fields(batch):
        value = getattr(batch, f.name)
        if isinstance(value, torch.Tensor):
            changes[f.name] = fn(value)
        elif dataclasses.is_dataclass(value):
            changes[f.name] = _map_tensors(value, fn)
        elif _is_structures(value):
            changes[f.name] = tuple(_map_tensors(v, fn) for v in value)
    return dataclasses.replace(batch, **changes)


def _read_back(pending: list[tuple]) -> tuple[np.ndarray, list[np.ndarray]]:
    """The pass's losses and each batch's predictions on the host, in
    float32: one copy of the stacked losses, one of the predictions
    concatenated (every batch of a pass has the model's output shape)."""
    if not pending:
        return np.zeros(0, np.float32), []
    losses = torch.stack([p[0].float() for p in pending]).cpu().numpy()
    preds = [p[1].float() for p in pending]
    flat = torch.cat(preds).cpu().numpy()
    return losses, np.split(flat, np.cumsum([len(p) for p in preds])[:-1])


class Trainer:
    """Trains, evaluates and tests neural networks on deeprank datasets.

    Args match the JAX package's (and the reference's, trainer.py:57-70),
    with ``device`` last: the Trainer runs there (CUDA when None; pass
    ``device="cpu"`` on a machine without one; inside a process group of
    several ranks a CUDA device is the rank's own card,
    ``parallel/cluster.py:rank_device``). ``cuda``/``ngpu`` are kept for
    signature parity: ``cuda=True`` or ``ngpu=1`` with a CPU device raises
    ``ValueError``, and so does ``ngpu > 1`` (one process drives one card;
    several cards train with ``data_parallel=True`` under a process group);
    the checkpoint records them as the run had them. ``data_parallel=True``
    shards each batch across the ranks of the process group (see the module
    docstring); a ``graph_parallel`` model with it raises ``ValueError``.
    """

    def __init__(  # noqa: C901, PLR0915
        self,
        neuralnet=None,
        dataset_train: GraphDataset | GridDataset | None = None,
        dataset_val: GraphDataset | GridDataset | None = None,
        dataset_test: GraphDataset | GridDataset | None = None,
        val_size: float | int | None = None,
        test_size: float | int | None = None,
        class_weights: bool = False,
        pretrained_model: str | None = None,
        cuda: bool = False,
        ngpu: int = 0,
        output_exporters: list[OutputExporter] | None = None,
        seed: int = 42,
        data_parallel: bool = False,
        collate_cache_batches: int = 256,
        device: str | torch.device | None = None,
    ):
        self.neuralnet = neuralnet
        self.pretrained_model = pretrained_model
        self.seed = seed
        self.data_parallel = data_parallel
        # non-shuffled loaders (validation/test, and shuffle=False training)
        # produce identical chunks every epoch; their collated (pinned) host
        # batches are cached. Bounded FIFO; 0 disables.
        self._collate_cache_capacity = collate_cache_batches
        self._collate_cache: dict[tuple, tuple] = {}

        if data_parallel and getattr(neuralnet, "graph_parallel", False):
            msg = "graph_parallel models cannot also use data_parallel=True"
            raise ValueError(msg)
        # the ranks of the default process group (1, 0 without one): data
        # parallelism shards batches over them, graph parallelism row tiles
        self._world, self._rank = comm.world()
        self._num_shards = self._world if data_parallel else 1

        self._init_datasets(dataset_train, dataset_val, dataset_test, val_size, test_size)

        if ngpu > 1:
            msg = f"ngpu={ngpu}: one process drives one card; train on several with data_parallel=True inside a torch.distributed process group (parallel/launch.py)"
            raise ValueError(msg)
        self.device = resolve_device(device)
        if self._world > 1 and self.device.type == "cuda" and self.device.index is None:
            self.device = cluster.rank_device()
        if (cuda or ngpu > 0) and self.device.type != "cuda":
            msg = f"cuda={cuda}, ngpu={ngpu} contradict device={self.device}"
            raise ValueError(msg)
        self.cuda = self.device.type == "cuda"
        self.ngpu = int(self.cuda)
        _log.info(f"Device set to {self.device}.")

        self._init_output_exporters(output_exporters)

        self.data_type = None
        self.batch_size_train = None
        self.batch_size_test = None
        self.shuffle = None
        self.model_load_state_dict = None
        self._prefetch = 2
        self.pass_stats: list[dict] = []
        self._counters: dict | None = None  # the running pass's (``_run_pass``)
        # dropout's generator, on the device; under data parallelism a CPU
        # generator of per-step seeds, from which each rank derives its own
        # (parallel/dp.py:shard_generator)
        self._rng = torch.Generator(device="cpu" if self._num_shards > 1 else self.device).manual_seed(seed)

        if self.pretrained_model is None:
            if self.dataset_train is None:
                msg = "No training data specified. Training data is required if there is no pretrained model."
                raise ValueError(msg)
            if self.neuralnet is None:
                msg = "No neural network specified. Specifying a model framework is required if there is no pretrained model."
                raise ValueError(msg)

            self._init_from_dataset(self.dataset_train)
            self.optimizer = None
            self.class_weights = class_weights
            self.subset = self.dataset_train.subset
            self.epoch_saved_model = None

            if self.target is None:
                msg = "No target set. You need to choose a target (set in the dataset) for training."
                raise ValueError(msg)

            self._load_model()

            if getattr(self.neuralnet, "needs_clusters", False) and self.clustering_method is None:
                msg = (
                    f"{self.neuralnet.__name__} pools over communities and needs preclustered data: "
                    'construct the dataset with clustering_method="mcl" (or "louvain").'
                )
                raise ValueError(msg)

            if self.clustering_method is not None:
                if self.clustering_method in ("mcl", "louvain"):
                    _log.info("Loading clusters")
                    self._precluster(self.dataset_train)
                    if self.dataset_val is not None:
                        self._precluster(self.dataset_val)
                    else:
                        _log.warning("No validation dataset given. Randomly splitting training set in training set and validation set.")
                        self.dataset_train, self.dataset_val = _divide_dataset(self.dataset_train, splitsize=self.val_size, rng=np.random.default_rng(self.seed))
                    if self.dataset_test is not None:
                        self._precluster(self.dataset_test)
                else:
                    msg = f"Invalid node clustering method: {self.clustering_method}. Please set clustering_method to 'mcl', 'louvain' or None."
                    raise ValueError(msg)
        else:
            if self.neuralnet is None:
                msg = "No neural network class found. Please add it to complete loading the pretrained model."
                raise ValueError(msg)
            if self.dataset_test is None:
                msg = "No dataset_test found. Please add it to evaluate the pretrained model."
                raise ValueError(msg)
            if self.dataset_train is not None:
                self.dataset_train = None
                _log.warning("Pretrained model loaded: dataset_train will be ignored.")
            if self.dataset_val is not None:
                self.dataset_val = None
                _log.warning("Pretrained model loaded: dataset_val will be ignored.")
            self._init_from_dataset(self.dataset_test)
            self._load_params()
            self._load_pretrained_model()

    # ------------------------------------------------------------------
    # Setup
    # ------------------------------------------------------------------
    def _init_output_exporters(self, output_exporters: list[OutputExporter] | None) -> None:
        if self._rank != 0:  # rank 0 alone writes
            self._output_exporters = OutputExporterCollection()
        elif output_exporters is not None:
            self._output_exporters = OutputExporterCollection(*output_exporters)
        else:
            self._output_exporters = OutputExporterCollection(HDF5OutputExporter("./output"))

    def _init_datasets(self, dataset_train, dataset_val, dataset_test, val_size, test_size) -> None:
        self._check_dataset_equivalence(dataset_train, dataset_val, dataset_test)
        self.dataset_train = dataset_train
        self.dataset_test = dataset_test
        self.dataset_val = dataset_val
        self.val_size = val_size
        self.test_size = test_size

        # one seeded generator for both splits: a resumed run re-derives the
        # same partitions, so trained entries never leak into val/test
        split_rng = np.random.default_rng(self.seed)
        if test_size is not None:
            if dataset_test is None:
                self.dataset_train, self.dataset_test = _divide_dataset(dataset_train, test_size, rng=split_rng)
            else:
                _log.warning("Test dataset was provided to Trainer; test_size parameter is ignored.")
        if val_size is not None:
            if dataset_val is None:
                self.dataset_train, self.dataset_val = _divide_dataset(self.dataset_train, val_size, rng=split_rng)
            else:
                _log.warning("Validation dataset was provided to Trainer; val_size parameter is ignored.")

    def _init_from_dataset(self, dataset) -> None:
        if isinstance(dataset, GraphDataset):
            self.clustering_method = dataset.clustering_method
            self.node_features = dataset.node_features
            self.edge_features = dataset.edge_features
            self.features = None
            self.features_transform = dataset.features_transform
            self.means = dataset.means
            self.devs = dataset.devs
        elif isinstance(dataset, GridDataset):
            self.clustering_method = None
            self.node_features = None
            self.edge_features = None
            self.features = dataset.features
            self.features_transform = None
            self.means = None
            self.devs = None
        else:
            msg = f"Incorrect `dataset` type provided: {type(dataset)}. Please provide a `GridDataset` or `GraphDataset` object instead."
            raise TypeError(msg)

        self.target = dataset.target
        self.target_transform = dataset.target_transform
        self.task = dataset.task
        self.classes = dataset.classes
        self.classes_to_index = dataset.classes_to_index

    def _load_model(self) -> None:
        self._put_model_to_device(self.dataset_train)
        self.configure_optimizers()
        self.set_lossfunction()

    def _check_dataset_equivalence(self, dataset_train, dataset_val, dataset_test) -> None:
        if dataset_train is None:
            if dataset_test is None and self.pretrained_model is None:
                msg = "Please provide at least a train or test dataset"
                raise ValueError(msg)
            return
        if not isinstance(dataset_train, GraphDataset | GridDataset):
            msg = f"train dataset is not the right type {type(dataset_train)}. Make sure it's either GraphDataset or GridDataset"
            raise TypeError(msg)
        if dataset_val is not None:
            self._check_dataset_value(dataset_train, dataset_val, "valid")
        if dataset_test is not None:
            self._check_dataset_value(dataset_train, dataset_test, "test")

    @staticmethod
    def _check_dataset_value(dataset_train, dataset_check, type_dataset: str) -> None:
        if dataset_check.train_source is None:
            msg = f"{type_dataset} dataset has train_source parameter set to None. Make sure to set it as a valid training data source."
            raise ValueError(msg)
        if dataset_check.train_source != dataset_train:
            msg = f"{type_dataset} dataset has different train_source parameter from Trainer. Make sure to assign equivalent train_source in Trainer."
            raise ValueError(msg)

    def _load_pretrained_model(self) -> None:
        self._put_model_to_device(self.dataset_test)
        state = self.model_load_state_dict
        if self._model_state_format == "jax":
            # the JAX package's parameter tree -> the reference's state_dict keys
            state = params_from_jax(state, _param_family(self.neuralnet))
        self.model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        # restore the optimizer and, from a port checkpoint, its state
        self.optimizer = self._optimizer_cls(self.model.parameters(), lr=self.lr, weight_decay=self.weight_decay)
        if self.opt_loaded_state_dict:
            self.optimizer.load_state_dict(self.opt_loaded_state_dict)

    def _precluster(self, dataset: GraphDataset) -> None:
        """Compute depth-0/depth-1 community clusters per entry and store them
        in the source HDF5 (reference: trainer.py:319-348). Under a process
        group rank 0 writes them while the others wait, and only once every
        rank has closed the file (HDF5 locks a file open for reading
        against a writer)."""
        if self._world > 1:
            torch.distributed.barrier()
            if self._rank == 0:
                self._write_clusters(dataset)
            torch.distributed.barrier()
            dataset._cache.clear()
        else:
            self._write_clusters(dataset)

    def _write_clusters(self, dataset: GraphDataset) -> None:
        for fname, mol in dataset.index_entries:
            data = dataset.load_one_graph(fname, mol)
            with open_store(fname, "a") as f5:
                grp = f5[mol]
                clust_grp = grp.require_group("clustering")
                if self.clustering_method.lower() in clust_grp:
                    del clust_grp[self.clustering_method.lower()]
                method_grp = clust_grp.create_group(self.clustering_method.lower())

                num_nodes = data["x"].shape[0]
                cluster0 = community_detection(data["edge_index"], num_nodes, method=self.clustering_method)
                method_grp.create_dataset("depth_0", data=cluster0)
                pooled_edges, num_clusters = community_pooling_host(cluster0, data["edge_index"])
                cluster1 = community_detection(pooled_edges, num_clusters, method=self.clustering_method)
                method_grp.create_dataset("depth_1", data=cluster1)
        dataset._cache.clear()

    def _layout(self) -> str:
        """The batch layout: ``"grid"`` for a grid dataset, else the model
        class's (``"clustered_blocksparse"``, ``"diag_clustered"``,
        ``"blocksparse"``, ``"blocked"``, ``"dense"`` or ``"coo"``)."""
        if not self._is_graph():
            return "grid"
        return next((layout for attr, layout in _LAYOUTS if getattr(self.neuralnet, attr, False)), "coo")

    def _put_model_to_device(self, dataset) -> None:
        if self.task == targets.REGRESS:
            self.output_shape = 1
        elif self.task == targets.CLASSIF:
            self.output_shape = len(self.classes)

        first = dataset.get(0)
        target_shape = 1 if first.get("y") is not None else None

        generator = torch.Generator().manual_seed(self.seed)
        if isinstance(dataset, GridDataset):
            # x [C, W, H, D]: the CNN takes the feature count and the box
            self.model = self.neuralnet(first["x"].shape[0], tuple(first["x"].shape[1:]), device=self.device, generator=generator)
        else:
            num_node_features = first["x"].shape[1]
            # the actual edge-attr matrix width (features can be multi-channel)
            num_edge_features = first["edge_attr"].shape[1]
            self.model = self.neuralnet(num_node_features, self.output_shape, num_edge_features, device=self.device, generator=generator)

        for output_exporter in self._output_exporters:
            if not output_exporter.is_compatible_with(self.output_shape, target_shape):
                msg = (
                    f"Output exporter of type {type(output_exporter)}\n\t"
                    f"is not compatible with output shape {self.output_shape}\n\t"
                    f"and target shape {target_shape}."
                )
                raise ValueError(msg)

    def configure_optimizers(self, optimizer=None, lr: float = 0.001, weight_decay: float = 1e-05) -> None:
        """Configure the optimizer (default Adam, lr 1e-3, weight decay 1e-5)."""
        self.lr = lr
        self.weight_decay = weight_decay
        self._optimizer_cls = optim.Adam if optimizer is None else optimizer
        if not (isinstance(self._optimizer_cls, type) and issubclass(self._optimizer_cls, optim.Optimizer)):
            msg = f"Invalid optimizer {optimizer}. Please use optimizer classes from deeprank2_tpu_torch.ops.optim."
            raise ValueError(msg)
        self.optimizer = self._optimizer_cls(self.model.parameters(), lr=lr, weight_decay=weight_decay)

    def set_lossfunction(self, lossfunction=None, override_invalid: bool = False) -> None:  # noqa: C901
        """Set the loss function with task-validity checks (reference: trainer.py:428-501)."""
        default_regression_loss = loss_nn.MSELoss
        default_classification_loss = loss_nn.CrossEntropyLoss

        def _invalid_loss() -> None:
            if override_invalid:
                _log.warning(
                    f"The provided loss function ({lossfunction}) is not appropriate for {self.task} tasks.\n\t"
                    "You have set override_invalid to True, so the training will run with this loss function nonetheless.",
                )
            else:
                invalid_loss_error = (
                    f"The provided loss function ({lossfunction}) is not appropriate for {self.task} tasks.\n\t"
                    "If you want to use this loss function anyway, set override_invalid to True."
                )
                raise ValueError(invalid_loss_error)

        if lossfunction in losses.other_losses:
            _invalid_loss()
            custom_loss = False
        elif lossfunction is not None and lossfunction not in (losses.regression_losses + losses.classification_losses):
            custom_loss = True
        else:
            custom_loss = False

        if self.task == targets.REGRESS:
            if lossfunction is None:
                lossfunction = default_regression_loss
            elif custom_loss:
                _log.warning(
                    f"The provided loss function ({lossfunction}) is not part of the default list.\n\t"
                    f"Please ensure that this loss function is appropriate for {self.task} tasks.",
                )
            elif lossfunction not in losses.regression_losses:
                _invalid_loss()
            self.lossfunction = lossfunction()
        elif self.task == targets.CLASSIF:
            if lossfunction is None:
                lossfunction = default_classification_loss
            elif custom_loss:
                _log.warning(
                    f"The provided loss function ({lossfunction}) is not part of the default list.\n\t"
                    f"Please ensure that this loss function is appropriate for {self.task} tasks.",
                )
            elif lossfunction not in losses.classification_losses:
                _invalid_loss()
            if not self.class_weights:
                self.lossfunction = lossfunction()
            else:
                self.lossfunction = lossfunction  # weights set in train()

    # ------------------------------------------------------------------
    # Batching / step functions
    # ------------------------------------------------------------------
    def _is_graph(self) -> bool:
        return isinstance(self.dataset_train or self.dataset_test, GraphDataset)

    def _blocksparse_bucket(self, key: str):
        """Grow-only geometric bucketing for collate capacities: round the
        required size up to the next multiple of ``2^(floor(log2 n) - 3)``
        (<= 12.5 % padding waste) and never shrink, so the shapes a run sees
        stay O(log) many instead of one per batch."""
        caps = self._bs_caps

        def round_up(required: int) -> int:
            cap = caps.get(key, 0)
            if required > cap:
                if required <= 8:
                    cap = 8
                else:
                    step = 1 << max(int(np.log2(required)) - 3, 0)
                    cap = -(-required // step) * step
                caps[key] = cap
            return cap

        return round_up

    def _collate(self, entries: list[dict], pad_graphs: int):
        """A host (CPU) batch of ``entries`` in the model's layout: this
        rank's shard or part when the batch is split across the ranks, with
        the names of every graph of the batch."""
        shards, names = self._collate_shards(entries, pad_graphs)
        return shards[self._rank if len(shards) > 1 else 0], names

    def _collate_shards(self, entries: list[dict], pad_graphs: int) -> tuple[tuple, list[str]]:  # noqa: C901
        """A batch of ``entries`` as its shards (one when not split): the
        data-parallel shards (per-shard capacity ``ceil(pad_graphs / D)``)
        or a graph-parallel model's parts, of which this rank collates its
        own and takes the others' targets alone (``ops.batch.ShardTargets``).
        The block-sparse, blocked and diag-clustered capacities come from
        the grow-only buckets, under the JAX Trainer's keys, so a run takes
        the same capacities as JAX's on the same batch sequence."""
        layout = self._layout()
        net = self.neuralnet
        if layout not in ("dense", "coo", "grid") and not hasattr(self, "_bs_caps"):
            self._bs_caps = {}
        bucket = self._blocksparse_bucket
        d = self._num_shards
        per_shard = max(1, -(-pad_graphs // d))  # ceil: floor would overfill shards when batch_size % D != 0
        sharded = {"device": "cpu", "shard": self._rank if d > 1 else 0}
        # The bucketed layouts keep the single-device collate outside a
        # group, as the JAX Trainer does: their sharded collates deal graphs
        # by tile count (another batch order) or bucket under other keys
        # (dc_big, not dc_region_big), so their one shard is not JAX's
        # single-device batch. One dense, grid or COO shard is.
        if layout == "clustered_blocksparse":
            slot8 = getattr(net, "clustered_blocksparse_slot8", False)
            weighted = getattr(net, "clustered_blocksparse_edge_weights", False)
            if d > 1:
                keys = ("tiles", "blocks", "pooled_tiles", "pooled_blocks", "c1", "members0_s", "members1_s") + (("members0s_s",) if slot8 else ())
                shards, names = batches.collate_graphs_blocksparse_clustered_sharded(
                    entries, d, per_shard, with_edge_weights=weighted, pad_caps={k: bucket(k) for k in keys}, slot8=slot8, **sharded
                )
            else:
                batch, names = batches.collate_graphs_blocksparse_clustered(
                    entries,
                    pad_tiles=bucket("tiles"),
                    pad_blocks=bucket("blocks"),
                    pad_pooled_tiles=bucket("pooled_tiles"),
                    pad_pooled_blocks=bucket("pooled_blocks"),
                    pad_c1=bucket("c1"),
                    pad_graphs=pad_graphs,
                    with_edge_weights=weighted,
                    pad_members0=bucket("members0_s"),
                    pad_members1=bucket("members1_s"),
                    slot8=slot8,
                    pad_members0s=bucket("members0s_s") if slot8 else None,
                    device="cpu",
                )
                shards = (batch,)
        elif layout == "blocksparse" and getattr(net, "graph_parallel", False):
            # row-tile partitioning across every rank: one structure a batch
            # spans them all
            from deeprank2_tpu_torch.parallel import blocksparse_partition as bp

            own = {"device": "cpu", "shard": self._rank}
            if getattr(net, "ring_halo", False):
                shards, names = bp.collate_graphs_blocksparse_ring(
                    entries,
                    self._world,
                    pad_tiles=bucket("tiles"),
                    pad_blocks_diag=bucket("ring_diag_blocks"),
                    # one grow-only capacity a ring step: the steps' shapes are independent
                    pad_blocks_off=lambda req, k: bucket(f"ring_off_{k}")(req),
                    pad_graphs=pad_graphs,
                    **own,
                )
            else:
                shards, names = bp.collate_graphs_blocksparse_partitioned(entries, self._world, pad_tiles=bucket("tiles"), pad_blocks=bucket("gp_blocks"), pad_graphs=pad_graphs, **own)
        elif layout == "blocksparse":
            if d > 1:
                shards, names = batches.collate_graphs_blocksparse_sharded(entries, d, per_shard, pad_tiles=bucket("tiles"), pad_blocks=bucket("blocks"), **sharded)
            else:
                batch, names = batches.collate_graphs_blocksparse(entries, pad_tiles=bucket("tiles"), pad_blocks=bucket("blocks"), pad_graphs=pad_graphs, device="cpu")
                shards = (batch,)
        elif layout == "blocked":
            if d > 1:
                shards, names = batches.collate_graphs_blocked_sharded(entries, d, per_shard, pad_tiles=bucket("be_tiles"), pad_slabs=bucket("be_slabs"), **sharded)
            else:
                batch, names = batches.collate_graphs_blocked(entries, pad_tiles=bucket("be_tiles"), pad_slabs=bucket("be_slabs"), pad_graphs=pad_graphs, device="cpu")
                shards = (batch,)
        elif layout == "diag_clustered":
            # pin the pure-vs-mixed layout decision on the FIRST batch: a
            # dataset near the inflation crossover would otherwise flip
            # layouts batch to batch, with a second family of buckets
            if "dc_layout_msn" not in self._bs_caps:
                self._bs_caps["dc_layout_msn"] = _auto_min_slot_nodes(entries)
            weighted = getattr(net, "diag_clustered_edge_weights", False)
            msn = self._bs_caps["dc_layout_msn"]
            if d > 1:
                keys = ("nodes", "clusters", "c1", "members0s_s", "members1_s", "big", "s4", "s2", "s1", "kbig")
                shards, names = batches.collate_graphs_diag_clustered_sharded(
                    entries, d, per_shard, min_slot_nodes=msn, pad_caps={k: bucket(f"dc_{k}") for k in keys}, with_edge_weights=weighted, **sharded
                )
            else:
                batch, names = batches.collate_graphs_diag_clustered(
                    entries,
                    pad_graphs=pad_graphs,
                    pad_nodes=bucket("dc_nodes"),
                    pad_clusters=bucket("dc_clusters"),
                    pad_c1=bucket("dc_c1"),
                    pad_members0s=bucket("dc_members0s_s"),
                    pad_members1=bucket("dc_members1_s"),
                    pad_region_caps={k: bucket(f"dc_region_{k}") for k in ("big", "s4", "s2", "s1", "kbig")},
                    with_edge_weights=weighted,
                    min_slot_nodes=msn,
                    device="cpu",
                )
                shards = (batch,)
        elif layout == "dense":
            shards, names = batches.collate_graphs_dense_sharded(
                entries,
                d,
                per_shard,
                with_clusters=getattr(net, "needs_clusters", False),
                with_edge_weights=getattr(net, "dense_edge_weights", False),
                # the flat route's operands only for a model that reads them
                with_diag_operands=getattr(net, "diag_operands", False),
                **sharded,
            )
        elif layout == "grid":
            shards, names = batches.collate_grids_sharded(entries, d, per_shard, **sharded)
        else:
            shards, names = batches.collate_graphs_sharded(entries, d, per_shard, **sharded)
        # map classification targets to class indices (reference _format_output,
        # trainer.py:807-835) on the host: the step sees only integer targets
        if self.task == targets.CLASSIF and self.classes_to_index is not None:
            for batch in shards:
                y = batch.y.numpy()
                mask = batch.y_mask.numpy()
                mapped = np.asarray(
                    [float(self.classes_to_index[int(v)]) if m else 0.0 for v, m in zip(y.reshape(-1), mask.reshape(-1))],
                    dtype=np.float32,
                ).reshape(y.shape)
                batch.y = torch.from_numpy(mapped)
        return shards, names

    def _iter_batches(self, dataset, batch_size: int, shuffle: bool, rng: np.random.Generator | None, prefetch: int = 2):
        """Batches built by a background producer thread with ``prefetch``-deep
        device staging: HDF5 reads, collation into pinned host memory and
        the copy of the next batches to the card (on a side stream, joined
        to the compute stream by an event) all overlap the current step (the
        reference's ``DataLoader(num_workers, pin_memory)``,
        trainer.py:541-547). Batch order (and so exporter output and RNG
        consumption) is the synchronous loader's. Yields ``(batch, names,
        stats)``; ``stats`` are host values of the batch (kept with it in
        the collate cache: ``n_valid``, ``n_edges``, the targets, and
        ``batch_bytes``, the bytes of its tensors, which the card gets
        pinned and copied).

        Spans, and what they add to the running pass's counters
        (``self._counters``, which ``_run_pass`` reports in ``pass_stats``):
        on the producer thread, for each batch collated afresh,
        ``loader.collate`` (the reads, the collate, the class-index map and
        the host stats; ``collate_s``, one value a batch) and, on a card,
        ``loader.pin`` (``pin_s``, one value a batch); a batch from the
        collate cache adds one to ``cache_hits`` and no time. On a card,
        ``loader.stage``: issuing the side-stream copies (no counter: the
        copies' own time is on the device). On the caller's thread,
        ``trainer.wait_batch``: the wait for the queue, the compute stream's
        wait on the copy and ``record_stream`` (``wait_s``), once a batch."""
        import queue
        import threading

        indices = np.arange(len(dataset))
        if shuffle and rng is not None:
            rng.shuffle(indices)
        chunks = [indices[start : start + batch_size] for start in range(0, len(indices), batch_size)]

        out_q: queue.Queue = queue.Queue(maxsize=max(2, prefetch))
        stop = threading.Event()
        sentinel = object()
        failure: list[BaseException] = []
        on_card = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(device=self.device) if on_card else None
        counters = self._counters

        # only worth caching when the whole pass fits: FIFO eviction under a
        # cyclic access pattern otherwise gives 0% hits at full memory cost
        cacheable = not shuffle and 0 < len(chunks) <= self._collate_cache_capacity
        if cacheable and not hasattr(dataset, "_dr2_collate_uid"):
            dataset._dr2_collate_uid = next(_COLLATE_UID)  # alias-proof (id() can recycle)

        def _collated(chunk) -> tuple:
            key = (getattr(dataset, "_dr2_collate_uid", None), batch_size, tuple(int(i) for i in chunk))
            if cacheable and key in self._collate_cache:
                if counters is not None:
                    counters["cache_hits"] += 1
                return self._collate_cache[key]
            with _span("loader.collate", counters, "collate_s"):
                entries = [dataset.get(int(i)) for i in chunk]
                shards, names = self._collate_shards(entries, pad_graphs=batch_size)
                batch = shards[self._rank if len(shards) > 1 else 0]
                # host-side stats (avoids per-batch device->host syncs in the
                # loop), of the whole batch: under data parallelism the targets
                # of every shard, in the order of the gathered predictions (the
                # edges, for the throughput log, of this rank's shard)
                whole = shards if self._num_shards > 1 else (batch,)
                stats = {
                    "n_valid": sum(int(b.y_mask.sum()) for b in whole),
                    "n_edges": int(batch.edge_mask.sum()) if hasattr(batch, "edge_mask") else 0,
                    "y_host": np.concatenate([b.y.numpy() for b in whole]),
                    "y_mask_host": np.concatenate([b.y_mask.numpy() for b in whole]),
                }
            if on_card:
                with _span("loader.pin", counters, "pin_s"):
                    batch = _map_tensors(batch, torch.Tensor.pin_memory)
            stats["batch_bytes"] = sum(t.numel() * t.element_size() for t in _tensor_fields(batch))
            if cacheable:
                if len(self._collate_cache) >= self._collate_cache_capacity:
                    self._collate_cache.pop(next(iter(self._collate_cache)))
                self._collate_cache[key] = (batch, names, stats)
            return batch, names, stats

        def _stage(batch) -> tuple:
            if not on_card:
                return batch, None
            with _span("loader.stage"), torch.cuda.stream(copy_stream):
                staged = _map_tensors(batch, lambda t: t.to(self.device, non_blocking=True))
                copied = torch.cuda.Event()
                copied.record(copy_stream)
            return staged, copied

        def _produce() -> None:
            try:
                with torch.cuda.device(self.device) if on_card else contextlib.nullcontext():
                    for chunk in chunks:
                        batch, names, stats = _collated(chunk)
                        staged = (*_stage(batch), names, stats)
                        while not stop.is_set():
                            try:
                                out_q.put(staged, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
            except BaseException as e:  # noqa: BLE001 — re-raised on the consumer side
                failure.append(e)
            finally:
                while not stop.is_set():
                    try:
                        out_q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        producer = threading.Thread(target=_produce, name="deeprank2-batch-loader", daemon=True)
        producer.start()
        try:
            for _ in chunks:
                with _span("trainer.wait_batch", counters, "wait_s"):
                    item = out_q.get()
                    if item is sentinel:  # the producer failed
                        break
                    batch, copied, names, stats = item
                    if copied is not None:
                        compute = torch.cuda.current_stream(self.device)
                        compute.wait_event(copied)
                        # the copies were made on the side stream: keep the
                        # allocator from reusing them while this stream reads them
                        for t in _tensor_fields(batch):
                            t.record_stream(compute)
                yield batch, names, stats
        finally:
            stop.set()
            producer.join()
        if failure:
            raise failure[0]

    def _build_step_functions(self) -> None:
        model = self.model
        lossfunction = self.lossfunction
        task = self.task

        # reference parity (_format_output, trainer.py:813-827): BCE losses and
        # untested classification losses are rejected for classification runs
        if task == targets.CLASSIF:
            if isinstance(lossfunction, (loss_nn.BCELoss, loss_nn.BCEWithLogitsLoss)):
                msg = "BCELoss and BCEWithLogitsLoss are currently not supported.\n\tFor further details see the reference's issue #318."
                raise ValueError(msg)
            if isinstance(lossfunction, losses.classification_losses) and not isinstance(lossfunction, losses.classification_tested):
                msg = (
                    f"{lossfunction} is currently not supported.\n\t"
                    f"Supported loss functions for classification: {losses.classification_tested}."
                )
                raise ValueError(msg)
        # class weights live on the device: a host array would be copied to
        # the card (and waited for) at every step
        if getattr(lossfunction, "weight", None) is not None:
            lossfunction.weight = torch.as_tensor(lossfunction.weight, dtype=torch.float32, device=self.device)

        def compute_loss(batch, generator: torch.Generator | None, training: bool):
            with _span("trainer.forward", self._counters, "forward_s"):
                pred = model(batch, training=training, generator=generator)
                if task == targets.CLASSIF:
                    loss = lossfunction(pred, batch.y.to(torch.int64), batch.y_mask)
                else:
                    loss = lossfunction(pred.reshape(-1), batch.y, batch.y_mask)
            return loss, pred

        if self._num_shards > 1:
            dp_train, dp_eval = dp.make_dp_train_step(compute_loss, self.optimizer), dp.make_dp_eval_step(compute_loss)

            def flat(loss, pred):  # the gathered [D, G, ...] predictions, in the order of the names
                return loss, pred.reshape(-1, *pred.shape[2:])

            self._train_step = lambda batch: flat(*dp_train(batch, self._rng))
            self._eval_step = lambda batch: flat(*dp_eval(batch))
            return

        # a graph-parallel model's parameters are replicated, each rank's
        # gradient a share of theirs: pmean'ed before the step
        graph_parallel = getattr(self.neuralnet, "graph_parallel", False) and self._world > 1
        params = [p for g in self.optimizer.param_groups for p in g["params"]]

        def train_step(batch):
            # gradients are cleared before the backward, so the last step's
            # stay readable after a pass
            self.optimizer.zero_grad(set_to_none=True)
            loss, pred = compute_loss(batch, self._rng, True)
            with _span("trainer.backward", self._counters, "backward_s"):
                loss.backward()
                if graph_parallel:
                    dp.sync_gradients(params, loss)
            self.optimizer.step()  # torch's own span: Optimizer.step#<class>.step
            return loss.detach(), pred.detach()

        @torch.no_grad()
        def eval_step(batch):
            return compute_loss(batch, None, False)

        self._train_step = train_step
        self._eval_step = eval_step

    # ------------------------------------------------------------------
    # Training / evaluation
    # ------------------------------------------------------------------
    def train(  # noqa: C901, PLR0915
        self,
        nepoch: int = 1,
        batch_size: int = 32,
        shuffle: bool = True,
        earlystop_patience: int | None = None,
        earlystop_maxgap: float | None = None,
        min_epoch: int = 10,
        validate: bool = False,
        num_workers: int = 0,  # sizes the prefetch queue (loading is one background thread)
        best_model: bool = True,
        filename: str | None = "model.pth.tar",
        profile_dir: str | None = None,
        checkpoint_every: int | None = None,
        checkpoint_path: str = "resume.pth.tar",
        resume_from: str | None = None,
    ) -> None:
        """Train the model (same arguments and semantics as the JAX package's).

        ``profile_dir``: if set, the first training epoch runs under
        ``torch.profiler.profile`` and its trace is written there
        (``epoch1.trace.json``, for chrome://tracing or Perfetto).

        ``checkpoint_every=k`` writes a resumable training-state snapshot to
        ``checkpoint_path`` every k epochs (current parameters and optimizer
        state, both generators, loss history, early-stopping state and the
        best-model checkpoint so far); ``resume_from=path`` restores it and
        continues at the next epoch (``nepoch`` is the *total*). A resumed
        run is bitwise-identical to an uninterrupted one wherever the run is
        deterministic (on the CPU, under
        ``torch.use_deterministic_algorithms(True)``).
        """
        if self.dataset_train is None:
            msg = "No training dataset provided."
            raise ValueError(msg)

        self.data_type = type(self.dataset_train).__name__
        self.batch_size_train = batch_size
        self._prefetch = max(2, num_workers)
        self.shuffle = shuffle
        loader_rng = np.random.default_rng(self.seed)

        if self.task == targets.CLASSIF and self.class_weights:
            targets_all = [self.dataset_train.get(i)["y"] for i in range(len(self.dataset_train))]
            counts = np.array([sum(1 for t in targets_all if t == c) for c in self.classes], dtype=np.float32)
            _log.info(f"class occurences: {counts}")
            weights = 1.0 / np.maximum(counts, 1e-12)
            weights = weights / weights.sum()
            _log.info(f"class weights: {weights}")
            self.weights = np.asarray(weights)
            try:
                self.lossfunction = self.lossfunction(weight=self.weights)
            except TypeError as e:
                weight_error = (
                    f"Loss function {self.lossfunction} does not allow for weighted classes.\n\t"
                    "Please use a different loss function or set class_weights to False.\n"
                )
                raise ValueError(weight_error) from e
        else:
            self.weights = None

        self._build_step_functions()

        train_losses = []
        valid_losses = []
        saved_model = False
        checkpoint_model = None
        start_epoch = 1

        early_stopping = (
            EarlyStopping(patience=earlystop_patience, maxgap=earlystop_maxgap, min_epoch=min_epoch, trace_func=_log.info)
            if (earlystop_patience or earlystop_maxgap)
            else None
        )

        if resume_from is not None:
            runtime = self._restore_training_state(resume_from, loader_rng, early_stopping)
            train_losses = runtime["train_losses"]
            valid_losses = runtime["valid_losses"]
            checkpoint_model = runtime["best"]
            saved_model = checkpoint_model is not None
            start_epoch = runtime["epoch"] + 1
            if start_epoch > nepoch:
                msg = f"Checkpoint at {resume_from} is already at epoch {runtime['epoch']}; nothing to resume for nepoch={nepoch}."
                raise ValueError(msg)
            _log.info(f"Resuming training from {resume_from} at epoch {start_epoch}.")

        with self._output_exporters:
            self.nepoch = nepoch
            if start_epoch == 1:
                _log.info("Epoch 0:")
                self._eval(self.dataset_train, 0, "training", batch_size)
            if validate:
                if self.dataset_val is None:
                    msg = "No validation dataset provided."
                    raise ValueError(msg)
                if start_epoch == 1:
                    self._eval(self.dataset_val, 0, "validation", batch_size)

            epoch = start_epoch - 1
            for epoch in range(start_epoch, nepoch + 1):
                _log.info(f"Epoch {epoch}:")
                if profile_dir and epoch == 1 and self._rank == 0:
                    loss_ = self._profiled_epoch(profile_dir, batch_size, shuffle, loader_rng)
                else:
                    loss_ = self._epoch(epoch, "training", batch_size, shuffle, loader_rng)
                train_losses.append(loss_)

                if validate:
                    loss_ = self._eval(self.dataset_val, epoch, "validation", batch_size)
                    valid_losses.append(loss_)
                    if best_model and min(valid_losses) == loss_:
                        checkpoint_model = self._save_model()
                        saved_model = True
                        self.epoch_saved_model = epoch
                        _log.info(f"Best model saved at epoch # {self.epoch_saved_model}.")
                    if early_stopping:
                        early_stopping(epoch, valid_losses[-1], train_losses[-1])
                        if early_stopping.early_stop:
                            break
                elif best_model and min(train_losses) == loss_:
                    checkpoint_model = self._save_model()
                    saved_model = True
                    self.epoch_saved_model = epoch
                    _log.info(f"Best model saved at epoch # {self.epoch_saved_model}.")

                if checkpoint_every and epoch % checkpoint_every == 0 and self._rank == 0:
                    self._write_training_state(checkpoint_path, epoch, loader_rng, train_losses, valid_losses, checkpoint_model, early_stopping)

            if best_model is False or not saved_model:
                checkpoint_model = self._save_model()
                self.epoch_saved_model = epoch
                _log.info(f"Last model saved at epoch # {self.epoch_saved_model}.")
                if not saved_model:
                    # reference parity (trainer.py:648-656): with
                    # best_model=False the reference also emits this NaN
                    # warning on perfectly healthy losses — reproduced.
                    warnings.warn(
                        "A model has been saved but the validation and/or the training losses were NaN;\n\t"
                        "try to increase the cutoff distance during the data processing or the number of data points during the training.",
                    )

        if filename and self._rank == 0:
            save_checkpoint(checkpoint_model, filename)
        self.opt_loaded_state_dict = checkpoint_model["optimizer_state"]
        self.model_load_state_dict = checkpoint_model["model_state"]
        self.model.load_state_dict(self.model_load_state_dict)
        self.optimizer.load_state_dict(self.opt_loaded_state_dict)

    def _profiled_epoch(self, profile_dir: str, batch_size: int, shuffle: bool, loader_rng) -> float | None:
        """Epoch 1 under ``torch.profiler``; its trace goes to ``profile_dir``."""
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        # every thread: the loader's spans too
        with profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            loss_ = self._epoch(1, "training", batch_size, shuffle, loader_rng)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "epoch1.trace.json"))
        return loss_

    def _export_outputs(self, pred: np.ndarray, y: np.ndarray, valid: np.ndarray, names: list[str]):
        """Outputs/targets of the real (non-padded) graphs for the exporters."""
        real = [i for i, name in enumerate(names) if name != ""]
        outputs = []
        target_vals = []
        for i in real:
            if self.task == targets.CLASSIF:
                p = np.exp(pred[i] - pred[i].max())
                outputs.append((p / p.sum()).tolist())
            else:
                outputs.append(float(pred[i].reshape(-1)[0]))
            target_vals.append(float(y[i]) if valid[i] else None)
        entry_names = [names[i] for i in real]
        return outputs, target_vals, entry_names

    def _run_pass(self, dataset, epoch_number: int, pass_name: str, batch_size: int, *, step, shuffle: bool = False, loader_rng=None) -> float | None:
        """Shared train/eval pass: iterate batches through ``step(batch) ->
        (loss, pred)``, accumulate the masked-mean loss, feed the exporters.

        Losses and predictions stay on the device during the batch loop, so
        the pass never waits for the device; the drain afterwards reads them
        all back at once (``trainer.readback``: every wait on the card), then
        exports them (``trainer.export``: host work alone, the exporters'
        ``process`` included). Each pass appends to ``self.pass_stats`` its
        host seconds, all on one clock (``perf_counter``): ``seconds`` in
        all, ``loop_s`` before the drain, ``batches``; the sums of its spans,
        ``wait_s`` (``trainer.wait_batch``), ``forward_s``
        (``trainer.forward``: the model and the loss), ``backward_s``
        (``trainer.backward``; the data-parallel step leaves its backward
        unsplit), ``readback_s`` and ``export_s``; the loader's
        ``collate_s`` and ``pin_s`` (one value a batch collated afresh, none
        for a batch from the collate cache), ``cache_hits``, and
        ``batch_bytes`` (one value a batch; ``_iter_batches``)."""
        counters = self._counters = {"wait_s": 0.0, "forward_s": 0.0, "backward_s": 0.0, "readback_s": 0.0, "export_s": 0.0, "collate_s": [], "pin_s": [], "cache_hits": 0}
        sum_of_losses = 0.0
        count_predictions = 0
        total_edges = 0
        target_vals = []
        outputs = []
        entry_names = []
        t0 = perf_counter()
        pending = []
        try:
            for batch, names, stats in self._iter_batches(dataset, batch_size, shuffle, loader_rng, prefetch=self._prefetch):
                loss_, pred = step(batch)
                pending.append((loss_, pred, names, stats))
            loop_s = perf_counter() - t0

            with _span("trainer.readback", counters, "readback_s"):
                host_losses, host_preds = _read_back(pending)
            with _span("trainer.export", counters, "export_s"):
                for loss_, pred, (_, _, names, stats) in zip(host_losses, host_preds, pending):
                    n_valid = stats["n_valid"]
                    total_edges += stats["n_edges"]
                    if n_valid > 0:  # guard: an all-padding batch's loss is NaN and 0 * NaN stays NaN
                        count_predictions += n_valid
                        sum_of_losses += float(loss_) * n_valid
                    out, tgt, nm = self._export_outputs(pred, stats["y_host"], stats["y_mask_host"], names)
                    outputs += out
                    target_vals += tgt
                    entry_names += nm
                pass_loss = sum_of_losses / count_predictions if count_predictions > 0 else None
                self._output_exporters.process(pass_name, epoch_number, entry_names, outputs, target_vals, pass_loss)
        finally:
            self._counters = None

        dt = perf_counter() - t0
        self.pass_stats.append(
            {"pass": pass_name, "epoch": epoch_number, "seconds": dt, "loop_s": loop_s, "batches": len(pending), **counters, "batch_bytes": [p[3]["batch_bytes"] for p in pending]}
        )
        if total_edges and dt > 0:
            _log.info(f"{pass_name} throughput: {total_edges / dt:,.0f} edges/s")
        self._log_epoch_data(pass_name, pass_loss, dt)
        return pass_loss

    def _epoch(self, epoch_number: int, pass_name: str, batch_size: int, shuffle: bool, loader_rng) -> float | None:
        return self._run_pass(self.dataset_train, epoch_number, pass_name, batch_size, step=self._train_step, shuffle=shuffle, loader_rng=loader_rng)

    def _eval(self, dataset, epoch_number: int, pass_name: str, batch_size: int) -> float | None:
        return self._run_pass(dataset, epoch_number, pass_name, batch_size, step=self._eval_step)

    @staticmethod
    def _log_epoch_data(stage: str, loss: float | None, time_: float) -> None:
        _log.info(f"{stage} loss {loss} | time {time_}")

    def test(self, batch_size: int = 32, num_workers: int = 0) -> None:
        """Evaluate on the independent test set."""
        if (not self.pretrained_model) and (self.model_load_state_dict is None):
            msg = "No pretrained model provided and no training performed. Please provide a pretrained model or train the model before testing."
            raise ValueError(msg)
        self.batch_size_test = batch_size
        self._prefetch = max(2, num_workers)
        if self.dataset_test is None:
            msg = "No test dataset provided."
            raise ValueError(msg)
        if getattr(self, "_eval_step", None) is None:
            self._build_step_functions()
        with self._output_exporters:
            self._eval(self.dataset_test, self.epoch_saved_model, "testing", batch_size)

    # ------------------------------------------------------------------
    # Checkpointing
    # ------------------------------------------------------------------
    def _load_params(self) -> None:
        """Restore the 28-key checkpoint state (reference: trainer.py:873-908)."""
        state = load_checkpoint(self.pretrained_model)

        self.data_type = state["data_type"]
        self.model_load_state_dict = state["model_state"]
        self._model_state_format = state["model_state_format"]
        self._optimizer_cls = state["optimizer"]
        self.opt_loaded_state_dict = state["optimizer_state"]
        self.lossfunction = state["lossfunction"]
        self.target = state["target"]
        self.target_transform = state["target_transform"]
        self.task = state["task"]
        self.classes = state["classes"]
        self.classes_to_index = state["classes_to_index"]
        self.class_weights = state["class_weights"]
        self.batch_size_train = state["batch_size_train"]
        self.batch_size_test = state["batch_size_test"]
        self.val_size = state["val_size"]
        self.test_size = state["test_size"]
        self.lr = state["lr"]
        self.weight_decay = state["weight_decay"]
        self.epoch_saved_model = state["epoch_saved_model"]
        self.subset = state["subset"]
        self.shuffle = state["shuffle"]
        self.clustering_method = state["clustering_method"]
        self.node_features = state["node_features"]
        self.edge_features = state["edge_features"]
        self.features = state["features"]
        self.features_transform = state["features_transform"]
        self.means = state["means"]
        self.devs = state["devs"]
        self.cuda = state["cuda"]
        self.ngpu = state["ngpu"]

    def _write_training_state(
        self,
        path: str,
        epoch: int,
        loader_rng: np.random.Generator,
        train_losses: list,
        valid_losses: list,
        best: dict | None,
        early_stopping: EarlyStopping | None,
    ) -> None:
        """Snapshot the full training state for mid-training resume: the
        *current* parameters and optimizer state (``_save_model``) plus every
        piece of loop state a bitwise-identical resumed run needs."""
        state = {
            "current": self._save_model(),
            "best": best,
            "runtime": {
                "epoch": epoch,
                "rng": self._rng.get_state(),
                "loader_rng_state": loader_rng.bit_generator.state,
                "train_losses": list(train_losses),
                "valid_losses": list(valid_losses),
                "epoch_saved_model": self.epoch_saved_model,
                "early_stopping": None
                if early_stopping is None
                else {
                    "counter": early_stopping.counter,
                    "best_score": early_stopping.best_score,
                    "val_loss_min": early_stopping.val_loss_min,
                    "early_stop": early_stopping.early_stop,
                },
            },
        }
        save_snapshot(state, path)
        _log.info(f"Resumable training state written to {path} (epoch {epoch}).")

    def _restore_training_state(self, path: str, loader_rng: np.random.Generator, early_stopping: EarlyStopping | None) -> dict:
        """Restore a :meth:`_write_training_state` snapshot; returns the loop
        state (epoch, loss history, best checkpoint) for ``train`` to resume."""
        state = load_snapshot(path)
        current = state["current"]
        self.model.load_state_dict(current["model_state"])
        self.optimizer.load_state_dict(current["optimizer_state"])
        runtime = state["runtime"]
        self._rng.set_state(runtime["rng"])
        loader_rng.bit_generator.state = runtime["loader_rng_state"]
        self.epoch_saved_model = runtime["epoch_saved_model"]
        if early_stopping is not None and runtime["early_stopping"] is not None:
            for key, value in runtime["early_stopping"].items():
                setattr(early_stopping, key, value)
        return {
            "epoch": runtime["epoch"],
            "train_losses": runtime["train_losses"],
            "valid_losses": runtime["valid_losses"],
            "best": state["best"],
        }

    def _save_model(self) -> dict[str, Any]:
        """Build the checkpoint dict (the reference's 28-key schema,
        trainer.py:910-958; transform lambdas stored as source strings), with
        CPU copies of the model's and the optimizer's state."""
        features_transform_to_save = copy.deepcopy(self.features_transform)
        if features_transform_to_save:
            for entry in features_transform_to_save.values():
                if entry.get("transform") is None:
                    continue
                if isinstance(entry["transform"], str):
                    continue
                try:
                    source = inspect.getsource(entry["transform"])
                    match = re.search(r"(lambda[^\n]*)", source)
                    entry["transform"] = _trim_lambda_source(match.group(1)) if match else None
                except (OSError, TypeError):
                    _log.warning("Could not serialize a features_transform function; storing None.")
                    entry["transform"] = None

        return {
            "data_type": self.data_type,
            "model_state": to_cpu(self.model.state_dict()),
            "optimizer": self._optimizer_cls,
            "optimizer_state": to_cpu(self.optimizer.state_dict()),
            "lossfunction": self.lossfunction,
            "target": self.target,
            "target_transform": self.target_transform,
            "task": self.task,
            "classes": self.classes,
            "classes_to_index": self.classes_to_index,
            "class_weights": self.class_weights,
            "batch_size_train": self.batch_size_train,
            "batch_size_test": self.batch_size_test,
            "val_size": self.val_size,
            "test_size": self.test_size,
            "lr": self.lr,
            "weight_decay": self.weight_decay,
            "epoch_saved_model": self.epoch_saved_model,
            "subset": self.subset,
            "shuffle": self.shuffle,
            "clustering_method": self.clustering_method,
            "node_features": self.node_features,
            "edge_features": self.edge_features,
            "features": self.features,
            "features_transform": features_transform_to_save,
            "means": self.means,
            "devs": self.devs,
            "cuda": self.cuda,
            "ngpu": self.ngpu,
        }
