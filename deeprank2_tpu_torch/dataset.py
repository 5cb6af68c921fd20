"""Dataset layer: HDF5 -> numpy entry dicts (port of ``deeprank2_tpu/dataset.py``).

API parity with the reference (deeprank2/dataset.py): ``GraphDataset`` /
``GridDataset`` with feature selection and validation, per-feature transforms
and standardization, target filtering, and train-source parameter inheritance
(from a training dataset object or a pretrained checkpoint).

Differences by design:
- ``get(idx)`` returns a plain dict of numpy arrays (the collation into padded
  batches happens in the Trainer's loader, ops/batch.py) —
  there is no per-item torch tensor creation;
- an in-memory entry cache (``cache=True``, default) avoids the reference's
  re-open-HDF5-per-item pattern (dataset.py:883), the reference's data-loading
  hot spot.

The port's copy is numpy and h5py, as the JAX package's; ``h5py`` loads
inside the functions that open files, so the package (and its Trainer)
imports on a machine without it. Every read goes through
``utils/store.py:open_store``, so ``hdf5_path`` may also be a
``MemoryStore`` (``QueryCollection.process_in_memory``): the same loads,
checks, statistics and transforms with no file and no h5py. The
standardization statistics read numpy columns (no pandas);
``hdf5_to_pandas`` lays the same columns out as a DataFrame. A
``train_source`` checkpoint is read by the port's ``utils/checkpoint.py``,
which reads both packages' formats.
"""

from __future__ import annotations

import copy
import logging
import os
import pickle
import re
import warnings
from typing import Literal

import numpy as np

from deeprank2_tpu_torch.domain import edgestorage as Efeat
from deeprank2_tpu_torch.domain import gridstorage
from deeprank2_tpu_torch.domain import nodestorage as Nfeat
from deeprank2_tpu_torch.domain import targetstorage as targets
from deeprank2_tpu_torch.utils.store import MemoryStore, open_store

_log = logging.getLogger(__name__)


class DeeprankDataset:
    """Parent class of :class:`GridDataset` and :class:`GraphDataset`."""

    def __init__(
        self,
        hdf5_path: str | list[str],
        subset: list[str] | None,
        train_source,
        target: str | None,
        target_transform: bool | None,
        target_filter: dict[str, str] | None,
        task: str | None,
        classes: list | None,
        use_tqdm: bool,
        root: str,
        check_integrity: bool,
    ):
        if not isinstance(hdf5_path, (str, list, MemoryStore)):
            msg = f"hdf5_path accepts a path, a list of paths or a MemoryStore, not {type(hdf5_path)}"
            raise TypeError(msg)
        self.hdf5_paths = hdf5_path if isinstance(hdf5_path, list) else [hdf5_path]

        self.subset = subset
        self.train_source = train_source
        self.target = target
        self.target_transform = target_transform
        self.target_filter = target_filter
        self.root = root
        self.use_tqdm = use_tqdm

        if check_integrity:
            self._check_hdf5_files()

        self._check_task_and_classes(task, classes)
        self._create_index_entries()

        self.df = None
        self.means = None
        self.devs = None
        self.train_means = None
        self.train_devs = None
        # FIFO-bounded in-memory entry cache (avoids the reference's
        # re-open-HDF5-per-item pattern without unbounded growth)
        self._cache: dict[tuple[str, str], dict] = {}
        self._cache_capacity = 16384

    # ------------------------------------------------------------------
    def _require_stored_target(self) -> None:
        """A training dataset must name a target that the files contain."""
        if not self.index_entries:
            msg = "the dataset matched no entries; check hdf5_path/subset/target_filter"
            raise IndexError(msg)
        fname, first = self.index_entries[0]
        with open_store(fname) as f5:
            stored = list(f5[first][targets.VALUES])
        if self.target is None:
            msg = f"a training dataset needs target=...; the file(s) store {stored}"
            raise ValueError(msg)
        if self.target not in stored:
            msg = f"Target {self.target} not among the stored targets {stored}"
            raise ValueError(msg)

    def _check_and_inherit_train(self, data_type, inherited_params: list[str]) -> None:
        """Inherit parameters from a training dataset or pretrained checkpoint."""
        if isinstance(self.train_source, str):
            try:
                from deeprank2_tpu_torch.utils.checkpoint import load_checkpoint

                data = load_checkpoint(self.train_source)
                if data["data_type"] != data_type.__name__:
                    msg = (
                        f"The pre-trained model has been trained with data of type {data['data_type']}, but you are trying\n\t"
                        f"to define a {data_type.__name__}-class validation/testing dataset."
                    )
                    raise TypeError(msg)
                if data_type is GraphDataset:
                    self.train_means = data["means"]
                    self.train_devs = data["devs"]
                    if data.get("features_transform"):
                        for entry in data["features_transform"].values():
                            if entry.get("transform") is None:
                                continue
                            if isinstance(entry["transform"], str):
                                entry["transform"] = eval(entry["transform"])  # noqa: S307 (reference parity: dataset.py:115)
            except pickle.UnpicklingError as e:
                msg = "The path provided to `train_source` is not a valid pre-trained model."
                raise ValueError(msg) from e
        elif isinstance(self.train_source, data_type):
            data = self.train_source
            if data_type is GraphDataset:
                self.train_means = self.train_source.means
                self.train_devs = self.train_source.devs
        else:
            msg = (
                f"The train data provided is invalid: {type(self.train_source)}.\n\t"
                f"Please provide a valid training {data_type} or the path to a valid pre-trained model."
            )
            raise TypeError(msg)

        self._check_inherited_params(inherited_params, data)

    def _check_hdf5_files(self) -> None:
        """Drop empty or corrupted files."""
        usable = []
        for path in self.hdf5_paths:
            try:
                with open_store(path) as f5:
                    if len(f5):
                        usable.append(path)
                    else:
                        _log.info(f"dropping {path}: no entries")
            except Exception as e:  # noqa: BLE001
                _log.error(e)
                _log.info(f"dropping {path}: unreadable")
        self.hdf5_paths[:] = usable

    def _check_task_and_classes(self, task: str | None, classes: list | None = None) -> None:
        known_task = targets.TARGET_TASKS.get(self.target)
        self.task = known_task if task is None else task

        if self.target is not None and self.task not in (targets.CLASSIF, targets.REGRESS):
            msg = f"custom target {self.target} needs task='classif' or 'regress' (got {self.task})"
            raise ValueError(msg)

        if task and known_task and task != known_task:
            self.task = known_task
            warnings.warn(f"target {self.target} implies task {known_task}; the requested task {task} is ignored")

        if self.task == targets.CLASSIF:
            if classes is None:
                self.classes = [0, 1, 2, 3, 4, 5] if self.target == targets.CAPRI else [0, 1]
            else:
                # (the reference never stores user-provided classes — dataset.py:180-183
                # only handles the None case; we keep them, which is the documented intent)
                self.classes = classes
            self.classes_to_index = {class_: index for index, class_ in enumerate(self.classes)}
        else:
            self.classes = None
            self.classes_to_index = None

    def _check_inherited_params(self, inherited_params: list[str], data) -> None:
        own = vars(self)
        if not isinstance(data, dict):
            data = vars(data)
        for param in inherited_params:
            if own[param] == data[param]:
                continue
            if own[param] != self.default_vars[param]:
                _log.warning(f"{param}={own[param]} differs from the training run's {data[param]}; the training value wins")
            setattr(self, param, data[param])

    def _create_index_entries(self) -> None:
        self.index_entries = []
        for path in self.hdf5_paths:
            try:
                with open_store(path) as f5:
                    names = list(f5) if self.subset is None else [n for n in self.subset if n in f5]
                    if self.target_filter is not None:
                        names = [n for n in names if self._filter_targets(f5[n])]
                    self.index_entries += [(path, n) for n in names]
            except Exception:  # noqa: BLE001
                _log.exception(f"while indexing {path}")

    def _filter_targets(self, grp) -> bool:
        """Keep the entry if every (target, condition) filter passes.

        Conditions are comparison strings like ``"<0.1"`` evaluated against the
        entry's target value (reference parity: dataset.py:251-289).
        """
        if self.target_filter is None:
            return True
        for target_name, condition in self.target_filter.items():
            stored = list(grp[targets.VALUES].keys())
            if target_name in stored:
                if isinstance(condition, str):
                    target_value = grp[targets.VALUES][target_name][()]
                    # one regex pass, two-char operators first. The reference
                    # bug (dataset.py:251-289) chains str.replace over the
                    # operator list, so "<=4.0" becomes "X<X=4.0"-style garbage
                    # whose SyntaxError silently drops the whole file — we do
                    # not reproduce that; "<=", ">=", "!=" work here.
                    operation = re.sub(r"(==|!=|<=|>=|<|>)", lambda m: f"{target_value}{m.group(1)}", condition)
                    if not eval(operation):  # noqa: S307 (reference parity)
                        return False
                elif condition is not None:
                    msg = f"a target filter is a comparison string like '<0.1'; got {condition!r}"
                    raise ValueError(msg)
            else:
                _log.warning(f"filter target {target_name} absent from entry {grp} (stored targets: {stored})")
        return True

    def __len__(self) -> int:
        return len(self.index_entries)

    def len(self) -> int:
        """Number of entries (reference-API alias)."""
        return len(self.index_entries)

    # ------------------------------------------------------------------
    def _feature_columns(self) -> list[dict]:
        """The selected features of every entry, one dict a file: ``"id"``
        (the entry names), then a list a column, one cell an entry (a
        matrix feature gives one column a channel, ``<feat>_<i>``), as
        :meth:`hdf5_to_pandas` lays out its frame."""
        files = []
        for fname in self.hdf5_paths:
            with open_store(fname) as f:
                first_entry = next(iter(f))
                entry_names = list(f) if self.subset is None else [e for e in f if e in self.subset]

                df_dict: dict = {"id": entry_names}
                for feat_type, feats in self.features_dict.items():
                    for feat in feats:
                        transform = None
                        if getattr(self, "features_transform", None):
                            transform = self.features_transform.get("all", {}).get("transform")
                            if transform is None and feat in self.features_transform:
                                transform = self.features_transform.get(feat, {}).get("transform")
                        # one read per entry; metadata from the h5py object
                        # (probing with [()] / re-reading per channel costs
                        # O(channels) full-dataset reads)
                        ndim = f[first_entry][feat_type][feat].ndim
                        if ndim == 2:  # noqa: PLR2004
                            values = [f[name][feat_type][feat][:] for name in entry_names]
                            if transform:
                                values = [transform(v) for v in values]
                            for i in range(f[first_entry][feat_type][feat].shape[1]):
                                df_dict[f"{feat}_{i}"] = [v[:, i] for v in values]
                        else:
                            col = [f[name][feat_type][feat][:] if ndim == 1 else f[name][feat_type][feat][()] for name in entry_names]
                            if transform:
                                col = [transform(row) for row in col]
                            df_dict[feat] = col
                files.append(df_dict)
        return files

    def hdf5_to_pandas(self):
        """Load the selected features into a pandas DataFrame (one row per entry)."""
        import pandas as pd

        frames = [pd.DataFrame(data=df_dict) for df_dict in self._feature_columns()]
        self.df = pd.concat(frames).reset_index(drop=True) if frames else pd.DataFrame()
        return self.df

    def save_hist(self, features: str | list[str], fname: str = "features_hist.png", bins=10, figsize=(15, 15), log: bool = False) -> None:
        """Save histograms of the requested features to an image."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if self.df is None:
            self.hdf5_to_pandas()
        if not isinstance(features, list):
            features = [features]

        features_df = [col for feat in features for col in self.df.columns.to_numpy().tolist() if feat in col]
        if not features_df:
            msg = "Please provide valid features names present in this dataset."
            raise ValueError(msg)

        def _series_values(col: str) -> np.ndarray:
            values = self.df[col].to_numpy()
            data = np.concatenate(values) if isinstance(values[0], np.ndarray) else values
            if log:
                data = np.log(data)
                data[data == -np.inf] = 0
            return data

        fig, axs = plt.subplots(len(features_df), figsize=figsize, squeeze=False)
        for row, feat in enumerate(features_df):
            data = _series_values(feat)
            axs[row][0].hist(data, bins=bins)
            axs[row][0].set(xlabel=f"{feat} (mean {round(float(np.mean(data)), 1)}, std {round(float(np.std(data)), 1)})", ylabel="Count")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fig.tight_layout()
            fig.savefig(fname)
            plt.close(fig)

    def _compute_mean_std(self) -> None:
        """Each column's mean and deviation over every entry, rounded to one
        decimal, from the columns :meth:`_feature_columns` reads (pandas
        is not needed: the numbers are those of :meth:`hdf5_to_pandas`'s
        frame, bit for bit)."""

        def flat(cells: list) -> np.ndarray:
            return np.concatenate(cells) if isinstance(cells[0], np.ndarray) else np.asarray(cells)

        files = self._feature_columns()
        stats = {col: flat([cell for f in files for cell in f[col]]) for col in list(files[0])[1:]}
        self.means = {col: round(float(np.nanmean(v)), 1) for col, v in stats.items()}
        self.devs = {col: round(float(np.nanstd(v)), 1) for col, v in stats.items()}


# grid channels of a vector feature carry a _NNN suffix (position_000 ...)
_GRID_CHANNEL_RE = re.compile(r"^([a-zA-Z_]+)_([0-9]{3})$")
GRID_PARTIAL_FEATURE_NAME_PATTERN = _GRID_CHANNEL_RE  # reference-name alias


class GridDataset(DeeprankDataset):
    """Loads 3D-grid entries from HDF5 (see reference dataset.py:471 for arg docs)."""

    def __init__(
        self,
        hdf5_path: str | list,
        subset: list[str] | None = None,
        train_source=None,
        features: list[str] | str | None = "all",
        target: str | None = None,
        target_transform: bool = False,
        target_filter: dict[str, str] | None = None,
        task: Literal["regress", "classif"] | None = None,
        classes: list | None = None,
        use_tqdm: bool = True,
        root: str = "./",
        check_integrity: bool = True,
    ):
        super().__init__(hdf5_path, subset, train_source, target, target_transform, target_filter, task, classes, use_tqdm, root, check_integrity)
        self.default_vars = {
            "features": "all",
            "target": None,
            "target_transform": False,
            "task": None,
            "classes": None,
            "classes_to_index": None,
        }
        self.features = features
        self.target_transform = target_transform

        if train_source is not None:
            self.inherited_params = ["features", "target", "target_transform", "task", "classes", "classes_to_index"]
            self._check_and_inherit_train(GridDataset, self.inherited_params)
            self._check_features()
        else:
            self._check_features()
            self.inherited_params = None
            self._require_stored_target()

        self.features_dict = {gridstorage.MAPPED_FEATURES: self.features}
        if self.target is not None:
            self.features_dict[targets.VALUES] = [self.target] if isinstance(self.target, str) else self.target

    def _check_features(self) -> None:
        hdf5_path = self.hdf5_paths[0]
        # normalize a single feature name up front — left as a bare str it
        # would match nothing below and silently select zero features
        if isinstance(self.features, str) and self.features != "all":
            self.features = [self.features]
        elif self.features is None:
            self.features = []
        with open_store(hdf5_path) as f:
            mol_key = next(iter(f.keys()))
            if isinstance(self.features, list):
                # strip the _NNN channel suffix and dedup
                stripped = [
                    m.group(1) if (m := GRID_PARTIAL_FEATURE_NAME_PATTERN.match(name)) is not None else name for name in self.features
                ]
                self.features = list(set(stripped))
            available_features = [key for key in f[f"{mol_key}/{gridstorage.MAPPED_FEATURES}"] if key[0] != "_"]

            matching = []
            unpartial_names = []
            for name in available_features:
                m = GRID_PARTIAL_FEATURE_NAME_PATTERN.match(name)
                base = m.group(1) if m is not None else name
                if self.features == "all" or (isinstance(self.features, list) and base in self.features):
                    matching.append(name)
                unpartial_names.append(base)

        missing = []
        if self.features == "all":
            self.features = sorted(available_features)
            self.default_vars["features"] = self.features
        else:
            if not isinstance(self.features, list):
                self.features = [] if self.features is None else [self.features]
            missing = [name for name in self.features if name not in unpartial_names]
            self.features = sorted(matching)

        if missing:
            msg = (
                f"Not all features could be found in the file {hdf5_path} under entry {mol_key}.\n\t"
                f"Missing features are: {missing}.\n\tAvailable features: {available_features}"
            )
            raise ValueError(msg)

    def get(self, idx: int) -> dict:
        """Entry dict: ``x [C, W, H, D]``, ``y`` (or None), ``entry_name``."""
        file_path, entry_name = self.index_entries[idx]
        key = (file_path, entry_name)
        if key not in self._cache:
            if len(self._cache) >= self._cache_capacity:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = self.load_one_grid(file_path, entry_name)
        return self._cache[key]

    def load_one_grid(self, hdf5_path: str, entry_name: str) -> dict:
        """Load one grid entry from HDF5."""
        with open_store(hdf5_path) as hdf5_file:
            grp = hdf5_file[entry_name]
            mapped = grp[gridstorage.MAPPED_FEATURES]
            x = np.array([mapped[name][:] for name in self.features if name[0] != "_"], dtype=np.float32)
            y = _load_target(grp, self.target, self.task, self.target_transform, self.train_source, entry_name, hdf5_path)
        return {"x": x, "y": y, "entry_name": entry_name}


class GraphDataset(DeeprankDataset):
    """Loads graph entries from HDF5 (see reference dataset.py:710 for arg docs)."""

    def __init__(  # noqa: C901
        self,
        hdf5_path: str | list,
        subset: list[str] | None = None,
        train_source=None,
        node_features: list[str] | str | None = "all",
        edge_features: list[str] | str | None = "all",
        features_transform: dict | None = None,
        clustering_method: str | None = None,
        target: str | None = None,
        target_transform: bool = False,
        target_filter: dict[str, str] | None = None,
        task: Literal["regress", "classif"] | None = None,
        classes: list | None = None,
        use_tqdm: bool = True,
        root: str = "./",
        check_integrity: bool = True,
    ):
        super().__init__(hdf5_path, subset, train_source, target, target_transform, target_filter, task, classes, use_tqdm, root, check_integrity)
        self.default_vars = {
            "node_features": "all",
            "edge_features": "all",
            "features_transform": None,
            "target": None,
            "target_transform": False,
            "task": None,
            "classes": None,
            "classes_to_index": None,
        }
        self.node_features = node_features
        self.edge_features = edge_features
        self.clustering_method = clustering_method
        self.target_transform = target_transform
        self.features_transform = features_transform

        if train_source is not None:
            self.inherited_params = [
                "node_features",
                "edge_features",
                "features_transform",
                "target",
                "target_transform",
                "task",
                "classes",
                "classes_to_index",
            ]
            self._check_and_inherit_train(GraphDataset, self.inherited_params)
            self._check_features()
        else:
            self._check_features()
            self.inherited_params = None
            self._require_stored_target()

        self.features_dict = {Nfeat.NODE: self.node_features, Efeat.EDGE: self.edge_features}
        if self.target is not None:
            self.features_dict[targets.VALUES] = [self.target] if isinstance(self.target, str) else self.target

        standardize = False
        if self.features_transform:
            standardize = any(entry.get("standardize") for entry in self.features_transform.values())

        if standardize and train_source is None:
            if self.means is None or self.devs is None:
                self._compute_mean_std()
        elif standardize and train_source is not None:
            self.means = self.train_means
            self.devs = self.train_devs

    def get(self, idx: int) -> dict:
        """Entry dict: x, edge_index (undirected), edge_attr, pos, y, cluster0/1."""
        fname, mol = self.index_entries[idx]
        key = (fname, mol)
        if key not in self._cache:
            if len(self._cache) >= self._cache_capacity:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = self.load_one_graph(fname, mol)
        return self._cache[key]

    def _apply_feature_pipeline(self, feat: str, vals: np.ndarray, fname: str, entry_name: str) -> np.ndarray:
        """Per-feature transform + standardization (reference: dataset.py:897-996)."""
        transform = None
        standard = None
        if self.features_transform is not None:
            transform = self.features_transform.get("all", {}).get("transform")
            standard = self.features_transform.get("all", {}).get("standardize")
            if transform is None and feat in self.features_transform:
                transform = self.features_transform.get(feat, {}).get("transform")
            if standard is None and feat in self.features_transform:
                standard = self.features_transform.get(feat, {}).get("standardize")

        if transform:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                vals = transform(vals)
                if len(w) > 0:
                    msg = (
                        f"Invalid value occurs in {entry_name}, file {fname}, when applying {transform} for feature {feat}.\n\t"
                        f"Please change the transformation function for {feat}."
                    )
                    raise ValueError(msg)

        if vals.ndim == 1:
            vals = vals.reshape(-1, 1)
            if standard:
                vals = (vals - self.means[feat]) / self.devs[feat]
        elif standard:
            # reference bug (dataset.py:932-934): substring matching, so e.g.
            # feat "polarity" also collects the "diff_polarity_NNN" mean keys
            # when both features are selected (broadcast error); reproduced.
            reshaped_mean = [mean_value for mean_key, mean_value in self.means.items() if feat in mean_key]
            reshaped_dev = [dev_value for dev_key, dev_value in self.devs.items() if feat in dev_key]
            vals = (vals - reshaped_mean) / reshaped_dev
        return vals

    def load_one_graph(self, fname: str, entry_name: str) -> dict:
        """Load one graph entry from HDF5 into numpy arrays."""
        with open_store(fname) as f5:
            grp = f5[entry_name]

            node_data = []
            for feat in self.node_features:
                if feat[0] == "_":
                    continue
                vals = grp[f"{Nfeat.NODE}/{feat}"][()]
                node_data.append(self._apply_feature_pipeline(feat, vals, fname, entry_name))
            x = np.hstack(node_data).astype(np.float32) if node_data else None

            if Efeat.INDEX in grp[Efeat.EDGE]:
                edge_index = grp[f"{Efeat.EDGE}/{Efeat.INDEX}"][()].astype(np.int64)
            else:
                edge_index = np.zeros((0, 2), dtype=np.int64)

            edge_data = []
            for feat in self.edge_features:
                if feat[0] == "_":
                    continue
                vals = grp[f"{Efeat.EDGE}/{feat}"][()]
                edge_data.append(self._apply_feature_pipeline(feat, vals, fname, entry_name))
            if edge_data:
                edge_attr = np.hstack(edge_data).astype(np.float32)
            else:
                edge_attr = np.zeros((edge_index.shape[0], 0), dtype=np.float32)

            y = _load_target(grp, self.target, self.task, self.target_transform, self.train_source, entry_name, fname)
            pos = grp[f"{Nfeat.NODE}/{Nfeat.POSITION}/"][()].astype(np.float32)

            cluster0 = None
            cluster1 = None
            if self.clustering_method is not None and "clustering" in grp:
                method = self.clustering_method
                if method in grp["clustering"]:
                    cgrp = grp[f"clustering/{method}"]
                    if "depth_0" in cgrp and "depth_1" in cgrp:
                        cluster0 = cgrp["depth_0"][()].astype(np.int64)
                        cluster1 = cgrp["depth_1"][()].astype(np.int64)
                    else:
                        _log.warning("no clusters detected")
                else:
                    _log.warning(f"no clustering/{method} detected")

        return {
            "x": x,
            "edge_index": edge_index,
            "edge_attr": edge_attr,
            "pos": pos,
            "y": y,
            "cluster0": cluster0,
            "cluster1": cluster1,
            "entry_name": entry_name,
        }

    def _check_features(self) -> None:
        """Validate requested node/edge features against the file contents."""
        with open_store(self.hdf5_paths[0]) as f:
            mol_key = next(iter(f.keys()))
            self.available_node_features = [key for key in f[f"{mol_key}/{Nfeat.NODE}/"] if key[0] != "_"]
            self.available_edge_features = [key for key in f[f"{mol_key}/{Efeat.EDGE}/"] if key[0] != "_"]

        def resolve(requested, available, attr):
            if requested == "all":
                self.default_vars[attr] = available
                return available, []
            if not isinstance(requested, list):
                requested = [] if requested is None else [requested]
            return requested, [f for f in requested if f not in available]

        self.node_features, missing_nodes = resolve(self.node_features, self.available_node_features, "node_features")
        self.edge_features, missing_edges = resolve(self.edge_features, self.available_edge_features, "edge_features")

        if missing_nodes or missing_edges:
            detail = []
            if missing_nodes:
                detail.append(f"node features {missing_nodes} (file has {self.available_node_features})")
            if missing_edges:
                detail.append(f"edge features {missing_edges} (file has {self.available_edge_features})")
            msg = (
                f"{self.hdf5_paths[0]} lacks requested " + "; ".join(detail) +
                " — check the feature_modules the data was processed with"
            )
            raise ValueError(msg)


def _load_target(grp, target, task, target_transform, train_source, entry_name, fname):
    """Read + optionally sigmoid(log(.))-transform the target (reference: dataset.py:1000-1020)."""
    if target is None:
        return None
    if targets.VALUES in grp and target in grp[targets.VALUES]:
        y = float(grp[f"{targets.VALUES}/{target}"][()])
        if task == targets.REGRESS and target_transform is True:
            y = float(1.0 / (1.0 + np.exp(-np.log(y))))
        elif task is not targets.REGRESS and target_transform is True:
            msg = f'Sigmoid transformation not possible for {task} tasks. Please change `task` to "regress" or set `target_transform` to `False`.'
            raise ValueError(msg)
        return y
    possible_targets = list(grp[targets.VALUES].keys()) if targets.VALUES in grp else []
    if train_source is None:
        msg = (
            f"Target {target} missing in entry {entry_name} in file {fname}, possible targets are {possible_targets}.\n\t"
            "Use the query class to add more target values to input data."
        )
        raise ValueError(msg)
    return None


def save_hdf5_keys(f_src_path: str, src_ids: list[str], f_dest_path: str, hardcopy: bool = False) -> None:
    """Save a subset of entries into a new file, as external links or hard copies."""
    import h5py

    if not all(isinstance(d, str) for d in src_ids):
        msg = "src_ids must be entry-name strings"
        raise TypeError(msg)
    with h5py.File(f_dest_path, "w") as dest, h5py.File(f_src_path, "r") as source:
        for key in src_ids:
            if hardcopy:
                source.copy(source[key], dest)
            else:
                dest[key] = h5py.ExternalLink(f_src_path, "/" + key)


def _divide_dataset(dataset, splitsize: float | int | None = None, rng: np.random.Generator | None = None):
    """Random train/eval split by entry (reference: trainer.py:961-1004).

    ``rng`` seeds the shuffle — the Trainer passes its own seed so a resumed
    run re-derives the SAME train/val partition (an unseeded split would leak
    already-trained entries into validation after resume)."""
    if splitsize is None:
        splitsize = 0.25
    full_size = len(dataset)

    if isinstance(splitsize, float):
        n_split = int(splitsize * full_size)
    elif isinstance(splitsize, int):
        n_split = splitsize
    else:
        msg = f"splitsize is a fraction, a count, or None — not {type(splitsize)}"
        raise TypeError(msg)

    if n_split >= full_size or n_split < 0:
        msg = f"cannot hold out {n_split} of {full_size} entries (need 0 <= split < dataset size)"
        raise ValueError(msg)

    if n_split == 0:
        return dataset, None

    indices = np.arange(full_size)
    (rng or np.random.default_rng()).shuffle(indices)

    dataset_main = copy.deepcopy(dataset)
    dataset_main.index_entries = [dataset.index_entries[i] for i in indices[n_split:]]
    dataset_split = copy.deepcopy(dataset)
    dataset_split.index_entries = [dataset.index_entries[i] for i in indices[:n_split]]
    return dataset_main, dataset_split
