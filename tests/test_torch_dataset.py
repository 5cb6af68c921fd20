"""The port's dataset layer (deeprank2_tpu_torch/dataset.py, domain/,
utils/{earlystopping,community_pooling}.py) against the JAX package's: the
same HDF5 file gives the same entries bit for bit, plain and through every
dataset option; the same seed gives the same split; the same losses give
the same early stops; the same graph gives the same communities."""

from __future__ import annotations

import numpy as np
import pytest

from deeprank2_tpu import dataset as jax_dataset
from deeprank2_tpu.domain import edgestorage as jax_edge
from deeprank2_tpu.domain import gridstorage as jax_grid
from deeprank2_tpu.domain import nodestorage as jax_node
from deeprank2_tpu.domain import targetstorage as jax_targets
from deeprank2_tpu.utils import community_pooling as jax_cp
from deeprank2_tpu.utils.earlystopping import EarlyStopping as JaxEarlyStopping
from deeprank2_tpu_torch import dataset as port_dataset
from deeprank2_tpu_torch.domain import edgestorage, gridstorage, nodestorage, targetstorage
from deeprank2_tpu_torch.utils import community_pooling as port_cp
from deeprank2_tpu_torch.utils.earlystopping import EarlyStopping

ENTRY_KEYS = ("x", "edge_index", "edge_attr", "pos", "y", "cluster0", "cluster1", "entry_name")


def _assert_same_entry(got: dict, want: dict, where: str) -> None:
    assert set(got) == set(want) == set(ENTRY_KEYS), where
    for key in ENTRY_KEYS:
        a, b = got[key], want[key]
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f"{where} {key}"
            assert np.array_equal(a, b, equal_nan=True), f"{where} {key}"
        else:
            assert a == b, f"{where} {key}"


def _both(srv_hdf5, **kwargs):
    return port_dataset.GraphDataset(hdf5_path=srv_hdf5, **kwargs), jax_dataset.GraphDataset(hdf5_path=srv_hdf5, **kwargs)


def _log_transform(t):
    return np.log(t + 10)


OPTIONS = {
    "plain": {"target": "binary"},
    "feature_subset": {"target": "binary", "node_features": ["res_mass", "polarity", "pssm"], "edge_features": ["distance"]},
    "transform_and_standardize": {
        "target": "binary",
        "node_features": ["res_mass", "res_charge", "pssm", "hb_donors"],
        "features_transform": {"res_mass": {"transform": _log_transform, "standardize": True}, "pssm": {"standardize": True}, "hb_donors": {"transform": _log_transform}},
    },
    "standardize_all": {"target": "irmsd", "node_features": ["res_mass", "res_size", "res_pI"], "edge_features": ["distance", "electrostatic"], "features_transform": {"all": {"standardize": True}}},
    "target_transform": {"target": "irmsd", "task": "regress", "target_transform": True},
    "subset": {"target": "binary", "subset": "odd"},
    "target_filter": {"target": "irmsd", "target_filter": {"irmsd": "<=4.0"}},
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_graph_dataset_entries_match_jax_bit_for_bit(srv_hdf5, option) -> None:
    kwargs = dict(OPTIONS[option])
    if kwargs.get("subset") == "odd":
        names = jax_dataset.GraphDataset(hdf5_path=srv_hdf5, target="binary").index_entries
        kwargs["subset"] = [name for _, name in names[1::2]]
    port, jax_ds = _both(srv_hdf5, **kwargs)
    assert len(port) == len(jax_ds) > 0
    assert port.index_entries == jax_ds.index_entries
    assert (port.task, port.classes, port.classes_to_index) == (jax_ds.task, jax_ds.classes, jax_ds.classes_to_index)
    assert (port.node_features, port.edge_features, port.means, port.devs) == (jax_ds.node_features, jax_ds.edge_features, jax_ds.means, jax_ds.devs)
    for i in range(len(port)):
        _assert_same_entry(port.get(i), jax_ds.get(i), f"{option} entry {i}")


def test_train_source_inheritance_matches_jax(srv_hdf5) -> None:
    """A validation dataset inherits the training dataset's features,
    transforms, standardization and target, and reads the same entries."""
    options = OPTIONS["transform_and_standardize"]
    port_train, jax_train = _both(srv_hdf5, **options)
    port_val = port_dataset.GraphDataset(hdf5_path=srv_hdf5, train_source=port_train, node_features="all")
    jax_val = jax_dataset.GraphDataset(hdf5_path=srv_hdf5, train_source=jax_train, node_features="all")
    for param in port_val.inherited_params:
        assert getattr(port_val, param) == getattr(jax_val, param) == getattr(port_train, param), param
    assert (port_val.means, port_val.devs) == (jax_val.means, jax_val.devs) == (port_train.means, port_train.devs)
    for i in range(len(port_val)):
        _assert_same_entry(port_val.get(i), jax_val.get(i), f"inherited entry {i}")


def test_divide_dataset_gives_the_same_split(srv_hdf5) -> None:
    port, jax_ds = _both(srv_hdf5, target="binary")
    for split in (0.25, 3):
        port_main, port_split = port_dataset._divide_dataset(port, split, rng=np.random.default_rng(42))
        jax_main, jax_split = jax_dataset._divide_dataset(jax_ds, split, rng=np.random.default_rng(42))
        assert port_main.index_entries == jax_main.index_entries
        assert port_split.index_entries == jax_split.index_entries
    with pytest.raises(ValueError, match="cannot hold out"):
        port_dataset._divide_dataset(port, len(port))


def test_schema_names_match_jax() -> None:
    for port_mod, jax_mod in ((nodestorage, jax_node), (edgestorage, jax_edge), (gridstorage, jax_grid), (targetstorage, jax_targets)):
        names = {k: v for k, v in vars(jax_mod).items() if not k.startswith("__")}
        assert {k: v for k, v in vars(port_mod).items() if not k.startswith("__")} == names


LOSS_SEQUENCES = {
    "stall": ([1.0, 0.9, 0.95, 0.94, 0.96, 0.97, 0.8], [0.9] * 7, {"patience": 3}),
    "delta": ([1.0, 0.99, 0.985, 0.98, 0.5], [0.9] * 5, {"patience": 2, "delta": 0.02}),
    "maxgap": ([0.5, 0.6, 0.7, 0.9, 1.2, 1.5], [0.5, 0.4, 0.3, 0.2, 0.1, 0.1], {"patience": 10, "maxgap": 0.8, "min_epoch": 2}),
}


@pytest.mark.parametrize("case", sorted(LOSS_SEQUENCES))
def test_early_stopping_matches_jax(case) -> None:
    val, train, kwargs = LOSS_SEQUENCES[case]
    port, jax_es = EarlyStopping(trace_func=lambda _: None, **kwargs), JaxEarlyStopping(trace_func=lambda _: None, **kwargs)
    trace = []
    for epoch, (v, t) in enumerate(zip(val, train), start=1):
        for es in (port, jax_es):
            es(epoch, v, t)
        state = lambda es: (es.early_stop, es.counter, es.best_score, es.val_loss_min)  # noqa: E731
        assert state(port) == state(jax_es), (case, epoch)
        trace.append(port.early_stop)
    assert any(trace)


@pytest.mark.parametrize("method", ["mcl", "louvain"])
def test_community_detection_matches_jax(srv_hdf5, method) -> None:
    ds = jax_dataset.GraphDataset(hdf5_path=srv_hdf5, target="binary")
    for i in range(len(ds)):
        entry = ds.get(i)
        n = entry["x"].shape[0]
        c0 = port_cp.community_detection(entry["edge_index"], n, method=method)
        assert np.array_equal(c0, jax_cp.community_detection(entry["edge_index"], n, method=method))
        pooled, k = port_cp.community_pooling_host(c0, entry["edge_index"])
        want_pooled, want_k = jax_cp.community_pooling_host(c0, entry["edge_index"])
        assert k == want_k and np.array_equal(pooled, want_pooled)
        assert np.array_equal(port_cp.community_detection(pooled, k, method=method), jax_cp.community_detection(pooled, k, method=method))
