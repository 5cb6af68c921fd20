"""The h5py-free corpus route (``store="memory"``) against the file route,
and the store itself against h5py.

For every configuration of the accuracy-parity twin, on a few queries of
its corpus flavor, the datasets built as the twin builds them
(``make_datasets``) from a ``MemoryStore`` give the entries the HDF5 file
gives, bit for bit: the selected and standardized node features, the edges
and their features, the targets, and, after the Trainer has preclustered
both, the ``mcl`` cluster ids; the means and deviations are equal. The
memory route runs with h5py and pandas unimportable, and nothing falls back
from one store to the other."""

from __future__ import annotations

import sys

import numpy as np
import pytest

from deeprank2_tpu_torch.tools import accuracy_parity as pap
from deeprank2_tpu_torch.trainer import Trainer
from deeprank2_tpu_torch.utils.store import MemoryStore, open_store

# a few queries of each flavor, by position in the assembled corpus: the
# 1ATN and 3C8P structures, two generated decoys, and the extra complexes 1ak4 and 9api
PPI_PICK = ("1ATN_1w", "1ATN_2w", "3C8P", "1ATN_rb03", "3C8P_rb05", "1ak4", "9api")


def _queries(data_path, decoy_dir, flavor):
    if flavor == "srv_residue":
        return pap.assemble_srv_queries(data_path, per_source=2)
    res = "atom" if flavor == "ppi_atom" else "residue"
    queries = pap.assemble_ppi_queries(data_path, res, decoy_dir, decoys_per_complex=6)
    return [q for q in queries if any(q.get_query_id().endswith(f":{p}") for p in PPI_PICK)]


@pytest.fixture(scope="module")
def corpora(data_path, tmp_path_factory):
    """``{flavor: (file path, MemoryStore)}``, each from its own assembly."""
    root = tmp_path_factory.mktemp("corpora")
    out = {}
    for flavor in pap.FLAVORS:
        file_src = pap.featurize_queries(_queries(data_path, root / "decoys_file", flavor), flavor, root / "file", "hdf5")
        mem_src = pap.featurize_queries(_queries(data_path, root / "decoys_memory", flavor), flavor, root / "memory", "memory")
        out[flavor] = (file_src, mem_src)
    return out


def _assert_entries_equal(a: dict, b: dict, where: str) -> None:
    assert a.keys() == b.keys(), where
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, (where, k)
            assert np.array_equal(va, vb, equal_nan=True), (where, k)
        else:
            assert va == vb and type(va) is type(vb), (where, k)


@pytest.mark.parametrize("config", pap.CONFIG_NAMES)
def test_memory_store_entries_equal_file(corpora, config) -> None:
    model_cls, _, task, target, _, clustered, ds_kwargs, grid = pap.config_table()[config]
    file_src, mem_src = corpora[pap.CONFIG_FLAVORS[config]]
    sides = {}
    for name, src in (("file", file_src), ("memory", mem_src)):
        train, val = pap.make_datasets(src, target=target, task=task, clustered=clustered, grid=grid, ds_kwargs=ds_kwargs)
        if clustered:
            # the Trainer preclusters both datasets, writing into the source
            Trainer(model_cls, dataset_train=train, dataset_val=val, output_exporters=[pap.PassRecorder()], seed=7, device="cpu")
        sides[name] = train
    f, m = sides["file"], sides["memory"]
    assert len(f) == len(m) > 3
    assert [n for _, n in f.index_entries] == [n for _, n in m.index_entries]
    if grid:
        assert f.features == m.features
    else:
        assert (f.node_features, f.edge_features) == (m.node_features, m.edge_features)
        assert f.means == m.means and f.devs == m.devs
        assert (f.means is not None) == bool(ds_kwargs.get("features_transform"))
    for i in range(len(f)):
        _assert_entries_equal(f.get(i), m.get(i), f"{config} {f.index_entries[i][1]}")
        if clustered:
            assert f.get(i)["cluster0"] is not None


def test_statistics_without_pandas_equal_the_frames(corpora, monkeypatch) -> None:
    """``_compute_mean_std`` reads numpy columns; its numbers are those of
    ``hdf5_to_pandas``'s frame (which stays for users who call it)."""
    from deeprank2_tpu_torch.dataset import GraphDataset

    file_src, _ = corpora["srv_residue"]
    feats = ["diff_charge", "res_size", "res_pI", "distance"]
    ds = GraphDataset(file_src, target="severity", task="regress", node_features=feats[:3], edge_features=["distance"], features_transform={f: {"standardize": True} for f in feats})
    df = ds.hdf5_to_pandas()

    def flat(col):
        cells = df[col].to_numpy()
        return np.concatenate(cells) if isinstance(cells[0], np.ndarray) else cells

    assert ds.means == {c: round(float(np.nanmean(flat(c))), 1) for c in df.columns[1:]}
    assert ds.devs == {c: round(float(np.nanstd(flat(c))), 1) for c in df.columns[1:]}
    monkeypatch.setitem(sys.modules, "pandas", None)
    ds.means = ds.devs = None
    ds._compute_mean_std()
    assert ds.means == {c: round(float(np.nanmean(flat(c))), 1) for c in df.columns[1:]}


def test_memory_route_needs_neither_h5py_nor_pandas(data_path, tmp_path, monkeypatch) -> None:
    """With h5py and pandas unimportable: the memory route featurizes,
    standardizes, preclusters and loads; the file route raises at once; and
    a Trainer without CUDA raises rather than running on the CPU."""
    from deeprank2_tpu_torch.neuralnets.gnn.ginet import GINet

    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        pap.featurize_corpus(data_path, tmp_path / "file", "hdf5", ["ppi_residue"])
    queries = [q for q in pap.assemble_ppi_queries(data_path, "residue") if "1ATN" in q.get_query_id()]
    store = pap.featurize_queries(queries, "ppi_residue", tmp_path / "memory", "memory")
    assert isinstance(store, MemoryStore) and len(store) == 4
    _, _, task, target, _, _, ds_kwargs, _ = pap.config_table()["ginet_ppi_classif"]
    train, val = pap.make_datasets(store, target=target, task=task, clustered=True, grid=False, ds_kwargs=ds_kwargs)
    Trainer(GINet, dataset_train=train, dataset_val=val, output_exporters=[pap.PassRecorder()], device="cpu")
    assert all(train.get(i)["cluster0"] is not None for i in range(len(train)))
    assert train.means is not None and np.isfinite(train.get(0)["x"]).all()
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pap.run_all(data_path, tmp_path, ["ginet_ppi_classif"], 1, store="memory", corpus={"ppi_residue": store})


def test_memory_store_behaves_as_h5py(tmp_path) -> None:
    """The store's surface against an h5py file written the same way:
    listing order, path lookups, read copies, scalar and string types,
    in-place writes, duplicate names, deletion."""
    import h5py

    def fill(f):
        for name in ("b", "B", "_meta", "a10", "a9"):
            f.create_group(name)
        f.create_dataset("b/node_features/x", data=np.arange(6, dtype=np.float32).reshape(3, 2))
        f["b"].create_dataset("node_features/_name", data=np.array(["A", "BC"]).astype("S"))
        g = f["b"].require_group("target_values")
        g.create_dataset("binary", data=1)
        g.create_dataset("dockq", data=0.25)
        g.create_dataset("flag", data=True)
        f["b/target_values"]["dockq"][()] = 0.5
        f.require_group("b").require_group("clustering").create_group("mcl").create_dataset("depth_0", data=np.array([0, 0, 1]))
        del f["b/clustering/mcl"]

    store = MemoryStore()
    fill(store)
    with h5py.File(tmp_path / "f.hdf5", "w") as f5:
        fill(f5)
    with h5py.File(tmp_path / "f.hdf5", "r") as f5, open_store(store) as st:
        assert list(st) == list(f5) and st.keys() == list(f5.keys()) and len(st) == len(f5)
        for path in ("b/node_features/x", "b/node_features/_name", "b/target_values/binary", "b/target_values/dockq", "b/target_values/flag"):
            got, want = st[path][()], f5[path][()]
            assert type(got) is type(want) and np.array_equal(got, want), path
            assert (st[path].ndim, st[path].shape, st[path].dtype) == (f5[path].ndim, f5[path].shape, f5[path].dtype)
        assert ("b/node_features/" in st, "b/clustering/mcl" in st, "b/clustering" in st, "nope/x" in st) == (True, False, True, False)
        assert "b/node_features/" in f5 and "b/clustering/mcl" not in f5
        st["b/node_features/x"][:][0, 0] = 99.0  # a read is a copy, as h5py's
        assert st["b/node_features/x"][0, 0] == 0.0
    with pytest.raises(ValueError, match="exists"):
        store.create_group("b")
    with pytest.raises(KeyError):
        store["b/missing"]
    import copy

    assert copy.deepcopy({"src": store})["src"] is store
