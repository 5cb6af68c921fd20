"""The port's ``QueryCollection.process`` against the JAX package's: the same
queries and seeds write the same HDF5, entry for entry, dataset for dataset
and attribute for attribute, bit for bit (graphs and grids, one and two
workers, combined and per-worker shards, augmentations, resume, the
multi-host split), each package's datasets read the other's files, the
host count follows ``torch.distributed``, the start method follows CUDA's
state, and ``chip_smoke.py``'s in-memory entries equal the port's load of
the file."""

from __future__ import annotations

import multiprocessing
import random
import runpy
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

import deeprank2_tpu.dataset as jax_dataset
import deeprank2_tpu.query as jax_query
import deeprank2_tpu.utils.grid as jax_grid
import deeprank2_tpu_torch.dataset as dataset
import deeprank2_tpu_torch.query as query
import deeprank2_tpu_torch.utils.grid as grid

ROOT = Path(__file__).resolve().parent.parent
DECOYS = ["1ATN_1w", "1ATN_2w", "1ATN_3w", "1ATN_4w"]
MODULES = ["components", "contact", "conservation"]
GRID = ([20, 18, 16], [24.0, 22.0, 20.0])


def collection(pkg, data_path, decoys=DECOYS, missing=False):
    qc = pkg.QueryCollection()
    for i, decoy in enumerate(decoys):
        qc.add(
            pkg.ProteinProteinInterfaceQuery(
                pdb_path=str(data_path / "pdb" / "1ATN" / f"{decoy}.pdb"),
                resolution="residue",
                chain_ids=["A", "B"],
                pssm_paths={c: str(data_path / "pssm" / "1ATN" / f"1ATN.{c}.pdb.pssm") for c in "AB"},
                targets={"binary": i % 2, "irmsd": 1.5 * i},
            )
        )
    if missing:
        qc.add(pkg.ProteinProteinInterfaceQuery(pdb_path=str(data_path / "pdb" / "absent.pdb"), resolution="residue", chain_ids=["A", "B"]))
    return qc


def run(pkg, mod, data_path, out, cpu_count=1, combine=True, grids=False, augmentations=0, seed=0, decoys=DECOYS, missing=False, **kwargs):
    """One ``process`` call of ``pkg`` into ``out``, ``random`` seeded first
    (the augmentations' rotations are drawn from it)."""
    random.seed(seed)
    settings = mod.GridSettings(*GRID) if grids else None
    method = mod.MapMethod.GAUSSIAN if grids else None
    return collection(pkg, data_path, decoys, missing).process(
        prefix=str(out / "proc"),
        feature_modules=MODULES,
        cpu_count=cpu_count,
        combine_output=combine,
        grid_settings=settings,
        grid_map_method=method,
        grid_augmentation_count=augmentations,
        **kwargs,
    )


def contents(paths) -> dict:
    """Every group and dataset of the files by name: attributes, dtype,
    shape, storage filters and the bytes of the values."""
    out = {}
    for path in paths:
        with h5py.File(path, "r") as f:

            def visit(name, obj):
                attrs = {k: np.asarray(v).tobytes() for k, v in obj.attrs.items()}
                if isinstance(obj, h5py.Dataset):
                    value = np.asarray(obj[()])
                    out[name] = (attrs, obj.dtype.str, obj.shape, obj.compression, obj.shuffle, obj.chunks, value.tobytes())
                else:
                    out[name] = (attrs,)

            f.visititems(visit)
    return out


def assert_same_files(port_paths, jax_paths) -> None:
    mine, theirs = contents(port_paths), contents(jax_paths)
    assert sorted(mine) == sorted(theirs)
    for name in mine:
        assert mine[name] == theirs[name], name


# (cpu_count, combine_output, grids, augmentations): with two workers each
# draws its rotations from its own copy of the parent's ``random``, and which
# worker takes which query varies from run to run, so augmentations are
# compared with one worker (in process, draws in query order)
CASES = {
    "one_worker_combined_grids_augmented": (1, True, True, 2),
    "one_worker_shards": (1, False, False, 0),
    "two_workers_combined_grids": (2, True, True, 0),
    "two_workers_shards_grids": (2, False, True, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_process_writes_what_jax_writes(tmp_path, data_path, case) -> None:
    cpu_count, combine, grids, augmentations = CASES[case]
    paths = {}
    for side, pkg, mod in (("port", query, grid), ("jax", jax_query, jax_grid)):
        (tmp_path / side).mkdir()
        paths[side] = run(pkg, mod, data_path, tmp_path / side, cpu_count, combine, grids, augmentations, missing=case == "one_worker_shards", mp_context="fork")
    assert len(paths["port"]) == (1 if combine else cpu_count)
    assert_same_files(paths["port"], paths["jax"])
    n_entries = 0
    for path in paths["port"]:
        with h5py.File(path, "r") as f:
            n_entries += len(f)
    assert n_entries == len(DECOYS) * (1 + augmentations)


def test_resume_writes_what_jax_writes(tmp_path, data_path) -> None:
    paths = {}
    for side, pkg, mod in (("port", query, grid), ("jax", jax_query, jax_grid)):
        out = tmp_path / side
        out.mkdir()
        run(pkg, mod, data_path, out, decoys=DECOYS[:2], grids=True, augmentations=1, seed=3)
        paths[side] = run(pkg, mod, data_path, out, grids=True, augmentations=1, seed=4, resume=True)
    assert_same_files(paths["port"], paths["jax"])
    with h5py.File(paths["port"][0], "r") as f:
        assert len(f) == 2 * len(DECOYS)


@pytest.fixture(scope="module")
def files(tmp_path_factory, data_path):
    """One combined file of graphs and grids from each package."""
    out = {}
    for side, pkg, mod in (("port", query, grid), ("jax", jax_query, jax_grid)):
        directory = tmp_path_factory.mktemp(side)
        out[side] = run(pkg, mod, data_path, directory, grids=True, augmentations=1)[0]
    return out


def assert_same_entries(a, b) -> None:
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a.get(i), b.get(i)
        assert sorted(x) == sorted(y)
        for key in x:
            if isinstance(x[key], np.ndarray):
                assert x[key].dtype == y[key].dtype and np.array_equal(x[key], y[key]), key
            else:
                assert x[key] == y[key], key


@pytest.mark.parametrize("reader", ["port_reads_jax", "jax_reads_port"])
def test_datasets_read_each_others_files(files, reader) -> None:
    mine, theirs = (dataset, jax_dataset) if reader == "port_reads_jax" else (jax_dataset, dataset)
    other = files["jax"] if reader == "port_reads_jax" else files["port"]
    own = files["port"] if reader == "port_reads_jax" else files["jax"]
    kwargs = {"target": "binary", "use_tqdm": False}
    # the augmented entries hold grids only
    graphs = {**kwargs, "subset": [f"residue-ppi:A-B:{d}" for d in DECOYS]}
    assert_same_entries(mine.GraphDataset(other, **graphs), theirs.GraphDataset(own, **graphs))
    selected = {**graphs, "node_features": ["res_type", "pssm"], "edge_features": ["distance"]}
    assert_same_entries(mine.GraphDataset(other, **selected), theirs.GraphDataset(own, **selected))
    grids = mine.GridDataset(other, **kwargs)
    assert len(grids) == 2 * len(DECOYS)
    assert_same_entries(grids, theirs.GridDataset(own, **kwargs))


@pytest.mark.parametrize("host_index", [0, 1])
def test_host_split_matches_jax(tmp_path, data_path, host_index) -> None:
    paths = {}
    for side, pkg, mod in (("port", query, grid), ("jax", jax_query, jax_grid)):
        (tmp_path / side).mkdir()
        paths[side] = run(pkg, mod, data_path, tmp_path / side, num_hosts=2, host_index=host_index)
    assert [Path(p).name for p in paths["port"]] == [f"proc-host{host_index}.hdf5"]
    assert_same_files(paths["port"], paths["jax"])
    with h5py.File(paths["port"][0], "r") as f:
        assert sorted(f) == sorted(f"residue-ppi:A-B:{d}" for d in DECOYS[host_index::2])


def test_host_count_follows_torch_distributed(tmp_path, data_path, monkeypatch) -> None:
    """Without ``num_hosts``/``host_index`` the split follows an initialized
    process group (the JAX package asks ``jax.process_count()``)."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = run(query, grid, data_path, tmp_path / "port")
    jax = run(jax_query, jax_grid, data_path, tmp_path / "jax", num_hosts=2, host_index=1)
    assert [Path(p).name for p in port] == ["proc-host1.hdf5"]
    assert_same_files(port, jax)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    (tmp_path / "alone").mkdir()
    assert [Path(p).name for p in run(query, grid, data_path, tmp_path / "alone", decoys=DECOYS[:1])] == ["proc.hdf5"]


@pytest.mark.parametrize("cuda_started", [False, True])
def test_start_method_follows_cuda(tmp_path, data_path, monkeypatch, cuda_started) -> None:
    """``mp_context=None`` forks unless CUDA is initialized in this process:
    a child forked after CUDA has started must never touch the device."""
    asked, get_context = [], multiprocessing.get_context

    def spy(method=None):
        asked.append(method)
        return get_context("fork")  # the pool itself forks: only the choice is under test

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: cuda_started)
    monkeypatch.setattr(multiprocessing, "get_context", spy)
    run(query, grid, data_path, tmp_path, cpu_count=2, decoys=DECOYS[:2])
    assert asked == ["spawn" if cuda_started else "fork"]


def test_spawned_workers_write_what_jax_writes(tmp_path, data_path) -> None:
    paths = {}
    for side, pkg, mod, method in (("port", query, grid, "spawn"), ("jax", jax_query, jax_grid, "fork")):
        (tmp_path / side).mkdir()
        paths[side] = run(pkg, mod, data_path, tmp_path / side, cpu_count=2, decoys=DECOYS[:2], mp_context=method)
    assert_same_files(paths["port"], paths["jax"])


@pytest.mark.parametrize("features", ["all", "tutorial"])
def test_chip_smoke_entries_equal_the_files(tmp_path, data_path, features) -> None:
    """``chip_smoke.py`` featurizes in memory (the card's machine has no
    h5py): its ``featurize``, ``graph_entry`` and ``grid_entry`` give the
    entries the port's datasets load from the file ``process`` writes."""
    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"), run_name="chip_smoke")
    path = run(query, grid, data_path, tmp_path, decoys=DECOYS[:2], grids=True, augmentations=2, seed=11)[0]
    node_features, edge_features = (None, None) if features == "all" else (["res_type"], ["distance"])
    kwargs = {"target": "binary", "use_tqdm": False}
    subset = [f"residue-ppi:A-B:{d}" for d in DECOYS[:2]]
    graphs = dataset.GraphDataset(path, subset=subset, node_features=node_features or "all", edge_features=edge_features or "all", **kwargs)
    grids = dataset.GridDataset(path, **kwargs)
    loaded = {e["entry_name"]: e for e in (graphs.get(i) for i in range(len(graphs)))}
    loaded_grids = {e["entry_name"]: e for e in (grids.get(i) for i in range(len(grids)))}
    random.seed(11)
    made, made_grids = {}, {}
    for q in collection(query, data_path, DECOYS[:2]):
        g, q_grids, times = smoke["featurize"](q, MODULES, grid.GridSettings(*GRID), grid.MapMethod.GAUSSIAN, 2)
        assert set(times["module_ms"]) == set(MODULES) and len(times["grid_ms"]) == 3
        made[g.id] = smoke["graph_entry"](g, node_features, edge_features)
        for q_grid in q_grids:
            made_grids[q_grid.id] = smoke["grid_entry"](q_grid, g)
    if features == "all":
        assert graphs.node_features == sorted(n for n in g.node_features if n[0] != "_")
    assert made.keys() == loaded.keys() and made_grids.keys() == loaded_grids.keys()
    for want, got in ((loaded, made), (loaded_grids, made_grids)):
        for name in want:
            assert sorted(want[name]) == sorted(got[name])
            for key, value in want[name].items():
                if isinstance(value, np.ndarray):
                    assert value.dtype == got[name][key].dtype and np.array_equal(value, got[name][key]), (name, key)
                else:
                    assert value == got[name][key], (name, key)
