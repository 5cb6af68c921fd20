"""The port's Trainer in its multi-device modes (deeprank2_tpu_torch/trainer.py)
over two gloo ranks on the CPU against the JAX Trainer on its 8 virtual CPU
devices, as ``tests/test_trainer.py`` runs the JAX modes: ``data_parallel=True``
with the dense, COO and graph-diagonal clustered models, and the
graph-parallel ``GINetBlockSparseGP`` and ``GINetBlockSparseRing``.

One spawn (``parallel/launch.py``) runs every port Trainer
(``parallel/probes.py:trainer_run``) while the JAX Trainers run here. Both
sides train dropout-free twins (the JAX graph-parallel models read the
single-device model's rate, patched to 0 here) from the JAX Trainer's
initial parameters (``param_interop``), on copies of one HDF5 file, two
shuffled epochs of batches that fill every shard evenly (8 graphs: one a
device in JAX, four a rank in the port), where the data-parallel loss (the
pmean of shard means) and gradients are the whole batch's in both. Every
pass's loss agrees at rtol 1e-5 and the final parameters at atol 1e-5 (the
synced probe's tolerances), on both ranks. Rank 0 alone feeds the
exporters and writes the checkpoint, which a one-process Trainer reads.
"""

from __future__ import annotations

import shutil

import jax
import numpy as np
import pytest

from deeprank2_tpu import dataset as jax_dataset
from deeprank2_tpu import trainer as jax_trainer
from deeprank2_tpu.neuralnets.gnn import ginet_blocksparse as j_gbs
from deeprank2_tpu.neuralnets.gnn import ginet_dense as j_dense
from deeprank2_tpu.neuralnets.gnn import vanilla_gnn as j_vanilla
from deeprank2_tpu.parallel import blocksparse_partition as jbp
from deeprank2_tpu_torch import dataset as port_dataset
from deeprank2_tpu_torch import trainer as port_trainer
from deeprank2_tpu_torch.neuralnets.gnn.ginet_blocksparse import GINetBlockSparse
from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
from deeprank2_tpu_torch.ops.synthetic import geometric_entry, synthetic_entries
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax
from deeprank2_tpu_torch.parallel import launch, probes
from deeprank2_tpu_torch.parallel.blocksparse_partition import GINetBlockSparseGP

RANKS = 2
BATCH = 8
LOSS_TOL = {"rtol": 1e-5, "atol": 0.0}
PARAM_TOL = {"rtol": 0.0, "atol": 1e-5}

# name -> (JAX class, port "module:Class", data_parallel, clustering, target, param_interop family)
MODELS = {
    "GINetDense-dp": (j_dense.GINetDense, "neuralnets.gnn.ginet_dense:GINetDense", True, None, "binary", None),
    "VanillaNetwork-dp-regression": (j_vanilla.VanillaNetwork, "neuralnets.gnn.vanilla_gnn:VanillaNetwork", True, None, "irmsd", "vanilla"),
    "GINetClusteredDiag-dp-mcl": (j_dense.GINetClusteredDiag, "neuralnets.gnn.ginet_dense:GINetClusteredDiag", True, "mcl", "binary", None),
    "GINetBlockSparseGP": (jbp.GINetBlockSparseGP, "parallel.blocksparse_partition:GINetBlockSparseGP", False, None, "binary", None),
    "GINetBlockSparseRing": (jbp.GINetBlockSparseRing, "parallel.blocksparse_partition:GINetBlockSparseRing", False, None, "binary", None),
}


# the first train step against one rank of the single-device model, in memory
ONE_RANK = {
    "GINetDense-dp": {
        "model": "neuralnets.gnn.ginet_dense:GINetDense",
        "dp": True,
        "entries": synthetic_entries(BATCH, 20, 12, 6, seed=4),
        "batch_size": BATCH,
        "one_rank": {"model": "neuralnets.gnn.ginet_dense:GINetDense", "collate": "collate_graphs_dense", "kwargs": {"with_diag_operands": GINetDense.diag_operands}},
    },
    **{
        name: {
            "model": f"parallel.blocksparse_partition:{name}",
            "entries": [geometric_entry(3000, 12, 1, seed=3)],
            "batch_size": 1,
            "one_rank": {"model": "neuralnets.gnn.ginet_blocksparse:GINetBlockSparse", "collate": "collate_graphs_blocksparse"},
        }
        for name in ("GINetBlockSparseGP", "GINetBlockSparseRing")
    },
}
ONE_RANK_TOL = 1e-4  # the logits' atol, and the gradients' relative to the largest


def _datasets(module, path, target, clustering):
    train = module.GraphDataset(hdf5_path=path, target=target, clustering_method=clustering)
    val = module.GraphDataset(hdf5_path=path, train_source=train, clustering_method=clustering) if clustering else None
    return train, val


@pytest.fixture(scope="module")
def runs(srv_hdf5, tmp_path_factory):
    """The ranks' Trainers (spawned first) and the JAX Trainers (run while
    the ranks run)."""
    tmp = tmp_path_factory.mktemp("parallel_trainer")
    mp = pytest.MonkeyPatch()
    mp.setattr(j_gbs.GINetBlockSparse, "dropout", 0.0)  # the JAX graph-parallel models' rate
    try:
        jax_trainers, cases = {}, []
        for name, (jax_cls, port_cls, dp, clustering, target, family) in MODELS.items():
            paths = {side: str(tmp / f"{name}-{side}.hdf5") for side in ("jax", "port")}
            for p in paths.values():
                shutil.copy(srv_hdf5, p)
            train, val = _datasets(jax_dataset, paths["jax"], target, clustering)
            recorder = probes.PassLosses()
            jt = jax_trainer.Trainer(type(jax_cls.__name__, (jax_cls,), {"dropout": 0.0}), dataset_train=train, dataset_val=val, output_exporters=[recorder], seed=7, data_parallel=dp)
            jax_trainers[name] = (jt, recorder)
            state = params_from_jax(jax.tree.map(np.asarray, jt.params), family)
            spec = {"model": port_cls, "dropout_free": True, "dp": dp, "hdf5": paths["port"], "target": target, "clustering_method": clustering, "state": state, "seed": 7, "batch_size": BATCH, "device": "cpu"}
            if name == "GINetBlockSparseGP":
                spec["filename"] = str(tmp / "gp.pth.tar")
            cases.append((name, "trainer_run", spec))
        # batch_size 6 on two ranks: ceil(6 / 2) graphs a shard, the last batch two
        cases.append(("uneven", "trainer_run", {"model": "neuralnets.gnn.vanilla_gnn:VanillaNetwork", "dp": True, "hdf5": str(tmp / "uneven.hdf5"), "batch_size": 6, "nepoch": 1, "device": "cpu"}))
        shutil.copy(srv_hdf5, tmp / "uneven.hdf5")
        for name, spec in ONE_RANK.items():
            cases.append((f"one-rank:{name}", "trainer_run", {**spec, "dropout_free": True, "nepoch": 1, "device": "cpu"}))
        started = launch.start(probes.run_cases, RANKS, cases, threads=2, deadline=240)
        for jt, _ in jax_trainers.values():
            jt.train(nepoch=2, batch_size=BATCH, filename=None)
        results = started.result()
    finally:
        mp.undo()
    return {"ranks": results, "jax": jax_trainers, "tmp": tmp}


@pytest.mark.parametrize("what", ["losses", "parameters", "epochs-and-buckets"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_parallel_trainer_matches_jax(runs, model, what) -> None:
    jt, recorder = runs["jax"][model]
    family = MODELS[model][5]
    rank0 = runs["ranks"][0][model]
    if what == "losses":
        want = recorder.losses
        assert [p[:2] for p in rank0["losses"]] == [p[:2] for p in want] == [("training", 0), ("training", 1), ("training", 2)]
        assert [p[3] for p in rank0["losses"]] == [p[3] for p in want] == [BATCH] * 3  # every graph's output
        np.testing.assert_allclose([p[2] for p in rank0["losses"]], [p[2] for p in want], **LOSS_TOL)
    elif what == "parameters":
        want = params_from_jax(jax.tree.map(np.asarray, jt.params), family)
        for rank in runs["ranks"]:
            got = rank[model]["params"]
            assert got.keys() == want.keys()
            for key, w in want.items():
                np.testing.assert_allclose(got[key], w.numpy(), **PARAM_TOL, err_msg=f"{model} {key}")
    else:
        assert rank0["epoch_saved_model"] == jt.epoch_saved_model
        caps = rank0["bs_caps"]
        if MODELS[model][2]:  # data parallel: the same capacities as JAX's
            assert caps == getattr(jt, "_bs_caps", None)
        else:  # graph parallel: the tiles; the block caps are per device, one a ring step of D - 1
            assert caps["tiles"] == jt._bs_caps["tiles"]
            assert set(caps) <= set(jt._bs_caps)


def test_rank_zero_alone_exports_and_checkpoints(runs) -> None:
    for rank, result in enumerate(runs["ranks"]):
        for model in MODELS:
            assert bool(result[model]["losses"]) == (rank == 0), (rank, model)
    # the graph-parallel checkpoint is the single-device model's: a one-process Trainer tests with it
    path = str(runs["tmp"] / "gp.pth.tar")
    ds = port_dataset.GraphDataset(hdf5_path=str(runs["tmp"] / "GINetBlockSparseGP-port.hdf5"), train_source=path)
    trainer = port_trainer.Trainer(GINetBlockSparse, dataset_test=ds, pretrained_model=path, output_exporters=[probes.PassLosses()], device="cpu")
    trainer.test(batch_size=4)


def test_uneven_batches_take_ceil_capacity(runs) -> None:
    """8 graphs in batches of 6 on two ranks: shards of 3 graphs, every
    graph exported once a pass."""
    losses = runs["ranks"][0]["uneven"]["losses"]
    assert [p[:2] for p in losses] == [("training", 0), ("training", 1)]
    assert all(p[3] == 8 and np.isfinite(p[2]) for p in losses)
    assert runs["ranks"][1]["uneven"]["losses"] == []


@pytest.mark.parametrize("what", ["logits", "gradients", "replicated-parameters"])
@pytest.mark.parametrize("model", sorted(ONE_RANK))
def test_first_step_matches_one_rank(runs, model, what) -> None:
    """The Trainer's first train step on two ranks against the single-device
    model on the whole batch on one rank (its logits, and its gradients
    after the all-reduce), and the parameters equal on both ranks after the
    run: the checks ``chip_smoke.py`` makes on the card."""
    ranks = [r[f"one-rank:{model}"] for r in runs["ranks"]]
    if what == "replicated-parameters":
        for key, value in ranks[0]["params"].items():
            np.testing.assert_array_equal(ranks[1]["params"][key], value, err_msg=key)
        return
    for r in ranks:
        check = r["one_rank"]
        assert check["graphs"] == len(ONE_RANK[model]["entries"])
        if what == "logits":
            assert check["max_err"] < ONE_RANK_TOL
        else:
            assert check["grad_err"] <= ONE_RANK_TOL * max(1.0, check["grad_max"])
            assert check["grad_max"] > 0


def test_graph_parallel_with_data_parallel_raises(srv_hdf5) -> None:
    ds = port_dataset.GraphDataset(hdf5_path=srv_hdf5, target="binary")
    with pytest.raises(ValueError, match="graph_parallel"):
        port_trainer.Trainer(GINetBlockSparseGP, dataset_train=ds, output_exporters=[], data_parallel=True, device="cpu")


def test_ngpu_above_one_names_data_parallel(srv_hdf5) -> None:
    ds = port_dataset.GraphDataset(hdf5_path=srv_hdf5, target="binary")
    with pytest.raises(ValueError, match="data_parallel=True"):
        port_trainer.Trainer(GINetBlockSparse, dataset_train=ds, output_exporters=[], ngpu=2, device="cpu")


def test_one_process_runs_data_parallel_as_one_device(srv_hdf5, tmp_path) -> None:
    """Outside a process group ``data_parallel=True`` trains one device, and
    a graph-parallel model its one part, as JAX with one device."""
    path = str(tmp_path / "data.hdf5")
    shutil.copy(srv_hdf5, path)
    for cls, dp in ((GINetBlockSparse, True), (GINetBlockSparseGP, False)):
        recorder = probes.PassLosses()
        trainer = port_trainer.Trainer(cls, dataset_train=port_dataset.GraphDataset(hdf5_path=path, target="binary"), output_exporters=[recorder], data_parallel=dp, device="cpu")
        trainer.train(nepoch=1, batch_size=4, filename=None)
        assert trainer._num_shards == 1 and len(recorder.losses) == 2
