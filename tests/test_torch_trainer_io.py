"""The port's Trainer: checkpoints within the port and across the two
packages, mid-training resume, the error cases of the JAX Trainer's tests
(tests/test_trainer.py) that apply to the port, the batch layouts still to
port, and the remaining layouts' models training through it."""

from __future__ import annotations

import shutil
import warnings
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeprank2_tpu import dataset as jax_dataset
from deeprank2_tpu import trainer as jax_trainer
from deeprank2_tpu.neuralnets.gnn import ginet_dense as jax_ginet_dense
from deeprank2_tpu.neuralnets.gnn import vanilla_gnn as jax_vanilla
from deeprank2_tpu_torch import trainer as port_trainer
from deeprank2_tpu_torch.dataset import GraphDataset, GridDataset
from deeprank2_tpu_torch.neuralnets.gnn.clustered_blocksparse import FoutNetBlockSparse, GINetClusteredBlockSparse, SGATBlockSparse
from deeprank2_tpu_torch.neuralnets.gnn.foutnet import FoutNet, FoutNetDiag
from deeprank2_tpu_torch.neuralnets.gnn.ginet import GINet
from deeprank2_tpu_torch.neuralnets.gnn.ginet_blocksparse import GINetBlockSparse
from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetClusteredDiag, GINetDense
from deeprank2_tpu_torch.neuralnets.gnn.sgat import SGAT, SGATDiag
from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetwork, VanillaNetworkBlocked
from deeprank2_tpu_torch.ops import losses, optim
from deeprank2_tpu_torch.utils.checkpoint import load_checkpoint

CROSS_TOL = {"rtol": 1e-5, "atol": 1e-5}
PORT_TO_JAX = {"VanillaNetwork": (VanillaNetwork, jax_vanilla.VanillaNetwork), "GINetDense": (GINetDense, jax_ginet_dense.GINetDense)}


class Outputs:
    """An output exporter that keeps each pass's outputs by entry."""

    def __init__(self):
        self.passes = []

    def __enter__(self):
        return self

    def __exit__(self, *exc_info) -> None:
        pass

    def is_compatible_with(self, output_data_shape, target_data_shape=None) -> bool:  # noqa: ARG002
        return True

    def process(self, pass_name, epoch_number, entry_names, output_values, target_values, loss) -> None:  # noqa: ARG002
        self.passes.append((pass_name, dict(zip(entry_names, output_values)), loss))


@pytest.fixture
def hdf5_copy(srv_hdf5, tmp_path) -> str:
    """The fixture file, copied: preclustering writes into its source."""
    path = tmp_path / "srv.hdf5"
    shutil.copy(srv_hdf5, path)
    return str(path)


def _train(model, path, tmp_path, nepoch=2, target="binary", **kwargs):
    trainer = port_trainer.Trainer(model, dataset_train=GraphDataset(hdf5_path=path, target=target), output_exporters=[], device="cpu", **kwargs)
    trainer.train(nepoch=nepoch, batch_size=4, filename=str(tmp_path / "model.pth.tar"))
    return trainer


def _test_outputs(trainer) -> dict:
    exporter = Outputs()
    trainer._output_exporters = jax_trainer.OutputExporterCollection(exporter) if isinstance(trainer, jax_trainer.Trainer) else port_trainer.OutputExporterCollection(exporter)
    trainer.test(batch_size=4)
    (name, outputs, _), = exporter.passes
    assert name == "testing"
    return outputs


def _assert_outputs_close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys() and len(got) == 8
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **CROSS_TOL, err_msg=key)


@pytest.mark.parametrize("model", [VanillaNetwork, GINetDense], ids=lambda m: m.__name__)
def test_save_load_same_predictions(srv_hdf5, tmp_path, model) -> None:
    """A reloaded port checkpoint gives the same predictions (the twin of
    tests/test_trainer.py:test_save_load_same_predictions), and the file is
    the reference's format: a torch.save zip of the JAX ``_save_model``
    dict's 29 keys, whose loss is the torch.nn twin of the port's."""
    trainer = _train(model, srv_hdf5, tmp_path, nepoch=3)
    path = str(tmp_path / "model.pth.tar")
    assert zipfile.is_zipfile(path)
    raw = torch.load(path, weights_only=False)
    assert len(raw) == 29 and type(raw["lossfunction"]) is torch.nn.CrossEntropyLoss and raw["optimizer"] is optim.Adam
    assert raw["model_state"].keys() == trainer.model.state_dict().keys() and (raw["cuda"], raw["ngpu"]) == (False, 0)
    state = load_checkpoint(path)
    assert state["lossfunction"] == losses.CrossEntropyLoss() and state["optimizer_state"]["state"]

    ds_test = GraphDataset(hdf5_path=srv_hdf5, train_source=path)
    trainer2 = port_trainer.Trainer(model, dataset_test=ds_test, pretrained_model=path, device="cpu")
    trainer2._build_step_functions()
    trainer._build_step_functions()
    for i in range(len(ds_test)):
        batch1, _ = trainer._collate([trainer.dataset_train.get(i)], pad_graphs=1)
        batch2, _ = trainer2._collate([ds_test.get(i)], pad_graphs=1)
        _, pred1 = trainer._eval_step(batch1)
        _, pred2 = trainer2._eval_step(batch2)
        np.testing.assert_allclose(pred1.numpy(), pred2.numpy(), rtol=0, atol=1e-6)
    assert trainer2.optimizer.state_dict()["state"].keys() == trainer.optimizer.state_dict()["state"].keys()


@pytest.mark.parametrize("model", sorted(PORT_TO_JAX))
def test_jax_checkpoint_loads_into_the_port(srv_hdf5, tmp_path, model) -> None:
    port_cls, jax_cls = PORT_TO_JAX[model]
    path = str(tmp_path / "jax.pth.tar")
    jt = jax_trainer.Trainer(jax_cls, dataset_train=jax_dataset.GraphDataset(hdf5_path=srv_hdf5, target="binary"), output_exporters=[])
    jt.configure_optimizers(jax_trainer.optim.SGD, lr=0.05, weight_decay=1e-4)
    jt.train(nepoch=2, batch_size=4, filename=path)
    want = _test_outputs(jax_trainer.Trainer(jax_cls, dataset_test=jax_dataset.GraphDataset(hdf5_path=srv_hdf5, train_source=path), pretrained_model=path))
    pt = port_trainer.Trainer(port_cls, dataset_test=GraphDataset(hdf5_path=srv_hdf5, train_source=path), pretrained_model=path, device="cpu")
    assert type(pt.optimizer) is optim.SGD and (pt.lr, pt.weight_decay) == (0.05, 1e-4)
    assert pt.lossfunction == losses.CrossEntropyLoss() and pt.opt_loaded_state_dict is None
    _assert_outputs_close(_test_outputs(pt), want)


@pytest.mark.parametrize("model", sorted(PORT_TO_JAX))
def test_port_checkpoint_loads_into_jax(srv_hdf5, tmp_path, model) -> None:
    port_cls, jax_cls = PORT_TO_JAX[model]
    path = str(tmp_path / "port.pth.tar")
    pt = port_trainer.Trainer(port_cls, dataset_train=GraphDataset(hdf5_path=srv_hdf5, target="binary"), output_exporters=[], device="cpu")
    pt.configure_optimizers(optim.AdamW, lr=0.01, weight_decay=1e-3)
    pt.train(nepoch=2, batch_size=4, filename=path)
    want = _test_outputs(port_trainer.Trainer(port_cls, dataset_test=GraphDataset(hdf5_path=srv_hdf5, train_source=path), pretrained_model=path, device="cpu"))
    jt = jax_trainer.Trainer(jax_cls, dataset_test=jax_dataset.GraphDataset(hdf5_path=srv_hdf5, train_source=path), pretrained_model=path)
    assert jt._optimizer_cls is jax_trainer.optim.AdamW and (jt.lr, jt.weight_decay) == (0.01, 1e-3)
    assert type(jt.lossfunction).__name__ == "CrossEntropyLoss"
    _assert_outputs_close(_test_outputs(jt), want)


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms: the CPU's multithreaded index_add
    (the COO models' segment sums and gathers' backward) otherwise sums in
    an order that changes from run to run."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("model", [VanillaNetwork, GINetDense], ids=lambda m: m.__name__)
def test_midtraining_resume_matches_uninterrupted(srv_hdf5, tmp_path, deterministic, model) -> None:
    """A run interrupted at epoch 2 and resumed to epoch 4 is the
    uninterrupted 4-epoch run bit for bit on the CPU (shuffled batches; and
    dropout, whose generator the snapshot carries, for GINetDense)."""

    def make_trainer():
        ds = GraphDataset(hdf5_path=srv_hdf5, target="binary")
        return port_trainer.Trainer(model, dataset_train=ds, output_exporters=[], seed=11, device="cpu")

    straight = make_trainer()
    straight.train(nepoch=4, batch_size=4, filename=None)

    snap = str(tmp_path / "resume.pth.tar")
    interrupted = make_trainer()
    interrupted.train(nepoch=2, batch_size=4, filename=None, checkpoint_every=1, checkpoint_path=snap)

    resumed = make_trainer()
    resumed.train(nepoch=4, batch_size=4, filename=None, resume_from=snap)

    assert resumed.epoch_saved_model == straight.epoch_saved_model
    for (key, a), (_, b) in zip(straight.model.state_dict().items(), resumed.model.state_dict().items()):
        assert torch.equal(a, b), key
    assert [p["seconds"] > 0 for p in resumed.pass_stats]
    with pytest.raises(ValueError, match="nothing to resume"):
        make_trainer().train(nepoch=2, batch_size=4, filename=None, resume_from=snap)


# the error cases of tests/test_trainer.py that apply to the port
def test_incompatible_exporter_regression(srv_hdf5, tmp_path) -> None:
    from deeprank2_tpu_torch.utils.exporters import TensorboardBinaryClassificationExporter

    ds = GraphDataset(hdf5_path=srv_hdf5, target="irmsd", task="regress")
    with pytest.raises(ValueError, match="compatible"):
        port_trainer.Trainer(VanillaNetwork, dataset_train=ds, output_exporters=[TensorboardBinaryClassificationExporter(str(tmp_path))], device="cpu")


def test_pretrained_and_training_errors(srv_hdf5, tmp_path) -> None:
    ds = GraphDataset(hdf5_path=srv_hdf5, target="binary")
    with pytest.raises(ValueError, match="[Nn]o neural network"):
        port_trainer.Trainer(neuralnet=None, dataset_train=ds, device="cpu")
    model_path = str(tmp_path / "model.pth.tar")
    _train(VanillaNetwork, srv_hdf5, tmp_path)
    with pytest.raises(ValueError, match="dataset_test"):
        port_trainer.Trainer(VanillaNetwork, pretrained_model=model_path, device="cpu")
    ds_test = GraphDataset(hdf5_path=srv_hdf5, train_source=model_path)
    with pytest.raises(ValueError, match="[Nn]o neural network"):
        port_trainer.Trainer(neuralnet=None, dataset_test=ds_test, pretrained_model=model_path, device="cpu")
    trainer = port_trainer.Trainer(VanillaNetwork, dataset_test=ds_test, pretrained_model=model_path, device="cpu")
    with pytest.raises(ValueError, match="[Nn]o training dataset"):
        trainer.train(nepoch=1, batch_size=4, filename=None)
    fresh = port_trainer.Trainer(
        VanillaNetwork, dataset_train=ds, dataset_test=GraphDataset(hdf5_path=srv_hdf5, train_source=ds), output_exporters=[], device="cpu"
    )
    with pytest.raises(ValueError, match="No pretrained model"):
        fresh.test()
    with pytest.raises(ValueError, match="train or test dataset"):
        port_trainer.Trainer(VanillaNetwork, device="cpu")
    with pytest.raises(ValueError):
        GraphDataset(hdf5_path=srv_hdf5)  # no target set


def test_dataset_equivalence_no_pretrained(srv_hdf5) -> None:
    train = GraphDataset(hdf5_path=srv_hdf5, target="binary")
    val_plain = GraphDataset(hdf5_path=srv_hdf5, target="binary")
    with pytest.raises(ValueError, match="train_source"):
        port_trainer.Trainer(VanillaNetwork, dataset_train=train, dataset_val=val_plain, device="cpu")
    other = GraphDataset(hdf5_path=srv_hdf5, target="binary", node_features=["res_mass"])
    val_other = GraphDataset(hdf5_path=srv_hdf5, train_source=other)
    with pytest.raises(ValueError, match="train_source"):
        port_trainer.Trainer(VanillaNetwork, dataset_train=train, dataset_val=val_other, device="cpu")


def test_optim_survives_save_load(srv_hdf5, tmp_path) -> None:
    ds = GraphDataset(hdf5_path=srv_hdf5, target="binary")
    trainer = port_trainer.Trainer(VanillaNetwork, dataset_train=ds, output_exporters=[], device="cpu")
    assert trainer._optimizer_cls is optim.Adam and (trainer.lr, trainer.weight_decay) == (1e-3, 1e-5)
    with pytest.raises(ValueError, match="Invalid optimizer"):
        trainer.configure_optimizers(torch.optim.SGD)
    trainer.configure_optimizers(optim.SGD, lr=0.05, weight_decay=1e-4)
    model_path = str(tmp_path / "model.pth.tar")
    trainer.train(nepoch=1, batch_size=4, filename=model_path)
    pretrained = port_trainer.Trainer(VanillaNetwork, dataset_test=GraphDataset(hdf5_path=srv_hdf5, train_source=model_path), pretrained_model=model_path, device="cpu")
    assert pretrained._optimizer_cls is optim.SGD and pretrained.lr == 0.05
    pretrained.test(batch_size=4)


def test_invalid_sizes_devices_and_losses(srv_hdf5) -> None:
    n = len(GraphDataset(hdf5_path=srv_hdf5, target="binary"))
    for bad in (1.0, n, -0.5, "half"):
        with pytest.raises((ValueError, TypeError)):
            port_trainer.Trainer(VanillaNetwork, dataset_train=GraphDataset(hdf5_path=srv_hdf5, target="binary"), val_size=bad, device="cpu")
    ds = GraphDataset(hdf5_path=srv_hdf5, target="binary")
    for kwargs in ({"cuda": True}, {"ngpu": 1}, {"ngpu": 2}):
        with pytest.raises(ValueError, match="ngpu|contradict"):
            port_trainer.Trainer(VanillaNetwork, dataset_train=ds, device="cpu", **kwargs)
    trainer = port_trainer.Trainer(VanillaNetwork, dataset_train=ds, output_exporters=[], device="cpu")
    with pytest.raises(ValueError, match="not appropriate"):
        trainer.set_lossfunction(losses.MSELoss)
    with pytest.raises(ValueError, match="not appropriate"):
        trainer.set_lossfunction(losses.CTCLoss)
    trainer.set_lossfunction(losses.BCELoss)
    with pytest.raises(ValueError, match="not supported"):
        trainer.train(nepoch=1, batch_size=4, filename=None)
    trainer.set_lossfunction(losses.MultiLabelSoftMarginLoss)
    with pytest.raises(ValueError, match="not supported"):
        trainer.train(nepoch=1, batch_size=4, filename=None)
    weighted = port_trainer.Trainer(VanillaNetwork, dataset_train=ds, class_weights=True, output_exporters=[], device="cpu")
    weighted.set_lossfunction(losses.MultiLabelSoftMarginLoss)
    with pytest.raises(ValueError, match="weighted classes"):
        weighted.train(nepoch=1, batch_size=4, filename=None)
    with pytest.raises(ValueError, match="needs preclustered data"):
        port_trainer.Trainer(GINetClusteredDiag, dataset_train=ds, output_exporters=[], device="cpu")


def test_class_weights_and_nan_losses(srv_hdf5, tmp_path) -> None:
    ds = GraphDataset(hdf5_path=srv_hdf5, target="binary")
    trainer = port_trainer.Trainer(VanillaNetwork, dataset_train=ds, class_weights=True, output_exporters=[], device="cpu")
    trainer.train(nepoch=1, batch_size=4, filename=None)
    assert trainer.weights is not None and torch.is_tensor(trainer.lossfunction.weight)

    ds_valid = GraphDataset(hdf5_path=srv_hdf5, train_source=ds)
    trainer = port_trainer.Trainer(VanillaNetwork, dataset_train=ds, dataset_val=ds_valid, output_exporters=[], device="cpu")
    trainer.configure_optimizers(optim.SGD, lr=10000, weight_decay=10000)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer.train(nepoch=3, batch_size=1, validate=True, filename=str(tmp_path / "nan.pth.tar"))
    assert any("losses were NaN" in str(w.message) for w in caught if issubclass(w.category, UserWarning))


def test_orbax_checkpoints_are_jax_only(srv_hdf5, tmp_path) -> None:
    ds = GraphDataset(hdf5_path=srv_hdf5, target="binary")
    trainer = port_trainer.Trainer(VanillaNetwork, dataset_train=ds, output_exporters=[], device="cpu")
    with pytest.raises(NotImplementedError, match="orbax"):
        trainer.train(nepoch=1, batch_size=4, filename=str(tmp_path / "model.orbax"))
    with pytest.raises(NotImplementedError, match="orbax"):
        load_checkpoint(str(tmp_path / "model.orbax"))


def _later(attr: str, base=GINetDense):
    return type(f"{base.__name__}With_{attr}", (base,), {attr: True})


# case -> (model, clustering, the layout the Trainer now collates it in, or
# the text of the NotImplementedError a layout still to port raises)
LATER = {
    "GINetBlockSparse": (GINetBlockSparse, None, "blocksparse"),
    "GINetClusteredBlockSparse": (GINetClusteredBlockSparse, "mcl", "clustered_blocksparse"),
    "FoutNetBlockSparse": (FoutNetBlockSparse, "mcl", "clustered_blocksparse"),
    "SGATBlockSparse": (SGATBlockSparse, "mcl", "clustered_blocksparse"),
    "VanillaNetworkBlocked": (VanillaNetworkBlocked, None, "blocked"),
    "graph_parallel": (_later("graph_parallel"), None, "graph-parallel.*ROADMAP §1 item 8"),
    "dense_with_clusters": (_later("needs_clusters"), "mcl", "dense"),
    "dense_edge_weights": (_later("dense_edge_weights"), None, "dense"),
}


@pytest.mark.parametrize("case", sorted(LATER))
def test_layouts_still_to_port_raise(hdf5_copy, case) -> None:
    """Only graph_parallel is still to port among these (ROADMAP §1 item 8);
    the others, once refused, now collate in their layout on the host."""
    model, clustering, want = LATER[case]
    ds = GraphDataset(hdf5_path=hdf5_copy, target="binary", clustering_method=clustering)
    if case == "graph_parallel":
        with pytest.raises(NotImplementedError, match=want):
            port_trainer.Trainer(model, dataset_train=ds, output_exporters=[], device="cpu")
        return
    trainer = port_trainer.Trainer(model, dataset_train=ds, output_exporters=[], device="cpu")
    assert trainer._layout() == want
    batch, names = trainer._collate([trainer.dataset_train.get(i) for i in range(2)], pad_graphs=3)
    assert len(names) == 3 and all(t.device.type == "cpu" for t in port_trainer._tensor_fields(batch))


def test_data_parallel_and_grids_raise(srv_hdf5, grid_hdf5) -> None:
    ds = GraphDataset(hdf5_path=srv_hdf5, target="binary")
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 8"):
        port_trainer.Trainer(VanillaNetwork, dataset_train=ds, data_parallel=True, device="cpu")
    grids = GridDataset(hdf5_path=grid_hdf5, target="binary")
    assert len(grids) == 4 and grids.get(0)["x"].ndim == 4
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 7"):
        port_trainer.Trainer(VanillaNetwork, dataset_train=grids, output_exporters=[], device="cpu")


TRAINS = {
    "FoutNet": (FoutNet, {}),
    "SGAT": (SGAT, {"edge_features": ["distance"]}),
    "FoutNetDiag": (FoutNetDiag, {}),
    "SGATDiag": (SGATDiag, {"edge_features": ["distance"]}),
    "GINet-louvain": (GINet, {"clustering_method": "louvain"}),
}


@pytest.mark.parametrize("case", sorted(TRAINS))
def test_clustered_models_train(hdf5_copy, tmp_path, case) -> None:
    """The clustered COO models and the graph-diagonal FoutNet and sGAT
    (sGAT on the weighted adjacency) train through the Trainer; the
    graph-diagonal buckets grow and the layout is pinned on the first batch."""
    model, kwargs = TRAINS[case]
    kwargs = {"clustering_method": "mcl", **kwargs}
    trainer = port_trainer.Trainer(model, dataset_train=GraphDataset(hdf5_path=hdf5_copy, target="binary", **kwargs), output_exporters=[], device="cpu")
    trainer.train(nepoch=1, batch_size=4, filename=None)
    assert trainer.epoch_saved_model == 1 and all(np.isfinite(p["seconds"]) for p in trainer.pass_stats)
    if getattr(model, "diag_clustered_batches", False):
        caps = dict(trainer._bs_caps)
        assert caps["dc_nodes"] > 0 and "dc_layout_msn" in caps
        trainer._collate([trainer.dataset_train.get(0)], pad_graphs=1)
        assert trainer._bs_caps == caps


def test_jax_params_roundtrip_through_a_checkpoint(srv_hdf5, tmp_path) -> None:
    """The JAX checkpoint's parameter tree becomes the port's state_dict
    exactly (param_interop, "vanilla" family)."""
    path = str(tmp_path / "jax.pth.tar")
    jt = jax_trainer.Trainer(jax_vanilla.VanillaNetwork, dataset_train=jax_dataset.GraphDataset(hdf5_path=srv_hdf5, target="binary"), output_exporters=[])
    jt.train(nepoch=1, batch_size=4, filename=path)
    pt = port_trainer.Trainer(VanillaNetwork, dataset_test=GraphDataset(hdf5_path=srv_hdf5, train_source=path), pretrained_model=path, device="cpu")
    from deeprank2_tpu_torch.neuralnets.param_interop import params_to_jax

    got = params_to_jax(pt.model.state_dict(), "vanilla")
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jt.params))):
        assert pa == pb and np.array_equal(a, b)
