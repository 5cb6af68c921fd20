"""The port's Trainer (deeprank2_tpu_torch/trainer.py) against the JAX
package's in the synced probe: dropout-free twins of one model on both
sides, the JAX Trainer's initial parameters loaded into the port's model
(neuralnets/param_interop.py) before ``configure_optimizers()``, the same
HDF5 file, seed, split and batch order (``shuffle=False``), two epochs with
validation; the graph models on the SRV graphs, the CNNs on the grid file
through the Trainer's grid branch. Every pass's loss (the epoch-0 evaluations, each epoch's
training and validation) agrees at rtol 1e-5, and the final parameters (the
best model, which both Trainers restore after training) at atol 1e-5; the
Trainers that bucket their capacities end with the same buckets."""

from __future__ import annotations

import shutil

import jax
import numpy as np
import pytest

from deeprank2_tpu import dataset as jax_dataset
from deeprank2_tpu import trainer as jax_trainer
from deeprank2_tpu.neuralnets.cnn import model3d as jax_model3d
from deeprank2_tpu.neuralnets.gnn import clustered_blocksparse as jax_clustered_blocksparse
from deeprank2_tpu.neuralnets.gnn import foutnet as jax_foutnet
from deeprank2_tpu.neuralnets.gnn import ginet as jax_ginet
from deeprank2_tpu.neuralnets.gnn import ginet_blocksparse as jax_ginet_blocksparse
from deeprank2_tpu.neuralnets.gnn import ginet_dense as jax_ginet_dense
from deeprank2_tpu.neuralnets.gnn import ginet_nocluster as jax_ginet_nocluster
from deeprank2_tpu.neuralnets.gnn import sgat as jax_sgat
from deeprank2_tpu.neuralnets.gnn import vanilla_gnn as jax_vanilla
from deeprank2_tpu_torch import dataset as port_dataset
from deeprank2_tpu_torch import trainer as port_trainer
from deeprank2_tpu_torch.neuralnets.cnn import model3d
from deeprank2_tpu_torch.neuralnets.gnn import clustered_blocksparse, foutnet, ginet, ginet_blocksparse, ginet_dense, ginet_nocluster, sgat, vanilla_gnn
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax

LOSS_TOL = {"rtol": 1e-5, "atol": 0.0}
PARAM_TOL = {"rtol": 0.0, "atol": 1e-5}


def _dropout_free(cls):
    return type(cls.__name__, (cls,), {"dropout": 0.0})


# model -> (JAX class, port class, target, clustering method, param_interop family)
MODELS = {
    "GINetDense": (jax_ginet_dense.GINetDense, ginet_dense.GINetDense, "binary", None, None),
    "GINetNoCluster": (jax_ginet_nocluster.GINet, ginet_nocluster.GINet, "binary", None, None),
    "GINet-mcl": (jax_ginet.GINet, ginet.GINet, "binary", "mcl", None),
    "VanillaNetwork-regression": (jax_vanilla.VanillaNetwork, vanilla_gnn.VanillaNetwork, "irmsd", None, "vanilla"),
    "GINetClusteredDiag-mcl": (jax_ginet_dense.GINetClusteredDiag, ginet_dense.GINetClusteredDiag, "binary", "mcl", None),
    # the block-sparse, clustered block-sparse and blocked-edge branches, with
    # their grow-only capacity buckets, and the batched dense family
    "GINetBlockSparse": (jax_ginet_blocksparse.GINetBlockSparse, ginet_blocksparse.GINetBlockSparse, "binary", None, None),
    "GINetClusteredBlockSparse-mcl": (jax_clustered_blocksparse.GINetClusteredBlockSparse, clustered_blocksparse.GINetClusteredBlockSparse, "binary", "mcl", None),
    "SGATBlockSparse-mcl": (jax_clustered_blocksparse.SGATBlockSparse, clustered_blocksparse.SGATBlockSparse, "binary", "mcl", "sgat"),
    "FoutNetBlockSparse-mcl": (jax_clustered_blocksparse.FoutNetBlockSparse, clustered_blocksparse.FoutNetBlockSparse, "binary", "mcl", "foutnet"),
    "VanillaNetworkBlocked": (jax_vanilla.VanillaNetworkBlocked, vanilla_gnn.VanillaNetworkBlocked, "binary", None, "vanilla"),
    "GINetClusteredDense-mcl": (jax_ginet_dense.GINetClusteredDense, ginet_dense.GINetClusteredDense, "binary", "mcl", None),
    "FoutNetDense-mcl": (jax_foutnet.FoutNetDense, foutnet.FoutNetDense, "binary", "mcl", "foutnet"),
    "SGATDense-mcl": (jax_sgat.SGATDense, sgat.SGATDense, "binary", "mcl", "sgat"),
    # the grid branch (GridDataset, collate_grids)
    "CnnClassification": (jax_model3d.CnnClassification, model3d.CnnClassification, "binary", None, "cnn"),
    "CnnRegression": (jax_model3d.CnnRegression, model3d.CnnRegression, "irmsd", None, "cnn"),
}


class PassLosses:
    """An output exporter that keeps each pass's loss."""

    def __init__(self):
        self.losses = []

    def __enter__(self):
        return self

    def __exit__(self, *exc_info) -> None:
        pass

    def is_compatible_with(self, output_data_shape, target_data_shape=None) -> bool:  # noqa: ARG002
        return True

    def process(self, pass_name, epoch_number, entry_names, output_values, target_values, loss) -> None:  # noqa: ARG002
        self.losses.append((pass_name, epoch_number, loss))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_trainer_matches_jax_in_the_synced_probe(request, tmp_path, model) -> None:
    jax_cls, port_cls, target, clustering, family = MODELS[model]
    grid = family == "cnn"
    # the fixture file, copied: preclustering writes into its source
    hdf5_copy = str(tmp_path / "data.hdf5")
    shutil.copy(request.getfixturevalue("grid_hdf5" if grid else "srv_hdf5"), hdf5_copy)
    kwargs = {"target": target} if grid else {"target": target, "clustering_method": clustering}
    kind = "GridDataset" if grid else "GraphDataset"
    jax_losses, port_losses = PassLosses(), PassLosses()
    jt = jax_trainer.Trainer(
        _dropout_free(jax_cls), dataset_train=getattr(jax_dataset, kind)(hdf5_path=hdf5_copy, **kwargs), val_size=2, output_exporters=[jax_losses], seed=7
    )
    pt = port_trainer.Trainer(
        _dropout_free(port_cls),
        dataset_train=getattr(port_dataset, kind)(hdf5_path=hdf5_copy, **kwargs),
        val_size=2,
        output_exporters=[port_losses],
        seed=7,
        device="cpu",
    )
    assert [e for _, e in pt.dataset_val.index_entries] == [e for _, e in jt.dataset_val.index_entries]
    pt.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jt.params), family))
    pt.configure_optimizers()

    for trainer in (jt, pt):
        trainer.train(nepoch=2, batch_size=4, shuffle=False, validate=True, filename=None)

    assert [p[:2] for p in port_losses.losses] == [p[:2] for p in jax_losses.losses] == [
        ("training", 0),
        ("validation", 0),
        ("training", 1),
        ("validation", 1),
        ("training", 2),
        ("validation", 2),
    ]
    np.testing.assert_allclose([p[2] for p in port_losses.losses], [p[2] for p in jax_losses.losses], **LOSS_TOL, err_msg=model)
    assert pt.epoch_saved_model == jt.epoch_saved_model
    want = params_from_jax(jax.tree.map(np.asarray, jt.params), family)
    got = pt.model.state_dict()
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), **PARAM_TOL, err_msg=f"{model} {key}")
    # the grow-only capacity buckets: the same keys and capacities
    assert getattr(pt, "_bs_caps", None) == getattr(jt, "_bs_caps", None)

