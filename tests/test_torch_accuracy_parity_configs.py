"""The accuracy-parity twin against the JAX harness on the ten configurations
that the smoke pair (tests/test_torch_accuracy_parity_smoke.py) leaves out,
one epoch each on a few queries of each corpus flavor and the same
``subset`` in both sides' dataset arguments.

The JAX side runs ``run_trainer_config`` on HDF5 files of the port's
featurization; the port's side reads its own ``MemoryStore`` of the same
queries (``store="memory"``), so the h5py-free route is held to the JAX
harness end to end: preclustering, standardization and targets included.
Both sides start from the JAX Trainer's initial parameters (the ones the
JAX harness hands its mirror), the port's Trainer steps with the JAX rule's
``Adam``, and both mirrors run under ``torch.use_deterministic_algorithms``:

- the port's mirror losses are the JAX mirror's, bit for bit;
- the port's Trainer's epoch matches the JAX Trainer's at ``LOSS_TOL``, and
  so does one epoch from the JAX harness's synced-probe parameters;
- both sides' metrics (each from its Trainer's exported probabilities) agree
  at the JAX smoke test's gate, and the port's report holds the JAX gate
  against its own mirror."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from deeprank2_tpu.neuralnets.cnn.model3d import CnnClassification as JaxCnn
from deeprank2_tpu.neuralnets.gnn.clustered_blocksparse import GINetClusteredBlockSparse as JaxGINetClusteredBlockSparse
from deeprank2_tpu.neuralnets.gnn.foutnet import FoutNet as JaxFoutNet
from deeprank2_tpu.neuralnets.gnn.ginet import GINet as JaxGINet
from deeprank2_tpu.neuralnets.gnn.ginet_blocksparse import GINetBlockSparse as JaxGINetBlockSparse
from deeprank2_tpu.neuralnets.gnn.ginet_dense import GINetClusteredDiag as JaxGINetClusteredDiag
from deeprank2_tpu.neuralnets.gnn.ginet_dense import GINetDense as JaxGINetDense
from deeprank2_tpu.neuralnets.gnn.sgat import SGAT as JaxSGAT
from deeprank2_tpu.neuralnets.gnn.vanilla_gnn import VanillaNetwork as JaxVanilla
from deeprank2_tpu.neuralnets.gnn.vanilla_gnn import VanillaNetworkBlocked as JaxVanillaBlocked
from deeprank2_tpu.tools import accuracy_parity as jap
from deeprank2_tpu.utils.exporters import HDF5OutputExporter
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax
from deeprank2_tpu_torch.ops import optim
from deeprank2_tpu_torch.tools import accuracy_parity as pap
from deeprank2_tpu_torch.trainer import Trainer, _param_family

LOSS_TOL = {"rtol": 1e-5, "atol": 0.0}
SUBSET = 5  # entries of each flavor's corpus in the subset


def _no_dropout(cls):
    return type(cls.__name__, (cls,), {"dropout": 0.0})


# the JAX harness's model of each configuration (deeprank2_tpu/tools/accuracy_parity.py:run_all)
JAX_MODELS = {
    "vanilla_srv_classif": JaxVanilla,
    "ginet_ppi_classif": _no_dropout(JaxGINet),
    "ginet_dense_diag_classif": _no_dropout(JaxGINetDense),
    "ginet_bcsr_classif": _no_dropout(JaxGINetBlockSparse),
    "vanilla_blocked_classif": JaxVanillaBlocked,
    "ginet_clustered_bcsr_classif": _no_dropout(JaxGINetClusteredBlockSparse),
    "ginet_clustered_diag_classif": _no_dropout(JaxGINetClusteredDiag),
    "fout_atom_classif": JaxFoutNet,
    "sgat_atom_classif": JaxSGAT,
    "cnn_grid_classif": JaxCnn,
}
PPI_PICK = ("1ATN_1w", "1ATN_2w", "1ATN_3w", "3C8P", "1ATN_rb02", "3C8P_rb01", "1ak4")


@pytest.fixture(scope="module", autouse=True)
def _exact_and_deterministic():
    """JAX's f32 products exact, torch's sums in one order; and torch on one
    thread (small tensors: the test runs beside others on the same cores)."""
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.use_deterministic_algorithms(True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    torch.use_deterministic_algorithms(False)
    jax.config.update("jax_default_matmul_precision", None)


def _queries(data_path, decoy_dir, flavor):
    if flavor == "srv_residue":
        return pap.assemble_srv_queries(data_path, per_source=2)
    res = "atom" if flavor == "ppi_atom" else "residue"
    queries = pap.assemble_ppi_queries(data_path, res, decoy_dir, decoys_per_complex=2)
    return [q for q in queries if any(q.get_query_id().endswith(f":{p}") for p in PPI_PICK)]


@pytest.fixture(scope="module")
def corpora(data_path, tmp_path_factory):
    """``{flavor: (HDF5 path for the JAX side, MemoryStore for the port)}``."""
    root = tmp_path_factory.mktemp("parity_configs")
    out = {}
    for flavor in ("srv_residue", "ppi_residue", "ppi_atom", "ppi_grid"):
        file_src = pap.featurize_queries(_queries(data_path, root / "decoys_file", flavor), flavor, root / "file", "hdf5")
        mem_src = pap.featurize_queries(_queries(data_path, root / "decoys_memory", flavor), flavor, root / "memory", "memory")
        out[flavor] = (file_src, mem_src)
    return out, root


def _port_epoch_from(source, config, params, ds_kwargs) -> float:
    """One training epoch of the port's Trainer from ``params`` (JAX
    layout) with a fresh JAX-rule Adam: the synced probe's port side."""
    model_cls, _, task, target, batch_size, clustered, _, grid = pap.config_table()[config]
    train, val = pap.make_datasets(source, target=target, task=task, clustered=clustered, grid=grid, ds_kwargs=ds_kwargs)
    recorder = pap.PassRecorder()
    trainer = Trainer(model_cls, dataset_train=train, dataset_val=val, output_exporters=[recorder], seed=7, device="cpu")
    trainer.model.load_state_dict(params_from_jax(params, _param_family(model_cls)))
    trainer.configure_optimizers(optim.Adam)
    trainer.train(nepoch=1, batch_size=batch_size, shuffle=False, best_model=False, filename=None)
    return recorder.get("training", 1)["loss"]


@pytest.mark.parametrize("config", list(JAX_MODELS))
def test_config_against_jax_harness(corpora, config) -> None:
    (sources, root) = corpora
    file_src, mem_src = sources[pap.CONFIG_FLAVORS[config]]
    model_cls, mirror, task, target, batch_size, clustered, ds_kwargs, grid = pap.config_table()[config]
    names = sorted(mem_src)[:SUBSET]
    kwargs = {**ds_kwargs, "subset": names}

    mirror_params = []

    class RecordingMirror(jap.TorchMirror):
        def __init__(self, kind, params, task):
            mirror_params.append(params)
            super().__init__(kind, params, task)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jap, "TorchMirror", RecordingMirror)
        jax_report = jap.run_trainer_config(
            config, file_src, root / "jax",
            model_cls=JAX_MODELS[config], mirror_kind=mirror, task=task, target=target, epochs=1, batch_size=batch_size,
            clustered=clustered, dataset_kwargs=kwargs, grid=grid,
        )  # fmt: skip
    port = pap.run_trainer_config(
        config, mem_src,
        model_cls=model_cls, mirror_kind=mirror, task=task, target=target, epochs=1, batch_size=batch_size,
        clustered=clustered, dataset_kwargs=kwargs, grid=grid, device="cpu", initial_params=mirror_params[0], optimizer=optim.Adam,
    )  # fmt: skip

    assert port["entries"] == jax_report["entries"] == len(names)
    assert port["loss_mirror"] == jax_report["loss_torch"]
    np.testing.assert_allclose(port["loss_port"], jax_report["loss_jax"], **LOSS_TOL)
    df = HDF5OutputExporter(str(root / "jax" / config / "probe")).read("training")
    jax_probe = float(df[(df["phase"] == "training") & (df["epoch"] == 1)]["loss"].iloc[0])
    np.testing.assert_allclose(_port_epoch_from(mem_src, config, mirror_params[1], kwargs), jax_probe, **LOSS_TOL)
    for k, v in port["metrics_port"].items():
        assert np.isclose(v, jax_report["metrics_jax"][k], rtol=1e-2, atol=1e-3, equal_nan=True), (k, v, jax_report["metrics_jax"][k])
        assert np.isclose(v, port["metrics_mirror"][k], rtol=1e-2, atol=1e-3, equal_nan=True), (k, v, port["metrics_mirror"][k])
    assert port["max_loss_delta"] < 1e-3 or port["max_loss_delta_rel"] < 1e-3
    assert port["synced_epoch_rel_delta"] <= 1e-4
