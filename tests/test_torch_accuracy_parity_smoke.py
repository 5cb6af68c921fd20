"""The accuracy-parity twin against the JAX harness on the JAX smoke test's
pair (tests/tools/test_accuracy_parity.py: ``vanilla_srv_regress`` and
``ginet_edgepart_ba``, two epochs), on the same corpus files (a part of the
corpus: ``SRV_PER_SOURCE``, ``DECOYS_PER_COMPLEX``) and from the same
initial parameters: the JAX Trainer's (and the JAX GINet's seed-7
initialization for the edge partition), loaded into the port through
``param_interop.params_from_jax`` as ``tests/test_torch_trainer.py`` does.

- The port's mirror trains to the JAX mirror's loss trajectories bit for
  bit (both under ``torch.use_deterministic_algorithms``: the CPU's
  ``index_add_`` otherwise sums in a different order each run).
- The port's Trainer (the JAX rule's ``Adam``, as the JAX Trainer), and the
  edge partition over two gloo ranks, match JAX's first-epoch losses at
  ``LOSS_TOL``; the port's Trainer, restarted from the JAX harness's
  synced-probe parameters (its end-of-training ones) with a fresh
  optimizer, matches the JAX probe's epoch at ``LOSS_TOL``. (Each side's
  own probe starts from its own end of training, and two epochs of this
  regression amplify f32 rounding 3.9e-5 apart, so those two probes are not
  comparable at ``LOSS_TOL``.)
- The JAX smoke test's own gates hold on the port's reports, and the
  twin's default (``ReferenceAdam``) holds the relative gates of
  ``chip_smoke.py`` on the CPU too."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from deeprank2_tpu.dataset import GraphDataset as JaxGraphDataset
from deeprank2_tpu.neuralnets.gnn.ginet_nocluster import GINet as JaxGINet
from deeprank2_tpu.neuralnets.gnn.vanilla_gnn import VanillaNetwork as JaxVanilla
from deeprank2_tpu.tools import accuracy_parity as jap
from deeprank2_tpu.trainer import Trainer as JaxTrainer
from deeprank2_tpu.utils.exporters import HDF5OutputExporter
from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetwork
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax
from deeprank2_tpu_torch.ops import optim
from deeprank2_tpu_torch.tools import accuracy_parity as pap
from deeprank2_tpu_torch.trainer import Trainer

LOSS_TOL = {"rtol": 1e-5, "atol": 0.0}
PAIR = ("vanilla_srv_regress", "ginet_edgepart_ba")
# a part of the corpus, to bound the test's time: 8 variants of each SRV
# source (of 26) and 5 decoys of each referenced complex (of 25)
SRV_PER_SOURCE = 8
DECOYS_PER_COMPLEX = 5


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


def jax_probe_loss(run_dir) -> float:
    """The JAX harness's synced-probe loss, from its probe exporter's file."""
    df = HDF5OutputExporter(str(run_dir / "probe")).read("training")
    return float(df[(df["phase"] == "training") & (df["epoch"] == 1)]["loss"].iloc[0])


@pytest.fixture(scope="module")
def pair_runs(data_path, tmp_path_factory):
    """The JAX harness's and the twin's reports on one corpus (the port's
    featurization into HDF5, which the JAX side reads)."""
    root = tmp_path_factory.mktemp("parity_pair")
    corpus = {
        "srv_residue": pap.featurize_queries(pap.assemble_srv_queries(data_path, per_source=SRV_PER_SOURCE), "srv_residue", root / "corpus", "hdf5"),
        "ppi_residue": pap.featurize_queries(
            pap.assemble_ppi_queries(data_path, "residue", root / "decoys", decoys_per_complex=DECOYS_PER_COMPLEX), "ppi_residue", root / "corpus", "hdf5"
        ),
    }
    table = pap.config_table()
    _, mirror, task, target, batch_size, clustered, srv_kwargs, _ = table["vanilla_srv_regress"]
    edge_kwargs = table["ginet_edgepart_ba"][6]

    mirror_params = []

    class RecordingMirror(jap.TorchMirror):
        def __init__(self, kind, params, task):
            mirror_params.append(params)
            super().__init__(kind, params, task)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jap, "TorchMirror", RecordingMirror)
        jax_srv = jap.run_trainer_config(
            "vanilla_srv_regress", corpus["srv_residue"], root / "jax",
            model_cls=JaxVanilla, mirror_kind=mirror, task=task, target=target, epochs=2, batch_size=batch_size, clustered=clustered, dataset_kwargs=srv_kwargs,
        )  # fmt: skip
    jax_edge = jap.run_edgepart_config(corpus["ppi_residue"], root / "jax", epochs=2, dataset_kwargs=edge_kwargs)
    init_srv = JaxTrainer(JaxVanilla, dataset_train=JaxGraphDataset(hdf5_path=corpus["srv_residue"], target=target, task=task, **srv_kwargs), output_exporters=[], seed=7).params
    e0 = JaxGraphDataset(hdf5_path=corpus["ppi_residue"], target="dockq", task="regress", **edge_kwargs).get(0)
    init_edge = JaxGINet(e0["x"].shape[1], 1, e0["edge_attr"].shape[1]).init(jax.random.PRNGKey(7))
    inits = {"vanilla_srv_regress": jax.tree.map(np.asarray, init_srv), "ginet_edgepart_ba": jax.tree.map(np.asarray, init_edge)}

    port = [
        pap.run_trainer_config(
            "vanilla_srv_regress", corpus["srv_residue"],
            model_cls=VanillaNetwork, mirror_kind=mirror, task=task, target=target, epochs=2, batch_size=batch_size, clustered=clustered,
            dataset_kwargs=srv_kwargs, device="cpu", initial_params=inits["vanilla_srv_regress"], optimizer=optim.Adam,
        ),
        pap.run_edgepart_config(
            corpus["ppi_residue"], epochs=2, dataset_kwargs=edge_kwargs, device="cpu", ranks=2, initial_params=inits["ginet_edgepart_ba"], optimizer=optim.Adam
        ),
    ]  # fmt: skip
    default = pap.run_all(data_path, root, list(PAIR), 2, device="cpu", corpus=corpus)
    # the port's Trainer from the JAX probe's parameters, one epoch
    train, _ = pap.make_datasets(corpus["srv_residue"], target=target, task=task, clustered=clustered, grid=False, ds_kwargs=srv_kwargs)
    recorder = pap.PassRecorder()
    trainer = Trainer(VanillaNetwork, dataset_train=train, output_exporters=[recorder], seed=7, device="cpu")
    trainer.model.load_state_dict(params_from_jax(mirror_params[1], "vanilla"))
    trainer.configure_optimizers(optim.Adam)
    trainer.train(nepoch=1, batch_size=batch_size, shuffle=False, best_model=False, filename=None)
    probes = {"jax": jax_probe_loss(root / "jax" / "vanilla_srv_regress"), "port": recorder.get("training", 1)["loss"]}
    return {"jax": {"vanilla_srv_regress": jax_srv, "ginet_edgepart_ba": jax_edge}, "port": dict(zip(PAIR, port)), "default": dict(zip(PAIR, default)), "probes": probes}


@pytest.mark.parametrize("config", PAIR)
def test_port_mirror_is_the_jax_mirror(pair_runs, config) -> None:
    assert pair_runs["port"][config]["loss_mirror"] == pair_runs["jax"][config]["loss_torch"]
    assert pair_runs["port"][config]["metrics_mirror"] == pair_runs["jax"][config]["metrics_torch"]


@pytest.mark.parametrize("config", PAIR)
def test_port_trainer_matches_jax_trainer(pair_runs, config) -> None:
    port, jax_report = pair_runs["port"][config], pair_runs["jax"][config]
    np.testing.assert_allclose(port["loss_port"][0], jax_report["loss_jax"][0], **LOSS_TOL)
    if config == "vanilla_srv_regress":
        np.testing.assert_allclose(pair_runs["probes"]["port"], pair_runs["probes"]["jax"], **LOSS_TOL)
    assert port["entries"] == jax_report["entries"]
    if config == "ginet_edgepart_ba":
        assert (port["shards"], jax_report["shards"]) == (2, 8)


@pytest.mark.parametrize("run", ["port", "default"])
@pytest.mark.parametrize("config", PAIR)
def test_jax_smoke_gates_hold(pair_runs, run, config) -> None:
    """tests/tools/test_accuracy_parity.py's gates, and (the twin's default
    optimizer) chip_smoke.py's relative gates."""
    r = pair_runs[run][config]
    assert r["max_loss_delta"] < 1e-3, r
    for k, v in r["metrics_port"].items():
        assert np.isclose(v, r["metrics_mirror"][k], rtol=1e-2, atol=1e-3), (config, k, v, r["metrics_mirror"][k])
    if run == "default":
        assert r["max_loss_delta_rel"] <= 1e-3
        assert r.get("synced_epoch_rel_delta", 0.0) <= 1e-4
