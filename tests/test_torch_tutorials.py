"""The port's tutorials (deeprank2_tpu_torch/tutorials/) on the CPU: the
training twin on HDF5 files made by the repo's PPI data-generation tutorial
(as tests/test_tutorials.py makes them), two epochs of the VanillaNetwork
GNN and the CnnClassification CNN, each writing its exporter's output and
its checkpoint; the data-generation twins, whose files equal the JAX
tutorials' on the same arguments; and the training twin on the port's own
files."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deeprank2_tpu_torch.tutorials import data_generation_ppi as port_ppi  # noqa: E402
from deeprank2_tpu_torch.tutorials import data_generation_srv as port_srv  # noqa: E402
from deeprank2_tpu_torch.tutorials import training  # noqa: E402
from tutorials import data_generation_ppi, data_generation_srv  # noqa: E402


@pytest.fixture(scope="module")
def ppi_residue_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tutorial") / "ppi")
    data_generation_ppi.main(["--out", out, "--limit", "6", "--resolutions", "residue"])
    return os.path.join(out, "residue")


def test_training_tutorial_twin(ppi_residue_dir, capsys):
    training.main(["--data", ppi_residue_dir, "--epochs", "2", "--batch-size", "4", "--device", "cpu"])
    for sub in ("gnn_classif", "cnn_classif"):
        assert os.path.exists(os.path.join(ppi_residue_dir, sub, "output_exporter.hdf5"))
        assert os.path.exists(os.path.join(ppi_residue_dir, sub, "model.pth.tar"))
    printed = capsys.readouterr().out
    assert "=== GNN (VanillaNetwork) ===" in printed and "=== CNN (CnnClassification) ===" in printed
    assert printed.count("training  : AUC") == 2


def test_training_tutorial_runs_on_cuda_by_default(ppi_residue_dir):
    """Without ``--device`` the tutorial's Trainer asks for the card, as
    every entry point of the port does; without one it raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        training.main(["--data", ppi_residue_dir, "--epochs", "1", "--models", "cnn"])


def _entries(directory) -> dict:
    """Every dataset of every HDF5 file in ``directory`` by entry and path:
    dtype, shape and bytes (the workers' shard names carry their PIDs, and
    which worker takes which query varies, so files are not compared)."""
    import glob

    import h5py
    import numpy as np

    out = {}
    for path in glob.glob(os.path.join(directory, "*.hdf5")):
        with h5py.File(path, "r") as f:
            f.visititems(lambda name, obj: out.__setitem__(name, (obj.dtype.str, obj.shape, np.asarray(obj[()]).tobytes())) if isinstance(obj, h5py.Dataset) else None)
    return out


@pytest.fixture(scope="module")
def port_ppi_dirs(tmp_path_factory):
    """The port's and the JAX package's PPI tutorials on the same arguments."""
    out = {}
    for side, module in (("port", port_ppi), ("jax", data_generation_ppi)):
        directory = str(tmp_path_factory.mktemp(f"{side}_ppi"))
        module.main(["--out", directory, "--limit", "4", "--resolutions", "residue"])
        out[side] = os.path.join(directory, "residue")
    return out


def test_data_generation_ppi_twin_writes_what_jax_writes(port_ppi_dirs):
    mine, theirs = _entries(port_ppi_dirs["port"]), _entries(port_ppi_dirs["jax"])
    assert len({name.split("/")[0] for name in mine}) == 4
    assert mine == theirs
    assert port_ppi.load_inputs(None, 4)[0] == data_generation_ppi.load_inputs(None, 4)[0]


def test_data_generation_srv_twin_writes_what_jax_writes(tmp_path):
    dirs = {}
    for side, module in (("port", port_srv), ("jax", data_generation_srv)):
        dirs[side] = str(tmp_path / side)
        module.main(["--out", dirs[side], "--resolutions", "residue", "--no-grids"])
    mine, theirs = _entries(os.path.join(dirs["port"], "residue")), _entries(os.path.join(dirs["jax"], "residue"))
    assert len({name.split("/")[0] for name in mine}) == len(port_srv.DEMO_VARIANTS)
    assert mine == theirs


def test_training_twin_on_the_ports_own_data(port_ppi_dirs, capsys):
    training.main(["--data", port_ppi_dirs["port"], "--epochs", "2", "--batch-size", "4", "--device", "cpu"])
    for sub in ("gnn_classif", "cnn_classif"):
        assert os.path.exists(os.path.join(port_ppi_dirs["port"], sub, "output_exporter.hdf5"))
        assert os.path.exists(os.path.join(port_ppi_dirs["port"], sub, "model.pth.tar"))
    assert capsys.readouterr().out.count("training  : AUC") == 2
