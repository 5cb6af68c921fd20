"""The port's training tutorial (deeprank2_tpu_torch/tutorials/training.py)
on the CPU, on HDF5 files made by the repo's PPI data-generation tutorial
(as tests/test_tutorials.py makes them): two epochs of the VanillaNetwork
GNN and the CnnClassification CNN, each writing its exporter's output and
its checkpoint."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deeprank2_tpu_torch.tutorials import training  # noqa: E402
from tutorials import data_generation_ppi  # noqa: E402


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
