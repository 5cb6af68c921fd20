"""The port's data tools (deeprank2_tpu_torch/tools/{target,similarity,
decoys}.py) against the JAX package's and against the pdb2sql oracle of
tests/tools/test_target.py:14-19; ``add_target`` on HDF5 that the port's own
featurization wrote."""

from __future__ import annotations

import h5py
import numpy as np
import pytest

from deeprank2_tpu.tools import decoys as jax_decoys
from deeprank2_tpu.tools import target as jax_target
from deeprank2_tpu_torch.query import ProteinProteinInterfaceQuery, QueryCollection
from deeprank2_tpu_torch.tools import decoys, similarity, target

# pdb2sql-computed scores stored in the reference fixture (tests/tools/test_target.py:14-19)
PDB2SQL_ORACLE = {
    "1ATN_1w": {"dockq": 0.0274, "fnat": 0.0441, "irmsd": 14.919, "lrmsd": 50.124},
    "1ATN_2w": {"dockq": 0.0269, "fnat": 0.0441, "irmsd": 15.25, "lrmsd": 51.097},
    "1ATN_3w": {"dockq": 0.0321, "fnat": 0.0588, "irmsd": 15.444, "lrmsd": 49.839},
    "1ATN_4w": {"dockq": 0.0108, "fnat": 0.0, "irmsd": 16.19, "lrmsd": 54.482},
}


@pytest.mark.parametrize("decoy", sorted(PDB2SQL_ORACLE))
def test_ppi_scores_match_jax_and_pdb2sql(data_path, decoy) -> None:
    args = (str(data_path / "pdb" / "1ATN" / f"{decoy}.pdb"), str(data_path / "ref" / "1ATN" / "1ATN.pdb"))
    scores = target.compute_ppi_scores(*args)
    assert scores == jax_target.compute_ppi_scores(*args)
    oracle = PDB2SQL_ORACLE[decoy]
    assert scores["lrmsd"] == pytest.approx(oracle["lrmsd"], abs=0.01)
    assert scores["irmsd"] == pytest.approx(oracle["irmsd"], abs=0.01)
    assert scores["fnat"] == pytest.approx(oracle["fnat"], abs=0.001)
    assert scores["dockq"] == pytest.approx(oracle["dockq"], abs=0.001)
    assert scores["binary"] == (scores["irmsd"] < 4)
    assert scores["capri_class"] == 4


def test_native_scores_itself_perfectly(data_path) -> None:
    native = str(data_path / "ref" / "1ATN" / "1ATN.pdb")
    scores = target.compute_ppi_scores(native, native)
    assert scores == jax_target.compute_ppi_scores(native, native)
    assert scores["fnat"] == 1.0 and scores["capri_class"] == 1 and scores["binary"]
    assert scores["irmsd"] == pytest.approx(0.0, abs=1e-6) and scores["dockq"] == pytest.approx(1.0, abs=1e-6)


@pytest.fixture
def port_hdf5(tmp_path, data_path) -> str:
    """Two 1ATN decoys featurized by the port (the reference's
    tests/data/hdf5/1ATN_ppi.hdf5 is not vendored)."""
    qc = QueryCollection()
    for decoy in ("1ATN_1w", "1ATN_2w"):
        qc.add(ProteinProteinInterfaceQuery(pdb_path=str(data_path / "pdb" / "1ATN" / f"{decoy}.pdb"), resolution="residue", chain_ids=["A", "B"], targets={"binary": 0}))
    return qc.process(prefix=str(tmp_path / "ppi"), cpu_count=1)[0]


def test_add_target(tmp_path, port_hdf5) -> None:
    with h5py.File(port_hdf5, "r") as f:
        entries = list(f.keys())
    labels = tmp_path / "targets.lst"
    labels.write_text("".join(f"{entry} {i * 10}\n" for i, entry in enumerate(entries)))
    target.add_target(port_hdf5, "custom", str(labels))
    with h5py.File(port_hdf5, "r") as f:
        for i, entry in enumerate(entries):
            assert f[entry]["target_values"]["custom"][()] == i * 10


def test_add_target_label_file_comments_and_spacing(tmp_path, port_hdf5) -> None:
    """Label files may carry comment lines and repeated separators (the
    np.loadtxt conventions the reference relied on); the JAX package's
    add_target writes the same on a copy of the file."""
    import shutil

    with h5py.File(port_hdf5, "r") as f:
        entry = next(iter(f.keys()))
    labels = tmp_path / "labels.txt"
    labels.write_text(f"# entry value\n{entry}  0.75\n\n")
    copy = str(tmp_path / "copy.hdf5")
    shutil.copy(port_hdf5, copy)
    target.add_target(port_hdf5, "newscore", str(labels))
    jax_target.add_target(copy, "newscore", str(labels))
    for path in (port_hdf5, copy):
        with h5py.File(path, "r") as f:
            assert float(f[entry]["target_values"]["newscore"][()]) == 0.75


def test_add_target_to_a_missing_file_raises(tmp_path) -> None:
    labels = tmp_path / "labels.txt"
    labels.write_text("x 1\n")
    with pytest.raises(FileNotFoundError):
        target.add_target([str(tmp_path / "absent.hdf5")], "t", str(labels))


def test_rigid_body_decoys_match_jax(tmp_path, data_path) -> None:
    ref = str(data_path / "ref" / "1ATN" / "1ATN.pdb")
    paths = decoys.rigid_body_decoys(ref, "B", tmp_path / "port", count=4, seed=7)
    jax_paths = jax_decoys.rigid_body_decoys(ref, "B", tmp_path / "jax", count=4, seed=7)
    assert [p.rsplit("/", 1)[1] for p in paths] == [p.rsplit("/", 1)[1] for p in jax_paths]
    for mine, theirs in zip(paths, jax_paths):
        assert open(mine, "rb").read() == open(theirs, "rb").read()
    irmsds = [target.compute_ppi_scores(p, ref)["irmsd"] for p in paths]
    assert irmsds[0] < irmsds[-1]  # graded: near-native first, incorrect last


def test_superpose_matches_jax() -> None:
    from deeprank2_tpu.tools import similarity as jax_similarity

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(30, 3))
    moved = pts @ np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]).T + np.array([1.0, -2.0, 3.0])
    r, t = similarity.superpose(moved, pts)
    jr, jt = jax_similarity.superpose(moved, pts)
    assert np.array_equal(r, jr) and np.array_equal(t, jt)
    assert similarity.superposed_rmsd(moved, pts) == pytest.approx(0.0, abs=1e-9)
