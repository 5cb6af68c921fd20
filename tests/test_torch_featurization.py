"""The port's featurization (deeprank2_tpu_torch/{query,features,molstruct,
io,utils}) against the JAX package's on the vendored corpus: ``Query.build``
for each feature module and for a PPI query at residue and at atom level
(1ATN_1w with its PSSMs) and an SRV query (101M, as tests/perf/srv_perf.py),
``Graph.map_to_grid`` under every map method with and without an
augmentation, and the error paths of malformed and missing PSSMs. Every
array is compared bit for bit: both packages run the same numpy and the same
C++ under the same flags."""

from __future__ import annotations

import warnings

import numpy as np
import pytest

import deeprank2_tpu.molstruct.aminoacid as jax_aa
import deeprank2_tpu.query as jax_query
import deeprank2_tpu.utils.grid as jax_grid
import deeprank2_tpu_torch.molstruct.aminoacid as aa
import deeprank2_tpu_torch.query as query
import deeprank2_tpu_torch.utils.grid as grid

FEATURE_MODULES = ["components", "conservation", "contact", "exposure", "irc", "secondary_structure", "surfacearea"]
SRV_MODULES = ["components", "contact", "exposure", "secondary_structure", "surfacearea"]  # tests/perf/srv_perf.py:37


def ppi_query(pkg, data_path, resolution, pssm=True, pdb="1ATN/1ATN_1w", chains=("A", "B"), pssms=None, **kwargs):
    name = pdb.split("/")[0]
    if pssms is None and pssm:
        pssms = {c: str(data_path / "pssm" / name / f"{name}.{c}.pdb.pssm") for c in chains}
    return pkg.ProteinProteinInterfaceQuery(
        pdb_path=str(data_path / "pdb" / f"{pdb}.pdb"), resolution=resolution, chain_ids=list(chains), pssm_paths=pssms, targets={"binary": 1}, **kwargs
    )


def srv_query(pkg, amino, data_path):
    return pkg.SingleResidueVariantQuery(
        pdb_path=str(data_path / "pdb" / "101M" / "101M.pdb"),
        resolution="residue",
        chain_ids="A",
        variant_residue_number=27,
        insertion_code=None,
        wildtype_amino_acid=amino.alanine,
        variant_amino_acid=amino.phenylalanine,
        targets={"binary": 0},
    )


CASES = {
    "ppi_residue": (lambda pkg, amino, d: ppi_query(pkg, d, "residue"), FEATURE_MODULES),
    "ppi_atom": (lambda pkg, amino, d: ppi_query(pkg, d, "atom"), FEATURE_MODULES),
    "srv_residue": (srv_query, SRV_MODULES),
}


def assert_same_graph(a, b) -> None:
    """Node names, chain ids, positions, edges, every feature and target,
    bit for bit and in the same order (the HDF5 writer follows it)."""
    assert (a.id, a.node_type, a.num_nodes, a.num_edges) == (b.id, b.node_type, b.num_nodes, b.num_edges)
    assert a.node_names() == b.node_names()
    assert a.node_chain_ids() == b.node_chain_ids()
    assert np.array_equal(a.positions(), b.positions())
    assert np.array_equal(a.center, b.center)
    assert np.array_equal(a.edge_index, b.edge_index)
    for mine, theirs in ((a.node_features, b.node_features), (a.edge_features, b.edge_features), (a.targets, b.targets)):
        assert list(mine) == list(theirs)
        for name in mine:
            x, y = np.asarray(mine[name]), np.asarray(theirs[name])
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), name


@pytest.fixture(scope="module")
def graphs(data_path):
    """Each case built once by each package: (port graph, JAX graph)."""
    out = {}
    for case, (make, modules) in CASES.items():
        out[case] = (make(query, aa, data_path).build(modules), make(jax_query, jax_aa, data_path).build(modules))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_query_build_matches_jax(graphs, case) -> None:
    port, jax = graphs[case]
    assert port.num_nodes > 0 and port.num_edges > 0
    assert_same_graph(port, jax)


@pytest.mark.parametrize("module", FEATURE_MODULES)
def test_each_feature_module_matches_jax(data_path, module) -> None:
    port = ppi_query(query, data_path, "residue").build([module])
    jax = ppi_query(jax_query, data_path, "residue").build([module])
    assert_same_graph(port, jax)


def test_all_feature_modules_are_the_ports_own() -> None:
    qc = query.QueryCollection()
    assert qc._set_feature_modules("all") == sorted(FEATURE_MODULES)
    assert jax_query.QueryCollection()._set_feature_modules("all") == sorted(FEATURE_MODULES)


AUGMENTATION = (np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8]), 0.7)


@pytest.mark.parametrize("augmented", [False, True])
@pytest.mark.parametrize("method", [m.name for m in grid.MapMethod])
def test_map_to_grid_matches_jax(graphs, method, augmented) -> None:
    port_graph, jax_graph = graphs["ppi_residue"]
    maps = {}
    for side, g, mod in (("port", port_graph, grid), ("jax", jax_graph, jax_grid)):
        target = mod.Grid("g", list(g.center), mod.GridSettings([20, 18, 16], [30.0, 27.0, 24.0]))
        aug = mod.Augmentation(*AUGMENTATION) if augmented else None
        g.map_to_grid(target, mod.MapMethod[method], aug)
        maps[side] = target
    port, jax = maps["port"], maps["jax"]
    assert list(port.features) == list(jax.features) and port.features
    for name in port.features:
        assert port.features[name].dtype == jax.features[name].dtype
        assert np.array_equal(port.features[name], jax.features[name]), name
    for axis in ("xs", "ys", "zs"):
        assert np.array_equal(getattr(port, axis), getattr(jax, axis))


def test_random_rotations_match_jax() -> None:
    for seed in (0, 7, 99):
        axis, angle = grid.random_rotation_axis_angle(seed)
        jax_axis, jax_angle = jax_grid.random_rotation_axis_angle(seed)
        assert np.array_equal(axis, jax_axis) and angle == jax_angle


def pssm_3c8p(data_path, pkg, pssms):
    return ppi_query(pkg, data_path, "residue", pdb="3C8P/3C8P", pssms=pssms)


@pytest.mark.parametrize("bad_chain_file", ["A:3C8P.A.wrong_order.pdb.pssm", "B:3C8P.B.missing_res.pdb.pssm"])
def test_malformed_pssm_raises_where_jax_does(data_path, bad_chain_file) -> None:
    bad_chain, bad_file = bad_chain_file.split(":")
    pssms = {c: str(data_path / "pssm" / "3C8P" / f"3C8P.{c}.pdb.pssm") for c in "AB"}
    pssms[bad_chain] = str(data_path / "pssm" / "3C8P_incorrect" / bad_file)
    for pkg in (query, jax_query):
        with pytest.raises(ValueError, match="do not match") as caught:
            pssm_3c8p(data_path, pkg, pssms).build(["conservation"])
        if pkg is query:
            port_message = str(caught.value)
    assert port_message == str(caught.value)
    # other modules need no PSSM; suppression turns the error into a warning
    assert_same_graph(pssm_3c8p(data_path, query, pssms).build(["components"]), pssm_3c8p(data_path, jax_query, pssms).build(["components"]))
    built = {}
    for pkg in (query, jax_query):
        q = pssm_3c8p(data_path, pkg, pssms)
        q.suppress_pssm_errors = True
        with pytest.warns(UserWarning):
            built[pkg] = q.build(["conservation"])
    assert_same_graph(built[query], built[jax_query])


@pytest.mark.parametrize("case", ["no_pssm", "missing_file", "missing_chain"])
def test_missing_pssm_raises_where_jax_does(data_path, case) -> None:
    good = {c: str(data_path / "pssm" / "3C8P" / f"3C8P.{c}.pdb.pssm") for c in "AB"}
    pssms, error = {
        "no_pssm": ({}, ValueError),
        "missing_file": ({**good, "B": str(data_path / "pssm" / "3C8P_incorrect" / "does_not_exist.pssm")}, FileNotFoundError),
        "missing_chain": ({"A": good["A"]}, FileNotFoundError),
    }[case]
    for pkg in (query, jax_query):
        with pytest.raises(error):
            pssm_3c8p(data_path, pkg, pssms).build(["conservation"])
        pssm_3c8p(data_path, pkg, pssms).build(["components"])


def test_missing_pdb_raises_where_jax_does(tmp_path, data_path) -> None:
    for pkg in (query, jax_query):
        q = pkg.ProteinProteinInterfaceQuery(pdb_path=str(tmp_path / "absent.pdb"), resolution="residue", chain_ids=["A", "B"])
        with pytest.raises(FileNotFoundError):
            q.build(["components"])


def test_missing_pdb_is_skipped_with_a_warning_by_process(tmp_path, data_path, caplog) -> None:
    """``process`` traps a failed query (query.py:370), warns and writes the
    rest, as the JAX package does."""
    qc = query.QueryCollection()
    qc.add(ppi_query(query, data_path, "residue", pssm=False))
    qc.add(query.ProteinProteinInterfaceQuery(pdb_path=str(tmp_path / "absent.pdb"), resolution="residue", chain_ids=["A", "B"]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        paths = qc.process(prefix=str(tmp_path / "out"), cpu_count=1, combine_output=False)
    import h5py

    with h5py.File(paths[0], "r") as f:
        assert list(f) == ["residue-ppi:A-B:1ATN_1w"]
    assert "absent" in caplog.text and "FileNotFoundError" in caplog.text
