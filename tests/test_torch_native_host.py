"""The port's native host kernels (deeprank2_tpu_torch/csrc/{pdb_parser,sasa,
grid_kernels}.cpp, built with g++ by ops/_build.py): each against its plain
version at the JAX package's own test tolerances (tests/utils/
test_pdb_native.py, test_sasa_native.py, test_grid.py), each against the JAX
package's native kernel bit for bit (the same source under the same flags on
one machine), the library's name, and a failed build raising instead of
falling back."""

from __future__ import annotations

import numpy as np
import pytest

import deeprank2_tpu.csrc as jax_csrc
from deeprank2_tpu.io.pdb import parse_pdb as jax_parse_pdb
from deeprank2_tpu.utils import sasa as jax_sasa
from deeprank2_tpu.utils.grid import Grid as JaxGrid
from deeprank2_tpu.utils.grid import GridSettings as JaxGridSettings
from deeprank2_tpu_torch.io.pdb import parse_pdb, parse_pdb_ref
from deeprank2_tpu_torch.ops import _build
from deeprank2_tpu_torch.utils import sasa
from deeprank2_tpu_torch.utils.grid import Grid, GridSettings

PDBS = ["1CRN/1CRN", "1ATN/1ATN_1w", "101M/101M", "9api/9api", "3C8P/3C8P"]
# the numpy Shrake-Rupley loop takes seconds on the larger structures
SASA_PDBS = ["1CRN/1CRN", "3C8P/3C8P"]
FIELDS = ["atom_residue", "elements", "res_numbers", "res_aa_ids", "res_chain", "res_atom_start", "res_atom_count"]


@pytest.fixture(scope="module")
def structures(data_path):
    return {p: str(data_path / "pdb" / f"{p}.pdb") for p in PDBS}


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    if jax_csrc.load() is None:
        pytest.fail("the JAX package's native library did not build; the bit-for-bit checks need it")


def assert_same_structure(a, b, exact=True) -> None:
    """Field for field as tests/utils/test_pdb_native.py:21-29 (``exact``:
    positions and occupancies bit for bit too)."""
    assert (a.num_atoms, a.num_residues, a.id) == (b.num_atoms, b.num_residues, b.id)
    same = np.array_equal if exact else np.allclose
    assert same(a.positions, b.positions)
    assert same(a.occupancies, b.occupancies)
    assert list(a.atom_names) == list(b.atom_names)
    assert list(a.res_icodes) == list(b.res_icodes)
    assert a.chain_ids == b.chain_ids
    for field in FIELDS:
        assert np.array_equal(getattr(a, field), getattr(b, field)), field
        assert getattr(a, field).dtype == getattr(b, field).dtype, field


@pytest.mark.parametrize("pdb", PDBS)
def test_parser_matches_its_plain_version_and_jax(structures, pdb) -> None:
    native = parse_pdb(structures[pdb])
    assert_same_structure(native, parse_pdb_ref(structures[pdb]), exact=False)
    assert_same_structure(native, jax_parse_pdb(structures[pdb]))


def test_parser_errors(tmp_path) -> None:
    with pytest.raises(FileNotFoundError):
        parse_pdb(str(tmp_path / "missing.pdb"))
    bad = tmp_path / "bad.pdb"
    bad.write_text("ATOM      1  CA  ALA A   1      11.104   6.134  -6.504  1.00  0.00           Xx\n")
    with pytest.raises(KeyError, match="unknown chemical element"):
        parse_pdb(str(bad))
    with pytest.raises(KeyError):
        parse_pdb_ref(str(bad))


@pytest.mark.parametrize("pdb", SASA_PDBS)
def test_sasa_matches_its_plain_version_and_jax(structures, pdb) -> None:
    arrays = parse_pdb(structures[pdb])
    radii = sasa.atom_radii(np.asarray(arrays.elements))
    areas = sasa.shrake_rupley(arrays.positions, radii)
    np.testing.assert_allclose(areas, sasa.shrake_rupley_ref(arrays.positions, radii), rtol=0, atol=1e-10)
    assert np.array_equal(areas, jax_sasa.shrake_rupley(arrays.positions, radii))
    mask = np.zeros(arrays.num_atoms, dtype=bool)
    mask[::3] = True
    masked = sasa.shrake_rupley(arrays.positions, radii, compute_mask=mask)
    np.testing.assert_allclose(masked, sasa.shrake_rupley_ref(arrays.positions, radii, compute_mask=mask), rtol=0, atol=1e-10)
    assert np.array_equal(masked, jax_sasa.shrake_rupley(arrays.positions, radii, compute_mask=mask))


def test_sasa_points_match_their_plain_version_and_jax(structures) -> None:
    arrays = parse_pdb(structures["1CRN/1CRN"])
    radii = sasa.atom_radii(np.asarray(arrays.elements))
    areas, points = sasa.shrake_rupley(arrays.positions, radii, n_points=64, return_points=True)
    _, ref_points = sasa.shrake_rupley_ref(arrays.positions, radii, n_points=64, return_points=True)
    assert points.shape == ref_points.shape
    a = np.asarray(sorted(map(tuple, np.round(points, 6))))
    b = np.asarray(sorted(map(tuple, np.round(ref_points, 6))))
    assert np.allclose(a, b)
    jax_areas, jax_points = jax_sasa.shrake_rupley(arrays.positions, radii, n_points=64, return_points=True)
    assert np.array_equal(areas, jax_areas) and np.array_equal(points, jax_points)


@pytest.mark.parametrize("truncate", [None, 5.0])
@pytest.mark.parametrize("pdb", ["1CRN/1CRN", "1ATN/1ATN_1w"])
def test_gaussian_grid_matches_its_plain_version_and_jax(structures, pdb, truncate) -> None:
    arrays = parse_pdb(structures[pdb])
    center = list(arrays.positions.mean(axis=0))
    points = arrays.positions[:: max(1, arrays.num_atoms // 150)]
    grid = Grid("g", center, GridSettings([35, 30, 30], [30.0, 28.0, 26.0]))
    k = grid._kernel_gaussian(points, truncate)
    assert k.dtype == np.float32 and k.shape == (len(points), 35 * 30 * 30)
    # tests/utils/test_grid.py's gate (np.allclose's defaults) widened by the
    # plain version's own f32 error in the distance, entry by entry
    ref = grid._kernel_gaussian_ref(points, truncate)
    assert (np.abs(k.astype(np.float64) - ref) <= grid._kernel_gaussian_ref_tolerance(points)).all()
    # the reference protocol's 1 Å box (tests/perf/ppi_perf.py): np.allclose's defaults alone
    small = Grid("g", center, GridSettings([35, 30, 30], [1.0, 1.0, 1.0]))
    np.testing.assert_allclose(small._kernel_gaussian(points, truncate), small._kernel_gaussian_ref(points, truncate), rtol=1e-5, atol=1e-8)
    jax_grid = JaxGrid("g", center, JaxGridSettings([35, 30, 30], [30.0, 28.0, 26.0]))
    assert np.array_equal(k, jax_grid._kernel_gaussian(points, truncate))


def test_library_name_follows_source_flags_and_host(tmp_path, monkeypatch) -> None:
    """A host library is named by its source, its flags, the compiler's
    version and the CPU's model: a library built with ``-march=native`` on
    one host is never loaded on another."""
    (tmp_path / "sasa.cpp").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "_host_identity", b"g++ 1\nCPU A")
    before = _build.host_target("sasa")
    assert _build.host_target("sasa") == before and before.name.startswith("libsasa-")
    (tmp_path / "sasa.cpp").write_text("// two\n")
    edited = _build.host_target("sasa")
    assert edited != before
    monkeypatch.setattr(_build, "GXX_FLAGS", [*_build.GXX_FLAGS, "-g"])
    flagged = _build.host_target("sasa")
    assert flagged != edited
    monkeypatch.setattr(_build, "_host_identity", b"g++ 1\nCPU B")
    assert _build.host_target("sasa") not in (before, edited, flagged)


def test_host_identity_names_the_compiler_and_the_cpu(monkeypatch) -> None:
    monkeypatch.setattr(_build, "_host_identity", None)
    identity = _build._host()
    assert b"g++" in identity or b"GCC" in identity
    with open("/proc/cpuinfo") as fh:
        fields = dict(line.split(":", 1) for line in fh if ":" in line)
    fields = {k.strip(): v.strip() for k, v in reversed(list(fields.items()))}
    for key in ("flags", "model name"):
        if key in fields:
            assert fields[key].encode() in identity, key


def test_grid_kernel_is_compiled_with_fast_math_only() -> None:
    assert _build.HOST_SOURCES == {"sasa": [], "pdb_parser": [], "grid_kernels": ["-ffast-math"]}
    assert _build.GXX_FLAGS == ["-O3", "-march=native", "-fPIC"]


def test_failed_build_raises_with_no_fallback(tmp_path, data_path, monkeypatch) -> None:
    (tmp_path / "pdb_parser.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_kernels")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="host kernel build failed"):
        _build.build_host(["pdb_parser"])
    # the entry point raises too: the plain version is never taken in its place
    with pytest.raises(RuntimeError, match="host kernel build failed"):
        parse_pdb(str(data_path / "pdb" / "1CRN" / "1CRN.pdb"))
    assert not list((tmp_path / "_kernels").glob("*.so"))


def test_missing_compiler_raises(tmp_path, monkeypatch) -> None:
    monkeypatch.setattr(_build, "_host_identity", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not usable"):
        _build.host_target("sasa")


def test_unloadable_library_raises(tmp_path, monkeypatch) -> None:
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_host_identity", b"g++ 1\nCPU A")
    _build.host_target("sasa").write_bytes(b"not a shared library")
    with pytest.raises(RuntimeError, match="cannot load the host kernel library"):
        _build.host_library("sasa")
