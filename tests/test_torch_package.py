"""The port package (deeprank2_tpu_torch) stands alone and never runs on the
CPU unless asked to."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_MODULES = [
    "deeprank2_tpu_torch",
    "deeprank2_tpu_torch.dataset",
    "deeprank2_tpu_torch.device",
    "deeprank2_tpu_torch.domain",
    "deeprank2_tpu_torch.domain.aminoacidlist",
    "deeprank2_tpu_torch.domain.edgestorage",
    "deeprank2_tpu_torch.domain.gridstorage",
    "deeprank2_tpu_torch.domain.losstypes",
    "deeprank2_tpu_torch.domain.nodestorage",
    "deeprank2_tpu_torch.domain.targetstorage",
    "deeprank2_tpu_torch.features",
    "deeprank2_tpu_torch.features.components",
    "deeprank2_tpu_torch.features.conservation",
    "deeprank2_tpu_torch.features.contact",
    "deeprank2_tpu_torch.features.exposure",
    "deeprank2_tpu_torch.features.irc",
    "deeprank2_tpu_torch.features.secondary_structure",
    "deeprank2_tpu_torch.features.surfacearea",
    "deeprank2_tpu_torch.io",
    "deeprank2_tpu_torch.io.pdb",
    "deeprank2_tpu_torch.molstruct",
    "deeprank2_tpu_torch.molstruct.aminoacid",
    "deeprank2_tpu_torch.molstruct.pair",
    "deeprank2_tpu_torch.molstruct.structure",
    "deeprank2_tpu_torch.neuralnets",
    "deeprank2_tpu_torch.neuralnets.cnn",
    "deeprank2_tpu_torch.neuralnets.cnn.model3d",
    "deeprank2_tpu_torch.neuralnets.gnn",
    "deeprank2_tpu_torch.neuralnets.gnn.alignmentnet",
    "deeprank2_tpu_torch.neuralnets.gnn.clustered_blocksparse",
    "deeprank2_tpu_torch.neuralnets.gnn.foutnet",
    "deeprank2_tpu_torch.neuralnets.gnn.ginet",
    "deeprank2_tpu_torch.neuralnets.gnn.ginet_blocksparse",
    "deeprank2_tpu_torch.neuralnets.gnn.ginet_dense",
    "deeprank2_tpu_torch.neuralnets.gnn.ginet_nocluster",
    "deeprank2_tpu_torch.neuralnets.gnn.sgat",
    "deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn",
    "deeprank2_tpu_torch.neuralnets.nn",
    "deeprank2_tpu_torch.neuralnets.param_interop",
    "deeprank2_tpu_torch.ops",
    "deeprank2_tpu_torch.ops._build",
    "deeprank2_tpu_torch.ops.batch",
    "deeprank2_tpu_torch.ops.block_sparse",
    "deeprank2_tpu_torch.ops.blocked_edges",
    "deeprank2_tpu_torch.ops.diag_spmm",
    "deeprank2_tpu_torch.ops.ginet_tower",
    "deeprank2_tpu_torch.ops.losses",
    "deeprank2_tpu_torch.ops.optim",
    "deeprank2_tpu_torch.ops.pooling",
    "deeprank2_tpu_torch.ops.segment",
    "deeprank2_tpu_torch.ops.segment_sorted",
    "deeprank2_tpu_torch.ops.slotpool",
    "deeprank2_tpu_torch.ops.synthetic",
    "deeprank2_tpu_torch.ops.tower_plan",
    "deeprank2_tpu_torch.ops.vanilla",
    "deeprank2_tpu_torch.parallel",
    "deeprank2_tpu_torch.parallel.blocksparse_partition",
    "deeprank2_tpu_torch.parallel.cluster",
    "deeprank2_tpu_torch.parallel.comm",
    "deeprank2_tpu_torch.parallel.comm_shape",
    "deeprank2_tpu_torch.parallel.dp",
    "deeprank2_tpu_torch.parallel.edge_partition",
    "deeprank2_tpu_torch.parallel.launch",
    "deeprank2_tpu_torch.parallel.probes",
    "deeprank2_tpu_torch.query",
    "deeprank2_tpu_torch.tools",
    "deeprank2_tpu_torch.tools.accuracy_parity",
    "deeprank2_tpu_torch.tools.decoys",
    "deeprank2_tpu_torch.tools.diag_order",
    "deeprank2_tpu_torch.tools.dryrun_multichip",
    "deeprank2_tpu_torch.tools.f64_gate",
    "deeprank2_tpu_torch.tools.similarity",
    "deeprank2_tpu_torch.tools.target",
    "deeprank2_tpu_torch.tools.timing",
    "deeprank2_tpu_torch.tools.tower_times",
    "deeprank2_tpu_torch.trainer",
    "deeprank2_tpu_torch.tutorials",
    "deeprank2_tpu_torch.tutorials.data_generation_ppi",
    "deeprank2_tpu_torch.tutorials.data_generation_srv",
    "deeprank2_tpu_torch.tutorials.training",
    "deeprank2_tpu_torch.utils",
    "deeprank2_tpu_torch.utils.buildgraph",
    "deeprank2_tpu_torch.utils.checkpoint",
    "deeprank2_tpu_torch.utils.community_pooling",
    "deeprank2_tpu_torch.utils.earlystopping",
    "deeprank2_tpu_torch.utils.exporters",
    "deeprank2_tpu_torch.utils.graph",
    "deeprank2_tpu_torch.utils.grid",
    "deeprank2_tpu_torch.utils.parsing",
    "deeprank2_tpu_torch.utils.parsing.forcefield",
    "deeprank2_tpu_torch.utils.parsing.pssm",
    "deeprank2_tpu_torch.utils.pssmdata",
    "deeprank2_tpu_torch.utils.sasa",
    "deeprank2_tpu_torch.utils.secstructure",
    "deeprank2_tpu_torch.utils.ses",
    "deeprank2_tpu_torch.utils.store",
]

# Runs in a fresh interpreter (this test process has imported JAX already).
# Imports of jax, of the JAX package and of h5py (the card's machine has
# none) fail; building or loading a library (nvcc or g++ through
# subprocess, ctypes.CDLL) fails too.
_IMPORT_PROBE = """
import ctypes, importlib, importlib.abc, runpy, subprocess, sys
import torch  # loads its own libraries before the refusals below
import scipy.ndimage, scipy.spatial  # numpy.testing, which they import, runs lscpu

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "deeprank2_tpu", "h5py"):
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())

def refuse(*args, **kwargs):
    raise AssertionError("importing the port must build and load nothing")

subprocess.Popen = refuse
ctypes.CDLL = refuse
for module in sys.argv[1:]:
    importlib.import_module(module)
runpy.run_path("chip_smoke.py", run_name="chip_smoke")  # imported, not run
assert not any(m.split(".")[0] in ("jax", "jaxlib", "deeprank2_tpu", "triton") for m in sys.modules)
from deeprank2_tpu_torch.ops import _build
assert not _build._loaded and not _build.build_logs
print("imported", len(sys.argv) - 1)
"""


def test_port_imports_without_jax_and_builds_nothing() -> None:
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_PROBE, *PORT_MODULES], cwd=ROOT, capture_output=True, text=True, timeout=300, check=False
    )
    assert out.returncode == 0, out.stderr
    assert f"imported {len(PORT_MODULES)}" in out.stdout


# Runs in a fresh interpreter: the featurization of a query (every feature
# module, PSSMs, the forcefield's table, a graph mapped to grids with an
# augmentation, chip_smoke.py's in-memory entries) with an audit hook that
# refuses to open, list or load anything inside the JAX package, and with
# imports of jax, the JAX package and h5py refused.
_FEATURIZE_PROBE = """
import importlib.abc, os, runpy, sys
root, data = sys.argv[1], sys.argv[2]
jax_dir = os.path.join(root, "deeprank2_tpu") + os.sep

def hook(event, args):
    if event in ("open", "os.listdir", "os.scandir", "ctypes.dlopen") and args and isinstance(args[0], (str, bytes, os.PathLike)):
        path = os.path.abspath(os.fsdecode(args[0]))
        if path.startswith(jax_dir):
            raise RuntimeError(f"{event} of {path} inside the JAX package")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "deeprank2_tpu", "h5py"):
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
sys.addaudithook(hook)
from deeprank2_tpu_torch.query import ProteinProteinInterfaceQuery, QueryCollection
from deeprank2_tpu_torch.utils.grid import Augmentation, Grid, GridSettings, MapMethod
modules = QueryCollection()._set_feature_modules("all")
query = ProteinProteinInterfaceQuery(
    pdb_path=f"{data}/pdb/1ATN/1ATN_1w.pdb", resolution="residue", chain_ids=["A", "B"],
    pssm_paths={c: f"{data}/pssm/1ATN/1ATN.{c}.pdb.pssm" for c in "AB"}, targets={"binary": 1},
)
graph = query.build(modules)
for aug in (None, Augmentation([0.0, 0.6, 0.8], 0.4)):
    grid = Grid(graph.id, list(graph.center), GridSettings([10, 10, 10], [20.0, 20.0, 20.0]))
    graph.map_to_grid(grid, MapMethod.GAUSSIAN, aug)
smoke = runpy.run_path(os.path.join(root, "chip_smoke.py"), run_name="chip_smoke")
entry = smoke["graph_entry"](graph)
assert entry["x"].shape[0] == graph.num_nodes and smoke["grid_entry"](grid, graph)["x"].shape[0] > 0
assert not any(m.split(".")[0] in ("jax", "jaxlib", "deeprank2_tpu", "h5py") for m in sys.modules)
print("featurized", len(modules), graph.num_nodes, len(grid.features))
"""


def test_featurization_runs_without_h5py_and_reads_nothing_of_the_jax_package(data_path) -> None:
    out = subprocess.run(
        [sys.executable, "-c", _FEATURIZE_PROBE, str(ROOT), str(data_path)], cwd=ROOT, capture_output=True, text=True, timeout=300, check=False
    )
    assert out.returncode == 0, out.stderr
    assert "featurized 7 " in out.stdout


def test_every_port_module_is_listed() -> None:
    found = {
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "deeprank2_tpu_torch").rglob("*.py")
    }
    assert found == set(PORT_MODULES)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_without_a_device_raise_without_cuda(no_cuda) -> None:
    from deeprank2_tpu_torch.device import resolve_device
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
    from deeprank2_tpu_torch.ops.batch import collate_graphs_dense
    from deeprank2_tpu_torch.ops.synthetic import synthetic_entries

    entries = synthetic_entries(2, 8, 4, 2, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collate_graphs_dense(entries)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GINetDense(4, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    batch, _ = collate_graphs_dense(entries, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.to("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_trainer_without_a_device_raises_without_cuda(no_cuda, srv_hdf5) -> None:
    """The Trainer resolves its device as every entry point does: CUDA
    unless ``device="cpu"``; on a machine without CUDA it raises."""
    from deeprank2_tpu_torch.dataset import GraphDataset
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
    from deeprank2_tpu_torch.trainer import Trainer

    ds = GraphDataset(hdf5_path=srv_hdf5, target="binary")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(GINetDense, dataset_train=ds, output_exporters=[])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(GINetDense, dataset_train=ds, output_exporters=[], cuda=True)
    trainer = Trainer(GINetDense, dataset_train=ds, output_exporters=[], device="cpu")
    assert trainer.device == torch.device("cpu") and (trainer.cuda, trainer.ngpu) == (False, 0)
    assert next(trainer.model.parameters()).device == torch.device("cpu")


def test_clustered_entry_points_raise_without_cuda(no_cuda) -> None:
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetClusteredDiag
    from deeprank2_tpu_torch.ops.batch import collate_graphs_diag_clustered
    from deeprank2_tpu_torch.ops.synthetic import ppi_clustered_entries

    entries = ppi_clustered_entries(2, 20, 4, seed=0)
    for min_slot_nodes in (1, 5):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            collate_graphs_diag_clustered(entries, min_slot_nodes=min_slot_nodes)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GINetClusteredDiag(4, 2, 1)
    batch, _ = collate_graphs_diag_clustered(entries, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.to("cuda")
    model = GINetClusteredDiag(4, 2, 1, device="cpu")
    assert model(batch).shape == (2, 2)


def test_blocksparse_entry_points_raise_without_cuda(no_cuda) -> None:
    from deeprank2_tpu_torch.neuralnets.gnn.clustered_blocksparse import GINetClusteredBlockSparse
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_blocksparse import GINetBlockSparse
    from deeprank2_tpu_torch.ops.batch import collate_graphs_blocksparse, collate_graphs_blocksparse_clustered
    from deeprank2_tpu_torch.ops.block_sparse import build_blocksparse
    from deeprank2_tpu_torch.ops.synthetic import clustered_entry

    entries = [clustered_entry(300, 4, seed=0)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_blocksparse(entries[0]["edge_index"], 300)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collate_graphs_blocksparse(entries)
    for slot8 in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            collate_graphs_blocksparse_clustered(entries, slot8=slot8)
    for cls, collate in ((GINetBlockSparse, collate_graphs_blocksparse), (GINetClusteredBlockSparse, collate_graphs_blocksparse_clustered)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(4, 2, 1)
        batch, _ = collate(entries, device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batch.to("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batch.structure.to("cuda")
        assert cls(4, 2, 1, device="cpu")(batch).shape == (1, 2)


def test_blocked_entry_points_raise_without_cuda(no_cuda) -> None:
    from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetworkBlocked
    from deeprank2_tpu_torch.ops.batch import collate_graphs_blocked
    from deeprank2_tpu_torch.ops.blocked_edges import build_blocked_edges
    from deeprank2_tpu_torch.ops.synthetic import geometric_entry

    entries = [geometric_entry(300, 4, 6, seed=0)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_blocked_edges(entries[0]["edge_index"], entries[0]["edge_attr"], 300)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collate_graphs_blocked(entries)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VanillaNetworkBlocked(4, 2, 6)
    batch, _ = collate_graphs_blocked(entries, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.to("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.structure.to("cuda")
    assert VanillaNetworkBlocked(4, 2, 6, device="cpu")(batch).shape == (1, 2)


def test_coo_entry_points_raise_without_cuda(no_cuda) -> None:
    from deeprank2_tpu_torch.neuralnets.gnn.ginet import GINet
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_nocluster import GINet as GINetNoCluster
    from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetwork
    from deeprank2_tpu_torch.ops.batch import collate_graphs
    from deeprank2_tpu_torch.ops.synthetic import ppi_clustered_entries

    entries = ppi_clustered_entries(2, 20, 4, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collate_graphs(entries)
    batch, _ = collate_graphs(entries, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.to("cuda")
    for cls in (GINet, GINetNoCluster, VanillaNetwork):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(4, 2, 1)
        assert cls(4, 2, 1, device="cpu")(batch).shape == (2, 2)


def test_fused_tower_entry_points_raise_without_cuda(no_cuda) -> None:
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense, set_dense_tower_backend
    from deeprank2_tpu_torch.ops.batch import collate_graphs_dense
    from deeprank2_tpu_torch.ops.diag_spmm import tower_pooled
    from deeprank2_tpu_torch.ops.ginet_tower import ginet_tower_pooled
    from deeprank2_tpu_torch.ops.synthetic import synthetic_entries

    entries = synthetic_entries(2, 8, 4, 2, seed=0)
    batch, _ = collate_graphs_dense(entries, device="cpu")
    w1, w2 = torch.ones(4, 32), torch.ones(32, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.to("cuda")
    # the kernels run on the tensors' device: a batch that is not on the CPU
    # or a CUDA device has neither kernel nor plain version
    meta = [t.to("meta") for t in (w1, w2, batch.x, batch.adj_i8, batch.node_mask, batch.x_t)]
    with pytest.raises(ValueError, match="no kernel"):
        ginet_tower_pooled(*meta[:5])
    with pytest.raises(ValueError, match="no kernel"):
        tower_pooled(meta[3], meta[4], meta[5], meta[0], meta[1])
    set_dense_tower_backend("pallas")
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GINetDense(4, 2, 2)
        assert GINetDense(4, 2, 2, device="cpu")(batch).shape == (2, 2)
    finally:
        set_dense_tower_backend("xla")
    assert ginet_tower_pooled(w1, w2, batch.x, batch.adj_i8, batch.node_mask).shape == (2, 64)
    assert tower_pooled(batch.adj_i8, batch.node_mask, batch.x_t, w1, w2).shape == (64, 2)


def test_foutnet_and_sgat_entry_points_raise_without_cuda(no_cuda) -> None:
    from deeprank2_tpu_torch.neuralnets.gnn.clustered_blocksparse import FoutNetBlockSparse, SGATBlockSparse
    from deeprank2_tpu_torch.neuralnets.gnn.foutnet import FoutNet, FoutNetDiag
    from deeprank2_tpu_torch.neuralnets.gnn.sgat import SGAT, SGATDiag
    from deeprank2_tpu_torch.ops.batch import collate_graphs, collate_graphs_blocksparse_clustered, collate_graphs_diag_clustered
    from deeprank2_tpu_torch.ops.block_sparse import build_blocksparse
    from deeprank2_tpu_torch.ops.synthetic import clustered_entry, ppi_clustered_entries

    entries = ppi_clustered_entries(2, 20, 4, seed=0)
    bcsr_entries = [clustered_entry(300, 4, seed=0)]
    und = bcsr_entries[0]["edge_index"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_blocksparse(und, 300, weights=bcsr_entries[0]["edge_attr"][:, 0])
    for min_slot_nodes in (1, 5):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            collate_graphs_diag_clustered(entries, with_edge_weights=True, min_slot_nodes=min_slot_nodes)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collate_graphs_blocksparse_clustered(bcsr_entries, with_edge_weights=True, slot8=True)
    batches = {
        "coo": collate_graphs(entries, device="cpu")[0],
        "diag": collate_graphs_diag_clustered(entries, device="cpu")[0],
        "diag_weighted": collate_graphs_diag_clustered(entries, with_edge_weights=True, device="cpu")[0],
        "bcsr": collate_graphs_blocksparse_clustered(bcsr_entries, slot8=True, device="cpu")[0],
        "bcsr_weighted": collate_graphs_blocksparse_clustered(bcsr_entries, with_edge_weights=True, slot8=True, device="cpu")[0],
    }
    for name in ("diag_weighted", "bcsr_weighted"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batches[name].to("cuda")
    models = {FoutNet: "coo", SGAT: "coo", FoutNetDiag: "diag", SGATDiag: "diag_weighted", FoutNetBlockSparse: "bcsr", SGATBlockSparse: "bcsr_weighted"}
    for cls, name in models.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(4, 2, 1)
        batch = batches[name]
        assert cls(4, 2, 1, device="cpu")(batch).shape == (batch.num_graphs, 2)


def test_cnn_and_alignment_entry_points_raise_without_cuda(no_cuda) -> None:
    from deeprank2_tpu_torch.neuralnets.cnn.model3d import CnnClassification, CnnRegression
    from deeprank2_tpu_torch.neuralnets.gnn.alignmentnet import AlignmentGNN
    from deeprank2_tpu_torch.ops.batch import collate_grids
    from deeprank2_tpu_torch.ops.synthetic import grid_arrays, grid_entries

    entries = grid_entries(*grid_arrays(2, 3, (8, 8, 8), seed=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collate_grids(entries)
    batch, _ = collate_grids(entries, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.to("cuda")
    for cls, width in ((CnnClassification, 2), (CnnRegression, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(3, (8, 8, 8))
        assert cls(3, (8, 8, 8), device="cpu")(batch).shape == (2, width)
    args = (3, 4, 2, 8, 4, 8, 2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AlignmentGNN(*args)
    out, attention = AlignmentGNN(*args, device="cpu")(torch.tensor([[0, 1, 2], [1, 2, 0]]), torch.ones(3, 3), torch.ones(3, 4))
    assert out.shape == (3, 2) and attention.shape == (3, 1)


def test_bf16_entry_points_raise_without_cuda(no_cuda) -> None:
    from deeprank2_tpu_torch.neuralnets.gnn.clustered_blocksparse import GINetClusteredBlockSparse
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_blocksparse import GINetBlockSparse
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetClusteredDiag, GINetDense
    from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetworkBlocked

    for cls in (GINetDense, GINetClusteredDiag, GINetBlockSparse, GINetClusteredBlockSparse, VanillaNetworkBlocked):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(4, 2, 1, compute_dtype=torch.bfloat16)
        assert cls(4, 2, 1, compute_dtype=torch.bfloat16, device="cpu").compute_dtype == torch.bfloat16


# what each case builds: a bf16 model that runs (its collate's keyword
# arguments), or what is refused (the exception and the message it names)
COMPUTE_DTYPE_CASES = {
    "pallas_tower_bf16": "dense",
    "foutnet_diag_bf16": ("diag", {}),
    "sgat_diag_bf16": ("diag", {"with_edge_weights": True}),
    "foutnet_bcsr_bf16": ("bcsr", {}),
    "sgat_bcsr_bf16": ("bcsr", {"with_edge_weights": True}),
    "float16": (ValueError, "compute_dtype"),
    "foutnet_coo_bf16": (TypeError, "compute_dtype"),
    "sgat_coo_bf16": (TypeError, "compute_dtype"),
}


@pytest.mark.parametrize("case", sorted(COMPUTE_DTYPE_CASES))
def test_compute_dtypes_without_a_port_raise(no_cuda, case) -> None:
    """Every model that takes ``compute_dtype`` in the JAX package takes
    bf16 in the port: GINetDense on the fused tower ("pallas"), FoutNet and
    sGAT on the Diag and BCSR paths. Each builds on ``device="cpu"``, gives
    f32 logits, and raises without a device on a machine with no CUDA.
    float16, which no kernel has, is refused, and so is any
    ``compute_dtype`` of the COO FoutNet and sGAT, which have none in the
    JAX package either."""
    from deeprank2_tpu_torch.neuralnets.gnn import clustered_blocksparse, foutnet, ginet_dense, sgat
    from deeprank2_tpu_torch.ops.batch import collate_graphs_blocksparse_clustered, collate_graphs_dense, collate_graphs_diag_clustered
    from deeprank2_tpu_torch.ops.synthetic import ppi_clustered_entries, synthetic_entries

    bf16 = torch.bfloat16
    models = {
        "pallas_tower_bf16": ginet_dense.GINetDense,
        "foutnet_diag_bf16": foutnet.FoutNetDiag,
        "sgat_diag_bf16": sgat.SGATDiag,
        "foutnet_bcsr_bf16": clustered_blocksparse.FoutNetBlockSparse,
        "sgat_bcsr_bf16": clustered_blocksparse.SGATBlockSparse,
        "float16": ginet_dense.GINetDense,
        "foutnet_coo_bf16": foutnet.FoutNet,
        "sgat_coo_bf16": sgat.SGAT,
    }
    cls, what = models[case], COMPUTE_DTYPE_CASES[case]
    if isinstance(what[0], type):
        with pytest.raises(what[0], match=what[1]):
            cls(4, 2, 2, device="cpu", compute_dtype=torch.float16 if case == "float16" else bf16)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(4, 2, 2, compute_dtype=bf16)
    model = cls(4, 2, 2, device="cpu", compute_dtype=bf16)
    assert model.compute_dtype == bf16
    if what == "dense":
        batch, _ = collate_graphs_dense(synthetic_entries(2, 8, 4, 2, seed=0), device="cpu")
        ginet_dense.set_dense_tower_backend("pallas")
        try:
            logits = model(batch)
        finally:
            ginet_dense.set_dense_tower_backend("xla")
    else:
        layout, kwargs = what
        collate = collate_graphs_diag_clustered if layout == "diag" else collate_graphs_blocksparse_clustered
        batch, _ = collate(ppi_clustered_entries(2, 30, 4, seed=3), device="cpu", **kwargs)
        logits = model(batch)
    assert logits.dtype == torch.float32 and logits.shape == (batch.num_graphs, 2)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda_or_without_the_repo(no_cuda, tmp_path, alone) -> None:
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=300, check=False, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_library_name_follows_nested_headers(tmp_path, monkeypatch) -> None:
    """A library is named by its source and every local header it includes,
    theirs in turn (csrc/tower_common.cuh includes csrc/bf16.cuh): an edit to
    a nested header gives a new name, so the kernel is rebuilt."""
    from deeprank2_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "outer.cuh"\n')
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("#pragma once\n// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("k")
    assert _build._target("k") == before
    (tmp_path / "inner.cuh").write_text("#pragma once\n// two\n")
    assert _build._target("k") != before
