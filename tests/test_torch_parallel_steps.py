"""The port's data-parallel steps and graph-parallel forwards
(deeprank2_tpu_torch/parallel) over two gloo ranks on the CPU against the
JAX package's on a 2-device mesh of its virtual CPU devices.

One spawn (``parallel/launch.py``) runs every port case
(``parallel/probes.py``), each rank from the same numpy-seeded inputs; the
JAX side runs here. The cases:

- ``make_dp_train_step`` (two steps, Adam) and ``make_dp_eval_step`` on the
  sharded collates of the dense, COO, blocked-edge, clustered block-sparse
  (slot8) and graph-diagonal clustered (pure and mixed) models, the JAX
  Trainer's initial parameters in both (``param_interop``), dropout-free
  twins; evenly and unevenly filled shards (the loss is the pmean of shard
  means in both packages): losses rtol 1e-5, predictions and parameters
  atol 1e-5 (the synced probe's tolerances);
- the edge-partitioned and ring forwards of the no-cluster GINet against the
  single-device JAX model (atol 1e-5, the JAX test's) and their gradients,
  pmean'ed, against JAX's (atol 1e-5);
- the block-sparse partitioned and ring forwards against the single-device
  JAX model (atol 1e-4) and their gradients (atol 5e-3), and the two
  SpMMs' VJPs against ``A @ w`` (atol 1e-4): the tolerances of
  ``tests/utils/test_blocksparse_{partition,ring}.py``;
- the collectives of ``comm_shape``'s four reports against JAX's (kinds,
  counts, and the bytes where the forms agree; see ``comm_shape.py``);
- ``edge_partition_scaling_report`` at the JAX test's gate (1e-5);
- ``cluster.hybrid_mesh``'s groups.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial import cKDTree

from deeprank2_tpu.neuralnets.gnn import clustered_blocksparse as j_cbs
from deeprank2_tpu.neuralnets.gnn import ginet_blocksparse as j_gbs
from deeprank2_tpu.neuralnets.gnn import ginet_dense as j_dense
from deeprank2_tpu.neuralnets.gnn import ginet_nocluster as j_nc
from deeprank2_tpu.neuralnets.gnn import vanilla_gnn as j_vanilla
from deeprank2_tpu.ops import batch as jbatch
from deeprank2_tpu.ops.losses import CrossEntropyLoss
from deeprank2_tpu.ops.optim import Adam
from deeprank2_tpu.parallel import blocksparse_partition as jbp
from deeprank2_tpu.parallel import comm_shape as jcs
from deeprank2_tpu.parallel import edge_partition as jep
from deeprank2_tpu.parallel.dp import default_mesh, make_dp_eval_step, make_dp_train_step
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax
from deeprank2_tpu_torch.ops.synthetic import clustered_entry, ppi_clustered_entries, synthetic_entries
from deeprank2_tpu_torch.parallel import cluster, launch, probes

FEAT, EDGE = 12, 3
RANKS = 2
STEPS = 2
LOSS_TOL = {"rtol": 1e-5, "atol": 0.0}
TOL = {"rtol": 0.0, "atol": 1e-5}


def _dropout_free(cls):
    return type(cls.__name__, (cls,), {"dropout": 0.0})


def _atomic(sizes, seed, feat=FEAT, edge_dim=1):
    rng = np.random.default_rng(seed)
    entries = []
    for g, n in enumerate(sizes):
        pos = rng.uniform(0, 26, size=(n, 3))
        pairs = cKDTree(pos).query_pairs(5.0, output_type="ndarray")
        entries.append(
            {
                "x": rng.normal(size=(n, feat)).astype(np.float32),
                "edge_index": pairs.astype(np.int64),
                "edge_attr": rng.normal(size=(len(pairs), edge_dim)).astype(np.float32),
                "pos": pos.astype(np.float32),
                "y": float(g % 2),
                "entry_name": f"p{g}",
            }
        )
    return entries


def _clustered():
    entries = [clustered_entry(n, FEAT, seed=30 + i) for i, n in enumerate((900, 400, 300))]
    for i, e in enumerate(entries):
        e["entry_name"] = f"c{i}"
    return entries


# name -> (JAX class, port "module:Class", param_interop family, edge dim, collate, per shard, collate kwargs, entries)
DP_CASES = {
    "dense": (j_dense.GINetDense, "neuralnets.gnn.ginet_dense:GINetDense", None, EDGE, "collate_graphs_dense_sharded", 3, {}, lambda: synthetic_entries(6, 30, FEAT, EDGE, seed=1)),
    "dense-uneven": (j_dense.GINetDense, "neuralnets.gnn.ginet_dense:GINetDense", None, EDGE, "collate_graphs_dense_sharded", 3, {}, lambda: synthetic_entries(5, 30, FEAT, EDGE, seed=2)),
    "coo-uneven": (j_nc.GINet, "neuralnets.gnn.ginet_nocluster:GINet", None, EDGE, "collate_graphs_sharded", 3, {}, lambda: synthetic_entries(5, 25, FEAT, EDGE, seed=3)),
    "blocked": (j_vanilla.VanillaNetworkBlocked, "neuralnets.gnn.vanilla_gnn:VanillaNetworkBlocked", "vanilla", 4, "collate_graphs_blocked_sharded", 2, {}, lambda: _atomic((300, 220, 330), 4, edge_dim=4)),
    "clustered-bcsr-slot8": (j_cbs.GINetClusteredBlockSparse, "neuralnets.gnn.clustered_blocksparse:GINetClusteredBlockSparse", None, 1, "collate_graphs_blocksparse_clustered_sharded", 2, {"slot8": True}, _clustered),
    "diag-clustered": (j_dense.GINetClusteredDiag, "neuralnets.gnn.ginet_dense:GINetClusteredDiag", None, 1, "collate_graphs_diag_clustered_sharded", 2, {"min_slot_nodes": 1}, lambda: ppi_clustered_entries(4, 60, FEAT, seed=5)),
    "diag-mixed-uneven": (j_dense.GINetClusteredDiag, "neuralnets.gnn.ginet_dense:GINetClusteredDiag", None, 1, "collate_graphs_diag_clustered_sharded", 2, {}, lambda: ppi_clustered_entries(3, 60, FEAT, cell=6.0, seed=6)),
}
GP_ENTRIES = {"seed": 2, "sizes": (300, 220, 330)}


def _gp_entries():
    return _atomic(GP_ENTRIES["sizes"], GP_ENTRIES["seed"])


def _edge_entries():
    return synthetic_entries(5, 30, FEAT, EDGE, seed=7)


def _jax_state(cls, family, edge_dim, key):
    model = _dropout_free(cls)(FEAT, 2, edge_dim)
    params = model.init(jax.random.PRNGKey(key))
    return model, params, params_from_jax(jax.tree.map(np.asarray, params), family)


def _cases() -> list:
    cases = []
    for name, (cls, port, family, edge_dim, collate, per, kw, make) in DP_CASES.items():
        _, _, state = _jax_state(cls, family, edge_dim, 0)
        spec = {"model": port, "feat": FEAT, "edge_dim": edge_dim, "state": state, "dropout_free": True, "entries": make(), "collate": collate, "per_shard": per, "collate_kwargs": kw, "steps": STEPS}
        cases.append((f"dp:{name}", "dp_steps", spec))
    _, _, state = _jax_state(j_gbs.GINetBlockSparse, None, 1, 1)
    for form in ("partitioned", "ring"):
        cases.append((f"gp:{form}", "gp_forward", {"model": "neuralnets.gnn.ginet_blocksparse:GINetBlockSparse", "feat": FEAT, "state": state, "entries": _gp_entries(), "form": form, "graphs": 3}))
    cases.append(("vjp", "spmm_vjp", {"entries": _atomic((300,), 4), "seed": 5}))
    _, _, state = _jax_state(j_nc.GINet, None, EDGE, 2)
    for form in ("all-gather", "ring"):
        cases.append((f"edge:{form}", "edge_forward", {"model": "neuralnets.gnn.ginet_nocluster:GINet", "feat": FEAT, "edge_dim": EDGE, "state": state, "entries": _edge_entries(), "pad_graphs": 6, "form": form}))
    cases.append(("comm", "comm_shapes", {}))
    cases.append(("scaling", "edge_scaling", {}))
    cases.append(("mesh", "mesh_groups", {}))
    for _, _, spec in cases:
        spec["device"] = "cpu"
    return cases


@pytest.fixture(scope="module")
def mesh():
    return default_mesh(devices=jax.devices()[:RANKS])


@pytest.fixture(scope="module")
def both(mesh) -> tuple[list[dict], dict]:
    """The ranks' results and the JAX data-parallel runs, which run here
    while the ranks do."""
    started = launch.start(probes.run_cases, RANKS, _cases(), threads=2, deadline=240)
    jax_runs = {name: _jax_dp(name, mesh) for name in DP_CASES}
    return started.result(), jax_runs


@pytest.fixture(scope="module")
def ranks(both) -> list[dict]:
    return both[0]


@pytest.fixture(scope="module")
def jax_dp(both) -> dict:
    return both[1]


def _jax_dp(name, mesh):
    cls, _, family, edge_dim, collate, per, kw, make = DP_CASES[name]
    model, params, _ = _jax_state(cls, family, edge_dim, 0)
    loss_fn = CrossEntropyLoss()

    def compute_loss(p, batch, rng, training):
        pred = model.apply(p, batch, training=training, rng=rng)
        return loss_fn(pred, batch.y.astype(jnp.int32), batch.y_mask), pred

    optimizer = Adam(lr=1e-3, weight_decay=1e-5)
    opt_state = optimizer.init(params)
    stacked, names = getattr(jbatch, collate)(make(), RANKS, per, **kw)
    step = make_dp_train_step(compute_loss, optimizer, mesh=mesh)
    rng = jax.random.PRNGKey(1)
    losses, preds = [], []
    for _ in range(STEPS):
        params, opt_state, loss, pred, rng = step(params, opt_state, rng, stacked)
        losses.append(float(loss))
        preds.append(np.asarray(pred))
    eval_loss, eval_pred = make_dp_eval_step(compute_loss, mesh=mesh)(params, stacked)
    return {"names": names, "losses": losses, "preds": preds, "eval_loss": float(eval_loss), "eval_pred": np.asarray(eval_pred), "params": params_from_jax(jax.tree.map(np.asarray, params), family)}


@pytest.mark.parametrize("what", ["losses", "predictions", "parameters"])
@pytest.mark.parametrize("case", sorted(DP_CASES))
def test_dp_steps_match_jax_on_a_2_device_mesh(ranks, jax_dp, case, what) -> None:
    want = jax_dp[case]
    for rank in ranks:
        got = rank[f"dp:{case}"]
        assert got["names"] == want["names"]
        if what == "losses":
            np.testing.assert_allclose([*got["losses"], got["eval_loss"]], [*want["losses"], want["eval_loss"]], **LOSS_TOL)
        elif what == "predictions":
            for g, w in zip([*got["preds"], got["eval_pred"]], [*want["preds"], want["eval_pred"]]):
                np.testing.assert_allclose(g, w, **TOL)
        else:
            assert got["params"].keys() == want["params"].keys()
            for key, w in want["params"].items():
                np.testing.assert_allclose(got["params"][key], w.numpy(), **TOL, err_msg=key)


def test_dp_step_is_one_fused_all_reduce_and_a_prediction_gather(ranks) -> None:
    for rank in ranks:
        for case in DP_CASES:
            comm = rank[f"dp:{case}"]["comm_train"]
            assert comm["all-reduce"]["count"] == 1 and comm["all-gather"]["count"] == 1 and comm["collective-permute"]["count"] == 0, case


def _jax_gp(form):
    model, params, _ = _jax_state(j_gbs.GINetBlockSparse, None, 1, 1)
    batch, _ = jbatch.collate_graphs_blocksparse(_gp_entries())

    def loss(p):
        return (model.apply(p, batch, training=False)[:3] ** 2).sum()

    return model.apply(params, batch, training=False), params_from_jax(jax.tree.map(np.asarray, jax.grad(loss)(params)), None), (model, params, batch)


@pytest.mark.parametrize("what", ["forward", "gradients", "forward-vs-jax-sharded"])
@pytest.mark.parametrize("form", ["partitioned", "ring"])
def test_blocksparse_graph_parallel_matches_jax(ranks, mesh, form, what) -> None:
    out, grads, (model, params, batch) = _jax_gp(form)
    for rank in ranks:
        got = rank[f"gp:{form}"]
        if what == "forward":
            np.testing.assert_allclose(got["out"][:3], np.asarray(out)[:3], atol=1e-4)
        elif what == "gradients":
            for key, w in grads.items():
                np.testing.assert_allclose(got["grads"][key], w.numpy(), atol=5e-3, err_msg=key)
        else:
            if form == "ring":
                fwd = jbp.make_blocksparse_ginet_ring_forward(model, mesh=mesh)
                part = jbp.partition_blocksparse_batch_ring(batch, RANKS)
            else:
                fwd = jbp.make_blocksparse_ginet_forward(model, mesh=mesh)
                part = jbp.partition_blocksparse_batch(batch, RANKS)
            np.testing.assert_allclose(got["out"][:3], np.asarray(fwd(params, part))[:3], atol=1e-5)


@pytest.mark.parametrize("spmm", ["sharded", "ring"])
def test_sharded_spmm_vjp_is_the_spmm_of_the_cotangent(ranks, spmm) -> None:
    for rank in ranks:
        got = rank["vjp"]
        np.testing.assert_allclose(got[spmm][: got["one_rank"].shape[0]], got["one_rank"], atol=1e-4)


@pytest.mark.parametrize("what", ["forward", "forward-vs-jax-sharded", "gradients"])
@pytest.mark.parametrize("form", ["all-gather", "ring"])
def test_edge_partition_matches_jax(ranks, mesh, form, what) -> None:
    model, params, _ = _jax_state(j_nc.GINet, None, EDGE, 2)
    batch, _ = jbatch.collate_graphs(_edge_entries(), pad_graphs=6)
    for rank in ranks:
        got = rank[f"edge:{form}"]
        if what == "forward":
            np.testing.assert_allclose(got["out"], np.asarray(model.apply(params, batch)), atol=1e-5)
        elif what == "gradients":
            grads = params_from_jax(jax.tree.map(np.asarray, jax.grad(lambda p: (model.apply(p, batch) ** 2).sum())(params)), None)
            for key, w in grads.items():
                np.testing.assert_allclose(got["grads"][key], w.numpy(), atol=1e-5, err_msg=key)
        else:
            if form == "ring":
                fwd, part = jep.make_ring_ginet_forward(model, mesh=mesh), jep.partition_graph_batch_ring(batch, RANKS)
            else:
                fwd, part = jep.make_edge_partitioned_ginet_forward(model, mesh=mesh), jep.partition_graph_batch(batch, RANKS)
            np.testing.assert_allclose(got["out"], np.asarray(fwd(params, part)), atol=1e-5)


# report -> the kinds whose count and bytes the port's run gives as JAX's HLO does
COMM = {
    "dp": (lambda: jcs.dp_train_report(RANKS), ("all-reduce", "collective-permute")),
    "edge": (lambda: jcs.edge_partition_report(RANKS), ("all-gather", "collective-permute", "all-reduce")),
    "ring": (lambda: jcs.edge_partition_report(RANKS, ring=True), ("all-gather", "collective-permute", "all-reduce")),
    "blocksparse_ring": (lambda: jcs.blocksparse_ring_report(RANKS), ("all-gather", "collective-permute", "all-reduce")),
}


@pytest.mark.parametrize("report", sorted(COMM))
def test_comm_counts_match_jax_comm_shape(ranks, report) -> None:
    jax_report, kinds = COMM[report]
    want = jax_report()
    for rank in ranks:
        got = rank["comm"][report]
        assert (got["path"], got["shards"]) == (want["path"], want["shards"])
        for kind in kinds:
            assert got[kind]["count"] == want[kind]["count"], kind
            if report != "dp":
                assert got[kind]["bytes"] == want[kind]["bytes"], kind
    if report == "dp":
        # one fused all-reduce of every gradient and the loss (the port's also
        # carries the zero gradients of the parameters outside the loss, which
        # XLA leaves out), and the gather of the predictions
        assert got["all-reduce"]["bytes"] >= want["all-reduce"]["bytes"] and got["all-gather"]["count"] == 1


def test_edge_partition_scaling_report(ranks) -> None:
    """The JAX test's gate (tests/utils/test_edge_partition.py:15)."""
    for rank in ranks:
        report = rank["scaling"]
        assert report["num_shards"] == RANKS and report["max_abs_err"] < 1e-5 and report["seconds_per_forward"] > 0


def test_hybrid_mesh_groups(ranks) -> None:
    for rank, got in enumerate(r["mesh"] for r in ranks):
        assert got["default"] == {"dp": 1, "gp": RANKS, "dp_rank": 0, "gp_rank": rank, "dp_sum": None, "gp_sum": 3.0}
        assert got["dp"] == {"dp": RANKS, "gp": 1, "dp_rank": rank, "gp_rank": 0, "dp_sum": 3.0, "gp_sum": None}
        assert "does not cover" in got["error"]


def test_single_process_passes_through() -> None:
    cluster.initialize("gloo")  # no-op without a process group
    assert cluster.hybrid_mesh() == cluster.Mesh(1, 1, None, None, 0, 0)
    with pytest.raises(ValueError, match="does not cover"):
        cluster.hybrid_mesh(dp=2)
