"""The port's batched dense family (deeprank2_tpu_torch) against the JAX
package's on the CPU: ``collate_graphs_dense`` with clusters, edge weights
and without the flat route's operands, field for field; the dense pools
``dense_segment_max`` and ``dense_community_pool`` (with and without edge
weights), forward and gradient; ``GINetClusteredDense``, ``FoutNetDense``,
``SGATDense`` and ``GINetDense``'s batched branch, logits, loss and every
gradient from one JAX initialisation (neuralnets/param_interop.py).

Tolerances: the collate exactly; the pools' forwards exactly (a max and a
count) and their sums of weights and positions at rtol 1e-6; the models'
logits and loss at rtol=atol=1e-5 and their gradients at rtol 1e-5, atol
1e-5, the tolerances of the JAX package's dense tests
(tests/test_torch_ginet_dense.py holds GINetDense to the same)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprank2_tpu.neuralnets.gnn.foutnet import FoutNetDense as JaxFoutNetDense
from deeprank2_tpu.neuralnets.gnn.ginet_dense import GINetClusteredDense as JaxGINetClusteredDense
from deeprank2_tpu.neuralnets.gnn.ginet_dense import GINetDense as JaxGINetDense
from deeprank2_tpu.neuralnets.gnn.sgat import SGATDense as JaxSGATDense
from deeprank2_tpu.ops import batch as jbatch
from deeprank2_tpu.ops import pooling as jpooling
from deeprank2_tpu.ops.losses import CrossEntropyLoss as JaxCrossEntropyLoss
from deeprank2_tpu_torch.neuralnets.gnn.foutnet import FoutNetDense
from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetClusteredDense, GINetDense
from deeprank2_tpu_torch.neuralnets.gnn.sgat import SGATDense
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax, params_to_jax
from deeprank2_tpu_torch.ops import batch as tbatch
from deeprank2_tpu_torch.ops import pooling as tpooling
from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
from deeprank2_tpu_torch.ops.synthetic import ppi_clustered_entries, synthetic_entries

FEAT = 38
TOL = {"rtol": 1e-5, "atol": 1e-5}
SUM_TOL = {"rtol": 1e-6, "atol": 1e-6}
# model -> (JAX class, port class, param_interop family, collate flags)
MODELS = {
    "GINetClusteredDense": (JaxGINetClusteredDense, GINetClusteredDense, None, {"with_clusters": True}),
    "FoutNetDense": (JaxFoutNetDense, FoutNetDense, "foutnet", {"with_clusters": True}),
    "SGATDense": (JaxSGATDense, SGATDense, "sgat", {"with_clusters": True, "with_edge_weights": True}),
}


def _clustered(num_graphs=5, nodes=40, seed=3):
    """Clustered PPI-like graphs of ragged size, one without a target."""
    entries = ppi_clustered_entries(num_graphs, nodes, FEAT, seed=seed)
    entries[1]["y"] = None
    return entries


def _to_numpy(value) -> np.ndarray:
    array = np.asarray(value)
    return array.astype(np.float32) if array.dtype.name == "bfloat16" else array


@pytest.mark.parametrize(
    "flags",
    [
        {"with_clusters": True},
        {"with_edge_weights": True},
        {"with_clusters": True, "with_edge_weights": True, "with_diag_operands": False},
        {"with_diag_operands": False},
    ],
    ids=["clusters", "weights", "clusters-weights-no-operands", "no-operands"],
)
def test_dense_collate_matches_jax_field_for_field(flags) -> None:
    entries = _clustered()
    # a duplicate pair and a self-loop: their weights add up, twice for the loop
    entries[0]["edge_index"] = np.concatenate([entries[0]["edge_index"], entries[0]["edge_index"][:1], [[3, 3]]])
    entries[0]["edge_attr"] = np.concatenate([entries[0]["edge_attr"], [[0.25], [0.5]]]).astype(np.float32)
    want, want_names = jbatch.collate_graphs_dense(entries, pad_graphs=7, **flags)
    got, names = tbatch.collate_graphs_dense(entries, pad_graphs=7, device="cpu", **flags)
    assert names == want_names
    assert got.adj.dtype == torch.bfloat16
    # the batch holds its adjacency once: beside the flat route's operands
    # as adj_i8 (the JAX batch also has it in bf16 there), else in bf16
    operands = flags.get("with_diag_operands", True)
    assert (got.adj.numel() == 0) == operands
    np.testing.assert_array_equal(got.adjacency.float().numpy(), _to_numpy(want.adj))
    for field in got.__dataclass_fields__:
        if field == "adj" and operands:
            continue
        ours = getattr(got, field)
        theirs = _to_numpy(getattr(want, field))
        assert ours.is_contiguous(), field
        np.testing.assert_array_equal(ours.float().numpy() if ours.dtype == torch.bfloat16 else ours.numpy(), theirs, err_msg=field)
        if ours.dtype != torch.bfloat16:
            assert ours.numpy().dtype == theirs.dtype, field


def _pool_inputs(seed=1):
    entries = _clustered(seed=seed)
    jb, _ = jbatch.collate_graphs_dense(entries, with_clusters=True, with_edge_weights=True)
    rng = np.random.default_rng(seed)
    # post-relu features with ties inside clusters (the max's tie rule)
    x = np.maximum(rng.standard_normal((*np.asarray(jb.x).shape[:2], 6)), 0.0).astype(np.float32).round(1)
    return jb, x


def test_dense_segment_max_matches_jax_with_ties() -> None:
    jb, x = _pool_inputs()
    g = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    cluster = np.asarray(jb.cluster0)
    want, vjp = jax.vjp(lambda v: jpooling.dense_segment_max(v, jnp.asarray(cluster)), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = tpooling.dense_segment_max(xt, torch.from_numpy(cluster))
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), **SUM_TOL)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_dense_community_pool_matches_jax(weighted) -> None:
    jb, x = _pool_inputs(seed=4)
    adj_w = np.asarray(jb.adj_w) if weighted else None
    want = jpooling.dense_community_pool(jnp.asarray(x), jb.pos, jb.adj, jb.cluster0, adj_w=None if adj_w is None else jnp.asarray(adj_w))
    tb, _ = tbatch.collate_graphs_dense(_clustered(seed=4), with_clusters=True, with_edge_weights=True, device="cpu")
    got = tpooling.dense_community_pool(torch.from_numpy(x), tb.pos, tb.adjacency, tb.cluster0, adj_w=tb.adj_w if weighted else None)
    names = ("x", "pos", "adj", "adj_w", "node_mask")
    for name, ours, theirs in zip(names, got, want):
        if theirs is None:
            assert ours is None, name
            continue
        if name in ("x", "adj", "node_mask"):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs), err_msg=name)
        else:
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **SUM_TOL, err_msg=name)


def test_ginet_conv_dense_matches_jax() -> None:
    from deeprank2_tpu.neuralnets.gnn.ginet_dense import ginet_conv_dense as jax_conv
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import ginet_conv_dense

    jb, x = _pool_inputs(seed=6)
    params = jax.tree.map(np.asarray, JaxGINetDense(6, 2, 1).init(jax.random.PRNGKey(2)))
    model = GINetDense(6, 2, 1, device="cpu")
    model.load_state_dict(params_from_jax(params))
    want = jax_conv(params["conv1"], jnp.asarray(x), jb.adj)
    got = ginet_conv_dense(model.conv1, torch.from_numpy(x), torch.from_numpy(_to_numpy(jb.adj)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _jax_loss(jmodel, jb, method="apply"):
    def compute(p):
        pred = getattr(jmodel, method)(p, jb, training=False)
        return JaxCrossEntropyLoss()(pred, jb.y.astype(jnp.int32), jb.y_mask), pred

    return compute


def _assert_step_matches(jmodel, params, jb, model, tb, family) -> None:
    (loss_want, pred_want), grads_want = jax.value_and_grad(_jax_loss(jmodel, jb), has_aux=True)(params)
    pred = model(tb, training=False)
    loss = CrossEntropyLoss()(pred, tb.y, tb.y_mask)
    loss.backward()
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(pred_want), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_want), **TOL)
    got = params_to_jax({k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in model.named_parameters()}, family)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, grads_want))
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_allclose(a, b, **TOL, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_dense_family_step_matches_jax(name) -> None:
    jax_cls, port_cls, family, flags = MODELS[name]
    entries = _clustered(num_graphs=6, nodes=48, seed=11)
    jb, _ = jbatch.collate_graphs_dense(entries, pad_graphs=8, with_diag_operands=False, **flags)
    tb, _ = tbatch.collate_graphs_dense(entries, pad_graphs=8, with_diag_operands=False, device="cpu", **flags)
    jmodel = jax_cls(FEAT, 2, 1)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    model = port_cls(FEAT, 2, 1, device="cpu")
    model.load_state_dict(params_from_jax(params, family))
    assert (model.needs_clusters, model.dense_batches, getattr(model, "diag_operands", False)) == (True, True, False)
    assert getattr(model, "dense_edge_weights", False) == getattr(jmodel, "dense_edge_weights", False)
    _assert_step_matches(jmodel, params, jb, model, tb, family)


def _ginet_dense_setup():
    entries = synthetic_entries(5, 40, FEAT, 6, seed=9)
    entries[-1]["x"], entries[-1]["pos"] = entries[-1]["x"][:31], entries[-1]["pos"][:31]
    entries[-1]["edge_index"] = entries[-1]["edge_index"][(entries[-1]["edge_index"] < 31).all(axis=1)]
    jmodel = JaxGINetDense(FEAT, 2, 6)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    model = GINetDense(FEAT, 2, 6, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return entries, jmodel, params, model


def test_ginet_dense_batched_branch_matches_jax() -> None:
    """A batch without the flat route's operands takes the batched branch,
    JAX's off its TPU (``diag_spmm.supports`` is False there) and beyond K1's
    shared memory: logits, loss and every gradient."""
    entries, jmodel, params, model = _ginet_dense_setup()
    jb, _ = jbatch.collate_graphs_dense(entries, pad_graphs=6, with_diag_operands=False)
    tb, _ = tbatch.collate_graphs_dense(entries, pad_graphs=6, with_diag_operands=False, device="cpu")
    assert tb.adj_i8.numel() == 0
    _assert_step_matches(jmodel, params, jb, model, tb, None)


def test_ginet_dense_batched_sums_equal_the_flat_route() -> None:
    """``batched_pooled`` on a batch with ``adj_i8`` (the branch a CUDA batch
    beyond K1's ``max_nodes`` takes) against the flat route's pooled sums."""
    entries, _, _, model = _ginet_dense_setup()
    tb, _ = tbatch.collate_graphs_dense(entries, pad_graphs=6, device="cpu")
    w1_t, w2_t = model.fused_weights()
    from deeprank2_tpu_torch.ops.diag_spmm import diag_layer_pool_t, diag_layer_t

    with torch.no_grad():
        flat = diag_layer_pool_t(tb.adj_i8, tb.node_mask, w2_t @ diag_layer_t(tb.adj_i8, tb.node_mask, w1_t @ tb.x_t)).T
        np.testing.assert_allclose(model.batched_pooled(tb).numpy(), flat.numpy(), rtol=1e-5, atol=1e-5)
