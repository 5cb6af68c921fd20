"""The port's COO slice (deeprank2_tpu_torch: collate_graphs, the COO
pooling, ginet_conv with the clustered and no-cluster GINet, and the COO
VanillaNetwork) against the JAX package's on the CPU: the collate field for
field, exactly; pooled integers exactly and pooled floats at 1e-6, with the
pooled rows ascending (the sorted segment sum's precondition); the models
with one JAX initialization loaded into both, logits and loss at rtol 1e-4 /
atol 1e-5 and every gradient at rtol 1e-4 / atol 1e-6 (f32 on both sides),
once against JAX's XLA route and once with its Pallas segment kernel
engaged in interpret mode."""

from __future__ import annotations

import contextlib
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deeprank2_tpu.neuralnets.gnn.ginet import GINet as JaxGINet
from deeprank2_tpu.neuralnets.gnn.ginet_nocluster import GINet as JaxGINetNoCluster
from deeprank2_tpu.neuralnets.gnn.vanilla_gnn import VanillaNetwork as JaxVanillaNetwork
from deeprank2_tpu.ops import batch as jbatch
from deeprank2_tpu.ops import pooling as jpool
from deeprank2_tpu.ops import segment as jseg
from deeprank2_tpu.ops.losses import CrossEntropyLoss as JaxCrossEntropyLoss
from deeprank2_tpu_torch.neuralnets.gnn.ginet import GINet
from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
from deeprank2_tpu_torch.neuralnets.gnn.ginet_nocluster import GINet as GINetNoCluster
from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetwork, VanillaNetworkBlocked
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax, params_to_jax
from deeprank2_tpu_torch.ops import batch as tbatch
from deeprank2_tpu_torch.ops import pooling as tpool
from deeprank2_tpu_torch.ops import segment_sorted as ss
from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
from deeprank2_tpu_torch.ops.optim import Adam
from deeprank2_tpu_torch.ops.synthetic import ppi_clustered_entries, synthetic_entries

FEAT = 12
TOL = {"rtol": 1e-4, "atol": 1e-5}
GRAD_TOL = {"rtol": 1e-4, "atol": 1e-6}
FLOAT_TOL = {"rtol": 1e-6, "atol": 1e-6}


def _ragged():
    """Graphs of 30, 55 and 12 nodes with clusters, one without a target and
    one with 1-D edge features; padded to 6 graphs."""
    entries = [ppi_clustered_entries(1, n, FEAT, seed=s)[0] for s, n in enumerate((30, 55, 12))]
    entries[1]["y"] = None
    entries[2]["edge_attr"] = entries[2]["edge_attr"][:, 0]
    return entries


# entries, pad_graphs, edge features
BATCHES = {
    "synthetic": (lambda: synthetic_entries(3, 24, FEAT, 3, seed=1), None, 3),
    "ppi": (lambda: ppi_clustered_entries(4, 40, FEAT, seed=1), 5, 1),
    "ragged": (_ragged, 6, 1),
}


def _batches(kind):
    make, pad_graphs, _ = BATCHES[kind]
    entries = make()
    jb, jnames = jbatch.collate_graphs(entries, pad_graphs=pad_graphs)
    tb, names = tbatch.collate_graphs(entries, pad_graphs=pad_graphs, device="cpu")
    assert names == jnames
    return jb, tb


@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_collate_matches_jax_field_for_field(kind) -> None:
    jb, tb = _batches(kind)
    for field in tb.__dataclass_fields__:
        ours, theirs = getattr(tb, field), getattr(jb, field)
        if field == "num_graphs":
            assert ours == theirs
            continue
        theirs = np.asarray(theirs)
        assert ours.device == torch.device("cpu") and ours.is_contiguous(), field
        assert ours.numpy().dtype == theirs.dtype, field
        np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=field)
    rows = tb.edge_index[0]
    assert bool((rows[1:] >= rows[:-1]).all()) and (tb.num_nodes, tb.num_edges) == (jb.num_nodes, jb.num_edges)
    moved = tb.to("cpu")
    assert moved.num_graphs == tb.num_graphs and torch.equal(moved.edge_index, tb.edge_index)


def test_collate_rejects_more_entries_than_pad_graphs() -> None:
    with pytest.raises(ValueError, match="exceed pad_graphs"):
        tbatch.collate_graphs(_ragged(), pad_graphs=2, device="cpu")


def _assert_ascending_with_padding_last(rows: torch.Tensor, capacity: int) -> None:
    assert bool((rows[1:] >= rows[:-1]).all())
    valid = rows < capacity
    assert not bool((~valid[:-1] & valid[1:]).any())  # no valid slot after an invalid one


@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_pool_edges_coalesce_matches_jax(kind) -> None:
    jb, tb = _batches(kind)
    cap = tb.num_nodes
    want = jpool.pool_edges_coalesce(jb.edge_index, jb.edge_attr, jb.edge_mask, jb.cluster0, cap)
    got = tpool.pool_edges_coalesce(tb.edge_index, tb.edge_attr, tb.edge_mask, tb.cluster0, cap)
    for name, a, b in zip(("edge_index", "edge_attr", "edge_mask"), got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        if name == "edge_attr":
            np.testing.assert_allclose(a.numpy(), b, **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    _assert_ascending_with_padding_last(got[0][0], cap)
    assert 0 < int(got[2].sum()) < int(tb.edge_mask.sum())  # self-loops dropped, duplicates coalesced


def test_pool_edges_coalesce_with_self_loops_duplicates_and_padded_clusters() -> None:
    rng = np.random.default_rng(7)
    cap, num_edges = 40, 300
    edge_index = rng.integers(0, cap + 1, size=(2, num_edges)).astype(np.int32)  # id cap = a padded endpoint
    cluster = rng.integers(0, 12, size=cap).astype(np.int32)
    cluster[rng.random(cap) < 0.1] = cap  # nodes outside every cluster
    edge_attr = rng.normal(size=(num_edges, 2)).astype(np.float32)
    edge_mask = rng.random(num_edges) > 0.2
    want = jpool.pool_edges_coalesce(*(jnp.asarray(a) for a in (edge_index, edge_attr, edge_mask, cluster)), cap)
    got = tpool.pool_edges_coalesce(*(torch.from_numpy(a) for a in (edge_index, edge_attr, edge_mask, cluster)), cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **FLOAT_TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _assert_ascending_with_padding_last(got[0][0], cap)


def _vjp_both(jfn, tfn, x, cot):
    out, vjp = jax.vjp(jfn, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(xt)
    (grad,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    return (got.detach().numpy(), grad.numpy()), (np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0]))


@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_community_pool_and_max_pool_x_match_jax(kind) -> None:
    jb, tb = _batches(kind)
    rng = np.random.default_rng(len(kind))
    # post-relu, masked features, as the model pools them
    x = (np.maximum(rng.normal(size=(tb.num_nodes, 16)), 0) * tb.node_mask.numpy()[:, None]).astype(np.float32)
    want = jpool.community_pool(jnp.asarray(x), jb.pos, jb.edge_index, jb.edge_attr, jb.edge_mask, jb.node_graph, jb.cluster0, jb.num_graphs)
    got = tpool.community_pool(torch.from_numpy(x), tb.pos, tb.edge_index, tb.edge_attr, tb.edge_mask, tb.node_graph, tb.cluster0, tb.num_graphs)
    names = ("x", "pos", "edge_index", "edge_attr", "edge_mask", "node_graph", "node_mask")
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b, **FLOAT_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    _assert_ascending_with_padding_last(got[2][0], tb.num_nodes)

    # values and gradients of the two max pools
    node_graph_p = got[5]
    cot = rng.normal(size=x.shape).astype(np.float32)
    (g, gg), (w, wg) = _vjp_both(
        lambda h: jpool.community_pool(h, jb.pos, jb.edge_index, jb.edge_attr, jb.edge_mask, jb.node_graph, jb.cluster0, jb.num_graphs)[0],
        lambda h: tpool.community_pool(h, tb.pos, tb.edge_index, tb.edge_attr, tb.edge_mask, tb.node_graph, tb.cluster0, tb.num_graphs)[0],
        x,
        cot,
    )
    np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(gg, wg, **FLOAT_TOL)
    (g, gg), (w, wg) = _vjp_both(
        lambda h: jpool.max_pool_x(jb.cluster1, h, jnp.asarray(node_graph_p.numpy()), jb.num_graphs)[0],
        lambda h: tpool.max_pool_x(tb.cluster1, h, node_graph_p, tb.num_graphs)[0],
        x,
        cot,
    )
    np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(gg, wg, **FLOAT_TOL)
    _, want_graph = jpool.max_pool_x(jb.cluster1, jnp.asarray(x), jnp.asarray(node_graph_p.numpy()), jb.num_graphs)
    _, got_graph = tpool.max_pool_x(tb.cluster1, torch.from_numpy(x), node_graph_p, tb.num_graphs)
    np.testing.assert_array_equal(got_graph.numpy(), np.asarray(want_graph))
    want_mean = jpool.graph_mean_pool(jnp.asarray(x), jb.node_graph, jb.num_graphs)
    np.testing.assert_allclose(tpool.graph_mean_pool(torch.from_numpy(x), tb.node_graph, tb.num_graphs).numpy(), np.asarray(want_mean), **FLOAT_TOL)


# (JAX model, port model, parameter family)
MODELS = {
    "ginet": (JaxGINet, GINet, None),
    "ginet_nocluster": (JaxGINetNoCluster, GINetNoCluster, None),
    "vanilla": (JaxVanillaNetwork, VanillaNetwork, "vanilla"),
}
CASES = [(m, k) for m in sorted(MODELS) for k in sorted(BATCHES)]


@contextlib.contextmanager
def _jax_pallas_route():
    """JAX's sorted segment sums through its Pallas kernel, interpreted: the
    backend at "pallas" and a TPU as the platform it sees."""
    previous = jseg._SEGMENT_BACKEND
    jseg.set_segment_backend("pallas")
    try:
        with mock.patch.object(jax, "default_backend", lambda: "tpu"), pltpu.force_tpu_interpret_mode():
            yield
    finally:
        jseg.set_segment_backend(previous)


def _setup(model, kind, seed=0):
    jcls, tcls, family = MODELS[model]
    fe = BATCHES[kind][2]
    jb, tb = _batches(kind)
    jmodel, tmodel = jcls(FEAT, 2, fe), tcls(FEAT, 2, fe, device="cpu")
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    tmodel.load_state_dict(params_from_jax(params, family=family))
    return jmodel, params, jb, tmodel, tb, family


def _assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("jax_route", ["xla", "pallas_interpret"])
@pytest.mark.parametrize(("model", "kind"), CASES)
def test_logits_loss_and_every_gradient_match_jax(model, kind, jax_route) -> None:
    jmodel, params, jb, tmodel, tb, family = _setup(model, kind)
    jb = jax.device_put(jb)  # jax arrays: numpy fields cannot be indexed by traced ids

    def jax_loss(p):
        return JaxCrossEntropyLoss()(jmodel.apply(p, jb), jb.y.astype(jnp.int32), jb.y_mask)

    # one jitted program each: eager JAX ops dispatched while the interpreted
    # kernel's host callbacks still run can deadlock
    with _jax_pallas_route() if jax_route == "pallas_interpret" else contextlib.nullcontext():
        want_logits = np.asarray(jax.jit(jmodel.apply)(params, jb))
        loss_want, grads_want = jax.block_until_ready(jax.jit(jax.value_and_grad(jax_loss))(params))
    ss.reset_launches()
    logits = tmodel(tb)
    loss = CrossEntropyLoss()(logits, tb.y, tb.y_mask)
    loss.backward()
    assert ss.launches == {"segment_sum_sorted_kernel": 0}  # the CPU takes the plain versions
    assert logits.shape == (tb.num_graphs, 2)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_want), **TOL)
    # the skipped attention's maps get no gradient in either package
    grads = params_to_jax({k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in tmodel.named_parameters()}, family=family)
    _assert_trees_close(grads, jax.tree.map(np.asarray, grads_want), **GRAD_TOL)
    missing = {k for k, p in tmodel.named_parameters() if p.grad is None}
    assert missing == ({f"{c}.{m}.weight" for c in ("conv1", "conv2", "conv1_ext", "conv2_ext") for m in ("fc_edge_attr", "fc_attention")} if family is None else set())


@pytest.mark.parametrize("model", sorted(MODELS))
def test_dropout_and_eight_adam_steps(model) -> None:
    *_, tmodel, tb, _ = _setup(model, "ppi")
    with torch.no_grad():
        eval_logits = tmodel(tb)
        dropped = tmodel(tb, training=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tmodel(tb, training=True).detach(), eval_logits)  # no generator: no dropout
    assert torch.equal(dropped, eval_logits) == (model == "vanilla")  # VanillaNetwork has no dropout
    opt = Adam(tmodel.parameters(), lr=1e-3, weight_decay=1e-5)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(8):
        opt.zero_grad(set_to_none=True)
        loss = CrossEntropyLoss()(tmodel(tb, training=True, generator=gen), tb.y, tb.y_mask)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_parameter_maps_round_trip_for_both_families() -> None:
    params = jax.tree.map(np.asarray, JaxGINet(FEAT, 2, 3).init(jax.random.PRNGKey(1)))
    state = params_from_jax(params)
    for cls in (GINet, GINetNoCluster, GINetDense):
        model = cls(FEAT, 2, 3, device="cpu")
        assert state.keys() == model.state_dict().keys(), cls
        model.load_state_dict(state)
        _assert_trees_close(params_to_jax(model.state_dict()), params, rtol=0, atol=0)
    # one torch generator seed gives every GINet of the port the same weights
    a, b = GINet(FEAT, 2, 3, device="cpu").state_dict(), GINetDense(FEAT, 2, 3, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)

    vparams = jax.tree.map(np.asarray, JaxVanillaNetwork(FEAT, 2, 3).init(jax.random.PRNGKey(2)))
    vstate = params_from_jax(vparams, family="vanilla")
    for cls in (VanillaNetwork, VanillaNetworkBlocked):
        model = cls(FEAT, 2, 3, device="cpu")
        assert vstate.keys() == model.state_dict().keys(), cls
        model.load_state_dict(vstate)
        _assert_trees_close(params_to_jax(model.state_dict(), family="vanilla"), vparams, rtol=0, atol=0)


def test_clustered_towers_feed_sorted_rows_to_both_convs() -> None:
    """The clustered GINet's conv2 sums over the pooled edges: their rows must
    come out ascending with the padding last, or the sorted kernel would drop
    edges. Checked on every batch kind, with the rows each conv receives."""
    seen = []
    real = tpool.community_pool

    def spy(*args):
        out = real(*args)
        seen.append((out[2][0].clone(), args[0].shape[0]))  # pooled rows, capacity
        return out

    for kind in sorted(BATCHES):
        *_, tmodel, tb, _ = _setup("ginet", kind)
        with mock.patch("deeprank2_tpu_torch.neuralnets.gnn.ginet.community_pool", spy):
            tmodel(tb)
        _assert_ascending_with_padding_last(tb.edge_index[0], tb.num_nodes)
    assert len(seen) == 2 * len(BATCHES)  # one per tower
    for rows, capacity in seen:
        _assert_ascending_with_padding_last(rows, capacity)
        assert bool((rows < capacity).any())
