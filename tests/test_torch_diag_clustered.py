"""The port's clustered GINet slice (deeprank2_tpu_torch: ppi_clustered_entries,
collate_graphs_diag_clustered, GINetClusteredDiag) against the JAX package's
on the CPU: the generator and the collate array for array, exactly; the model
with one JAX initialization loaded into both, logits, loss, every gradient
and two Adam steps at rtol 1e-4 / atol 1e-5."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprank2_tpu.neuralnets.gnn.ginet_dense import GINetClusteredDiag as JaxGINetClusteredDiag
from deeprank2_tpu.ops import batch as jbatch
from deeprank2_tpu.ops.losses import CrossEntropyLoss as JaxCrossEntropyLoss
from deeprank2_tpu.ops.optim import Adam as JaxAdam
from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetClusteredDiag, GINetDense
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax, params_to_jax
from deeprank2_tpu_torch.ops import batch as tbatch
from deeprank2_tpu_torch.ops import diag_spmm as ds
from deeprank2_tpu_torch.ops import slotpool as sp
from deeprank2_tpu_torch.ops.block_sparse import locality_order
from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
from deeprank2_tpu_torch.ops.optim import Adam
from deeprank2_tpu_torch.ops.synthetic import ppi_clustered_entries
from tests.perf.diag_clustered_perf import ppi_clustered_entries as jax_ppi_clustered_entries

FEAT = 38
TOL = {"rtol": 1e-4, "atol": 1e-5}
# (nodes, cell, min_slot_nodes): the layout each case collates
LAYOUTS = {
    "pure": (40, 10.0, 1),
    "auto_pure": (160, 10.0, None),
    "mixed": (40, 6.0, 5),
    "auto_mixed": (40, 6.0, None),
}


def _entries(nodes, cell, num_graphs=6, seed=1):
    entries = ppi_clustered_entries(num_graphs, nodes, FEAT, cell=cell, seed=seed)
    entries[-1]["y"] = None  # a graph without a target
    return entries


@pytest.mark.parametrize("cell", [10.0, 6.0])
def test_ppi_clustered_entries_match_jax(cell) -> None:
    ours = ppi_clustered_entries(4, 40, 7, cell=cell, seed=3)
    theirs = jax_ppi_clustered_entries(4, 40, 7, cell=cell, seed=3)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            got, want = np.asarray(a[key]), np.asarray(b[key])
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_locality_order_matches_jax() -> None:
    from deeprank2_tpu.ops.block_sparse import locality_order as jax_locality_order

    pos = np.random.default_rng(0).uniform(-30, 30, (500, 3)).astype(np.float32)
    pos[7] = pos[3]  # a duplicate point
    for cell in (8.0, 3.5):
        np.testing.assert_array_equal(locality_order(pos, cell), jax_locality_order(pos, cell))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("pad_graphs", [None, 8])
def test_collate_matches_jax_field_for_field(layout, pad_graphs) -> None:
    nodes, cell, msn = LAYOUTS[layout]
    entries = _entries(nodes, cell)
    want, want_names = jbatch.collate_graphs_diag_clustered(entries, pad_graphs=pad_graphs, min_slot_nodes=msn)
    got, names = tbatch.collate_graphs_diag_clustered(entries, pad_graphs=pad_graphs, min_slot_nodes=msn, device="cpu")
    assert names == want_names
    assert bool(got.region_caps) == ("mixed" in layout)
    assert (got.num_graphs, got.region_caps, got.nodes_per_graph) == (want.num_graphs, want.region_caps, want.nodes_per_graph)
    for field in got.__dataclass_fields__:
        if field in tbatch.DiagClusteredBatch._STATIC:
            continue
        ours, theirs = getattr(got, field), np.asarray(getattr(want, field))
        assert ours.device == torch.device("cpu") and ours.is_contiguous(), field
        if ours.dtype == torch.bfloat16:  # the weighted adjacencies' bf16 storage, bit for bit
            ours, theirs = ours.view(torch.int16), theirs.view(np.int16)
        assert ours.numpy().dtype == theirs.dtype, field
        np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=field)
    # the edge-weighted fields are empty in an unweighted batch, in both packages
    for field in ("adj_w", "adj_wp", "wsum", "wsum_p"):
        assert np.asarray(getattr(want, field)).size == getattr(got, field).numel() == 0
    moved = got.to("cpu")
    assert moved.region_caps == got.region_caps and torch.equal(moved.members1, got.members1)


@pytest.mark.parametrize("layout", ["pure", "mixed"])
def test_requirements_match_jax(layout) -> None:
    nodes, cell, _ = LAYOUTS[layout]
    entries = _entries(nodes, cell)
    assert tbatch.diag_clustered_requirements(entries) == jbatch.diag_clustered_requirements(entries)
    assert tbatch.diag_mixed_requirements(entries, 5) == jbatch.diag_mixed_requirements(entries, 5)
    assert tbatch._auto_min_slot_nodes(entries) == jbatch._auto_min_slot_nodes(entries)


def test_collate_with_bucketed_caps_matches_jax() -> None:
    entries = _entries(40, 6.0)
    caps = {"pad_c1": lambda c: c + 5, "pad_members1": 9, "pad_members0s": 3, "pad_clusters": 56}
    for msn, extra in ((1, {"pad_nodes": 200}), (5, {"pad_region_caps": {"big": 24, "s4": lambda c: 2 * c, "kbig": 16}})):
        want, _ = jbatch.collate_graphs_diag_clustered(entries, pad_graphs=7, min_slot_nodes=msn, **caps, **extra)
        got, _ = tbatch.collate_graphs_diag_clustered(entries, pad_graphs=7, min_slot_nodes=msn, device="cpu", **caps, **extra)
        assert got.region_caps == want.region_caps
        for field in ("x_t", "adj_i8", "adj_p_i8", "members0s", "members1", "cluster1", "c1_graph", "slot_cluster"):
            np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)


def test_collate_rejects_what_is_not_ported_or_does_not_fit() -> None:
    entries = _entries(40, 10.0, num_graphs=3)
    # the weighted collate takes the storage types of the kernels only
    with pytest.raises(ValueError, match="weight_dtype"):
        tbatch.collate_graphs_diag_clustered(entries, with_edge_weights=True, weight_dtype=torch.float16, device="cpu")
    with pytest.raises(ValueError, match="exceed pad_graphs"):
        tbatch.collate_graphs_diag_clustered(entries, pad_graphs=2, device="cpu")
    entries[0]["cluster1"] = entries[0]["cluster1"][:-1]
    for msn in (1, 5):
        with pytest.raises(ValueError, match="cluster1 has"):
            tbatch.collate_graphs_diag_clustered(entries, min_slot_nodes=msn, device="cpu")


def _setup(layout):
    nodes, cell, msn = LAYOUTS[layout]
    entries = _entries(nodes, cell)
    jb, _ = jbatch.collate_graphs_diag_clustered(entries, pad_graphs=8, min_slot_nodes=msn)
    tb, _ = tbatch.collate_graphs_diag_clustered(entries, pad_graphs=8, min_slot_nodes=msn, device="cpu")
    jmodel = JaxGINetClusteredDiag(FEAT, 2, 1)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    model = GINetClusteredDiag(FEAT, 2, 1, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return jmodel, params, jb, model, tb


def _jax_loss(jmodel, jb):
    def compute(p):
        return JaxCrossEntropyLoss()(jmodel.apply(p, jb, training=False), jb.y.astype(jnp.int32), jb.y_mask)

    return compute


def _assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("layout", ["pure", "auto_pure", "mixed"])
def test_logits_loss_and_every_gradient_match_jax(layout) -> None:
    jmodel, params, jb, model, tb = _setup(layout)
    want_logits = np.asarray(jmodel.apply(params, jb))
    loss_want, grads_want = jax.value_and_grad(_jax_loss(jmodel, jb))(params)
    ds.reset_launches()
    sp.reset_launches()
    logits = model(tb)
    loss = CrossEntropyLoss()(logits, tb.y, tb.y_mask)
    loss.backward()
    # on the CPU every wrapper takes its plain version
    assert set(ds.launches.values()) == {0} and set(sp.launches.values()) == {0}
    assert logits.shape == (8, 2)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_want), **TOL)
    grads = params_to_jax({k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in model.named_parameters()})
    _assert_trees_close(grads, jax.tree.map(np.asarray, grads_want), **TOL)
    # the conv layers and the head all receive a gradient
    for name in ("conv1", "conv1_ext", "conv2", "conv2_ext"):
        assert np.abs(grads[name]["fc"]["w"]).max() > 0, name
    for name in ("fc1", "fc2"):
        assert np.abs(grads[name]["w"]).max() > 0, name


@pytest.mark.parametrize("layout", ["pure", "mixed"])
def test_two_adam_steps_match_jax(layout) -> None:
    jmodel, params, jb, model, tb = _setup(layout)
    jopt = JaxAdam(lr=1e-3, weight_decay=1e-5)
    state = jopt.init(params)
    jparams = params
    for _ in range(2):
        grads = jax.grad(_jax_loss(jmodel, jb))(jparams)
        jparams, state = jopt.step(jparams, grads, state)
    opt = Adam(model.parameters(), lr=1e-3, weight_decay=1e-5)
    for _ in range(2):
        opt.zero_grad()
        CrossEntropyLoss()(model(tb), tb.y, tb.y_mask).backward()
        opt.step()
    _assert_trees_close(params_to_jax(model.state_dict()), jax.tree.map(np.asarray, jparams), **TOL)


def test_model_shares_the_ginet_parameter_set() -> None:
    params = jax.tree.map(np.asarray, JaxGINetClusteredDiag(FEAT, 2, 1).init(jax.random.PRNGKey(1)))
    state = GINetClusteredDiag(FEAT, 2, 1, device="cpu").state_dict()
    assert params_from_jax(params).keys() == state.keys() == GINetDense(FEAT, 2, 1, device="cpu").state_dict().keys()
    for key, value in params_from_jax(params).items():
        assert value.shape == state[key].shape, key


def test_dropout_and_unported_options() -> None:
    _, _, _, model, tb = _setup("pure")
    with torch.no_grad():
        eval_out = model(tb)
        assert torch.equal(model(tb, training=True), eval_out)
        assert not torch.equal(model(tb, training=True, generator=torch.Generator().manual_seed(0)), eval_out)
    # compute_dtype takes None or bfloat16 (the bf16 forms; tests/test_torch_bf16_models.py)
    assert GINetClusteredDiag(FEAT, 2, 1, device="cpu", compute_dtype=torch.bfloat16).compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="GINetClusteredDiag"):
        GINetClusteredDiag(FEAT, 2, 1, device="cpu", compute_dtype=torch.float16)
