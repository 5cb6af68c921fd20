"""The port's GINetDense train step (deeprank2_tpu_torch) against the JAX
package's on the CPU: one JAX initialization loads into both, and logits,
loss, every gradient and two Adam steps are compared."""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprank2_tpu.neuralnets.gnn.ginet_dense import GINetDense as JaxGINetDense
from deeprank2_tpu.ops.batch import collate_graphs_dense as jax_collate
from deeprank2_tpu.ops.losses import CrossEntropyLoss as JaxCrossEntropyLoss
from deeprank2_tpu.ops.optim import Adam as JaxAdam
from deeprank2_tpu_torch.neuralnets import nn as tnn
from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax, params_to_jax
from deeprank2_tpu_torch.ops.batch import collate_graphs_dense
from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
from deeprank2_tpu_torch.ops.optim import Adam
from deeprank2_tpu_torch.ops.synthetic import synthetic_entries

FEAT, EDGE = 38, 6


def _setup(num_graphs=5, nodes=24, pad_graphs=6, pad_nodes=32, seed=5):
    entries = synthetic_entries(num_graphs, nodes, FEAT, EDGE, seed=seed)
    entries[-1]["x"] = entries[-1]["x"][: nodes - 5]  # a smaller graph: padded nodes inside a real graph
    entries[-1]["pos"] = entries[-1]["pos"][: nodes - 5]
    entries[-1]["edge_index"] = entries[-1]["edge_index"][(entries[-1]["edge_index"] < nodes - 5).all(axis=1)]
    jbatch, _ = jax_collate(entries, pad_graphs=pad_graphs, pad_nodes=pad_nodes)
    tbatch, _ = collate_graphs_dense(entries, pad_graphs=pad_graphs, pad_nodes=pad_nodes, device="cpu")
    jmodel = JaxGINetDense(FEAT, 2, EDGE)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    model = GINetDense(FEAT, 2, EDGE, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return jmodel, params, jbatch, model, tbatch


def _jax_loss(jmodel, jbatch, flat=False):
    def compute(p):
        pred = jmodel._apply_flat(p, jbatch, False, None) if flat else jmodel.apply(p, jbatch, training=False)
        return JaxCrossEntropyLoss()(pred, jbatch.y.astype(jnp.int32), jbatch.y_mask)

    return compute


def _torch_loss(model, tbatch):
    pred = model(tbatch, training=False)
    return CrossEntropyLoss()(pred, tbatch.y, tbatch.y_mask)


def _grads(model):
    return params_to_jax({k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in model.named_parameters()})


def _assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("jax_path", ["apply", "_apply_flat"])
def test_logits_match_jax(jax_path) -> None:
    jmodel, params, jbatch, model, tbatch = _setup()
    want = jmodel.apply(params, jbatch) if jax_path == "apply" else jmodel._apply_flat(params, jbatch, False, None)
    with torch.no_grad():
        got = model(tbatch).numpy()
    assert got.shape == (6, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_loss_and_every_gradient_match_jax() -> None:
    jmodel, params, jbatch, model, tbatch = _setup()
    loss_want, grads_want = jax.value_and_grad(_jax_loss(jmodel, jbatch))(params)
    loss = _torch_loss(model, tbatch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_want), rtol=1e-5, atol=1e-5)
    _assert_trees_close(_grads(model), jax.tree.map(np.asarray, grads_want), rtol=1e-5, atol=1e-5)


def test_two_adam_steps_match_jax() -> None:
    jmodel, params, jbatch, model, tbatch = _setup()
    jopt = JaxAdam(lr=1e-3, weight_decay=1e-5)
    state = jopt.init(params)
    jparams = params
    for _ in range(2):
        grads = jax.grad(_jax_loss(jmodel, jbatch, flat=True))(jparams)
        jparams, state = jopt.step(jparams, grads, state)
    opt = Adam(model.parameters(), lr=1e-3, weight_decay=1e-5)
    for _ in range(2):
        opt.zero_grad()
        _torch_loss(model, tbatch).backward()
        opt.step()
    got = params_to_jax(model.state_dict())
    _assert_trees_close(got, jax.tree.map(np.asarray, jparams), rtol=1e-4, atol=1e-6)
    # the parameters outside the forward decay as in JAX (torch.optim.Adam would skip them)
    for conv in ("conv1", "conv2", "conv1_ext", "conv2_ext"):
        for unused in ("fc_edge_attr", "fc_attention"):
            assert not np.array_equal(got[conv][unused]["w"], params[conv][unused]["w"])


def test_param_interop_round_trips_exactly() -> None:
    params = jax.tree.map(np.asarray, JaxGINetDense(FEAT, 2, EDGE).init(jax.random.PRNGKey(3)))
    back = params_to_jax(params_from_jax(params))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    state = GINetDense(FEAT, 2, EDGE, device="cpu").state_dict()
    assert params_from_jax(params).keys() == state.keys()
    for key, value in params_from_jax(params_to_jax(state)).items():
        assert torch.equal(value, state[key])


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_with_mask_and_class_weights_matches_jax(weighted) -> None:
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(9, 3)).astype(np.float32)
    target = rng.integers(0, 3, size=9)
    mask = rng.random(9) < 0.7
    weight = np.array([0.2, 1.0, 3.0], np.float32) if weighted else None
    want = JaxCrossEntropyLoss(weight)(jnp.asarray(logits), jnp.asarray(target), jnp.asarray(mask))
    got = CrossEntropyLoss(None if weight is None else torch.from_numpy(weight))(torch.from_numpy(logits), torch.from_numpy(target), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_init_has_the_jax_shapes_and_bounds() -> None:
    params = JaxGINetDense(FEAT, 2, EDGE).init(jax.random.PRNGKey(0))
    state = GINetDense(FEAT, 2, EDGE, device="cpu", generator=torch.Generator().manual_seed(1)).state_dict()
    ours = params_to_jax(state)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
    # conv layers draw from +-1/sqrt(in_channels), fc layers from +-1/sqrt(in_dim)
    assert np.abs(ours["conv1"]["fc_attention"]["w"]).max() <= 1 / np.sqrt(FEAT)
    assert np.abs(ours["fc1"]["w"]).max() <= 1 / np.sqrt(64)


def test_dropout() -> None:
    x = torch.ones(64, 128)
    assert tnn.dropout(x, 0.4, True, None) is x
    assert tnn.dropout(x, 0.4, False, torch.Generator().manual_seed(0)) is x
    out = tnn.dropout(x, 0.4, True, torch.Generator().manual_seed(0))
    kept = out != 0
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.6))
    assert 0.5 < kept.float().mean().item() < 0.7
    again = tnn.dropout(x, 0.4, True, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


def test_training_forward_uses_dropout_only_with_a_generator() -> None:
    _, _, _, model, tbatch = _setup()
    with torch.no_grad():
        eval_out = model(tbatch)
        assert torch.equal(model(tbatch, training=True), eval_out)
        dropped = model(tbatch, training=True, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(dropped, eval_out)


def test_bfloat16_is_not_ported() -> None:
    """bf16 runs on both tower backends: the flat route
    (tests/test_torch_bf16_models.py) and, since the fused batched tower (K8)
    has its bf16 form, the "pallas" backend (tests/test_torch_bf16_towers.py),
    which hands the tower the f32 weights and features and gives f32 logits
    that round where the f32 form does not; float16 has no form at all."""
    from deeprank2_tpu_torch.neuralnets.gnn import ginet_dense
    from deeprank2_tpu_torch.ops import ginet_tower

    model = GINetDense(FEAT, 2, EDGE, device="cpu", compute_dtype=torch.bfloat16)
    batch, _ = collate_graphs_dense(synthetic_entries(4, 24, FEAT, EDGE, seed=1), device="cpu")
    assert model(batch).dtype == torch.float32
    f32_model = GINetDense(FEAT, 2, EDGE, device="cpu")
    ginet_dense.set_dense_tower_backend("pallas")
    try:
        with mock.patch.object(ginet_tower, "ginet_tower_pooled", wraps=ginet_tower.ginet_tower_pooled) as spy, torch.no_grad():
            fused, fused_f32 = model(batch), f32_model(batch)
        assert [c.args[-1] for c in spy.call_args_list] == [torch.bfloat16, None]
    finally:
        ginet_dense.set_dense_tower_backend("xla")
    assert fused.dtype == torch.float32
    assert not torch.equal(fused, fused_f32)
    torch.testing.assert_close(fused, fused_f32, rtol=0, atol=2e-2 * max(1.0, fused_f32.abs().max().item()))
    with pytest.raises(ValueError, match="compute_dtype"):
        GINetDense(FEAT, 2, EDGE, device="cpu", compute_dtype=torch.float16)
