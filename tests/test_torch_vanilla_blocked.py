"""The port's blocked-edge VanillaNetwork slice (deeprank2_tpu_torch:
collate_graphs_blocked, VanillaNetworkBlocked, the VanillaNetwork parameter
map) against the JAX package's on the CPU: the collate field for field,
exactly; the model with one JAX initialization loaded into both, logits and
loss at rtol 1e-4 / atol 1e-5 and every gradient at rtol 1e-4 / atol 1e-6
(f32 on both sides); eight Adam steps lower the loss."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprank2_tpu.neuralnets.gnn.vanilla_gnn import VanillaNetworkBlocked as JaxVanillaNetworkBlocked
from deeprank2_tpu.neuralnets.torch_interop import _vanilla as reference_vanilla_keys
from deeprank2_tpu.ops import batch as jbatch
from deeprank2_tpu.ops.losses import CrossEntropyLoss as JaxCrossEntropyLoss
from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetwork, VanillaNetworkBlocked
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax, params_to_jax
from deeprank2_tpu_torch.ops import batch as tbatch
from deeprank2_tpu_torch.ops import vanilla as tv
from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
from deeprank2_tpu_torch.ops.optim import Adam
from deeprank2_tpu_torch.ops.synthetic import geometric_entry

FEAT, FE = 10, 6
TOL = {"rtol": 1e-4, "atol": 1e-5}
GRAD_TOL = {"rtol": 1e-4, "atol": 1e-6}
STRUCTURE_FIELDS = ("row_local", "col_local", "eattr_t", "step_row", "sub_col", "out_visited")


def _entries(num_graphs=3, nodes=90, feat=FEAT, fe=FE, seed=5):
    """Spatial graphs of growing size (the JAX blocked-edge tests' entries)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    out = []
    for g in range(num_graphs):
        v = nodes + g * 7
        pos = rng.uniform(0, 30, size=(v, 3)).astype(np.float32)
        pairs = cKDTree(pos).query_pairs(6.0, output_type="ndarray").astype(np.int64)
        out.append(
            {
                "x": rng.normal(size=(v, feat)).astype(np.float32),
                "edge_index": pairs,
                "edge_attr": rng.normal(size=(len(pairs), fe)).astype(np.float32),
                "pos": pos,
                "y": float(g % 2),
                "entry_name": f"g{g}",
            }
        )
    return out


# the JAX tests' three small graphs; a batch with a graph of several tiles
# and a graph without a target
BATCHES = {
    "small": lambda: _entries(),
    "tiles": lambda: [geometric_entry(700, FEAT, FE, seed=1), {**geometric_entry(300, FEAT, FE, seed=2), "y": 0.0}, {**geometric_entry(90, FEAT, FE, seed=3), "y": None}],
}


def _assert_batch_equal(got, want):
    for field in got.__dataclass_fields__:
        ours, theirs = getattr(got, field), getattr(want, field)
        if field == "structure":
            for name in STRUCTURE_FIELDS:
                a, b = getattr(ours, name), np.asarray(getattr(theirs, name))
                assert a.numpy().dtype == b.dtype, name
                np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
            assert (ours.num_node_tiles, ours.edge_dim) == (theirs.num_node_tiles, theirs.edge_dim)
        elif field == "num_graphs":
            assert ours == theirs
        else:
            theirs = np.asarray(theirs)
            assert ours.device == torch.device("cpu") and ours.is_contiguous(), field
            assert ours.numpy().dtype == theirs.dtype, field
            np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=field)


# (pad_graphs, extra tiles, extra slabs) above the requirement, as ints or as
# required -> capacity callables
PADS = {"none": None, "ints": (5, 2, 3), "callables": (4, lambda t: t + 2, lambda s: 2 * s)}


@pytest.mark.parametrize("pads", sorted(PADS))
@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_collate_blocked_matches_jax_field_for_field(kind, pads) -> None:
    entries = BATCHES[kind]()
    kw = {}
    if PADS[pads] is not None:
        pad_graphs, pad_tiles, pad_slabs = PADS[pads]
        tiles, slabs = jbatch.blocked_requirements(entries)
        if pads == "ints":
            pad_tiles, pad_slabs = tiles + pad_tiles, slabs + pad_slabs
        kw = {"pad_graphs": pad_graphs, "pad_tiles": pad_tiles, "pad_slabs": pad_slabs}
    want, want_names = jbatch.collate_graphs_blocked(entries, **kw)
    got, names = tbatch.collate_graphs_blocked(entries, **kw, device="cpu")
    assert names == want_names
    _assert_batch_equal(got, want)
    if kw:
        assert got.num_graphs > len(entries) and got.structure.num_node_tiles > tiles and got.structure.num_slabs > slabs
    moved = got.to("cpu")
    assert moved.num_graphs == got.num_graphs and torch.equal(moved.structure.eattr_t, got.structure.eattr_t)


def test_collate_rejects_what_does_not_fit() -> None:
    entries = _entries()
    with pytest.raises(ValueError, match="pad_tiles"):
        tbatch.collate_graphs_blocked(entries, pad_tiles=1, device="cpu")
    with pytest.raises(ValueError, match="pad_slabs"):
        tbatch.collate_graphs_blocked(entries, pad_slabs=1, device="cpu")
    with pytest.raises(ValueError, match="exceed pad_graphs"):
        tbatch.collate_graphs_blocked(entries, pad_graphs=2, device="cpu")


def _setup(kind, pad_graphs=4):
    """The JAX model, its parameters and batch; the port's model with those
    parameters loaded, and its batch."""
    entries = BATCHES[kind]()
    jb, _ = jbatch.collate_graphs_blocked(entries, pad_graphs=pad_graphs)
    tb, _ = tbatch.collate_graphs_blocked(entries, pad_graphs=pad_graphs, device="cpu")
    jmodel, model = JaxVanillaNetworkBlocked(FEAT, 2, FE), VanillaNetworkBlocked(FEAT, 2, FE, device="cpu")
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    model.load_state_dict(params_from_jax(params, family="vanilla"))
    return jmodel, params, jb, model, tb


def _assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_logits_loss_and_every_gradient_match_jax(kind) -> None:
    jmodel, params, jb, model, tb = _setup(kind)

    def jax_loss(p):
        return JaxCrossEntropyLoss()(jmodel.apply(p, jb), jb.y.astype(jnp.int32), jb.y_mask)

    want_logits = np.asarray(jmodel.apply(params, jb))
    loss_want, grads_want = jax.value_and_grad(jax_loss)(params)
    tv.reset_launches()
    logits = model(tb)
    loss = CrossEntropyLoss()(logits, tb.y, tb.y_mask)
    loss.backward()
    assert tv.launches == {"blocked_fwd_kernel": 0, "blocked_bwd_kernel": 0}  # the CPU takes the plain versions
    assert logits.shape == (4, 2)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_want), **TOL)
    grads = params_to_jax({k: p.grad for k, p in model.named_parameters()}, family="vanilla")
    _assert_trees_close(grads, jax.tree.map(np.asarray, grads_want), **GRAD_TOL)
    for layer in ("external1", "external2"):
        assert np.abs(grads[layer]["edge_mlp"]["w"][2 * FEAT :]).max() > 0, layer  # w_e has a gradient


def test_eight_adam_steps_lower_the_loss() -> None:
    entries = _entries(num_graphs=4)
    batch, names = tbatch.collate_graphs_blocked(entries, pad_graphs=6, device="cpu")
    assert names[:4] == ["g0", "g1", "g2", "g3"] and int(batch.y_mask.sum()) == 4
    model = VanillaNetworkBlocked(FEAT, 2, FE, device="cpu")
    opt = Adam(model.parameters(), lr=1e-3)
    loss_fn = CrossEntropyLoss()
    losses = []
    for _ in range(8):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model(batch, training=True), batch.y, batch.y_mask)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]


def test_parameter_map_round_trips_and_uses_the_reference_keys() -> None:
    params = jax.tree.map(np.asarray, JaxVanillaNetworkBlocked(FEAT, 2, FE).init(jax.random.PRNGKey(1)))
    state = params_from_jax(params, family="vanilla")
    model = VanillaNetworkBlocked(FEAT, 2, FE, device="cpu")
    assert state.keys() == model.state_dict().keys() == VanillaNetwork(FEAT, 2, FE, device="cpu").state_dict().keys()
    model.load_state_dict(state)
    _assert_trees_close(params_to_jax(model.state_dict(), family="vanilla"), params, rtol=0, atol=0)
    # the keys the JAX package reads from a reference VanillaNetwork state_dict
    _assert_trees_close(reference_vanilla_keys({k: v.numpy() for k, v in model.state_dict().items()}), params, rtol=0, atol=0)
    assert "_external1._edge_mlp.0.weight" in state and "_graph_mlp.2.bias" in state
    with pytest.raises(ValueError, match="family"):
        params_from_jax(params, family="no_such_family")


def test_training_flag_and_unported_parts() -> None:
    *_, model, tb = _setup("small")
    with torch.no_grad():
        assert torch.equal(model(tb, training=True, generator=torch.Generator().manual_seed(0)), model(tb))
    # compute_dtype takes None or bfloat16 (the bf16 forms; tests/test_torch_bf16_models.py)
    assert VanillaNetworkBlocked(FEAT, 2, FE, compute_dtype=torch.bfloat16, device="cpu").compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        VanillaNetworkBlocked(FEAT, 2, FE, compute_dtype=torch.float16, device="cpu")
    # the COO VanillaNetwork, with the same parameters, on the COO collate of
    # the same entries: the same function
    coo = VanillaNetwork(FEAT, 2, FE, device="cpu")
    coo.load_state_dict(model.state_dict())
    coo_batch, _ = tbatch.collate_graphs(BATCHES["small"](), pad_graphs=4, device="cpu")
    with torch.no_grad():
        torch.testing.assert_close(coo(coo_batch), model(tb), rtol=1e-4, atol=1e-5)
