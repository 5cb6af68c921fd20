"""The port's AlignmentGNN (deeprank2_tpu_torch/neuralnets/gnn/alignmentnet.py)
against the JAX package's on the CPU: from the JAX initialization carried
across by ``params_from_jax(..., "alignment")``, the per-node outputs, the
attention and every parameter's gradient agree at rtol 1e-5, atol 1e-6 (the
JAX test's tolerance, tests/test_alignmentnet.py), on edges inside the graph
and on edges whose ids reach past the last node (gathers clip them, the
message sum drops them). The ``"alignment"`` family maps the JAX tree (lists
and batch norms) to the port's state_dict and back bit for bit.

Every input comes from a seeded numpy generator.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprank2_tpu.neuralnets.gnn import alignmentnet as jax_alignmentnet
from deeprank2_tpu_torch.neuralnets.gnn import alignmentnet
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax, params_to_jax

TOL = {"rtol": 1e-5, "atol": 1e-6}
ARGS = {
    "nmb_edge_attr": 3,
    "nmb_node_attr": 7,
    "nmb_output_features": 4,
    "nmb_hidden_attr": 16,
    "message_vector_length": 8,
    "nmb_mlp_neurons": 16,
    "nmb_gnn_layers": 3,
    "nmb_edge_projection": 8,
}


def _pair(seed: int = 0):
    jm = jax_alignmentnet.AlignmentGNN(**ARGS)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    pm = alignmentnet.AlignmentGNN(**ARGS, device="cpu")
    pm.load_state_dict(params_from_jax(params, "alignment"))
    return jm, params, pm


def _graph(seed: int, num_nodes: int = 20, num_edges: int = 60, beyond: int = 0):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, num_nodes, size=(2, num_edges))
    if beyond:  # ids at and past V, in both rows
        edges[:, :beyond] = rng.integers(num_nodes, num_nodes + 5, size=(2, beyond))
    edge_attr = rng.normal(size=(num_edges, 3)).astype(np.float32)
    node_attr = rng.normal(size=(num_nodes, 7)).astype(np.float32)
    return edges, edge_attr, node_attr


@pytest.mark.parametrize("beyond", [0, 6], ids=["in_range", "ids_beyond_v"])
def test_alignment_gnn_matches_jax(beyond) -> None:
    jm, params, pm = _pair(seed=1)
    edges, edge_attr, node_attr = _graph(2, beyond=beyond)
    rng = np.random.default_rng(3)
    g_out = rng.normal(size=(20, 4)).astype(np.float32)
    g_att = rng.normal(size=(20, 1)).astype(np.float32)

    def objective(p):
        out, att = jm.forward(p, jnp.asarray(edges), jnp.asarray(edge_attr), jnp.asarray(node_attr))
        return (out * g_out).sum() + (att * g_att).sum(), (out, att)

    (_, (out, att)), grads = jax.value_and_grad(objective, has_aux=True)(jax.tree.map(jnp.asarray, params))

    got_out, got_att = pm(torch.from_numpy(edges), torch.from_numpy(edge_attr), torch.from_numpy(node_attr))
    ((got_out * torch.from_numpy(g_out)).sum() + (got_att * torch.from_numpy(g_att)).sum()).backward()
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(got_att.detach().numpy(), np.asarray(att), **TOL)
    assert got_out.shape == (20, 4) and got_att.shape == (20, 1)
    want = params_from_jax(jax.tree.map(np.asarray, grads), "alignment")
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert got.keys() == want.keys() and len(got) == 60
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), **TOL, err_msg=key)


def test_alignment_family_round_trips_bit_for_bit() -> None:
    _, params, pm = _pair(seed=4)
    assert "preproc_edge_bn0.weight" in pm.state_dict() and "layers.2.attention_mlp.1.bias" in pm.state_dict()
    assert "attention_mlp.0.weight" not in {k.split(".", 2)[-1] for k in pm.state_dict() if k.startswith("layers.0.")}
    back = params_to_jax(pm.state_dict(), "alignment")
    got, want = jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves_with_path(params)
    assert len(got) == len(want) == 60
    for (pa, a), (pb, b) in zip(got, want):
        assert pa == pb and a.dtype == b.dtype and np.array_equal(a, b), pa


def test_batch_norm_uses_batch_statistics() -> None:
    """The norm of a batch is the same in training and evaluation (no running
    statistics): the JAX ``_batchnorm``."""
    _, _, pm = _pair(seed=5)
    edges, edge_attr, node_attr = _graph(6)
    args = (torch.from_numpy(edges), torch.from_numpy(edge_attr), torch.from_numpy(node_attr))
    with torch.no_grad():
        out_train = pm.train()(*args)[0]
        out_eval = pm.eval()(*args)[0]
    assert torch.equal(out_train, out_eval)
    assert not any(name.endswith(("running_mean", "running_var")) for name, _ in pm.named_buffers())


def test_alignment_sums_bound_every_gradient() -> None:
    """tools/f64_gate.py:alignment_sums: its walk computes the model's
    outputs, and each parameter gradient's sum of |terms| bounds its
    float64 value, the bias before a batch norm's too (0 in exact
    arithmetic, its f32 value rounding alone: the batch norm's three terms
    give it a scale)."""
    from deeprank2_tpu_torch.tools import f64_gate as fg

    _, _, pm = _pair(seed=7)
    m64 = pm.double()
    edges, edge_attr, node_attr = _graph(8, beyond=4)
    rng = np.random.default_rng(9)
    g_out = torch.from_numpy(rng.normal(size=(20, 4)))
    g_att = torch.from_numpy(rng.normal(size=(20, 1)))
    args = (torch.from_numpy(edges), torch.from_numpy(edge_attr).double(), torch.from_numpy(node_attr).double())
    sums = fg.alignment_sums(m64, *args, g_out, g_att)
    out, att = m64(*args)
    ((out * g_out).sum() + (att * g_att).sum()).backward()
    assert sums.keys() == dict(m64.named_parameters()).keys()
    for name, p in m64.named_parameters():
        assert bool((sums[name] >= p.grad.abs() * (1 - 1e-12)).all()), name
    pre_norm = m64.preproc_node_mlp[0].bias.grad
    assert pre_norm.abs().max() < 1e-12 < sums["preproc_node_mlp.0.bias"].min()
