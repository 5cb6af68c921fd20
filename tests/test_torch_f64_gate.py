"""The float64 gate of the tower's weight gradients
(deeprank2_tpu_torch/tools/f64_gate.py), on the CPU at 8 graphs of 40
nodes.

- Its float64 function is the JAX package's tower (``_tower_ref``, autodiff
  for the weight gradients) at the JAX tests' tolerances, and the port's
  plain version; its sums of |products| bound every term.
- The plain route (ascending einsum sums) and a route that sums in another
  order (each graph's nodes reversed) pass it; an error of 4x the bound at
  one entry fails.
- A relu flip inside the band is admitted and counted, and the route is
  held against the float64 function with its relu decisions; a flip outside
  the band fails.
- GINetDense's head cotangent and the map of the fused gradients to the
  conv weights are the model's own (autograd through ``GINetDense``).

Every input comes from a seeded numpy generator.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprank2_tpu.ops import diag_spmm as jd
from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
from deeprank2_tpu_torch.ops import diag_spmm as td
from deeprank2_tpu_torch.ops.batch import collate_graphs_dense
from deeprank2_tpu_torch.ops.synthetic import synthetic_entries
from deeprank2_tpu_torch.tools import f64_gate as fg

G, N = 8, 40


def _operands(seed=0):
    """The bench layout cut to 8 graphs of 40 nodes: a collated dense batch,
    GINetDense(38, 2, 6)'s fused weights and a cotangent of the pooled sums."""
    batch, _ = collate_graphs_dense(synthetic_entries(G, N - 6, 38, 6, seed=seed), pad_graphs=G, pad_nodes=N, device="cpu")
    model = GINetDense(38, 2, 6, device="cpu", generator=torch.Generator().manual_seed(seed))
    w1_t, w2_t = model.fused_weights()
    w1, w2 = w1_t.detach().T.contiguous(), w2_t.detach().T.contiguous()
    g_pool = torch.from_numpy(np.random.default_rng(seed).normal(size=(w2.shape[1], G)).astype(np.float32))
    return batch, model, (batch.adj_i8, batch.node_mask, batch.x_t, w1, w2, g_pool)


def _pass(fn, adj, mask, x_t, w1, w2, g_pool) -> dict:
    a, b = w1.clone().requires_grad_(True), w2.clone().requires_grad_(True)
    out = fn(adj, mask, x_t, a, b)
    dw1, dw2 = torch.autograd.grad(out, (a, b), g_pool)
    return {"pooled": out.detach(), "dw1": dw1, "dw2": dw2}


def _reversed_order(adj, mask, x_t, a, b):
    """The tower with each graph's nodes reversed: every sum over nodes or
    neighbours runs in another order than the plain version's."""
    f = x_t.shape[0]
    rev = torch.arange(N - 1, -1, -1)
    x_r = x_t.reshape(f, G, N)[:, :, rev].reshape(f, G * N)
    return td.tower_pooled_ref(adj[:, rev][:, :, rev].contiguous(), mask[:, rev].contiguous(), x_r, a, b)


def test_the_f64_function_is_the_jax_tower() -> None:
    _, _, args = _operands()
    adj, mask, x_t, w1, w2, g_pool = args
    exact = fg.tower_f64(*args)

    @jax.jit
    def run(a, b, g):
        out, vjp = jax.vjp(lambda p, q: jd._tower_ref(jnp.asarray(adj.numpy()), jnp.asarray(mask.numpy()), jnp.asarray(x_t.numpy()), p, q)[2], a, b)
        return (out, *vjp(g))

    want = [np.asarray(v) for v in run(jnp.asarray(w1.numpy()), jnp.asarray(w2.numpy()), jnp.asarray(g_pool.numpy()))]
    np.testing.assert_allclose(exact.pooled.numpy(), want[0], rtol=1e-5, atol=1e-4)
    for got, ref in zip((exact.dw1, exact.dw2), want[1:]):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-3 * float(np.abs(ref).max()))
    plain = _pass(td.tower_pooled_ref, *args)
    for what in ("pooled", "dw1", "dw2"):
        value, scale = getattr(exact, what), getattr(exact, f"s_{what}")
        assert (scale >= value.abs()).all()
        assert ((plain[what].double() - value).abs() <= 64 * fg.UNIT * scale + 1e-12).all()


@pytest.mark.parametrize("route", ["plain", "reversed order"])
def test_routes_in_any_order_pass_against_float64(route) -> None:
    _, _, args = _operands(seed=1)
    got = _pass(td.tower_pooled_ref if route == "plain" else _reversed_order, *args)
    if route == "reversed order":  # the other order does move the sums
        plain = _pass(td.tower_pooled_ref, *args)
        assert any(not torch.equal(got[k], plain[k]) for k in got)
    row = fg.hold_tower(route, got, args)
    assert row["passed"] and row["oracle_masks"] == "float64" and row["flips"] is None
    assert set(row["share_of_gate"]) == {"pooled", "dw1", "dw2"}
    assert all(v <= 1.0 for v in row["share_of_gate"].values())
    assert all(c <= fg.C for c in row["needed_c"].values())


def test_an_error_of_four_times_the_bound_fails() -> None:
    _, _, args = _operands(seed=2)
    exact = fg.tower_f64(*args)
    got = {"pooled": exact.pooled.float(), "dw1": exact.dw1.float(), "dw2": exact.dw2.float()}
    assert fg.hold_tower("exact", got, args)["passed"]
    atol = fg.gate_atol(exact.s_dw1)
    k = int(torch.argmax(exact.s_dw1))
    off = exact.dw1.clone()
    off.view(-1)[k] += 4 * (atol.view(-1)[k] + fg.RTOL * exact.dw1.abs().view(-1)[k])
    with pytest.raises(AssertionError, match="against float64"):
        fg.hold_tower("4x off", {**got, "dw1": off.float()}, args)
    row = fg.hold_tower("4x off", {**got, "dw1": off.float()}, args, raise_on_fail=False)
    assert not row["passed"] and 3.9 < row["share_of_gate"]["dw1"] < 4.1  # 4, and the f32 rounding of got
    assert row["needed_c"]["dw1"] > fg.C


def _near_zero(args):
    """``args`` with x moved at one neighbour of a live node so that one relu
    input of layer 1 (channel 3 at that node) is zero to float64 rounding,
    far inside its band, and where that node is."""
    adj, mask, x_t, w1, w2, g_pool = args
    exact = fg.tower_f64(*args)
    live = mask.reshape(-1)
    v = next(int(i) for i in torch.nonzero(live).flatten() if adj.reshape(G * N, N)[i].sum() > 0 and exact.z1[3, i] > 0)
    j = int(torch.nonzero(adj.reshape(G * N, N)[v]).flatten()[0]) + (v // N) * N
    f = int(torch.argmax(w1[:, 3].abs()))
    x = x_t.double().clone()
    x[f, j] -= exact.z1[3, v] / w1[f, 3].double()
    near = (adj, mask, x.float(), w1, w2, g_pool)
    z = fg.tower_f64(*near)
    return near, z, v


def test_a_flip_inside_the_band_is_admitted_and_counted() -> None:
    _, _, args = _operands(seed=3)
    near, z, v = _near_zero(args)
    assert abs(z.z1[3, v].item()) <= fg.C * fg.UNIT * z.s_z1[3, v].item()
    m1, m2 = z.m1.clone(), z.m2.clone()
    m1[3, v] = not m1[3, v]
    # the route: the float64 function with its relu decisions, in f32
    routed = fg.tower_f64(*near, masks=(m1, m2))
    got = {"pooled": routed.pooled.float(), "dw1": routed.dw1.float(), "dw2": routed.dw2.float()}
    row = fg.hold_tower("flip in band", got, near, route_masks=(m1, m2))
    # the flip moves dw1 off the float64 function's own relu decisions; the
    # route passes against its own
    assert row["passed"] and row["oracle_masks"] == "the route's"
    assert row["with_float64_masks"]["share_of_gate"]["dw1"] > 1.0
    assert row["flips"]["h1"]["in_band"] == 1 and row["flips"]["h1"]["out_of_band"] == 0
    assert row["flips"]["h2"] == {"in_band": 0, "out_of_band": 0, "needed_c": 0.0}
    assert row["needed_c"]["flips"] <= fg.C


def test_a_flip_outside_the_band_fails() -> None:
    _, _, args = _operands(seed=4)
    exact = fg.tower_f64(*args)
    live = args[1].reshape(1, -1)
    # the live relu input of layer 2 farthest from zero against its band
    ratio = torch.where(live & (exact.z2 > 0), exact.z2 / exact.s_z2.clamp_min(1e-300), torch.zeros_like(exact.z2))
    k = int(torch.argmax(ratio))
    m2 = exact.m2.clone()
    m2.view(-1)[k] = False
    got = {"pooled": exact.pooled.float(), "dw1": exact.dw1.float(), "dw2": exact.dw2.float()}
    with pytest.raises(AssertionError, match="against float64"):
        fg.hold_tower("flip out of band", got, args, route_masks=(exact.m1, m2))
    row = fg.hold_tower("flip out of band", got, args, route_masks=(exact.m1, m2), raise_on_fail=False)
    assert row["flips"]["h2"]["out_of_band"] == 1 and not row["passed"]


def test_ginet_dense_head_and_gradient_map_are_the_models() -> None:
    """The conv weight gradients of the sum of GINetDense's logits (its flat
    route on the CPU, the plain versions in f32) are the tower's float64
    weight gradients for the head's cotangent, mapped to the conv weights."""
    batch, model, _ = _operands(seed=5)
    model.zero_grad(set_to_none=True)
    model(batch).sum().backward()
    w1_t, w2_t = model.fused_weights()
    w1, w2 = w1_t.detach().T, w2_t.detach().T
    adj, mask, x_t = batch.adj_i8, batch.node_mask, batch.x_t
    pooled = fg.tower_f64(adj, mask, x_t, w1, w2, torch.zeros(64, G)).pooled
    counts = mask.sum(dim=1).double().clamp_min(1.0)
    g_pool, g_scale = fg.dense_head_cotangent(pooled, counts, model.fc1.weight.detach(), model.fc1.bias.detach(), model.fc2.weight.detach())
    assert (g_scale >= g_pool.abs()).all()
    exact = fg.tower_f64(adj, mask, x_t, w1, w2, g_pool, g_scale=g_scale)
    grads = fg.ginet_dense_grads(exact.dw1, exact.dw2)
    scales = fg.ginet_dense_grads(exact.s_dw1, exact.s_dw2)
    params = dict(model.named_parameters())
    assert set(grads) == {k for k, p in params.items() if k.startswith("conv") and p.grad is not None}
    for name, want in grads.items():
        assert params[name].grad.shape == want.shape
        assert ((params[name].grad.double() - want).abs() <= 64 * fg.UNIT * scales[name] + 1e-12).all(), name
        assert (scales[name] >= want.abs()).all()
