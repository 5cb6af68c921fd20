"""The port's fused batched GINet tower (deeprank2_tpu_torch/ops/ginet_tower.py)
and GINetDense's "pallas" tower backend against the JAX package's
(deeprank2_tpu/ops/pallas_ginet.py) on the CPU.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
JAX side runs its TPU kernels in Pallas's interpret mode (the fixture of
tests/utils/test_pallas_ginet.py) and its plain reference, at that file's
tolerances: the forward at rtol 1e-5 / atol 1e-4, the weight gradients at
rtol 1e-4 / atol 1e-3 of their largest magnitude. The JAX kernel needs a
multiple of 8 graphs; the ragged G=7 case is held against its reference only.
Every input comes from a seeded numpy generator.
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import deeprank2_tpu.ops.pallas_ginet as pg
from deeprank2_tpu.neuralnets.gnn import ginet_dense as jgd
from deeprank2_tpu.ops.batch import collate_graphs_dense as jax_collate
from deeprank2_tpu.ops.losses import CrossEntropyLoss as JaxCrossEntropyLoss
from deeprank2_tpu.ops.optim import Adam as JaxAdam
from deeprank2_tpu_torch.neuralnets.gnn import ginet_dense as tgd
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax, params_to_jax
from deeprank2_tpu_torch.ops import ginet_tower as gt
from deeprank2_tpu_torch.ops.batch import collate_graphs_dense, collate_graphs_diag_clustered
from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
from deeprank2_tpu_torch.ops.optim import Adam
from deeprank2_tpu_torch.ops.synthetic import ppi_clustered_entries, synthetic_entries

FWD_TOL = {"rtol": 1e-5, "atol": 1e-4}  # tests/utils/test_pallas_ginet.py:45
FEAT, EDGE = 38, 6


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        return orig(*args, **kwargs, interpret=True)

    monkeypatch.setattr(pl, "pallas_call", interp)


@pytest.fixture
def pallas_backend():
    tgd.set_dense_tower_backend("pallas")
    yield
    tgd.set_dense_tower_backend("xla")


def _inputs(G=16, N=64, F=38, C1=32, C2=64, seed=0, padded=False):
    """JAX's ``_inputs`` (tests/utils/test_pallas_ginet.py:30), as numpy;
    ``padded`` drops a tail of each graph's nodes (masked and edgeless)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(G, N, F)).astype(np.float32)
    adj = rng.random((G, N, N)) < 0.1
    adj = adj | adj.transpose(0, 2, 1)
    mask = rng.random((G, N)) < 0.9
    if padded:
        for g in range(G):
            mask[g, N - 3 * g - 1 :] = False
        adj &= mask[:, :, None] & mask[:, None, :]
    w1 = (rng.normal(size=(F, C1)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(C1, C2)) * 0.1).astype(np.float32)
    return w1, w2, x, adj, mask


def _jax_args(w1, w2, x, adj, mask):
    return jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(x), jnp.asarray(adj, jnp.float32), jnp.asarray(mask, jnp.float32)


def _torch_args(w1, w2, x, adj, mask):
    return torch.from_numpy(w1), torch.from_numpy(w2), torch.from_numpy(x), torch.from_numpy(adj.astype(np.int8)), torch.from_numpy(mask)


def _loss(pooled):
    return (pooled**2).sum() * 1e-4  # tests/utils/test_pallas_ginet.py:52


def _grad_tol(ref):
    return {"rtol": 1e-4, "atol": 1e-3 * float(np.abs(ref).max())}  # tests/utils/test_pallas_ginet.py:56-57


def _torch_grads(fn, w1, w2, x, adj, mask):
    a, b = (t.clone().requires_grad_(True) for t in (w1, w2))
    out = fn(a, b, x, adj, mask)
    ga, gb = torch.autograd.grad(_loss(out), (a, b))
    return out.detach().numpy(), ga.numpy(), gb.numpy()


@pytest.mark.parametrize("variant", ["function", "ref"])
@pytest.mark.parametrize("jax_fn", ["kernel_interpret", "reference"])
def test_tower_and_weight_gradients_match_jax(interpret_pallas, jax_fn, variant) -> None:
    inputs = _inputs()
    jargs = _jax_args(*inputs)
    fn = pg.ginet_tower_pooled if jax_fn == "kernel_interpret" else pg.ginet_tower_pooled_reference

    def jloss(a, b):
        return _loss(fn(a, b, *jargs[2:]))

    # one jitted program each (the interpreted kernel runs inside it)
    want = np.asarray(jax.jit(fn)(*jargs))
    gw1, gw2 = jax.jit(jax.grad(jloss, argnums=(0, 1)))(*jargs[:2])
    tfn = gt.ginet_tower_pooled if variant == "function" else gt.ginet_tower_pooled_ref
    out, g1, g2 = _torch_grads(tfn, *_torch_args(*inputs))
    np.testing.assert_allclose(out, want, **FWD_TOL)
    np.testing.assert_allclose(g1, np.asarray(gw1), **_grad_tol(np.asarray(gw1)))
    np.testing.assert_allclose(g2, np.asarray(gw2), **_grad_tol(np.asarray(gw2)))


def test_ragged_graphs_match_the_jax_reference() -> None:
    inputs = _inputs(G=7, N=40, seed=3, padded=True)
    jargs = _jax_args(*inputs)
    want = np.asarray(pg.ginet_tower_pooled_reference(*jargs))
    gw1, gw2 = jax.grad(lambda a, b: _loss(pg.ginet_tower_pooled_reference(a, b, *jargs[2:])), argnums=(0, 1))(*jargs[:2])
    out, g1, g2 = _torch_grads(gt.ginet_tower_pooled, *_torch_args(*inputs))
    np.testing.assert_allclose(out, want, **FWD_TOL)
    np.testing.assert_allclose(g1, np.asarray(gw1), **_grad_tol(np.asarray(gw1)))
    np.testing.assert_allclose(g2, np.asarray(gw2), **_grad_tol(np.asarray(gw2)))


def test_x_gets_a_zero_cotangent() -> None:
    # x is batch data, not a parameter: zeros, as the JAX custom_vjp returns
    w1, w2, x, adj, mask = _torch_args(*_inputs(G=4, N=32))
    x = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(gt.ginet_tower_pooled(w1, w2, x, adj, mask).sum(), x)
    assert dx.shape == x.shape
    assert not dx.any()


def test_kernel_plain_versions_match_the_interpreted_pallas_calls(interpret_pallas) -> None:
    inputs = _inputs(G=8, N=48, seed=5)
    jargs = _jax_args(*inputs)
    dpooled = np.random.default_rng(6).normal(size=(8, 64)).astype(np.float32)
    want = np.asarray(jax.jit(lambda *a: pg._pooled_fwd_call(*a, jnp.float32))(*jargs))
    dw1, dw2, *_ = jax.jit(lambda *a: pg._pooled_bwd_call(a[:5], a[5], jnp.float32))(*jargs, jnp.asarray(dpooled))
    targs = _torch_args(*inputs)
    dp = torch.from_numpy(dpooled)
    for fwd, bwd in ((gt.ginet_tower_fwd_kernel, gt.ginet_tower_bwd_kernel), (gt.ginet_tower_fwd_kernel_ref, gt.ginet_tower_bwd_kernel_ref)):
        np.testing.assert_allclose(fwd(*targs).numpy(), want, **FWD_TOL)
        got1, got2 = bwd(*targs, dp)
        np.testing.assert_allclose(got1.numpy(), np.asarray(dw1), **_grad_tol(np.asarray(dw1)))
        np.testing.assert_allclose(got2.numpy(), np.asarray(dw2), **_grad_tol(np.asarray(dw2)))
    # the error scale bounds every product sum of the gradients
    s1, s2 = gt.dw_error_scale(*targs, dp)
    assert (s1 >= got1.abs()).all() and (s2 >= got2.abs()).all()


@pytest.mark.parametrize(("g", "n", "ok"), [(512, 160, True), (7, 96, True), (1, 352, True), (1, 353, False), (0, 160, False)])
def test_supports_is_the_shared_memory_rule(g, n, ok) -> None:
    assert gt.supports(g, n) == ok
    assert (gt.smem_bytes(n, 38, 32, 64) <= gt.SMEM_LIMIT) == (n <= 400)
    # the adjacency's [160, 5] and the mask's [5] bit words (16-byte parts),
    # the warp sums [8, 64], then w1 [48, 36], w2 [32, 68], the slab
    # [160, 84] (x and fcx side by side) and h1's [160, 36]
    assert gt.smem_bytes(160, 38, 32, 64) == 4 * (160 * 5 + 8 + 8 * 64) + 4 * (48 * 36 + 32 * 68 + 160 * 84 + 160 * 36)


# the forward's plan (csrc/ginet_tower.cu:plan): the backward's, with the
# signs and dpooled replaced by the pool's warp sums [8, c2p] (f32) and fcx
# kept beside x in the wide slab (48 + 32 columns: f32 rows of 84, bf16 of
# 88), so no third slab; N padded to 16 rows (1 -> 16, 33 -> 48), bit rows
# of ceil(N/32) words, each part 16-byte aligned; at N = 400 it still fits
# one block's opt-in limit
@pytest.mark.parametrize(
    ("n", "elem", "want", "graphs_an_sm"),
    [
        (1, 4, 16 + 16 + 4 * 8 * 64 + 4 * (48 * 36 + 32 * 68 + 16 * 84 + 16 * 36), None),
        (33, 4, 272 + 16 + 4 * 8 * 64 + 4 * (48 * 36 + 32 * 68 + 48 * 84 + 48 * 36), None),
        (160, 4, 4 * (160 * 5 + 8 + 8 * 64) + 4 * (48 * 36 + 32 * 68 + 160 * 84 + 160 * 36), 2),
        (160, 2, 4 * (160 * 5 + 8 + 8 * 64) + 2 * (48 * 40 + 32 * 72 + 160 * 88 + 160 * 40), 4),
        (400, 4, 4 * (400 * 13 + 16 + 8 * 64) + 4 * (48 * 36 + 32 * 68 + 400 * 84 + 400 * 36), 1),
    ],
)
def test_smem_bytes_mirrors_the_forward_plan(n, elem, want, graphs_an_sm) -> None:
    got = gt.smem_bytes(n, 38, 32, 64, elem)
    assert got == want
    assert got <= gt.SMEM_LIMIT < gt.smem_bytes(401, 38, 32, 64)
    if graphs_an_sm is not None:  # an H100 SM: 233,472 bytes of shared memory, 1 KB reserved a block
        assert 233_472 // (got + 1024) == graphs_an_sm


# the backward's own plan (csrc/ginet_tower.cu:backward::plan): N, F, C1, C2
# padded to 16 (160, 48, 32, 64), each row an odd number of 16-byte units
# (f32: 36 and 68 floats; bf16: 40 and 72), bits [160, 5], the mask's bits
# [5] and signs [64, 5] as uint32, dpooled [64] as f32, then w1 [48, ld(C1)],
# w2 [32, ld(C2)], the slab [160, ld(C2)] and two [160, ld(C1)]; N = F = C1 =
# C2 = 1 pads all to 16 (rows of 5 units, bits, mask and signs one word,
# each part 16-byte aligned)
@pytest.mark.parametrize(
    ("shape", "elem", "want", "graphs_an_sm"),
    [
        ((160, 38, 32, 64), 4, 4 * (160 * 5 + 8 + 64 * 5 + 64) + 4 * (48 * 36 + 32 * 68 + 160 * 68 + 2 * 160 * 36), 2),
        ((160, 38, 32, 64), 2, 4 * (160 * 5 + 8 + 64 * 5 + 64) + 2 * (48 * 40 + 32 * 72 + 160 * 72 + 2 * 160 * 40), 3),
        ((1, 1, 1, 1), 4, 16 + 16 + 64 + 64 + 5 * 16 * 80, None),
    ],
)
def test_bwd_smem_bytes_mirrors_the_backward_plan(shape, elem, want, graphs_an_sm) -> None:
    got = gt.bwd_smem_bytes(*shape, elem)
    assert got == want
    if graphs_an_sm is not None:  # an H100 SM: 233,472 bytes of shared memory, 1 KB reserved a block
        assert 233_472 // (got + 1024) == graphs_an_sm


# supports() holds both plans (the forward's cut from the backward's): the
# backward's binds at the bench widths (N = 352) and at narrow channels
# (N = 384); at a wide F both end at N = 160
@pytest.mark.parametrize(("f", "c1", "c2", "n_max"), [(38, 32, 64, 352), (38, 20, 36, 384), (200, 32, 64, 160)])
def test_supports_holds_the_forward_and_the_backward_plan(f, c1, c2, n_max) -> None:
    assert max(n for n in range(1, 600) if gt.supports(1, n, f, c1, c2)) == n_max
    fwd = max(n for n in range(1, 600) if gt.smem_bytes(n, f, c1, c2) <= gt.SMEM_LIMIT)
    bwd = max(n for n in range(1, 600) if gt.bwd_smem_bytes(n, f, c1, c2) <= gt.SMEM_LIMIT)
    assert n_max == min(fwd, bwd)
    assert gt.bwd_smem_bytes(n_max, f, c1, c2, 2) < gt.bwd_smem_bytes(n_max, f, c1, c2)  # the bf16 form fits wherever the f32 form does


def test_wrappers_check_their_operands() -> None:
    w1, w2, x, adj, mask = _torch_args(*_inputs(G=2, N=16))
    with pytest.raises(TypeError):
        gt.ginet_tower_fwd_kernel(w1, w2, x, adj.float(), mask)
    with pytest.raises(TypeError):
        gt.ginet_tower_fwd_kernel(w1, w2, x, adj, mask.float())
    with pytest.raises(ValueError, match="shape"):
        gt.ginet_tower_fwd_kernel(w1[:-1].contiguous(), w2, x, adj, mask)
    with pytest.raises(ValueError, match="contiguous"):
        gt.ginet_tower_fwd_kernel(w1, w2, x.transpose(0, 1).contiguous().transpose(0, 1), adj, mask)
    with pytest.raises(ValueError, match="shape"):
        gt.ginet_tower_bwd_kernel(w1, w2, x, adj, mask, torch.zeros(2, 63))
    with pytest.raises(ValueError, match="no kernel"):
        gt.ginet_tower_fwd_kernel(*(t.to("meta") for t in (w1, w2, x, adj, mask)))


def test_launch_counts_stay_zero_on_cpu() -> None:
    gt.reset_launches()
    w1, w2, x, adj, mask = _torch_args(*_inputs(G=2, N=16))
    a = w1.clone().requires_grad_(True)
    gt.ginet_tower_pooled(a, w2, x, adj, mask).sum().backward()
    assert gt.launches == {"ginet_tower_fwd_kernel": 0, "ginet_tower_bwd_kernel": 0}


def test_set_dense_tower_backend_names() -> None:
    for name in ("pallas", "xla"):
        tgd.set_dense_tower_backend(name)
        assert tgd._TOWER_BACKEND == name
    with pytest.raises(ValueError, match="unknown dense tower backend: nope"):
        tgd.set_dense_tower_backend("nope")
    assert tgd._TOWER_BACKEND == "xla"


def _setup(pad_nodes=32):
    """Six graphs (one with padded nodes inside) in eight slots, as JAX's
    kernel needs a multiple of 8 graphs; one JAX initialization in both."""
    entries = synthetic_entries(6, 24, FEAT, EDGE, seed=5)
    entries[-1]["x"] = entries[-1]["x"][:19]
    entries[-1]["pos"] = entries[-1]["pos"][:19]
    entries[-1]["edge_index"] = entries[-1]["edge_index"][(entries[-1]["edge_index"] < 19).all(axis=1)]
    jbatch, _ = jax_collate(entries, pad_graphs=8, pad_nodes=pad_nodes)
    tbatch, _ = collate_graphs_dense(entries, pad_graphs=8, pad_nodes=pad_nodes, device="cpu")
    jmodel = jgd.GINetDense(FEAT, 2, EDGE)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    model = tgd.GINetDense(FEAT, 2, EDGE, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return jmodel, params, jbatch, model, tbatch


def _assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path), **tol)


def _torch_loss(model, tbatch):
    return CrossEntropyLoss()(model(tbatch, training=False), tbatch.y, tbatch.y_mask)


def test_ginet_dense_pallas_backend_matches_jax(interpret_pallas, pallas_backend) -> None:
    """The slice as a whole: logits (1e-5), loss and every gradient (rtol =
    atol = 1e-5) and two Adam steps (rtol 1e-4, atol 1e-6), the tolerances of
    tests/test_torch_ginet_dense.py, against the JAX model with its pallas
    backend forced onto the interpreted kernel."""
    jmodel, params, jbatch, model, tbatch = _setup()

    def jax_loss(p):
        return JaxCrossEntropyLoss()(jmodel.apply(p, jbatch, training=False), jbatch.y.astype(jnp.int32), jbatch.y_mask)

    jgd.set_dense_tower_backend("pallas")
    try:
        with mock.patch.object(pg, "supports", return_value=True):
            want = np.asarray(jax.jit(lambda p: jmodel.apply(p, jbatch))(params))
            loss_want, grads_want = jax.jit(jax.value_and_grad(jax_loss))(params)
            jopt = JaxAdam(lr=1e-3, weight_decay=1e-5)
            state, jparams = jopt.init(params), params
            grad_fn = jax.jit(jax.grad(jax_loss))
            for _ in range(2):
                jparams, state = jopt.step(jparams, grad_fn(jparams), state)
    finally:
        jgd.set_dense_tower_backend("xla")

    with mock.patch.object(gt, "ginet_tower_pooled", wraps=gt.ginet_tower_pooled) as spy:
        with torch.no_grad():
            got = model(tbatch).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        loss = _torch_loss(model, tbatch)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(loss_want), rtol=1e-5, atol=1e-5)
        grads = params_to_jax({k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in model.named_parameters()})
        _assert_trees_close(grads, jax.tree.map(np.asarray, grads_want), rtol=1e-5, atol=1e-5)
        opt = Adam(model.parameters(), lr=1e-3, weight_decay=1e-5)
        for _ in range(2):
            opt.zero_grad()
            _torch_loss(model, tbatch).backward()
            opt.step()
        assert spy.call_count == 4  # the batched tower ran every forward
    _assert_trees_close(params_to_jax(model.state_dict()), jax.tree.map(np.asarray, jparams), rtol=1e-4, atol=1e-6)


def test_backend_switch_leaves_the_flat_route_and_the_clustered_model_unchanged(pallas_backend) -> None:
    _, _, _, model, tbatch = _setup()
    with torch.no_grad():
        fused = model(tbatch)
        tgd.set_dense_tower_backend("xla")
        flat = model(tbatch)
    torch.testing.assert_close(fused, flat, rtol=1e-5, atol=1e-5)
    # beyond the shape rule (N > 352) and in GINetClusteredDiag the "pallas"
    # backend takes the flat route: the same values, and no batched tower
    _, _, _, model, wide = _setup(pad_nodes=384)
    c_entries = ppi_clustered_entries(3, 40, FEAT, seed=2)
    c_batch, _ = collate_graphs_diag_clustered(c_entries, device="cpu")
    clustered = tgd.GINetClusteredDiag(FEAT, 2, 1, device="cpu")
    with torch.no_grad():
        want = (model(wide), clustered(c_batch))
        tgd.set_dense_tower_backend("pallas")
        with mock.patch.object(gt, "ginet_tower_pooled", side_effect=AssertionError("batched tower taken")):
            got = (model(wide), clustered(c_batch))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
