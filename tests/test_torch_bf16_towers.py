"""The single-pass bf16 forms (``compute_dtype=torch.bfloat16``) of the fused
GINet towers: K8f/K8b (deeprank2_tpu_torch/ops/ginet_tower.py, the batched
layout) and K9f/K9b (deeprank2_tpu_torch/ops/diag_spmm.py:tower_pooled, the
flat layout), and ``GINetDense`` on the "pallas" tower backend, against the
JAX package on the CPU.

JAX's CPU routes ignore ``compute_dtype`` in the towers (``tower_pooled``
runs ``_tower_ref``, and ``pallas_ginet.supports`` is False off a TPU), so
the oracle is JAX's TPU kernels with ``compute_dtype`` bf16 run by the Pallas
interpreter: ``pallas_call(..., interpret=True)`` for K8 (G a multiple of
8, ``pallas_ginet.supports`` patched), ``force_tpu_interpret_mode`` with
``diag_spmm.supports`` patched for K9. Every JAX program is jitted (eager JAX
ops during an interpreted kernel's host callbacks can deadlock). Every input
comes from a seeded numpy generator.

Tolerances, and why. Both sides round to bf16 at the same points (the
matmul operands of the Pallas bodies) and sum in f32, so they differ by the
f32 summation order, except where a value about to be rounded lies so close
to a rounding boundary that the two orders round it to neighbouring bf16
numbers (a flip): that moves what follows by at most one bf16 step of the
flipped value (2^-8 of it, 2^-7 counting the output's own rounding), and
a flip of ``[h2 > 0]`` moves ``t2`` by a whole ``bf16(g)``. So each output is
held, entry by entry, to an f32-order bound, rtol 1e-5 and an atol of 1e-6 ×
Σ|terms| (the same value computed on the absolute values of every operand:
the sum of the absolute products through the whole chain, which bounds
every partial sum); at most 0.1 % of the entries may be off it, each within
2^-7 × (Σ|terms| + |value|). K9f's sign may differ only where ``|h2|`` is
within 2^-7 × Σ|terms| of zero, at most 0.1 % of the entries. Gaps measured
on one CPU run, as a share of Σ|terms|: K8f pooled 1.3e-9, K8b dw1 4.6e-8
and dw2 2.3e-7, K9f h1 3.7e-9 and pooled 2.1e-9, K9b t2 and t1 0 (bit for
bit), no sign differs, and no entry was off the f32-order bound. Control:
each f32 form misses that tolerance against the JAX bf16 kernels (63-99 %
of the entries off it).
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import deeprank2_tpu.ops.pallas_ginet as pg
from deeprank2_tpu.neuralnets.gnn import ginet_dense as jgd
from deeprank2_tpu.ops import diag_spmm as jd
from deeprank2_tpu.ops.batch import collate_graphs_dense as jax_collate
from deeprank2_tpu.ops.losses import CrossEntropyLoss as JaxCrossEntropyLoss
from deeprank2_tpu.ops.optim import Adam as JaxAdam
from deeprank2_tpu_torch.neuralnets.gnn import ginet_dense as tgd
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax, params_to_jax
from deeprank2_tpu_torch.ops import diag_spmm as td
from deeprank2_tpu_torch.ops import ginet_tower as gt
from deeprank2_tpu_torch.ops.batch import collate_graphs_dense
from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
from deeprank2_tpu_torch.ops.optim import Adam
from tests.test_torch_bf16_models import _dense_entries
from tests.test_torch_diag_tower import _operands as _flat_operands
from tests.test_torch_ginet_tower import _inputs as _batched_inputs
from tests.test_torch_ginet_tower import interpret_pallas  # noqa: F401 (a fixture)

BF16 = torch.bfloat16
FLIP = 2.0**-7  # one bf16 step of a value (at most), counting the output's rounding too
SHARE = 1e-3  # entries that may be off the f32-order bound
LR, WD = 1e-3, 1e-5


def _off(got, want, scale) -> np.ndarray:
    """The entries off the f32-order bound: |got - want| > 1e-5 |want| + 1e-6 Σ|terms|."""
    got, want, scale = (np.asarray(v, np.float64) for v in (got, want, scale))
    return np.abs(got - want) > 1e-5 * np.abs(want) + 1e-6 * scale


def _flip_close(got, want, scale, what: str) -> None:
    """The tolerance of the module docstring: f32 order, except a counted
    share of flips, each within one bf16 step of the chain."""
    got, want, scale = (np.asarray(v, np.float64) for v in (got, want, scale))
    off = _off(got, want, scale)
    assert off.mean() <= SHARE, f"{what}: {int(off.sum())} of {off.size} entries off the f32-order bound"
    err = np.abs(got - want)[off]
    assert np.all(err <= FLIP * (scale + np.abs(want))[off]), f"{what}: a flip beyond one bf16 step, error {err.max():.3e}"


def _misses(got, want, scale) -> bool:
    """The control: more than the allowed share off the f32-order bound."""
    return bool(_off(got, want, scale).mean() > SHARE)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# K8f and K8b


def _k8(g, n, seed):
    """The batched inputs of tests/test_torch_ginet_tower.py in both packages
    and a cotangent of the pooled sums."""
    w1, w2, x, adj, mask = _batched_inputs(G=g, N=n, seed=seed)
    jargs = (jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(x), jnp.asarray(adj, jnp.float32), jnp.asarray(mask, jnp.float32))
    targs = (torch.from_numpy(w1), torch.from_numpy(w2), torch.from_numpy(x), torch.from_numpy(adj.astype(np.int8)), torch.from_numpy(mask))
    dp = np.random.default_rng(seed + 1).normal(size=(g, w2.shape[1])).astype(np.float32)
    return jargs, targs, dp


def _k8_fwd_scale(w1, w2, x, adj, mask, compute_dtype=BF16):
    """Σ|terms| of the pooled sums: the forward on the absolute values (all
    non-negative, so relu passes everything)."""
    return gt.ginet_tower_fwd_kernel_ref(w1.abs(), w2.abs(), x.abs(), adj, mask, compute_dtype)


@pytest.mark.parametrize(("g", "n", "seed"), [(16, 64, 0), (8, 48, 5)])
def test_k8_bf16_plain_versions_match_the_interpreted_kernels(interpret_pallas, g, n, seed) -> None:  # noqa: F811
    jargs, targs, dp = _k8(g, n, seed)
    want = np.asarray(jax.jit(lambda *a: pg._pooled_fwd_call(*a, jnp.bfloat16))(*jargs))
    dw1, dw2, *_ = jax.jit(lambda *a: pg._pooled_bwd_call(a[:5], a[5], jnp.bfloat16))(*jargs, jnp.asarray(dp))
    dpt = torch.from_numpy(dp)
    fwd_scale = _k8_fwd_scale(*targs)
    _flip_close(gt.ginet_tower_fwd_kernel_ref(*targs, BF16), want, fwd_scale, "K8f pooled")
    scales = gt.dw_error_scale(*targs, dpt, BF16)
    for what, got, ref, scale in zip(("dw1", "dw2"), gt.ginet_tower_bwd_kernel_ref(*targs, dpt, BF16), (dw1, dw2), scales):
        _flip_close(got, ref, scale, f"K8b {what}")
    # the wrappers take the plain versions on the CPU; x is f32 in both forms
    assert torch.equal(gt.ginet_tower_fwd_kernel(*targs, BF16), gt.ginet_tower_fwd_kernel_ref(*targs, BF16))
    with pytest.raises(TypeError, match="x must be torch.float32, got"):
        gt.ginet_tower_fwd_kernel(*targs[:2], targs[2].to(BF16), *targs[3:], BF16)
    # the control: the f32 form misses the bf16 kernels' tolerance
    assert _misses(gt.ginet_tower_fwd_kernel_ref(*targs), want, fwd_scale)
    for got, ref, scale in zip(gt.ginet_tower_bwd_kernel_ref(*targs, dpt), (dw1, dw2), scales):
        assert _misses(got, ref, scale)


# ---------------------------------------------------------------------------
# K9f and K9b


@jax.jit
def _jax_flat_kernels(adj, x_t, mask, w1, w2, g_pool, sign, h1):
    fwd = jd._tower_fwd_tpu(adj, x_t, mask, w1, w2, compute_dtype="bfloat16")
    return fwd, jd._tower_bwd_tpu(adj, g_pool, sign, h1, w2, compute_dtype="bfloat16")


@pytest.mark.parametrize(("g", "n", "seed"), [(8, 32, 12), (16, 64, 1)])
def test_k9_bf16_plain_versions_match_the_interpreted_kernels(g, n, seed) -> None:
    adj, mask, x_t, w1, w2, g_pool = _flat_operands(g, n, seed=seed)
    targs = [torch.from_numpy(v) for v in (adj, x_t, mask, w1, w2)]
    gp = torch.from_numpy(g_pool)
    h1, sign, pooled = td.tower_fwd_kernel_ref(*targs, BF16)
    t2, t1 = td.tower_bwd_kernel_ref(targs[0], gp, sign, h1, targs[4], BF16)
    assert h1.dtype == torch.float32 and t2.dtype == t1.dtype == BF16
    with pltpu.force_tpu_interpret_mode():
        (h1_j, sign_j, pooled_j), (t2_j, t1_j) = _jax_flat_kernels(
            *(jnp.asarray(v) for v in (adj, x_t, mask, w1, w2, g_pool)), jnp.asarray(sign.numpy().astype(np.int8)), jnp.asarray(h1.numpy())
        )
    assert t2_j.dtype == t1_j.dtype == jnp.bfloat16
    h1_scale, _, pooled_scale = td.tower_fwd_kernel_ref(targs[0], targs[1].abs(), targs[2], targs[3].abs(), targs[4].abs(), BF16)
    _flip_close(h1, h1_j, h1_scale, "K9f h1")
    _flip_close(pooled, pooled_j, pooled_scale, "K9f pooled")
    # the sign may differ only where a flip can reach h2 = 0
    h2_scale = td.diag_kernel_ref(targs[0], td.round_to(targs[4].abs(), BF16).T @ td.round_to(h1_scale, BF16), compute_dtype=BF16)
    h2 = torch.relu(td.diag_kernel_ref(targs[0], td.round_to(targs[4], BF16).T @ td.round_to(h1, BF16), compute_dtype=BF16)) * targs[2].reshape(1, -1)
    differ = sign.numpy() != np.asarray(sign_j)
    assert differ.mean() <= SHARE
    assert np.all(h2.numpy()[differ] <= FLIP * h2_scale.numpy()[differ])
    scales = td.tower_bwd_error_scale(targs[0], gp, sign, h1, targs[4], BF16)
    for what, got, want, scale in (("t2", t2, t2_j, scales[0]), ("t1", t1, t1_j, scales[1])):
        _flip_close(_np(got), np.asarray(want.astype(jnp.float32)), scale, f"K9b {what}")
    # the control: the f32 forms miss
    h1_f32, _, pooled_f32 = td.tower_fwd_kernel_ref(*targs)
    assert _misses(h1_f32, h1_j, h1_scale) and _misses(pooled_f32, pooled_j, pooled_scale)
    _, t1_f32 = td.tower_bwd_kernel_ref(targs[0], gp, sign, h1, targs[4])
    assert _misses(t1_f32, np.asarray(t1_j.astype(jnp.float32)), scales[1])


def test_k9_wrappers_run_the_bf16_form_on_the_cpu() -> None:
    """f32 x_t (bf16 refused in either form), bf16 t2/t1, the plain versions
    on the CPU (no launch counted), and the forms named in
    ``launches_by_dtype``."""
    adj, mask, x_t, w1, w2, g_pool = (torch.from_numpy(v) for v in _flat_operands(3, 24, seed=4))
    td.reset_launches()
    want = td.tower_fwd_kernel_ref(adj, x_t, mask, w1, w2, BF16)
    for a, b in zip(td.tower_fwd_kernel(adj, x_t, mask, w1, w2, BF16), want):
        assert torch.equal(a, b)
    h1, sign, _ = want
    for a, b in zip(td.tower_bwd_kernel(adj, g_pool, sign, h1, w2, BF16), td.tower_bwd_kernel_ref(adj, g_pool, sign, h1, w2, BF16)):
        assert a.dtype == BF16 and torch.equal(a, b)
    assert td.launches["tower_fwd_kernel"] == td.launches["tower_bwd_kernel"] == 0
    for kernel in ("tower_fwd_kernel", "tower_bwd_kernel"):
        assert td.launches_by_dtype[kernel] == {"int8/float32": 0, "int8/bfloat16": 0}
    for cd in (None, BF16):
        with pytest.raises(TypeError, match="x_t must be torch.float32, got"):
            td.tower_fwd_kernel(adj, x_t.to(BF16), mask, w1, w2, cd)


# ---------------------------------------------------------------------------
# The differentiable towers


def _jax_vjp(fn, w1, w2, cot):
    @jax.jit
    def run(a, b, c):
        out, vjp = jax.vjp(fn, a, b)
        return (out, *vjp(c))

    return [np.asarray(v) for v in run(jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(cot))]


def _torch_vjp(fn, w1, w2, cot):
    a, b = (t.clone().requires_grad_(True) for t in (w1, w2))
    out = fn(a, b)
    return [_np(out), *(_np(v) for v in torch.autograd.grad(out, (a, b), cot))]


def test_ginet_tower_pooled_in_bf16_matches_jax(interpret_pallas) -> None:  # noqa: F811
    jargs, targs, dp = _k8(16, 64, seed=2)
    with mock.patch.object(pg, "supports", return_value=True):
        want = _jax_vjp(lambda a, b: pg.ginet_tower_pooled(a, b, *jargs[2:], compute_dtype=jnp.bfloat16), *jargs[:2], dp)
    gt.reset_launches()
    got = _torch_vjp(lambda a, b: gt.ginet_tower_pooled(a, b, *targs[2:], BF16), *targs[:2], torch.from_numpy(dp))
    assert gt.launches_by_dtype["ginet_tower_fwd_kernel"] == {"int8/float32": 0, "int8/bfloat16": 0}
    scales = (_k8_fwd_scale(*targs), *gt.dw_error_scale(*targs, torch.from_numpy(dp), BF16))
    for what, a, b, scale in zip(("pooled", "dw1", "dw2"), got, want, scales):
        _flip_close(a, b, scale, f"ginet_tower_pooled {what}")
    # x is batch data: a zero cotangent
    x = targs[2].clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(gt.ginet_tower_pooled(*targs[:2], x, *targs[3:], BF16).sum(), x)
    assert dx.dtype == torch.float32 and not dx.any()
    f32 = _torch_vjp(lambda a, b: gt.ginet_tower_pooled(a, b, *targs[2:]), *targs[:2], torch.from_numpy(dp))
    assert all(_misses(a, b, scale) for a, b, scale in zip(f32, want, scales))


@pytest.mark.parametrize("variant", ["function", "ref"])
def test_tower_pooled_in_bf16_matches_jax(variant) -> None:
    """``tower_pooled`` (its autograd Function, on the kernels' plain
    versions here) and ``tower_pooled_ref`` (the plain ops, written apart)
    in bf16 against JAX's, with the flip tolerance."""
    tfn = td.tower_pooled if variant == "function" else td.tower_pooled_ref
    adj, mask, x_t, w1, w2, g_pool = _flat_operands(8, 32, seed=13)
    jfix = (jnp.asarray(adj), jnp.asarray(mask), jnp.asarray(x_t))
    with mock.patch.object(jd, "supports", return_value=True), pltpu.force_tpu_interpret_mode():
        want = _jax_vjp(lambda a, b: jd.tower_pooled(*jfix, a, b, compute_dtype=jnp.bfloat16), w1, w2, g_pool)
    tfix = [torch.from_numpy(v) for v in (adj, mask, x_t)]
    tw1, tw2, gp = (torch.from_numpy(v) for v in (w1, w2, g_pool))
    got = _torch_vjp(lambda a, b: tfn(*tfix, a, b, compute_dtype=BF16), tw1, tw2, gp)
    # Σ|terms|: the pooled sums on absolute values, and |x_t| |t1|ᵀ, |h1| |t2|ᵀ
    h1, sign, _ = td.tower_fwd_kernel_ref(tfix[0], tfix[2], tfix[1], tw1, tw2, BF16)
    t2, t1 = (t.float() for t in td.tower_bwd_kernel_ref(tfix[0], gp, sign, h1, tw2, BF16))
    pooled_scale = td.tower_fwd_kernel_ref(tfix[0], tfix[2].abs(), tfix[1], tw1.abs(), tw2.abs(), BF16)[2]
    scales = (pooled_scale, tfix[2].abs() @ t1.abs().T, h1.abs() @ t2.abs().T)
    for what, a, b, scale in zip(("pooled", "dw1", "dw2"), got, want, scales):
        _flip_close(a, b, scale, f"tower_pooled {what}")
    f32 = _torch_vjp(lambda a, b: tfn(*tfix, a, b), tw1, tw2, gp)
    assert all(_misses(a, b, scale) for a, b, scale in zip(f32, want, scales))


# ---------------------------------------------------------------------------
# The slice as a whole: GINetDense on the "pallas" tower backend


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v, np.float64)) for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def test_ginet_dense_bf16_pallas_backend_matches_jax(interpret_pallas) -> None:  # noqa: F811
    """Logits, loss, every gradient and one Adam step of
    ``GINetDense(compute_dtype=bf16)`` on the "pallas" backend against JAX's
    on its pallas backend, forced onto the interpreted kernels. bf16 enters
    only inside the tower kernels (the head is f32 on both sides), so the
    tolerances of tests/test_torch_bf16_models.py's kernel-only models hold:
    rtol 1e-4 and an atol of 1e-5 of the largest logit or gradient
    (measured on one CPU run: logits 2.4e-7, gradients 2.3e-7 of it). Adam as in that
    file: lr × sign(g) to rtol 1e-5 / atol 1e-7 where |g| > 1e-4 of the
    largest gradient and both signs agree, within 2 lr elsewhere. The
    control: the port's f32 model misses these tolerances."""
    entries = _dense_entries()
    jbatch, _ = jax_collate(entries, pad_graphs=8, pad_nodes=32)
    tbatch, _ = collate_graphs_dense(entries, pad_graphs=8, pad_nodes=32, device="cpu")
    jmodel = jgd.GINetDense(38, 2, 6, compute_dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    model = tgd.GINetDense(38, 2, 6, device="cpu", compute_dtype=BF16)
    model.load_state_dict(params_from_jax(params))
    f32_model = tgd.GINetDense(38, 2, 6, device="cpu")
    f32_model.load_state_dict(params_from_jax(params))

    def jax_loss(p):
        return JaxCrossEntropyLoss()(jmodel.apply(p, jbatch), jbatch.y.astype(jnp.int32), jbatch.y_mask)

    jgd.set_dense_tower_backend("pallas")
    try:
        with mock.patch.object(pg, "supports", return_value=True):
            want = np.asarray(jax.jit(jmodel.apply)(params, jbatch))
            loss_want, grads_want = jax.jit(jax.value_and_grad(jax_loss))(params)
    finally:
        jgd.set_dense_tower_backend("xla")
    grads_want = jax.tree.map(np.asarray, grads_want)

    def port_run(m):
        m.zero_grad()
        logits = m(tbatch)
        loss = CrossEntropyLoss()(logits, tbatch.y, tbatch.y_mask)
        loss.backward()
        grads = params_to_jax({k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in m.named_parameters()})
        return logits.detach().numpy(), float(loss.detach()), grads

    tgd.set_dense_tower_backend("pallas")
    try:
        gt.reset_launches()
        with mock.patch.object(gt, "ginet_tower_pooled", wraps=gt.ginet_tower_pooled) as spy:
            logits, loss, grads = port_run(model)
            f32_logits, _, f32_grads = port_run(f32_model)
        assert spy.call_count == 2
    finally:
        tgd.set_dense_tower_backend("xla")
    assert not any(gt.launches.values())  # the CPU takes the plain versions
    rtol, share = 1e-4, 1e-5
    gscale = max(np.abs(v).max() for _, v in _leaves(grads_want))
    assert logits.dtype == np.float32
    np.testing.assert_allclose(logits, want, rtol=rtol, atol=share * np.abs(want).max())
    np.testing.assert_allclose(loss, float(loss_want), rtol=rtol, atol=share * abs(float(loss_want)))
    for (path, a), (_, b) in zip(_leaves(grads), _leaves(grads_want), strict=True):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=share * gscale, err_msg=f"gradient {path}")
    # the control: the f32 model is further from JAX's bf16 one
    f32_off = np.any(np.abs(f32_logits - want) > rtol * np.abs(want) + share * np.abs(want).max())
    assert f32_off or any(np.any(np.abs(a - b) > rtol * np.abs(b) + share * gscale) for (_, a), (_, b) in zip(_leaves(f32_grads), _leaves(grads_want)))

    # one Adam step in each package from its own gradients
    jopt = JaxAdam(lr=LR, weight_decay=WD)
    jparams, _ = jopt.step(params, grads_want, jopt.init(params))
    opt = Adam(model.parameters(), lr=LR, weight_decay=WD)
    opt.step()
    got = _leaves(params_to_jax(model.state_dict()))
    for (path, a), (_, b), (_, g_port), (_, g_jax) in zip(got, _leaves(jparams), _leaves(grads), _leaves(grads_want), strict=True):
        settled = (np.abs(g_jax) > 1e-4 * gscale) & (np.sign(g_port) == np.sign(g_jax))
        np.testing.assert_allclose(a[settled], b[settled], rtol=1e-5, atol=1e-7, err_msg=f"Adam step {path}")
        assert np.all(np.abs(a - b)[~settled] <= 2 * LR * (1 + 1e-3)), f"Adam step {path}"
