"""The port's graph-diagonal aggregation (deeprank2_tpu_torch/ops/diag_spmm.py)
against the JAX package's (deeprank2_tpu/ops/diag_spmm.py) on the CPU.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
JAX side runs its XLA oracle and, for the TPU kernels themselves, Pallas's
interpret mode (as tests/ops/test_diag_spmm.py does). Both are f32 with exact
0/1 adjacencies, so the oracles agree to summation order (1e-5); the TPU
kernels' near-f32 hi/lo path is held at that file's tolerances.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deeprank2_tpu.ops import diag_spmm as jd
from deeprank2_tpu_torch.ops import diag_spmm as td

TOL = {"rtol": 1e-5, "atol": 1e-5}
SHAPES = [(16, 32, 10), (4, 96, 38), (7, 32, 38)]


def _operands(g, n, f, seed):
    """Symmetric 0/1 adjacency with padded (masked, edgeless) nodes, features,
    and a cotangent, all from one numpy seed."""
    rng = np.random.default_rng(seed)
    adj = rng.random((g, n, n)) < 0.2
    adj = adj | adj.transpose(0, 2, 1)
    mask = np.ones((g, n), bool)
    for gi in range(g):
        mask[gi, n - int(rng.integers(0, n // 4)) :] = False
    adj &= mask[:, :, None] & mask[:, None, :]
    x_t = rng.normal(size=(f, g * n)).astype(np.float32)
    cot = rng.normal(size=(f, g * n)).astype(np.float32)
    return adj.astype(np.int8), mask, x_t, cot


def _jax_vjp(fn, x, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


def _torch_vjp(fn, x, cot):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(xt)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(cot))
    return out.detach().numpy(), grad.numpy()


@pytest.mark.parametrize(("g", "n", "f"), SHAPES)
@pytest.mark.parametrize("layer", ["diag_spmm_t", "diag_layer_t", "diag_layer_pool_t"])
@pytest.mark.parametrize("variant", ["function", "ref"])
def test_layer_fwd_vjp_matches_jax(layer, variant, g, n, f) -> None:
    adj, mask, x_t, cot = _operands(g, n, f, seed=g * n + f)
    if layer == "diag_layer_pool_t":
        cot = cot[:, :g]
    adj_j, mask_j = jnp.asarray(adj), jnp.asarray(mask)
    adj_t, mask_t = torch.from_numpy(adj), torch.from_numpy(mask)
    jfn = {
        "diag_spmm_t": lambda v: jd.diag_spmm_t(adj_j, v),
        "diag_layer_t": lambda v: jd.diag_layer_t(adj_j, mask_j, v),
        "diag_layer_pool_t": lambda v: jd.diag_layer_pool_t(adj_j, mask_j, v),
    }[layer]
    tfn = getattr(td, layer if variant == "function" else f"{layer}_ref")
    targs = (adj_t,) if layer == "diag_spmm_t" else (adj_t, mask_t)
    want_out, want_grad = _jax_vjp(jfn, x_t, cot)
    got_out, got_grad = _torch_vjp(lambda v: tfn(*targs, v), x_t, cot)
    np.testing.assert_allclose(got_out, want_out, **TOL)
    np.testing.assert_allclose(got_grad, want_grad, **TOL)


@pytest.mark.parametrize(("g", "n", "f"), SHAPES)
def test_kernel_plain_versions_match_jax_oracle(g, n, f) -> None:
    adj, mask, x_t, cot = _operands(g, n, f, seed=3 + g)
    adj_t, mask_t, x = torch.from_numpy(adj), torch.from_numpy(mask), torch.from_numpy(x_t)
    agg = np.asarray(jd.diag_spmm_t_xla(jnp.asarray(adj), jnp.asarray(x_t)))
    h = np.maximum(agg, 0.0) * mask.reshape(1, g * n)
    np.testing.assert_allclose(td.diag_kernel(adj_t, x).numpy(), agg, **TOL)
    np.testing.assert_allclose(td.diag_kernel(adj_t, x, mask_t, "relu_mask").numpy(), h, **TOL)
    sign, pooled = td.diag_kernel(adj_t, x, mask_t, "relu_mask_pool")
    assert sign.dtype == torch.uint8
    np.testing.assert_array_equal(sign.numpy(), (h > 0).astype(np.uint8))
    np.testing.assert_allclose(pooled.numpy(), h.reshape(f, g, n).sum(axis=2), **TOL)
    g_pool = np.ascontiguousarray(cot[:, :g])
    u = np.repeat(g_pool, n, axis=1) * (h > 0)
    want = np.asarray(jd.diag_spmm_t_xla(jnp.asarray(adj), jnp.asarray(u.astype(np.float32))))
    got = td.pool_bwd_kernel(adj_t, sign, torch.from_numpy(g_pool)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(("n", "f"), [(32, 10), (96, 38)])
def test_tpu_diag_kernel_interpret_matches_plain_version(n, f) -> None:
    g = jd.GS
    adj, mask, x_t, _ = _operands(g, n, f, seed=n + f)
    adj_t, mask_t, x = torch.from_numpy(adj), torch.from_numpy(mask), torch.from_numpy(x_t)
    try:
        with pltpu.force_tpu_interpret_mode():
            plain = jd._diag_spmm_tpu(jnp.asarray(adj), jnp.asarray(x_t), None, relu=False)
            relu = jd._diag_spmm_tpu(jnp.asarray(adj), jnp.asarray(x_t), jnp.asarray(mask), relu=True)
            h_bf16, pooled = jd._diag_spmm_tpu(jnp.asarray(adj), jnp.asarray(x_t), jnp.asarray(mask), relu=True, pool=True)
    except NotImplementedError as e:  # pragma: no cover - interpreter support varies
        pytest.skip(f"pallas interpret mode unavailable here: {e}")
    np.testing.assert_allclose(np.asarray(plain), td.diag_kernel_ref(adj_t, x).numpy(), rtol=5e-4, atol=5e-4)
    h_ref = td.diag_kernel_ref(adj_t, x, mask_t, "relu_mask").numpy()
    np.testing.assert_allclose(np.asarray(relu), h_ref, rtol=5e-4, atol=5e-4)
    sign_ref, pooled_ref = td.diag_kernel_ref(adj_t, x, mask_t, "relu_mask_pool")
    np.testing.assert_allclose(np.asarray(pooled), pooled_ref.numpy(), rtol=5e-4, atol=5e-4)
    h_tpu = np.asarray(h_bf16.astype(jnp.float32))
    np.testing.assert_allclose(h_tpu, h_ref, rtol=2e-2, atol=2e-2)
    # the stored sign agrees wherever the value is clear of bf16 rounding
    clear = np.abs(h_ref) > 2e-2
    np.testing.assert_array_equal((h_tpu > 0)[clear], sign_ref.numpy().astype(bool)[clear])


@pytest.mark.parametrize(("n", "f"), [(32, 10), (96, 38)])
def test_tpu_pool_bwd_kernel_interpret_matches_plain_version(n, f) -> None:
    g = jd.GS
    adj, mask, x_t, cot = _operands(g, n, f, seed=5 * n + f)
    h = np.maximum(np.asarray(jd.diag_spmm_t_xla(jnp.asarray(adj), jnp.asarray(x_t))), 0.0) * mask.reshape(1, g * n)
    g_pool = np.ascontiguousarray(cot[:, :g])
    try:
        with pltpu.force_tpu_interpret_mode():
            du = jd._diag_pool_bwd_tpu(jnp.asarray(adj), jnp.asarray(h).astype(jnp.bfloat16), jnp.asarray(g_pool))
    except NotImplementedError as e:  # pragma: no cover
        pytest.skip(f"pallas interpret mode unavailable here: {e}")
    sign = torch.from_numpy((h > 0).astype(np.uint8))
    want = td.pool_bwd_kernel_ref(torch.from_numpy(adj), sign, torch.from_numpy(g_pool)).numpy()
    np.testing.assert_allclose(np.asarray(du), want, rtol=5e-3, atol=5e-3)


def test_wrappers_check_their_operands() -> None:
    adj, mask, x_t, _ = _operands(2, 32, 4, seed=0)
    adj_t, mask_t, x = torch.from_numpy(adj), torch.from_numpy(mask), torch.from_numpy(x_t)
    with pytest.raises(TypeError, match="adj must be one of"):
        td.diag_kernel(adj_t.double(), x)
    with pytest.raises(TypeError):
        td.diag_kernel(adj_t, x.double())
    with pytest.raises(ValueError, match="shape"):
        td.diag_kernel(adj_t, x[:, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        td.diag_kernel(adj_t, torch.from_numpy(np.asfortranarray(x_t)))
    with pytest.raises(ValueError, match="unknown mode"):
        td.diag_kernel(adj_t, x, mask_t, "relu")
    with pytest.raises(TypeError):
        td.diag_kernel(adj_t, x, mask_t.float(), "relu_mask")
    with pytest.raises(TypeError):
        td.pool_bwd_kernel(adj_t, x, torch.zeros(4, 2))
    # neither CPU nor CUDA: no kernel and no plain version
    with pytest.raises(ValueError, match="no kernel"):
        td.diag_kernel(adj_t.to("meta"), x.to("meta"))


def test_launch_counts_stay_zero_on_cpu() -> None:
    td.reset_launches()
    adj, mask, x_t, _ = _operands(2, 32, 4, seed=1)
    td.diag_layer_pool_t(torch.from_numpy(adj), torch.from_numpy(mask), torch.from_numpy(x_t))
    assert td.launches == {"diag_kernel": 0, "pool_bwd_kernel": 0, "tower_fwd_kernel": 0, "tower_bwd_kernel": 0}
