"""The port's fused flat tower ``tower_pooled`` (deeprank2_tpu_torch/ops/diag_spmm.py)
against the JAX package's (deeprank2_tpu/ops/diag_spmm.py:tower_pooled) on
the CPU.

No JAX test covers ``tower_pooled``, so this file chooses its oracle: the
JAX ``_tower_ref`` (the function, autodiff for the gradients) and
``tower_pooled``'s own CPU route, at the tolerances of the batched tower's
JAX tests (tests/utils/test_pallas_ginet.py:45, 56-57: the forward at rtol
1e-5 / atol 1e-4, the weight gradients at rtol 1e-4 / atol 1e-3 of their
largest magnitude). The JAX TPU kernels, run in interpret mode, round the
weights to bf16 even on their near-f32 route and store the backward's t1/t2
as bf16: they are compared with w1 and w2 rounded to bf16 on both sides,
the pooled sums at rtol 1e-5 / atol 1e-5 of their largest magnitude and the
weight gradients, the backward aggregates and h1's products at one bf16
step (4e-3) of their largest magnitude. Every input comes from a seeded
numpy generator.
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deeprank2_tpu.ops import diag_spmm as jd
from deeprank2_tpu_torch.ops import diag_spmm as td
from deeprank2_tpu_torch.ops import ginet_tower as gt
from deeprank2_tpu_torch.ops.tower_plan import round16

FWD_TOL = {"rtol": 1e-5, "atol": 1e-4}
BF16_STEP = 4e-3  # one bf16 rounding (2^-8) of t1/t2's storage


def _grad_tol(ref):
    return {"rtol": 1e-4, "atol": 1e-3 * float(np.abs(ref).max())}


def _operands(g, n, f=38, c1=32, c2=64, seed=0):
    """Symmetric 0/1 adjacency with padded (masked, edgeless) nodes, features,
    the two fused weights and a cotangent of the pooled sums."""
    rng = np.random.default_rng(seed)
    adj = rng.random((g, n, n)) < 0.15
    adj = adj | adj.transpose(0, 2, 1)
    mask = np.ones((g, n), bool)
    for gi in range(g):
        mask[gi, n - int(rng.integers(0, n // 4)) :] = False
    adj &= mask[:, :, None] & mask[:, None, :]
    x_t = rng.normal(size=(f, g * n)).astype(np.float32)
    w1 = (rng.normal(size=(f, c1)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(c1, c2)) * 0.1).astype(np.float32)
    g_pool = rng.normal(size=(c2, g)).astype(np.float32)
    return adj.astype(np.int8), mask, x_t, w1, w2, g_pool


def _bf16(w):
    return np.array(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))


def _jax_vjp(fn, adj, mask, x_t, w1, w2, g_pool):
    """Pooled sums and the weight VJP of ``fn(adj, mask, x_t, w1, w2)``, in
    one jitted program (the interpreted kernels run inside it)."""

    @jax.jit
    def run(w1, w2, g_pool):
        out, vjp = jax.vjp(lambda a, b: fn(jnp.asarray(adj), jnp.asarray(mask), jnp.asarray(x_t), a, b), w1, w2)
        return (out, *vjp(g_pool))

    return [np.asarray(v) for v in run(jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(g_pool))]


def _torch_vjp(fn, adj, mask, x_t, w1, w2, g_pool):
    a, b = (torch.from_numpy(w).requires_grad_(True) for w in (w1, w2))
    out = fn(torch.from_numpy(adj), torch.from_numpy(mask), torch.from_numpy(x_t), a, b)
    ga, gb = torch.autograd.grad(out, (a, b), torch.from_numpy(g_pool))
    return out.detach().numpy(), ga.numpy(), gb.numpy()


def _jax_tower_ref_pooled(adj, mask, x_t, w1, w2):
    return jd._tower_ref(adj, mask, x_t, w1, w2)[2]


@pytest.mark.parametrize(("g", "n"), [(8, 32), (7, 40), (4, 96)])
@pytest.mark.parametrize("variant", ["function", "ref"])
@pytest.mark.parametrize("oracle", ["_tower_ref", "tower_pooled_cpu_route"])
def test_tower_pooled_matches_jax(oracle, variant, g, n) -> None:
    ops = _operands(g, n, seed=g * n)
    jfn = _jax_tower_ref_pooled if oracle == "_tower_ref" else jd.tower_pooled
    want, w1_want, w2_want = _jax_vjp(jfn, *ops)
    tfn = td.tower_pooled if variant == "function" else td.tower_pooled_ref
    got, dw1, dw2 = _torch_vjp(tfn, *ops)
    assert got.shape == (64, g)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    np.testing.assert_allclose(dw1, w1_want, **_grad_tol(w1_want))
    np.testing.assert_allclose(dw2, w2_want, **_grad_tol(w2_want))


def test_tower_pooled_matches_the_interpreted_jax_kernels_with_bf16_weights() -> None:
    adj, mask, x_t, w1, w2, g_pool = _operands(8, 32, seed=11)
    ops = (adj, mask, x_t, _bf16(w1), _bf16(w2), g_pool)
    # JAX's tower_pooled forced onto its TPU kernels, interpreted
    with mock.patch.object(jd, "supports", return_value=True), pltpu.force_tpu_interpret_mode():
        want, w1_want, w2_want = _jax_vjp(jd.tower_pooled, *ops)
    got, dw1, dw2 = _torch_vjp(td.tower_pooled, *ops)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(dw1, w1_want, rtol=0, atol=BF16_STEP * np.abs(w1_want).max())
    np.testing.assert_allclose(dw2, w2_want, rtol=0, atol=BF16_STEP * np.abs(w2_want).max())


def test_the_interpreted_jax_kernels_round_the_weights_to_bf16() -> None:
    """Why the kernels are compared with bf16-rounded weights: with f32
    weights the interpreted JAX tower is off from ``_tower_ref`` by more
    than one bf16 step of dw1's largest magnitude, and within it once both
    sides take the rounded weights."""
    adj, mask, x_t, w1, w2, g_pool = _operands(8, 32, seed=11)
    gaps = {}
    for name, (a, b) in (("f32", (w1, w2)), ("bf16", (_bf16(w1), _bf16(w2)))):
        ops = (adj, mask, x_t, a, b, g_pool)
        with mock.patch.object(jd, "supports", return_value=True), pltpu.force_tpu_interpret_mode():
            _, dw1, _ = _jax_vjp(jd.tower_pooled, *ops)
        _, want, _ = _jax_vjp(_jax_tower_ref_pooled, *ops)
        gaps[name] = np.abs(dw1 - want).max() / np.abs(want).max()
    assert gaps["f32"] > BF16_STEP > gaps["bf16"], gaps


def test_kernel_plain_versions_match_the_interpreted_tpu_kernels() -> None:
    adj, mask, x_t, w1, w2, g_pool = _operands(8, 32, seed=12)
    w1, w2 = _bf16(w1), _bf16(w2)
    targs = [torch.from_numpy(v) for v in (adj, x_t, mask, w1, w2)]
    h1, sign, pooled = td.tower_fwd_kernel_ref(*targs)
    t2, t1 = td.tower_bwd_kernel_ref(targs[0], torch.from_numpy(g_pool), sign, h1, targs[4])

    @jax.jit
    def run(adj, x_t, mask, w1, w2, g_pool, sign, h1):
        fwd = jd._tower_fwd_tpu(adj, x_t, mask, w1, w2)
        return fwd, jd._tower_bwd_tpu(adj, g_pool, sign, h1, w2)

    with pltpu.force_tpu_interpret_mode():
        (h1_j, sign_j, pooled_j), (t2_j, t1_j) = run(
            *(jnp.asarray(v) for v in (adj, x_t, mask, w1, w2, g_pool)), jnp.asarray(sign.numpy().astype(np.int8)), jnp.asarray(h1.numpy())
        )
    h1_j, pooled_j = np.asarray(h1_j), np.asarray(pooled_j)
    np.testing.assert_allclose(h1.numpy(), h1_j, rtol=1e-5, atol=1e-5 * np.abs(h1_j).max())
    np.testing.assert_allclose(pooled.numpy(), pooled_j, rtol=1e-5, atol=1e-5 * np.abs(pooled_j).max())
    # the stored sign agrees wherever h2 is clear of the rounding
    h2 = torch.relu(td.diag_kernel_ref(targs[0], targs[4].T @ h1)) * targs[2].reshape(1, -1)
    clear = (h2.abs() > 1e-5 * h2.abs().max()).numpy()
    np.testing.assert_array_equal(sign.numpy()[clear], np.asarray(sign_j)[clear])
    for got, want in ((t2, t2_j), (t1, t1_j)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.numpy(), want, rtol=BF16_STEP, atol=1e-5 * np.abs(want).max())


def test_kernel_wrappers_route_to_their_plain_versions_on_cpu() -> None:
    adj, mask, x_t, w1, w2, g_pool = (torch.from_numpy(v) for v in _operands(3, 24, seed=4))
    td.reset_launches()
    fwd = td.tower_fwd_kernel(adj, x_t, mask, w1, w2)
    for a, b in zip(fwd, td.tower_fwd_kernel_ref(adj, x_t, mask, w1, w2)):
        assert torch.equal(a, b)
    h1, sign, _ = fwd
    assert sign.dtype == torch.uint8 and h1.shape == (32, 72)
    for a, b in zip(td.tower_bwd_kernel(adj, g_pool, sign, h1, w2), td.tower_bwd_kernel_ref(adj, g_pool, sign, h1, w2)):
        assert torch.equal(a, b)
    assert td.launches["tower_fwd_kernel"] == td.launches["tower_bwd_kernel"] == 0


def test_tower_wrappers_check_their_operands() -> None:
    adj, mask, x_t, w1, w2, g_pool = (torch.from_numpy(v) for v in _operands(2, 16, seed=1))
    with pytest.raises(TypeError):
        td.tower_fwd_kernel(adj, x_t, mask.float(), w1, w2)
    with pytest.raises(ValueError, match="shape"):
        td.tower_fwd_kernel(adj, x_t, mask, w1, w2[:-1].contiguous())
    h1, sign, _ = td.tower_fwd_kernel_ref(adj, x_t, mask, w1, w2)
    with pytest.raises(TypeError):
        td.tower_bwd_kernel(adj, g_pool, sign.bool(), h1, w2)
    with pytest.raises(ValueError, match="shape"):
        td.tower_bwd_kernel(adj, g_pool[:, :1].contiguous(), sign, h1, w2)
    with pytest.raises(ValueError, match="no kernel"):
        td.tower_fwd_kernel(*(t.to("meta") for t in (adj, x_t, mask, w1, w2)))


# K9b's plan (csrc/diag_tower.cu:bwd_plan), channels padded to 4: the
# adjacency's bit rows [N, words], the sign's [64, words] and h1's
# [32, words] and g_pool [64] (f32), then w2 [32, ld], the t2 slab [N, ld]
# and the u1 slab [N, ld'] (f32 rows of 68 and 36, bf16 rows of 72 and 40),
# each part 16-byte aligned; at N = 457 it still fits one block's opt-in
# limit
@pytest.mark.parametrize(
    ("n", "elem", "want", "blocks_an_sm"),
    [
        (1, 4, 16 + 4 * (64 + 32 + 64) + 4 * (32 * 68 + 1 * 68 + 1 * 36), None),
        (33, 4, 272 + 4 * 2 * (64 + 32) + 4 * 64 + 4 * (32 * 68 + 33 * 68 + 33 * 36), None),
        (160, 4, 4 * 5 * (160 + 64 + 32) + 4 * 64 + 4 * (32 * 68 + 160 * 68 + 160 * 36), 2),
        (160, 2, 4 * 5 * (160 + 64 + 32) + 4 * 64 + 2 * (32 * 72 + 160 * 72 + 160 * 40), 4),
        (457, 4, round16(4 * 15 * 457) + 4 * 15 * (64 + 32) + 4 * 64 + 4 * (32 * 68 + 457 * 68 + 457 * 36), 1),
    ],
)
def test_tower_bwd_smem_bytes_mirrors_the_backward_plan(n, elem, want, blocks_an_sm) -> None:
    got = td.tower_bwd_smem_bytes(n, 32, 64, elem)
    assert got == want
    assert got <= td.SMEM_LIMIT < td.tower_bwd_smem_bytes(458, 32, 64)
    if blocks_an_sm is not None:  # an H100 SM: 233,472 bytes of shared memory, 1 KB reserved a block
        assert 233_472 // (got + 1024) == blocks_an_sm


# tower_supports() holds K9f's plan, which is the batched forward's (K8f,
# csrc/tower_common.cuh:plan: the bit rows, the mask's bits, the warp sums,
# w1 [48, 36], w2 [32, 68], the slab [rows, 84] of x with fcx beside it and
# h1's [rows, 36], f32; bf16 rows of 40, 72 and 88) and ends at N = 400 at
# the bench widths, and K9b's, which goes on to N = 457
@pytest.mark.parametrize(("g", "n", "ok"), [(512, 160, True), (1, 33, True), (1, 400, True), (1, 401, False), (0, 160, False)])
def test_tower_supports_is_both_plans(g, n, ok) -> None:
    assert td.tower_supports(g, n) == ok
    assert (td.tower_fwd_smem_bytes(n, 38, 32, 64) <= td.SMEM_LIMIT) == (n <= 400)
    assert td.tower_bwd_smem_bytes(n, 32, 64) <= td.SMEM_LIMIT
    assert td.tower_fwd_smem_bytes(160, 38, 32, 64) == 4 * (160 * 5 + 8 + 8 * 64) + 4 * (48 * 36 + 32 * 68 + 160 * 84 + 160 * 36)
    assert td.tower_fwd_smem_bytes(160, 38, 32, 64, 2) == 4 * (160 * 5 + 8 + 8 * 64) + 2 * (48 * 40 + 32 * 72 + 160 * 88 + 160 * 40)
    for k in (1, 33, 160, 400):
        assert td.tower_fwd_smem_bytes(k, 38, 32, 64) == gt.smem_bytes(k, 38, 32, 64)
    # an H100 SM (233,472 bytes, 1 KB reserved a block) holds two f32 and
    # four bf16 forward blocks at the bench shape
    assert 233_472 // (td.tower_fwd_smem_bytes(160, 38, 32, 64) + 1024) == 2
    assert 233_472 // (td.tower_fwd_smem_bytes(160, 38, 32, 64, 2) + 1024) == 4
    assert max(k for k in range(1, 1000) if td.tower_supports(1, k)) == 400


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
def test_t2_is_g_pool_times_the_sign_counts(act) -> None:
    """K9b's t2 = A (sign ⊙ g_pool) as g_pool times the count of row i's
    neighbours whose sign is set at c, in both forms. In the bf16 form
    g_pool is a bf16 value, so g_pool times the count and every partial sum
    of the plain version (K2's, pool_bwd_kernel_ref) are exact: bit for
    bit. In f32 the product is the exact sum rounded once, and the plain
    version's sum, which rounds each of its count partial sums, is within
    count roundings of it."""
    rng = np.random.default_rng(21)
    g, n, c = 16, 96, 64
    adj = rng.random((g, n, n)) < 0.3
    adj[:, n - 8 :, :] = adj[:, :, n - 8 :] = False  # edgeless padded nodes: counts of 0
    adj = torch.from_numpy((adj | adj.transpose(0, 2, 1)).astype(np.int8))
    sign = torch.from_numpy((rng.random((c, g * n)) < 0.5).astype(np.uint8))
    g_pool = torch.from_numpy((rng.normal(size=(c, g)) * np.exp(rng.normal(size=(c, g)))).astype(np.float32))
    counts = torch.einsum("gij,cgj->cgi", adj.float(), sign.float().reshape(c, g, n)).reshape(c, g * n)
    assert counts.max() > 20 and counts.min() == 0
    g_r = td.round_to(g_pool, act).repeat_interleave(n, dim=1)
    t2 = g_r * counts
    want = td.pool_bwd_kernel_ref(adj, sign, g_pool, act)
    exact = g_r.double() * counts.double()
    assert torch.equal(t2, exact.float())  # one rounding
    if act == torch.bfloat16:
        assert torch.equal(t2, want)
        assert torch.equal(td.round_to(t2, act), td.tower_bwd_kernel_ref(adj, g_pool, sign, torch.zeros(32, g * n), torch.zeros(32, c), act)[0].float())
    else:
        assert ((want.double() - t2.double()).abs() <= 2.0**-24 * counts.double() * exact.abs()).all()
