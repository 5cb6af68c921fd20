"""The single-pass bf16 forms (``compute_dtype=torch.bfloat16``) of kernels
K1, K2, K5, K6f and K6b: each plain version (``*_ref``) against the JAX
kernel body it replaces, run by the Pallas interpreter on the CPU with
``compute_dtype="bfloat16"``, on the same numpy inputs made from a seed; and
the port's differentiable ops in that form against the JAX ones on their
interpreted TPU route (values and VJPs).

Tolerances, and why:

- K1 (three modes, int8 and bf16 adjacencies), K2, K5 (int8, bf16 and f32
  blocks): the rounding points are the same on both sides (the activations
  or ``u`` rounded to bf16 once, the adjacency or blocks cast to bf16, every
  sum f32), so only the f32 summation order differs: rtol 1e-5 and an atol
  of 1e-6 × Σ|terms|, the sum of the absolute products of the entry (PERF.md
  §2's rule for the weighted forms). K1's pool-mode sign exactly.
- K6f and K6b: the same rounding points, plus one inside the kernel: each
  message ``relu(pre)`` is rounded to bf16 before its sum. ``pre`` holds an
  edge term ``Σ_k bf16(e_k) bf16(w_k)`` whose f32 sum over the edge channels
  may run in another order in JAX's dot, so a message can round to the
  neighbouring bf16 value: one step is at most 2^-7 of the message (a bf16
  holds 8 significant bits), and since messages are >= 0 an output may move
  by at most 2^-7 × Σ|msg| = 2^-7 × out (k = 1, however many flip). A flip
  of ``[pre > 0]`` moves a
  backward entry by a whole ``bf16(g)``. So each output is held to rtol
  1e-5 / atol 1e-5 × max (f32 order) wherever no flip happened, the
  forward's flips to 2^-7 × out, and at most 0.1 % of entries may be off
  the f32-order bound; ``dw_e`` at rtol 1e-5 and an atol of 1e-6 ×
  ``dw_error_scale``. (On these inputs the forward and ``dxr``/``dxc`` came
  out bit-identical: no flip.)
- Control: each bf16 form misses its tolerance against the f32 form's
  result, so the rounding is really there.
"""

from __future__ import annotations

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import deeprank2_tpu.ops.block_sparse as jbs
from deeprank2_tpu.ops import blocked_edges as jbe
from deeprank2_tpu.ops import diag_spmm as jd
from deeprank2_tpu.ops import pallas_vanilla
from deeprank2_tpu_torch.ops import block_sparse as tbs
from deeprank2_tpu_torch.ops import blocked_edges as tbe
from deeprank2_tpu_torch.ops import diag_spmm as td
from deeprank2_tpu_torch.ops import vanilla as tv

BF16 = torch.bfloat16
FLIP = 2.0**-7  # one bf16 step, relative to the value (at most)
MODES = ("plain", "relu_mask", "relu_mask_pool")


@contextlib.contextmanager
def _interpreted_tpu_route():
    """JAX's dispatch sees a TPU and its Pallas kernels run interpreted."""
    old = pallas_vanilla._INTERPRET
    pallas_vanilla._INTERPRET = True
    try:
        with mock.patch.object(jax, "default_backend", lambda: "tpu"), pltpu.force_tpu_interpret_mode():
            yield
    finally:
        pallas_vanilla._INTERPRET = old


def _close(got, want, scale, what: str, rtol: float = 1e-5, atol: float = 1e-6) -> None:
    """|got - want| <= rtol |want| + atol × scale, entry by entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = rtol * np.abs(want) + atol * np.asarray(scale, np.float64)
    err = np.abs(got - want)
    worst = np.unravel_index(np.argmax(err - bound), err.shape)
    assert np.all(err <= bound), f"{what}: {got[worst]} vs {want[worst]}, error {err[worst]:.3e} > {bound[worst]:.3e}"


def _misses(got, want, scale, rtol: float = 1e-5, atol: float = 1e-6) -> bool:
    """The control: ``got`` lies outside :func:`_close`'s bound somewhere."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool(np.any(np.abs(got - want) > rtol * np.abs(want) + atol * np.asarray(scale, np.float64)))


def _adjacency(g, n, kind, seed):
    """A symmetric 0/1 (int8) or positive-weight (bf16) adjacency with masked,
    edgeless padding nodes, in both packages, its mask and features."""
    rng = np.random.default_rng(seed)
    edges = rng.random((g, n, n)) < 0.2
    edges = edges | edges.transpose(0, 2, 1)
    mask = np.ones((g, n), bool)
    for gi in range(g):
        mask[gi, n - int(rng.integers(0, n // 4)) :] = False
    edges &= mask[:, :, None] & mask[:, None, :]
    if kind == "int8":
        a = edges.astype(np.int8)
        adj_t, adj_j = torch.from_numpy(a), jnp.asarray(a)
    else:
        w = rng.uniform(0.5, 3.0, (g, n, n)).astype(np.float32)
        w = ((w + w.transpose(0, 2, 1)) * edges).astype(np.float32)
        adj_t, adj_j = torch.from_numpy(w).to(BF16), jnp.asarray(w, dtype=jnp.bfloat16)
    x = rng.normal(size=(38, g * n)).astype(np.float32)
    return adj_t, adj_j, mask, x


def _bf16(a: np.ndarray) -> torch.Tensor:
    """``a`` rounded to bf16, as f32."""
    return torch.from_numpy(a).to(BF16).float()


# ---------------------------------------------------------------------------
# K1 and K2


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_k1_bf16_form_matches_the_interpreted_kernel(kind, mode) -> None:
    g, n = jd.GS, 48
    adj_t, adj_j, mask, x = _adjacency(g, n, kind, seed=len(mode) + n)
    xt, mask_t = torch.from_numpy(x), torch.from_numpy(mask)
    with pltpu.force_tpu_interpret_mode():
        want = jd._diag_spmm_tpu(
            adj_j, jnp.asarray(x), None if mode == "plain" else jnp.asarray(mask), relu=mode != "plain", compute_dtype="bfloat16", pool=mode == "relu_mask_pool"
        )
    got = td.diag_kernel_ref(adj_t, xt, mask_t, mode, BF16)
    f32 = td.diag_kernel_ref(adj_t, xt, mask_t, mode)
    scale = td.diag_kernel_ref(adj_t, _bf16(x).abs())  # Σ|A||x_bf16| per entry
    if mode == "relu_mask_pool":
        (sign, pooled), (_, pooled32), (h_want, pool_want) = got, f32, want
        np.testing.assert_array_equal(sign.numpy().astype(bool), np.asarray(h_want).astype(np.float32) > 0)
        pool_scale = scale.reshape(38, g, n).sum(dim=2)
        _close(pooled, pool_want, pool_scale, "pooled")
        assert _misses(pooled32, pool_want, pool_scale)
    else:
        _close(got, want, scale, mode)
        assert _misses(f32, want, scale)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_k2_bf16_form_matches_the_interpreted_kernel(kind) -> None:
    g, n = jd.GS, 48
    adj_t, adj_j, mask, x = _adjacency(g, n, kind, seed=5)
    h = td.diag_kernel_ref(adj_t, torch.from_numpy(x), torch.from_numpy(mask), "relu_mask")
    sign = (h > 0).to(torch.uint8)
    g_pool = np.random.default_rng(6).normal(size=(38, g)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jd._diag_pool_bwd_tpu(adj_j, jnp.asarray(h.numpy()).astype(jnp.bfloat16), jnp.asarray(g_pool), compute_dtype="bfloat16")
    gp = torch.from_numpy(g_pool)
    scale = td.pool_bwd_kernel_ref(adj_t, sign, _bf16(g_pool).abs())
    _close(td.pool_bwd_kernel_ref(adj_t, sign, gp, BF16), want, scale, "K2")
    assert _misses(td.pool_bwd_kernel_ref(adj_t, sign, gp), want, scale)


def test_k1_k2_wrappers_run_the_bf16_form_on_the_cpu() -> None:
    """The wrappers take f32 or bf16 activations in the bf16 form, return f32,
    take their plain versions on the CPU (no launch counted), and refuse an
    f32 adjacency (no bf16 form: JAX sends it to XLA) and other types."""
    adj_t, _, mask, x = _adjacency(4, 32, "int8", seed=2)
    xt, mask_t = torch.from_numpy(x), torch.from_numpy(mask)
    td.reset_launches()
    for xin in (xt, xt.to(BF16)):
        out = td.diag_kernel(adj_t, xin, mask_t, "relu_mask", BF16)
        assert out.dtype == torch.float32
        torch.testing.assert_close(out, td.diag_kernel_ref(adj_t, xt, mask_t, "relu_mask", BF16), rtol=0, atol=0)
    sign, _ = td.diag_kernel(adj_t, xt, mask_t, "relu_mask_pool", BF16)
    gp = torch.randn(38, 4, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(td.pool_bwd_kernel(adj_t, sign, gp, BF16), td.pool_bwd_kernel_ref(adj_t, sign, gp, BF16), rtol=0, atol=0)
    assert not any(v for forms in td.launches_by_dtype.values() for v in forms.values())
    assert set(td.launches_by_dtype["diag_kernel"]) == {"int8/float32", "bfloat16/float32", "float32/float32", "int8/bfloat16", "bfloat16/bfloat16"}
    with pytest.raises(TypeError, match="int8 or bf16 adjacency"):
        td.diag_kernel(adj_t.float(), xt, compute_dtype=BF16)
    with pytest.raises(TypeError, match="x_t must be torch.float32 or torch.bfloat16"):
        td.diag_kernel(adj_t, xt.double(), compute_dtype=BF16)
    with pytest.raises(TypeError, match="x_t must be torch.float32, got"):
        td.diag_kernel(adj_t, xt.to(BF16))
    with pytest.raises(ValueError, match="compute_dtype"):
        td.diag_kernel(adj_t, xt, compute_dtype=torch.float16)


@pytest.mark.parametrize("layer", ["diag_spmm_t", "diag_layer_t", "diag_layer_pool_t"])
def test_diag_layers_in_bf16_match_jax_on_its_interpreted_route(layer) -> None:
    """Values and VJPs: the cotangent is rounded to bf16 in the kernel and the
    gradient is f32, in both packages."""
    g, n = jd.GS, 32
    adj_t, adj_j, mask, x = _adjacency(g, n, "int8", seed=9)
    cot = np.random.default_rng(10).normal(size=(38, g if layer == "diag_layer_pool_t" else g * n)).astype(np.float32)
    mask_j, mask_t = jnp.asarray(mask), torch.from_numpy(mask)
    jfn = {
        "diag_spmm_t": lambda v: jd.diag_spmm_t(adj_j, v, jnp.bfloat16),
        "diag_layer_t": lambda v: jd.diag_layer_t(adj_j, mask_j, v, jnp.bfloat16),
        "diag_layer_pool_t": lambda v: jd.diag_layer_pool_t(adj_j, mask_j, v, jnp.bfloat16),
    }[layer]
    with _interpreted_tpu_route():
        want, vjp = jax.vjp(jfn, jnp.asarray(x))
        (want_grad,) = jax.jit(vjp)(jnp.asarray(cot))
    targs = (adj_t,) if layer == "diag_spmm_t" else (adj_t, mask_t)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = getattr(td, layer)(*targs, xt, BF16)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(cot))
    assert grad.dtype == torch.float32 and np.asarray(want_grad).dtype == np.float32
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-6 * np.abs(np.asarray(want_grad)).max())


# ---------------------------------------------------------------------------
# K5


def _bcsr(storage):
    """A locality-ordered geometric graph on several column chunks, in both
    packages: unweighted (int8 blocks) or weighted (bf16 or f32 blocks)."""
    from deeprank2_tpu_torch.ops.synthetic import geometric_entry

    n = 900
    entry = geometric_entry(n, 4, 1, seed=n)
    order = tbs.locality_order(entry["pos"])
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    pairs = inv[entry["edge_index"]]
    if storage == "int8":
        return tbs.build_blocksparse(pairs, n, chunk_tiles=2, device="cpu"), jbs.build_blocksparse(pairs, n, chunk_tiles=2, to_device=False)
    weights = (np.abs(np.random.default_rng(1).normal(size=len(pairs))) + 0.1).astype(np.float32)
    tdt, jdt = (BF16, None) if storage == "bf16" else (torch.float32, np.float32)
    ours = tbs.build_blocksparse(pairs, n, chunk_tiles=2, weights=weights, weight_dtype=tdt, device="cpu")
    return ours, jbs.build_blocksparse(pairs, n, chunk_tiles=2, weights=weights, weight_dtype=jdt, to_device=False)


@pytest.mark.parametrize("storage", ["int8", "bf16", "f32"])
def test_k5_bf16_form_matches_the_interpreted_kernel(storage) -> None:
    """f32 blocks are rounded to bf16 in the bf16 form, as JAX's kernel casts
    them (``astype(compute_dtype)``)."""
    ours, theirs = _bcsr(storage)
    assert ours.num_chunks > 1
    x = np.random.default_rng(3).normal(size=(ours.padded_nodes, 32)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jbs._bcsr_spmm_tpu(
            *map(jnp.asarray, (theirs.blocks_t, theirs.block_col, theirs.batch_row, theirs.batch_chunk, theirs.visited, x)),
            num_tiles=theirs.num_tiles,
            num_chunks=theirs.num_chunks,
            block=theirs.block,
            precision=jax.lax.Precision.DEFAULT,
            chunk_tiles_cfg=theirs.chunk_tiles,
            compute_dtype="bfloat16",
        )
    want = np.asarray(want).T
    xt = torch.from_numpy(np.ascontiguousarray(x.T))
    rounded = dataclasses.replace(ours, blocks_t=ours.blocks_t.to(BF16).float().abs())
    scale = tbs.bcsr_spmm_kernel_ref(rounded, _bf16(x.T.copy()).abs())  # Σ|bf16(A)||bf16(x)|
    _close(tbs.bcsr_spmm_kernel_ref(ours, xt, BF16), want, scale, "K5")
    assert _misses(tbs.bcsr_spmm_kernel_ref(ours, xt), want, scale)
    if storage == "f32":  # the rounding of the blocks is there, beside that of x
        xr = _bf16(x.T.copy())
        assert _misses(tbs.bcsr_spmm_kernel_ref(ours, xr), want, scale)


def test_bcsr_spmm_in_bf16_matches_jax_on_its_interpreted_route() -> None:
    ours, theirs = _bcsr("int8")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, ours.padded_nodes)).astype(np.float32)
    cot = rng.normal(size=(16, ours.padded_rows)).astype(np.float32)
    with _interpreted_tpu_route():
        want, vjp = jax.vjp(lambda v: jbs.bcsr_spmm_t(theirs, v, compute_dtype=jnp.bfloat16), jnp.asarray(x))
        (want_grad,) = jax.jit(vjp)(jnp.asarray(cot))
    tbs.reset_launches()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tbs.bcsr_spmm_t(ours, xt, BF16)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(cot))
    assert tbs.launches == {"bcsr_spmm_kernel": 0}  # the CPU takes the plain version
    assert "int8/bfloat16" in tbs.launches_by_dtype["bcsr_spmm_kernel"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6 * np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-6 * np.abs(np.asarray(want_grad)).max())
    # the row-major form is the same op
    np.testing.assert_array_equal(tbs.bcsr_spmm(ours, torch.from_numpy(x.T.copy()), BF16).numpy(), out.detach().numpy().T)


# ---------------------------------------------------------------------------
# K6f and K6b


def _blocked(m, seed):
    rng = np.random.default_rng(seed)
    n = 700
    und = rng.integers(0, n, size=(5000, 2))
    und = und[und[:, 0] != und[:, 1]]
    eattr = rng.normal(size=(len(und), 6)).astype(np.float32)
    ours = tbe.build_blocked_edges(und, eattr, n, device="cpu")
    theirs = jbe.build_blocked_edges(und, eattr, n)
    v = ours.padded_nodes
    ops = [rng.normal(size=shape).astype(np.float32) for shape in ((v, m), (v, m), (6, m), (v, m))]
    return ours, theirs, ops


def _flip_close(got, want, flip_bound, what) -> None:
    """f32-order agreement except where a bf16 rounding flipped: at most
    0.1 % of the entries off it, each within ``flip_bound``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    off = err > 1e-5 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert off.mean() <= 1e-3, f"{what}: {int(off.sum())} of {off.size} entries off the f32-order bound"
    assert np.all(err[off] <= np.asarray(flip_bound, np.float64)[off]), what


@pytest.mark.parametrize("m", [12, 32])
def test_k6_bf16_forms_match_the_interpreted_kernels(m) -> None:
    ours, theirs, (xr, xc, w_e, g) = _blocked(m, seed=m)
    with _interpreted_tpu_route():
        out, vjp = jax.vjp(lambda a, b, c: pallas_vanilla.blocked_message_sum_tpu(theirs, a, b, c, compute_dtype=jnp.bfloat16), *map(jnp.asarray, (xr, xc, w_e)))
        want_grads = jax.jit(vjp)(jnp.asarray(g))
    ops = [torch.from_numpy(a) for a in (xr, xc, w_e, g)]
    fwd = tv.blocked_fwd_kernel_ref(ours, *ops[:3], BF16)
    # a flipped message rounding moves an output by at most 2^-7 of its sum of messages, the output itself
    _flip_close(fwd, out, FLIP * np.abs(np.asarray(out)), "K6f")
    assert _misses(tv.blocked_fwd_kernel_ref(ours, *ops[:3]), out, np.abs(np.asarray(out)).max(), atol=1e-5)
    dxr, dxc, dw_e = tv.blocked_bwd_kernel_ref(ours, *ops, BF16)
    # a flipped relu' moves a gradient entry by one bf16(g) entry
    gmax = np.abs(g).max() * (1 + FLIP)
    for name, got, want in (("dxr", dxr, want_grads[0]), ("dxc", dxc, want_grads[1])):
        _flip_close(got, want, np.full(np.shape(want), gmax), name)
    scale = tv.dw_error_scale(ours, ops[3], BF16)
    _close(dw_e, want_grads[2], scale, "dw_e")
    f32 = tv.blocked_bwd_kernel_ref(ours, *ops)
    assert _misses(f32[0], want_grads[0], np.abs(np.asarray(want_grads[0])).max(), atol=1e-5)
    assert _misses(f32[2], want_grads[2], scale)


def test_k6_wrappers_run_the_bf16_form_on_the_cpu() -> None:
    ours, _, (xr, xc, w_e, g) = _blocked(8, seed=1)
    ops = [torch.from_numpy(a) for a in (xr, xc, w_e, g)]
    tv.reset_launches()
    out = tbe.blocked_message_sum(ours, *[t.requires_grad_(True) for t in ops[:3]], compute_dtype=BF16)
    grads = torch.autograd.grad(out, ops[:3], ops[3])
    assert tv.launches == {"blocked_fwd_kernel": 0, "blocked_bwd_kernel": 0}
    assert set(tv.launches_by_dtype["blocked_bwd_kernel"]) == {"float32", "bfloat16"}
    torch.testing.assert_close(out, tv.blocked_fwd_kernel_ref(ours, *ops[:3], BF16), rtol=0, atol=0)
    for got, want in zip(grads, tv.blocked_bwd_kernel_ref(ours, *[t.detach() for t in ops], BF16)):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # bf16 operands are taken as they are
    bf = [t.detach().to(BF16) for t in ops]
    torch.testing.assert_close(tv.blocked_fwd_kernel(ours, *bf[:3], BF16), out.detach(), rtol=0, atol=0)
    with pytest.raises(TypeError, match="xr must be torch.float32, got"):
        tv.blocked_fwd_kernel(ours, *bf[:3])
