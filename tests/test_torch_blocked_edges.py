"""The port's blocked per-edge-feature message passing
(deeprank2_tpu_torch.ops.blocked_edges and ops.vanilla) against the JAX
package's on the CPU: build_blocked_edges array for array, exactly; the plain
versions of kernels K6f and K6b against ``blocked_message_sum_xla`` (outputs
at rtol=atol=1e-5, the JAX test's; gradients at rtol=atol=1e-4, the JAX
gradient test's) and against the Pallas kernels in interpret mode (the
forward at atol 1e-4 and the backward at atol 1e-3, the JAX interpret test's
tolerances for its bf16 hi/lo split); ``tiled_graph_mean_pool_rows``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeprank2_tpu.ops.blocked_edges as jbe
from deeprank2_tpu.ops import pallas_vanilla
from deeprank2_tpu.ops.pooling import tiled_graph_mean_pool_rows as jax_tiled_graph_mean_pool_rows
from deeprank2_tpu_torch.ops import blocked_edges as tbe
from deeprank2_tpu_torch.ops import vanilla as tv
from deeprank2_tpu_torch.ops.pooling import tiled_graph_mean_pool_rows

TOL = {"rtol": 1e-5, "atol": 1e-5}
GRAD_TOL = {"rtol": 1e-4, "atol": 1e-4}
JAX_FIELDS = ("row_local", "col_local", "eattr_t", "step_row", "sub_col", "out_visited")

# (nodes, undirected pairs, pad_slabs): one tile; several row tiles; slab
# capacity as an int above the requirement and as a callable; no edges
CASES = {
    "one_tile": (200, 1000, None),
    "row_tiles": (1000, 8000, None),
    "pad_slabs_int": (700, 5000, "req+3"),
    "pad_slabs_callable": (700, 5000, lambda req: req + 2),
    "no_edges": (100, 0, None),
}


def _random_graph(num_nodes: int, num_pairs: int, fe: int = 6, seed: int = 0):
    rng = np.random.default_rng(seed)
    und = rng.integers(0, num_nodes, size=(num_pairs, 2))
    und = und[und[:, 0] != und[:, 1]]
    return und, rng.normal(size=(len(und), fe)).astype(np.float32)


def _build_both(case):
    n, pairs, pad = CASES[case]
    und, eattr = _random_graph(n, pairs)
    if pad == "req+3":
        pad = jbe.required_slabs(und, n) + 3
    ours = tbe.build_blocked_edges(und, eattr, n, pad_slabs=pad, device="cpu")
    theirs = jbe.build_blocked_edges(und, eattr, n, pad_slabs=pad, to_device=False)
    return ours, theirs, und, eattr


def _operands(structure, m, seed=1):
    rng = np.random.default_rng(seed)
    v = structure.padded_nodes
    return [rng.normal(size=shape).astype(np.float32) for shape in ((v, m), (v, m), (structure.edge_dim, m), (v, m))]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_matches_jax_array_for_array(case) -> None:
    ours, theirs, und, _ = _build_both(case)
    for field in JAX_FIELDS:
        got, want = getattr(ours, field), np.asarray(getattr(theirs, field))
        assert got.device == torch.device("cpu") and got.is_contiguous(), field
        assert got.numpy().dtype == want.dtype, field
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    assert (ours.num_node_tiles, ours.edge_dim, ours.padded_nodes, ours.num_slabs) == (
        theirs.num_node_tiles,
        theirs.edge_dim,
        theirs.padded_nodes,
        theirs.num_slabs,
    )
    assert tbe.required_slabs(und, CASES[case][0]) == jbe.required_slabs(und, CASES[case][0])
    if case.startswith("pad_slabs"):
        assert ours.num_slabs > tbe.required_slabs(und, CASES[case][0])
    if case == "row_tiles":
        assert ours.num_node_tiles > 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_index_lists_each_real_edge_once_by_row(case) -> None:
    ours, theirs, und, _ = _build_both(case)
    ptr, order = ours.row_ptr.numpy(), ours.edge_order.numpy()
    real = np.flatnonzero(ours.row_local.numpy() < tbe.EDGE_TILE)
    np.testing.assert_array_equal(np.sort(order), real)
    assert len(order) == 2 * len(und) and ptr[0] == 0 and ptr[-1] == len(order) and len(ptr) == ours.padded_nodes + 1
    grow, _ = jbe.global_indices(theirs)
    grow = np.asarray(grow)
    for v in range(0, ours.padded_nodes, 7):
        mine = order[ptr[v] : ptr[v + 1]]
        assert (grow[mine] == v).all()
        assert (np.diff(mine) > 0).all()


def test_global_indices_match_jax() -> None:
    ours, theirs, _, _ = _build_both("pad_slabs_int")
    for got, want in zip(tbe.global_indices(ours), jbe.global_indices(theirs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_build_rejects_bad_input() -> None:
    und, eattr = _random_graph(200, 1000)
    with pytest.raises(ValueError, match="pad_slabs"):
        tbe.build_blocked_edges(und, eattr, 200, pad_slabs=tbe.required_slabs(und, 200) - 1, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        tbe.build_blocked_edges(np.array([[0, 10]]), np.ones((1, 6), np.float32), 10, device="cpu")


@pytest.mark.parametrize("m", [12, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_matches_blocked_message_sum_xla(case, m) -> None:
    ours, theirs, _, _ = _build_both(case)
    xr, xc, w_e, _ = _operands(ours, m)
    want = np.asarray(jbe.blocked_message_sum_xla(theirs, jnp.asarray(xr), jnp.asarray(xc), jnp.asarray(w_e)))
    tv.reset_launches()
    for fn in (tbe.blocked_message_sum_ref, tv.blocked_fwd_kernel, tbe.blocked_message_sum):
        got = fn(ours, *_t(xr, xc, w_e))
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL, err_msg=fn.__name__)
    assert tv.launches == {"blocked_fwd_kernel": 0, "blocked_bwd_kernel": 0}  # the CPU takes the plain versions
    if case == "no_edges":
        assert not got.any()


@pytest.mark.parametrize("m", [12, 32])
@pytest.mark.parametrize("case", ["row_tiles", "pad_slabs_int", "no_edges"])
def test_gradients_match_jax(case, m) -> None:
    """Autograd through the plain version, the autograd Function (backward:
    blocked_bwd_kernel, its plain version on the CPU) and blocked_bwd_kernel_ref
    directly, against jax.vjp of blocked_message_sum_xla."""
    ours, theirs, _, _ = _build_both(case)
    xr, xc, w_e, g = _operands(ours, m, seed=3)
    _, vjp = jax.vjp(lambda a, b, c: jbe.blocked_message_sum_xla(theirs, a, b, c), *map(jnp.asarray, (xr, xc, w_e)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    for fn in (tbe.blocked_message_sum_ref, tbe.blocked_message_sum):
        args = [t.requires_grad_(True) for t in _t(xr, xc, w_e)]
        grads = torch.autograd.grad(fn(ours, *args), args, torch.from_numpy(g))
        for name, got, w in zip(("dxr", "dxc", "dw_e"), grads, want):
            np.testing.assert_allclose(got.numpy(), w, **GRAD_TOL, err_msg=f"{fn.__name__} {name}")
    for name, got, w in zip(("dxr", "dxc", "dw_e"), tv.blocked_bwd_kernel_ref(ours, *_t(xr, xc, w_e, g)), want):
        np.testing.assert_allclose(got.numpy(), w, **GRAD_TOL, err_msg=f"blocked_bwd_kernel_ref {name}")
    if case == "no_edges":
        assert not any(np.any(w) for w in want)


def test_capacity_pads_change_nothing() -> None:
    base, _, _, _ = _build_both("pad_slabs_int")
    und, eattr = _random_graph(*CASES["pad_slabs_int"][:2])
    tight = tbe.build_blocked_edges(und, eattr, CASES["pad_slabs_int"][0], device="cpu")
    assert base.num_slabs > tight.num_slabs
    xr, xc, w_e, g = _t(*_operands(base, 8))
    torch.testing.assert_close(tv.blocked_fwd_kernel_ref(base, xr, xc, w_e), tv.blocked_fwd_kernel_ref(tight, xr, xc, w_e), rtol=0, atol=0)
    (dxr, dxc, dw_e), (dxr_t, dxc_t, dw_e_t) = tv.blocked_bwd_kernel_ref(base, xr, xc, w_e, g), tv.blocked_bwd_kernel_ref(tight, xr, xc, w_e, g)
    torch.testing.assert_close(dxr, dxr_t, rtol=0, atol=0)
    torch.testing.assert_close(dxc, dxc_t, rtol=0, atol=0)
    # dw_e sums 10k products in one matrix product, blocked by its length
    torch.testing.assert_close(dw_e, dw_e_t, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m", [12, 32])
def test_plain_versions_match_the_pallas_kernels_in_interpret_mode(m) -> None:
    und, eattr = _random_graph(700, 5000)
    ours = tbe.build_blocked_edges(und, eattr, 700, device="cpu")
    theirs = jbe.build_blocked_edges(und, eattr, 700)
    xr, xc, w_e, g = _operands(ours, m, seed=7)
    old = pallas_vanilla._INTERPRET
    pallas_vanilla._INTERPRET = True
    try:
        out, vjp = jax.vjp(lambda a, b, c: pallas_vanilla.blocked_message_sum_tpu(theirs, a, b, c), *map(jnp.asarray, (xr, xc, w_e)))
        want_grads = vjp(jnp.asarray(g))
    finally:
        pallas_vanilla._INTERPRET = old
    np.testing.assert_allclose(tv.blocked_fwd_kernel_ref(ours, *_t(xr, xc, w_e)).numpy(), np.asarray(out), rtol=1e-5, atol=1e-4)
    for name, got, want in zip(("dxr", "dxc", "dw_e"), tv.blocked_bwd_kernel_ref(ours, *_t(xr, xc, w_e, g)), want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3, err_msg=name)


def test_edge_term_rounds_in_channel_order() -> None:
    """The plain versions' e_attr · w_e is the channel-ordered sum that the
    CUDA kernels compute, and agrees with a matrix product to rounding."""
    rng = np.random.default_rng(5)
    ea = torch.from_numpy(rng.normal(size=(6, 300)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(6, 12)).astype(np.float32))
    want = torch.zeros(300, 12)
    for k in range(6):
        want = want + ea[k][:, None] * w[k]
    torch.testing.assert_close(tbe.edge_term(ea, w), want, rtol=0, atol=0)
    torch.testing.assert_close(tbe.edge_term(ea, w), ea.T @ w, rtol=1e-5, atol=1e-5)


def test_wrappers_check_their_operands() -> None:
    ours, _, _, _ = _build_both("one_tile")
    xr, xc, w_e, g = _t(*_operands(ours, 8))
    with pytest.raises(TypeError, match="float32"):
        tv.blocked_fwd_kernel(ours, xr.double(), xc, w_e)
    with pytest.raises(ValueError, match="shape"):
        tv.blocked_fwd_kernel(ours, xr, xc[:, :4].contiguous(), w_e)
    with pytest.raises(ValueError, match="contiguous"):
        tv.blocked_bwd_kernel(ours, xr, xc, w_e, torch.zeros(8, ours.padded_nodes).T)
    with pytest.raises(ValueError, match="is on"):
        tv.blocked_fwd_kernel(ours, xr.to("meta"), xc.to("meta"), w_e.to("meta"))
    with pytest.raises(ValueError, match="rows"):
        tbe.blocked_message_sum(ours, xr[:-1], xc, w_e)
    with pytest.raises(ValueError, match="edge channels"):
        tbe.blocked_message_sum(ours, xr, xc, w_e[:-1])
    with pytest.raises(ValueError, match="compute_dtype"):
        tbe.blocked_message_sum(ours, xr, xc, w_e, compute_dtype=torch.float16)
    for cd in (torch.float32, torch.bfloat16):
        assert tbe.blocked_message_sum(ours, xr, xc, w_e, compute_dtype=cd).shape == xr.shape
    moved = ours.to("cpu")
    assert moved.edge_dim == ours.edge_dim and torch.equal(moved.edge_order, ours.edge_order)


def test_tiled_graph_mean_pool_rows_matches_jax() -> None:
    rng = np.random.default_rng(3)
    nt, block, num_graphs = 6, 256, 4
    # graphs own whole tiles; padded rows inside tiles and a padding tile
    node_graph = np.repeat(np.array([0, 1, 1, 2, 2, 4]), block).astype(np.int32)
    node_mask = (rng.uniform(size=nt * block) > 0.2) & (node_graph < num_graphs)
    node_graph = np.where(node_mask, node_graph, num_graphs).astype(np.int32)
    x = (rng.normal(size=(nt * block, 13)) * node_mask[:, None]).astype(np.float32)
    want = np.asarray(jax_tiled_graph_mean_pool_rows(jnp.asarray(x), jnp.asarray(node_graph), jnp.asarray(node_mask), num_graphs, block))
    got = tiled_graph_mean_pool_rows(*_t(x, node_graph, node_mask), num_graphs, block)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[3].any()  # a graph with no node pools to 0
