"""The port's blocked per-edge-feature message passing
(deeprank2_tpu_torch.ops.blocked_edges and ops.vanilla) against the JAX
package's on the CPU: build_blocked_edges array for array, exactly; the plain
versions of kernels K6f and K6b against ``blocked_message_sum_xla`` (outputs
at rtol=atol=1e-5, the JAX test's; gradients at rtol=atol=1e-4, the JAX
gradient test's) and against the Pallas kernels in interpret mode (the
forward at atol 1e-4 and the backward at atol 1e-3, the JAX interpret test's
tolerances for its bf16 hi/lo split); ``tiled_graph_mean_pool_rows``; the
CUDA kernels' destination-ordered stream (``edge_src``, ``edge_feat``) and
their summation order as a float32 loop (``blocked_order_ref``)."""

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
from deeprank2_tpu_torch.ops.batch import collate_graphs_blocked
from deeprank2_tpu_torch.ops.pooling import tiled_graph_mean_pool_rows
from deeprank2_tpu_torch.ops.synthetic import geometric_entry

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


def _ragged_structure(pad_slabs=None):
    """The blocked collate of graphs of 700 and 1,300 nodes, one of 200
    without edges and an empty padding graph."""
    entries = [geometric_entry(700, 4, 6, seed=1), geometric_entry(1300, 4, 6, seed=2), geometric_entry(200, 4, 6, seed=3)]
    entries[2]["edge_index"] = entries[2]["edge_index"][:0]
    entries[2]["edge_attr"] = entries[2]["edge_attr"][:0]
    return collate_graphs_blocked(entries, pad_graphs=4, pad_slabs=pad_slabs, device="cpu")[0].structure


STREAM_CASES = [*sorted(CASES), "ragged", "ragged_pad_slabs"]


def _stream_structure(case):
    if case.startswith("ragged"):
        return _ragged_structure((lambda req: req + 3) if case == "ragged_pad_slabs" else None)
    return _build_both(case)[0]


def _assert_stream_is_the_listed_edges(st) -> None:
    order = st.edge_order.long()
    _, gcol = tbe.global_indices(st)
    fe, fe_pad = st.edge_dim, st.eattr_t.shape[0]
    assert st.edge_src.dtype == torch.int32 and st.edge_feat.dtype == torch.float32
    assert st.edge_src.is_contiguous() and st.edge_feat.is_contiguous()
    assert tuple(st.edge_feat.shape) == (order.numel(), fe_pad) and st.edge_src.shape == order.shape
    torch.testing.assert_close(st.edge_src.long(), gcol[order], rtol=0, atol=0)
    torch.testing.assert_close(st.edge_feat[:, :fe], st.eattr_t[:fe, order].T, rtol=0, atol=0)
    assert not st.edge_feat[:, fe:].any()


@pytest.mark.parametrize("case", STREAM_CASES)
def test_stream_holds_each_listed_edge_source_and_features(case) -> None:
    """edge_src and edge_feat are the gathers through edge_order of the
    slots' global source nodes and features (zero pad channels), before and
    after ``.to()``."""
    st = _stream_structure(case)
    _assert_stream_is_the_listed_edges(st)
    moved = st.to("cpu")
    _assert_stream_is_the_listed_edges(moved)
    assert torch.equal(moved.edge_src, st.edge_src) and torch.equal(moved.edge_feat, st.edge_feat)
    if case == "no_edges":
        assert st.edge_src.numel() == 0 and st.edge_feat.shape == (0, 8)
    if case.startswith("ragged"):
        ptr = st.row_ptr.long()
        assert (ptr[1:] == ptr[:-1]).any() and st.edge_src.numel() > 0  # edgeless nodes and real edges


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("m", [12, 32, 5])
@pytest.mark.parametrize("case", ["ragged", "pad_slabs_int", "no_edges"])
def test_order_loop_is_the_plain_version_in_slot_order(case, m, compute_dtype) -> None:
    """blocked_order_ref, the kernels' order as a float32 loop, against the
    plain versions (which add in index_add's order: rtol=atol=1e-5) and, for
    the first nodes, bit for bit against one add at a time in ascending slot
    order."""
    st = _stream_structure(case)
    xr, xc, w_e, g = _t(*_operands(st, m, seed=m))
    out, dxr, dxc = tv.blocked_order_ref(st, xr, xc, w_e, g, compute_dtype)
    torch.testing.assert_close(out, tv.blocked_fwd_kernel_ref(st, xr, xc, w_e, compute_dtype), **TOL)
    for got, want in zip((dxr, dxc), tv.blocked_bwd_kernel_ref(st, xr, xc, w_e, g, compute_dtype)):
        torch.testing.assert_close(got, want, **TOL)
    (out_only,) = tv.blocked_order_ref(st, xr, xc, w_e, compute_dtype=compute_dtype)
    torch.testing.assert_close(out_only, out, rtol=0, atol=0)
    act = tv.activation_dtype(compute_dtype)
    xr, xc, g = (tv.round_to(t, act) for t in (xr, xc, g))
    ew = tbe.edge_term(st.edge_feat[:, : st.edge_dim].T, w_e, act)
    ptr, src = st.row_ptr.tolist(), st.edge_src.tolist()
    for v in range(0, st.padded_nodes, 97):
        acc = [torch.zeros(m) for _ in range(3)]
        for i in range(ptr[v], ptr[v + 1]):
            c = src[i]
            pre = xr[v] + xc[c] + ew[i]
            acc[0] = acc[0] + tv.round_to(torch.relu(pre), act)
            acc[1] = acc[1] + torch.where(pre > 0, g[v], 0.0)
            acc[2] = acc[2] + torch.where(xr[c] + xc[v] + ew[i] > 0, g[c], 0.0)
        for got, want in zip((out, dxr, dxc), acc):
            torch.testing.assert_close(got[v], want, rtol=0, atol=0)
    if case == "no_edges":
        assert not out.any() and not dxr.any() and not dxc.any()


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
    assert torch.equal(moved.edge_src, ours.edge_src) and torch.equal(moved.edge_feat, ours.edge_feat)


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
