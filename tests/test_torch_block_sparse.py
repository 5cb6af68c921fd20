"""The port's BCSR SpMM (deeprank2_tpu_torch.ops.block_sparse) against the JAX
package's on the CPU: the atomic-scale generators and build_blocksparse array for
array, exactly; the plain version of kernel K5 against ``bcsr_spmm_xla`` at
rtol=atol=1e-5 (both f32, only the summation order differs) and against the
Pallas kernel in interpret mode at atol 1e-4 (the JAX test's tolerance for
its bf16 hi/lo split); the SpMM's gradient against the dense ``Aᵀ g``; and
``tiled_graph_mean_pool``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import deeprank2_tpu.ops.block_sparse as jbs
from deeprank2_tpu.ops.pooling import tiled_graph_mean_pool as jax_tiled_graph_mean_pool
from deeprank2_tpu_torch.ops import block_sparse as tbs
from deeprank2_tpu_torch.ops.pooling import tiled_graph_mean_pool
from deeprank2_tpu_torch.ops.synthetic import clustered_entry, geometric_entry
from tests.perf.blocksparse_perf import geometric_entry as jax_geometric_entry
from tests.perf.clustered_bcsr_perf import clustered_entry as jax_clustered_entry

TOL = {"rtol": 1e-5, "atol": 1e-5}
JAX_FIELDS = ("blocks_t", "block_row", "block_col", "batch_row", "batch_chunk", "visited")
STATIC = ("num_tiles", "num_chunks", "block", "num_row_tiles", "symmetric", "kbatch", "super_batches", "chunk_tiles")


def _pairs(n, seed):
    """The undirected pairs of a geometric graph, in locality order."""
    entry = geometric_entry(n, 4, 1, seed=seed)
    order = tbs.locality_order(entry["pos"])
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    return inv[entry["edge_index"]]


def _dense_adj(pairs, n):
    adj = np.zeros((n, n), np.float32)
    adj[pairs[:, 0], pairs[:, 1]] = 1.0
    adj[pairs[:, 1], pairs[:, 0]] = 1.0
    return adj


# (nodes, chunk_tiles, kbatch, super_batches): one chunk; several chunks with
# trailing capacity-pad batches routed into the last chunk; an odd node count
CASES = {
    "one_chunk": (1500, None, None, None),
    "chunks": (3000, 2, None, None),
    "chunks_trailing_pads": (2200, 3, 8, 3),
}


@pytest.mark.parametrize("n", [300, 2500])
def test_atomic_generators_match_jax(n) -> None:
    for ours, theirs in ((geometric_entry(n, 7, 3, seed=4), jax_geometric_entry(n, 7, 3, seed=4)), (clustered_entry(n, seed=5), jax_clustered_entry(n, seed=5))):
        assert ours.keys() == theirs.keys()
        for key in ours:
            got, want = np.asarray(ours[key]), np.asarray(theirs[key])
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)


def _build_both(n, chunk_tiles, kbatch, super_batches, pairs=None):
    pairs = _pairs(n, seed=n) if pairs is None else pairs
    kw = {"chunk_tiles": chunk_tiles, "kbatch": kbatch, "super_batches": super_batches}
    return tbs.build_blocksparse(pairs, n, device="cpu", **kw), jbs.build_blocksparse(pairs, n, to_device=False, **kw), pairs


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_matches_jax_array_for_array(case) -> None:
    n, chunk_tiles, kbatch, super_batches = CASES[case]
    ours, theirs, _ = _build_both(n, chunk_tiles, kbatch, super_batches)
    for field in JAX_FIELDS:
        got, want = getattr(ours, field), np.asarray(getattr(theirs, field))
        assert got.device == torch.device("cpu") and got.is_contiguous(), field
        assert got.numpy().dtype == want.dtype, field
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    for field in STATIC:
        assert getattr(ours, field) == getattr(theirs, field), field
    if case != "one_chunk":
        assert ours.num_chunks > 1
    # trailing capacity-pad blocks point into their routed chunk
    local = ours.block_col.numpy() - np.repeat(ours.batch_chunk.numpy(), ours.kbatch) * ours.chunk_tiles
    assert (local >= 0).all() and (local < ours.chunk_tiles).all()
    if case == "chunks_trailing_pads":
        # the runs, each padded to a kbatch multiple, end before the capacity
        ids = np.flatnonzero(ours.blocks_t.numpy().any(axis=(1, 2)))
        run = np.repeat(ours.batch_chunk.numpy(), ours.kbatch)[ids] * ours.num_row_tiles + ours.block_row.numpy()[ids]
        run_blocks = (-(-np.unique(run, return_counts=True)[1] // ours.kbatch) * ours.kbatch).sum()
        assert ours.num_blocks > run_blocks, "expected trailing capacity-pad blocks"


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_index_lists_each_nonzero_block_once_by_row(case) -> None:
    ours, _, _ = _build_both(*CASES[case])
    ptr, ids = ours.tile_ptr.numpy(), ours.tile_blocks.numpy()
    nonzero = np.flatnonzero(ours.blocks_t.numpy().any(axis=(1, 2)))
    np.testing.assert_array_equal(np.sort(ids), nonzero)
    assert ptr[0] == 0 and ptr[-1] == len(ids) and (np.diff(ptr) >= 0).all()
    rows = ours.block_row.numpy()
    for r in range(ours.num_row_tiles):
        mine = ids[ptr[r] : ptr[r + 1]]
        assert (rows[mine] == r).all()
        np.testing.assert_array_equal(mine, np.sort(mine))


def test_empty_graph_structure() -> None:
    ours, theirs, _ = _build_both(10, None, None, None, pairs=np.zeros((0, 2), np.int64))
    for field in JAX_FIELDS:
        np.testing.assert_array_equal(getattr(ours, field).numpy(), np.asarray(getattr(theirs, field)), err_msg=field)
    assert ours.tile_blocks.numel() == 0 and not ours.tile_ptr.any()
    out = tbs.bcsr_spmm_kernel(ours, torch.ones(4, ours.padded_nodes))
    assert out.shape == (4, 128) and not out.any()


def test_build_rejects_out_of_range_pairs() -> None:
    with pytest.raises(ValueError, match="out of range"):
        tbs.build_blocksparse(np.array([[0, 10]]), 10, device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("feat", [19, 64])
def test_plain_version_matches_bcsr_spmm_xla(case, feat) -> None:
    ours, theirs, pairs = _build_both(*CASES[case])
    x = np.random.default_rng(feat).normal(size=(ours.padded_nodes, feat)).astype(np.float32)
    want = np.asarray(jbs.bcsr_spmm_xla(theirs, jnp.asarray(x)))
    tbs.reset_launches()
    got = tbs.bcsr_spmm_kernel(ours, torch.from_numpy(np.ascontiguousarray(x.T)))
    assert tbs.launches == {"bcsr_spmm_kernel": 0}  # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy().T, want, **TOL)
    np.testing.assert_allclose(got.numpy().T, _dense_adj(pairs, ours.padded_nodes) @ x, **TOL)


# F=19 on one chunk; F=64 on several chunks, with capacity-pad batches
@pytest.mark.parametrize(("n", "chunk_tiles", "feat"), [(600, None, 19), (900, 2, 64)])
def test_plain_version_matches_the_pallas_kernel_in_interpret_mode(n, chunk_tiles, feat) -> None:
    ours, theirs, _ = _build_both(n, chunk_tiles, None, None)
    x = np.random.default_rng(n).normal(size=(ours.padded_nodes, feat)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            jbs._bcsr_spmm_tpu(
                theirs.blocks_t,
                theirs.block_col,
                theirs.batch_row,
                theirs.batch_chunk,
                theirs.visited,
                jnp.asarray(x),
                num_tiles=theirs.num_tiles,
                num_chunks=theirs.num_chunks,
                block=theirs.block,
                precision=jax.lax.Precision.HIGHEST,
                chunk_tiles_cfg=theirs.chunk_tiles,
            )
        )
    got = tbs.bcsr_spmm_kernel(ours, torch.from_numpy(np.ascontiguousarray(x.T)))
    np.testing.assert_allclose(got.numpy().T, want, atol=1e-4)


@pytest.mark.parametrize("layout", ["transposed", "rows"])
def test_gradient_is_the_spmm_of_the_cotangent(layout) -> None:
    ours, _, pairs = _build_both(*CASES["chunks"])
    rng = np.random.default_rng(2)
    x = rng.normal(size=(ours.padded_nodes, 8)).astype(np.float32)
    g = rng.normal(size=(ours.padded_nodes, 8)).astype(np.float32)
    adj = _dense_adj(pairs, ours.padded_nodes)
    if layout == "transposed":
        xt = torch.from_numpy(np.ascontiguousarray(x.T)).requires_grad_(True)
        out = tbs.bcsr_spmm_t(ours, xt)
        (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(np.ascontiguousarray(g.T)))
        got_out, got_grad = out.detach().numpy().T, grad.numpy().T
    else:
        xr = torch.from_numpy(x).requires_grad_(True)
        out = tbs.bcsr_spmm(ours, xr)
        (grad,) = torch.autograd.grad(out, xr, torch.from_numpy(g))
        got_out, got_grad = out.detach().numpy(), grad.numpy()
    np.testing.assert_allclose(got_out, adj @ x, **TOL)
    np.testing.assert_allclose(got_grad, adj.T @ g, **TOL)
    # the plain version's own autograd agrees
    xt = torch.from_numpy(np.ascontiguousarray(x.T)).requires_grad_(True)
    (grad_ref,) = torch.autograd.grad(tbs.bcsr_spmm_t_ref(ours, xt), xt, torch.from_numpy(np.ascontiguousarray(g.T)))
    np.testing.assert_allclose(grad_ref.numpy().T, adj.T @ g, **TOL)


def test_wrapper_checks_its_operands() -> None:
    ours, _, _ = _build_both(300, None, None, None)
    with pytest.raises(ValueError, match="expects"):
        tbs.bcsr_spmm_t(ours, torch.zeros(4, ours.padded_nodes + 128))
    with pytest.raises(TypeError, match="float32"):
        tbs.bcsr_spmm_kernel(ours, torch.zeros(4, ours.padded_nodes, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tbs.bcsr_spmm_kernel(ours, torch.zeros(ours.padded_nodes, 4).T)
    with pytest.raises(ValueError, match="is on"):
        tbs.bcsr_spmm_kernel(ours, torch.zeros(4, ours.padded_nodes, device="meta"))
    assert ours.to("cpu").tile_ptr.equal(ours.tile_ptr)


def test_tiled_graph_mean_pool_matches_jax() -> None:
    rng = np.random.default_rng(3)
    nt, block, num_graphs = 7, 128, 4
    # graphs own whole tiles; padded rows inside tiles and a padding tile
    node_graph = np.repeat(np.array([0, 0, 1, 2, 2, 2, 4]), block).astype(np.int32)
    node_mask = (rng.uniform(size=nt * block) > 0.2) & (node_graph < num_graphs)
    node_graph = np.where(node_mask, node_graph, num_graphs).astype(np.int32)
    h_t = (rng.normal(size=(13, nt * block)) * node_mask).astype(np.float32)
    want = np.asarray(jax_tiled_graph_mean_pool(jnp.asarray(h_t), jnp.asarray(node_graph), jnp.asarray(node_mask), num_graphs, block))
    got = tiled_graph_mean_pool(torch.from_numpy(h_t), torch.from_numpy(node_graph), torch.from_numpy(node_mask), num_graphs, block)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[3].any()  # a graph with no node pools to 0
