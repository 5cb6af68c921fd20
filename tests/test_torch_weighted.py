"""The weighted kernel forms of the port against the JAX package's on the CPU:
``build_blocksparse(weights=...)`` and both weighted collates
(``collate_graphs_blocksparse_clustered`` and ``collate_graphs_diag_clustered``
with ``with_edge_weights=True``) array for array, bit for bit, in bf16 and in
f32 storage, on graphs with duplicate pairs and a self-loop; the plain
versions of K5 on bf16 and f32 blocks and of K1/K2 on bf16 and f32
adjacencies against the JAX XLA oracles at rtol=atol=1e-5 (both f32 on the
same exact weights, only the summation order differs), and against the
interpreted Pallas kernels at the tolerances of the port's unweighted tests
(their bf16 hi/lo split of x)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import deeprank2_tpu.ops.block_sparse as jbs
from deeprank2_tpu.ops import batch as jbatch
from deeprank2_tpu.ops import diag_spmm as jd
from deeprank2_tpu_torch.ops import batch as tbatch
from deeprank2_tpu_torch.ops import block_sparse as tbs
from deeprank2_tpu_torch.ops import diag_spmm as td
from deeprank2_tpu_torch.ops.synthetic import clustered_entry, geometric_entry, ppi_clustered_entries

TOL = {"rtol": 1e-5, "atol": 1e-5}
# storage type in the port, and in the JAX package (None: its bf16 default)
STORAGE = {"bf16": (torch.bfloat16, None), "f32": (torch.float32, np.float32)}
STRUCTURE_FIELDS = ("blocks_t", "block_row", "block_col", "batch_row", "batch_chunk", "visited")


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy, bf16 as ``ml_dtypes.bfloat16`` (the JAX arrays' type)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _assert_bits_equal(got: torch.Tensor, want, what: str) -> None:
    got, want = _numpy(got), np.asarray(want)
    assert got.dtype == want.dtype, what
    assert got.shape == want.shape, what
    if want.dtype == ml_dtypes.bfloat16:
        got, want = got.view(np.uint16), want.view(np.uint16)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _weighted_pairs(n, seed):
    """Locality-ordered geometric pairs with duplicate pairs (some reversed)
    and one self-loop, and a positive weight per pair, distributed as
    ``clustered_entry``'s edge attributes (``|N(0, 1)| + 0.1``)."""
    entry = geometric_entry(n, 4, 1, seed=seed)
    order = tbs.locality_order(entry["pos"])
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    pairs = inv[entry["edge_index"]]
    pairs = np.concatenate([pairs, pairs[:40], pairs[40:60, ::-1], [[7, 7]]])
    weights = (np.abs(np.random.default_rng(seed).normal(size=len(pairs))) + 0.1).astype(np.float32)
    return pairs, weights


# (nodes, chunk_tiles): one chunk; several chunks with trailing capacity pads
CASES = {"one_chunk": (1500, None), "chunks": (2200, 3)}


def _build_both(case, storage):
    n, chunk_tiles = CASES[case]
    pairs, weights = _weighted_pairs(n, seed=n)
    tdt, jdt = STORAGE[storage]
    ours = tbs.build_blocksparse(pairs, n, chunk_tiles=chunk_tiles, weights=weights, weight_dtype=tdt, device="cpu")
    theirs = jbs.build_blocksparse(pairs, n, chunk_tiles=chunk_tiles, weights=weights, weight_dtype=jdt, to_device=False)
    return ours, theirs, pairs, weights


def _dense_weighted(pairs, weights, n):
    adj = np.zeros((n, n), np.float64)
    np.add.at(adj, (pairs[:, 0], pairs[:, 1]), weights)
    np.add.at(adj, (pairs[:, 1], pairs[:, 0]), weights)
    return adj


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("case", sorted(CASES))
def test_weighted_build_matches_jax_bit_for_bit(case, storage) -> None:
    ours, theirs, pairs, _ = _build_both(case, storage)
    assert ours.blocks_t.dtype == STORAGE[storage][0]
    for field in STRUCTURE_FIELDS:
        _assert_bits_equal(getattr(ours, field), getattr(theirs, field), field)
    assert (ours.num_tiles, ours.num_chunks, ours.chunk_tiles) == (theirs.num_tiles, theirs.num_chunks, theirs.chunk_tiles)
    # the self-loop's weight lands twice, as in the JAX package; duplicates add up
    blocks = ours.blocks_t.float().numpy()
    nonzero = np.flatnonzero(blocks.any(axis=(1, 2)))
    np.testing.assert_array_equal(np.sort(ours.tile_blocks.numpy()), nonzero)
    if case == "chunks":
        assert ours.num_chunks > 1


def test_weighted_build_rejects_what_the_kernel_does_not_take() -> None:
    pairs, weights = _weighted_pairs(300, seed=1)
    with pytest.raises(ValueError, match="weight_dtype"):
        tbs.build_blocksparse(pairs, 300, weights=weights, weight_dtype=torch.float16, device="cpu")
    with pytest.raises(ValueError, match="entries for"):
        tbs.build_blocksparse(pairs, 300, weights=weights[:-1], device="cpu")
    st = tbs.build_blocksparse(pairs, 300, weights=weights, device="cpu")
    half = tbs.BlockSparseStructure(**{**st.__dict__, "blocks_t": st.blocks_t.to(torch.float16)})
    with pytest.raises(TypeError, match="blocks_t must be one of"):
        tbs.bcsr_spmm_kernel(half, torch.zeros(4, st.padded_nodes))


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("feat", [16, 19, 32])
def test_bcsr_plain_version_on_weighted_blocks_matches_bcsr_spmm_xla(case, storage, feat) -> None:
    ours, theirs, pairs, weights = _build_both(case, storage)
    x = np.random.default_rng(feat).normal(size=(ours.padded_nodes, feat)).astype(np.float32)
    want = np.asarray(jbs.bcsr_spmm_xla(theirs, jnp.asarray(x)))
    tbs.reset_launches()
    got = tbs.bcsr_spmm_kernel(ours, torch.from_numpy(np.ascontiguousarray(x.T)))
    assert tbs.launches == {"bcsr_spmm_kernel": 0} and not any(tbs.launches_by_dtype["bcsr_spmm_kernel"].values())
    np.testing.assert_allclose(got.numpy().T, want, **TOL)
    # the same weights, rounded to the storage type, in a dense product
    dense = torch.from_numpy(_dense_weighted(pairs, weights, ours.padded_nodes).astype(np.float32)).to(STORAGE[storage][0]).double().numpy()
    np.testing.assert_allclose(got.numpy().T, dense @ x, **TOL)


@pytest.mark.parametrize("storage", sorted(STORAGE))
def test_weighted_spmm_gradient_is_the_spmm_of_the_cotangent(storage) -> None:
    ours, _, _, _ = _build_both("chunks", storage)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(16, ours.padded_nodes)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(16, ours.padded_rows)).astype(np.float32))
    (grad,) = torch.autograd.grad(tbs.bcsr_spmm_t(ours, x), x, g)
    torch.testing.assert_close(grad, tbs.bcsr_spmm_kernel_ref(ours, g), **TOL)
    xr = x.detach().clone().requires_grad_(True)
    (grad_ref,) = torch.autograd.grad(tbs.bcsr_spmm_t_ref(ours, xr), xr, g)
    torch.testing.assert_close(grad, grad_ref, **TOL)


# F=16 on one chunk (the sGAT full graph's width); F=32 on several chunks
@pytest.mark.parametrize(("case", "feat"), [("one_chunk", 16), ("chunks", 32)])
def test_bcsr_plain_version_on_bf16_blocks_matches_the_pallas_kernel_in_interpret_mode(case, feat) -> None:
    ours, theirs, _, _ = _build_both(case, "bf16")
    x = np.random.default_rng(feat).normal(size=(ours.padded_nodes, feat)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            jbs._bcsr_spmm_tpu(
                jnp.asarray(theirs.blocks_t),
                jnp.asarray(theirs.block_col),
                jnp.asarray(theirs.batch_row),
                jnp.asarray(theirs.batch_chunk),
                jnp.asarray(theirs.visited),
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


def _weighted_adjacency(g, n, f, storage, seed):
    """A symmetric weighted adjacency with padded (masked, edgeless) nodes,
    stored as ``storage`` in both packages (bf16 rounded by torch and by
    ml_dtypes alike), features and a cotangent."""
    rng = np.random.default_rng(seed)
    edges = rng.random((g, n, n)) < 0.2
    edges = edges | edges.transpose(0, 2, 1)
    mask = np.ones((g, n), bool)
    for gi in range(g):
        mask[gi, n - int(rng.integers(0, n // 4)) :] = False
    edges &= mask[:, :, None] & mask[:, None, :]
    w = rng.uniform(0.5, 3.0, (g, n, n)).astype(np.float32)
    w = ((w + w.transpose(0, 2, 1)) * edges).astype(np.float32)
    tdt, _ = STORAGE[storage]
    adj_t = torch.from_numpy(w).to(tdt)
    adj_j = jnp.asarray(w, dtype=jnp.bfloat16 if storage == "bf16" else jnp.float32)
    _assert_bits_equal(adj_t, adj_j, "adjacency")
    x_t = rng.normal(size=(f, g * n)).astype(np.float32)
    cot = rng.normal(size=(f, g * n)).astype(np.float32)
    return adj_t, adj_j, mask, x_t, cot


SHAPES = [(16, 32, 10), (4, 96, 38), (7, 32, 16)]


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize(("g", "n", "f"), SHAPES)
def test_diag_plain_versions_on_weighted_adjacency_match_jax_oracle(storage, g, n, f) -> None:
    adj_t, adj_j, mask, x_t, cot = _weighted_adjacency(g, n, f, storage, seed=g + n + f)
    mask_t, x = torch.from_numpy(mask), torch.from_numpy(x_t)
    agg = np.asarray(jd.diag_spmm_t_xla(adj_j, jnp.asarray(x_t)))
    h = np.maximum(agg, 0.0) * mask.reshape(1, g * n)
    td.reset_launches()
    np.testing.assert_allclose(td.diag_kernel(adj_t, x).numpy(), agg, **TOL)
    np.testing.assert_allclose(td.diag_kernel(adj_t, x, mask_t, "relu_mask").numpy(), h, **TOL)
    sign, pooled = td.diag_kernel(adj_t, x, mask_t, "relu_mask_pool")
    clear = np.abs(h) > TOL["atol"]
    np.testing.assert_array_equal(sign.numpy().astype(bool)[clear], (h > 0)[clear])
    np.testing.assert_allclose(pooled.numpy(), h.reshape(f, g, n).sum(axis=2), **TOL)
    g_pool = np.ascontiguousarray(cot[:, :g])
    u = (np.repeat(g_pool, n, axis=1) * sign.numpy()).astype(np.float32)
    want = np.asarray(jd.diag_spmm_t_xla(adj_j, jnp.asarray(u)))
    np.testing.assert_allclose(td.pool_bwd_kernel(adj_t, sign, torch.from_numpy(g_pool)).numpy(), want, **TOL)
    # on the CPU every call took the plain version
    assert not any(v for forms in td.launches_by_dtype.values() for v in forms.values())


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("layer", ["diag_spmm_t", "diag_layer_t", "diag_layer_pool_t"])
def test_diag_layers_on_weighted_adjacency_match_jax(layer, storage) -> None:
    g, n, f = 4, 96, 16
    adj_t, adj_j, mask, x_t, cot = _weighted_adjacency(g, n, f, storage, seed=7)
    if layer == "diag_layer_pool_t":
        cot = cot[:, :g]
    mask_j, mask_t = jnp.asarray(mask), torch.from_numpy(mask)
    jfn = {
        "diag_spmm_t": lambda v: jd.diag_spmm_t(adj_j, v),
        "diag_layer_t": lambda v: jd.diag_layer_t(adj_j, mask_j, v),
        "diag_layer_pool_t": lambda v: jd.diag_layer_pool_t(adj_j, mask_j, v),
    }[layer]
    targs = (adj_t,) if layer == "diag_spmm_t" else (adj_t, mask_t)
    want_out, vjp = jax.vjp(jfn, jnp.asarray(x_t))
    (want_grad,) = vjp(jnp.asarray(cot))
    for fn in (getattr(td, layer), getattr(td, f"{layer}_ref")):
        xt = torch.from_numpy(x_t).requires_grad_(True)
        out = fn(*targs, xt)
        (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(cot))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), **TOL)


@pytest.mark.parametrize(("n", "f"), [(32, 16), (96, 38)])
def test_tpu_diag_kernels_interpret_on_bf16_match_plain_versions(n, f) -> None:
    g = jd.GS
    adj_t, adj_j, mask, x_t, cot = _weighted_adjacency(g, n, f, "bf16", seed=3 * n + f)
    mask_t, x = torch.from_numpy(mask), torch.from_numpy(x_t)
    assert jd._pick_gs(g, n, 2) is not None  # the kernel takes the bf16 adjacency
    with pltpu.force_tpu_interpret_mode():
        plain = jd._diag_spmm_tpu(adj_j, jnp.asarray(x_t), None, relu=False)
        relu = jd._diag_spmm_tpu(adj_j, jnp.asarray(x_t), jnp.asarray(mask), relu=True)
    np.testing.assert_allclose(np.asarray(plain), td.diag_kernel_ref(adj_t, x).numpy(), rtol=5e-4, atol=5e-4)
    h_ref = td.diag_kernel_ref(adj_t, x, mask_t, "relu_mask").numpy()
    np.testing.assert_allclose(np.asarray(relu), h_ref, rtol=5e-4, atol=5e-4)
    g_pool = np.ascontiguousarray(cot[:, :g])
    with pltpu.force_tpu_interpret_mode():
        du = jd._diag_pool_bwd_tpu(adj_j, jnp.asarray(h_ref).astype(jnp.bfloat16), jnp.asarray(g_pool))
    sign = torch.from_numpy((h_ref > 0).astype(np.uint8))
    want = td.pool_bwd_kernel_ref(adj_t, sign, torch.from_numpy(g_pool)).numpy()
    np.testing.assert_allclose(np.asarray(du), want, rtol=5e-3, atol=5e-3)


def _with_duplicates_and_a_self_loop(entries):
    """Each entry gains a repeated edge (its attributes again) and a
    self-loop on node 1, which the weighted collates accumulate as JAX does."""
    for e in entries:
        und = np.asarray(e["edge_index"])
        ea = np.asarray(e["edge_attr"], dtype=np.float32).reshape(len(und), -1)
        e["edge_index"] = np.concatenate([und, und[:3], [[1, 1]]]).astype(np.int64)
        e["edge_attr"] = np.concatenate([ea, ea[:3] * 0.5, np.full((1, ea.shape[1]), 1.25, np.float32)])
    return entries


DIAG_LAYOUTS = {"pure": (40, 10.0, 1), "mixed": (40, 6.0, 5)}


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("layout", sorted(DIAG_LAYOUTS))
def test_weighted_diag_collate_matches_jax_field_for_field(layout, storage) -> None:
    nodes, cell, msn = DIAG_LAYOUTS[layout]
    entries = _with_duplicates_and_a_self_loop(ppi_clustered_entries(5, nodes, 9, cell=cell, seed=4))
    tdt, jdt = STORAGE[storage]
    want, _ = jbatch.collate_graphs_diag_clustered(entries, pad_graphs=6, with_edge_weights=True, weight_dtype=jdt, min_slot_nodes=msn)
    got, _ = tbatch.collate_graphs_diag_clustered(entries, pad_graphs=6, with_edge_weights=True, weight_dtype=tdt, min_slot_nodes=msn, device="cpu")
    assert got.region_caps == want.region_caps and bool(got.region_caps) == (layout == "mixed")
    for field in got.__dataclass_fields__:
        if field not in tbatch.DiagClusteredBatch._STATIC:
            _assert_bits_equal(getattr(got, field), getattr(want, field), field)
    assert got.adj_w.dtype == tdt and got.wsum.numel() == got.node_mask.numel()
    # the self-loop on node 1 of graph 0 counts its weight twice
    w = got.adj_w.float()
    assert (w.diagonal(dim1=1, dim2=2) == torch.tensor(2.5, dtype=tdt).float()).sum() == 5
    moved = got.to("cpu")
    assert torch.equal(moved.adj_wp, got.adj_wp) and moved.adj_wp.dtype == tdt


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("slot8", [True, False])
def test_weighted_blocksparse_clustered_collate_matches_jax_field_for_field(slot8, storage, monkeypatch) -> None:
    for module in (jbatch, tbatch):
        monkeypatch.setattr(module, "_CLUSTERED_CHUNK_TILES", 3)
    entries = _with_duplicates_and_a_self_loop([clustered_entry(n, 7, seed=20 + i) for i, n in enumerate((2500, 900, 300))])
    tdt, jdt = STORAGE[storage]
    want, _ = jbatch.collate_graphs_blocksparse_clustered(entries, pad_graphs=4, with_edge_weights=True, weight_dtype=jdt, slot8=slot8)
    got, _ = tbatch.collate_graphs_blocksparse_clustered(entries, pad_graphs=4, with_edge_weights=True, weight_dtype=tdt, slot8=slot8, device="cpu")
    assert got.structure.num_chunks > 1
    for field in got.__dataclass_fields__:
        ours, theirs = getattr(got, field), getattr(want, field)
        if field.startswith("structure"):
            for sf in STRUCTURE_FIELDS:
                _assert_bits_equal(getattr(ours, sf), getattr(theirs, sf), f"{field}.{sf}")
            assert ours.blocks_t.dtype == tdt
        elif field == "num_graphs":
            assert ours == theirs
        else:
            _assert_bits_equal(ours, theirs, field)
    assert got.wsum.numel() == got.num_nodes and got.wsum_p.numel() == got.structure_p.padded_nodes
    # the row sums of the f32 structure are the weighted adjacency's
    ones = torch.ones(1, got.structure.padded_nodes)
    if storage == "f32":
        torch.testing.assert_close(tbs.bcsr_spmm_kernel_ref(got.structure, ones)[0], got.wsum, **TOL)


def test_weighted_collates_reject_what_the_kernels_do_not_take() -> None:
    entries = ppi_clustered_entries(2, 20, 4, seed=0)
    with pytest.raises(ValueError, match="weight_dtype"):
        tbatch.collate_graphs_diag_clustered(entries, with_edge_weights=True, weight_dtype=torch.float16, device="cpu")
    with pytest.raises(ValueError, match="weight_dtype"):
        tbatch.collate_graphs_blocksparse_clustered(entries, with_edge_weights=True, weight_dtype=torch.float64, device="cpu")
