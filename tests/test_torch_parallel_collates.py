"""The host side of the port's parallel paths (deeprank2_tpu_torch) against
the JAX package's on the CPU, field for field and exactly: the seven sharded
collates of data parallelism (each port shard against the JAX stack's slice
``[d]``, the names in the JAX order), the row- and column-sliced
``build_blocksparse`` and ``required_blocks``, the edge partition and its
ring buckets, and the block-sparse partitions (collated and cut from a
batch) with their ring buckets. K5's plain version on the row slices and
ring buckets adds up to the whole SpMM (atol 1e-4, the JAX test's). No
process group is needed: these run in the test process."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import deeprank2_tpu.ops.block_sparse as jbs
from deeprank2_tpu.ops import batch as jbatch
from deeprank2_tpu.parallel import blocksparse_partition as jbp
from deeprank2_tpu.parallel import edge_partition as jep
from deeprank2_tpu_torch.ops import batch as tbatch
from deeprank2_tpu_torch.ops import block_sparse as tbs
from deeprank2_tpu_torch.ops.synthetic import clustered_entry, geometric_entry, ppi_clustered_entries, synthetic_entries
from deeprank2_tpu_torch.parallel import blocksparse_partition as tbp
from deeprank2_tpu_torch.parallel import edge_partition as tep

FEAT = 12
# the port's names of the JAX fields that differ: the partitions' replicated targets
RENAMED = {"y_rep": "y", "y_mask_rep": "y_mask"}


def _host(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def assert_fields_equal(got, want, d: int | None, what: str) -> None:
    """Every JAX field of ``want`` (its slice ``[d]`` when ``d`` is given)
    equals the port's ``got``, the nested structures' included; the port's
    extra fields are not compared. Where the port's dense batch leaves out
    the bf16 ``adj`` beside ``adj_i8`` (the flat route's operands), that
    field is skipped."""
    for f in dataclasses.fields(want):
        theirs = getattr(want, f.name)
        ours = getattr(got, RENAMED.get(f.name, f.name))
        name = f"{what}.{f.name}"
        if f.metadata.get("static"):
            assert ours == theirs, name
        elif dataclasses.is_dataclass(theirs):
            assert_fields_equal(ours, theirs, d, name)
        elif isinstance(theirs, tuple):
            assert len(ours) == len(theirs), name
            for k, (o, t) in enumerate(zip(ours, theirs)):
                assert_fields_equal(o, t, d, f"{name}[{k}]")
        else:
            arr = np.asarray(theirs)
            arr = arr[d] if d is not None else arr
            if f.name == "adj" and ours.numel() == 0:
                continue
            if isinstance(ours, tuple):  # the ring's off_has_blocks: host bools
                assert ours == tuple(bool(v) for v in arr), name
                continue
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
            else:
                assert _host(ours).dtype == arr.dtype, name
            np.testing.assert_array_equal(_host(ours), arr, err_msg=name)


def _atomic(sizes=(300, 220, 330), seed=0, feat=FEAT, edge_dim=1):
    """Small spatial graphs, as the JAX partition tests make them."""
    rng = np.random.default_rng(seed)
    entries = []
    for g, n in enumerate(sizes):
        pos = rng.uniform(0, 26, size=(n, 3))
        pairs = cKDTree(pos).query_pairs(5.0, output_type="ndarray")
        entries.append(
            {
                "x": rng.normal(size=(n, feat)).astype(np.float32),
                "edge_index": pairs.astype(np.int64),
                "edge_attr": rng.normal(size=(len(pairs), edge_dim)).astype(np.float32),
                "pos": pos.astype(np.float32),
                "y": float(g % 2),
                "entry_name": f"p{g}",
            }
        )
    return entries


def _clustered(sizes=(900, 400, 300)):
    entries = [clustered_entry(n, FEAT, seed=20 + i) for i, n in enumerate(sizes)]
    for i, e in enumerate(entries):
        e["entry_name"] = f"c{i}"
    return entries


def _with_clusters(entries):
    """Entries with cluster ids (a node's cell), for the clustered COO and dense shards."""
    out = []
    for e in entries:
        c0 = (np.arange(e["x"].shape[0]) // 3).astype(np.int32)
        out.append({**e, "cluster0": c0, "cluster1": (np.arange(c0.max() + 1) // 2).astype(np.int32)})
    return out


# (name, JAX call, port call); every call gets (entries, num_shards, per_shard)
SHARDED = {
    "coo": (lambda e, d, g: jbatch.collate_graphs_sharded(e, d, g), lambda e, d, g, **kw: tbatch.collate_graphs_sharded(e, d, g, device="cpu", **kw), lambda: synthetic_entries(7, 20, FEAT, 3, seed=1)),
    "coo-clusters": (
        lambda e, d, g: jbatch.collate_graphs_sharded(e, d, g),
        lambda e, d, g, **kw: tbatch.collate_graphs_sharded(e, d, g, device="cpu", **kw),
        lambda: _with_clusters(synthetic_entries(6, 18, FEAT, 3, seed=2)),
    ),
    "coo-empty-shard": (lambda e, d, g: jbatch.collate_graphs_sharded(e, d, g), lambda e, d, g, **kw: tbatch.collate_graphs_sharded(e, d, g, device="cpu", **kw), lambda: synthetic_entries(1, 20, FEAT, 3, seed=3)),
    "dense": (
        lambda e, d, g: jbatch.collate_graphs_dense_sharded(e, d, g),
        lambda e, d, g, **kw: tbatch.collate_graphs_dense_sharded(e, d, g, device="cpu", **kw),
        lambda: synthetic_entries(7, 30, FEAT, 3, seed=4),
    ),
    "dense-clusters-weights": (
        lambda e, d, g: jbatch.collate_graphs_dense_sharded(e, d, g, with_clusters=True, with_edge_weights=True, with_diag_operands=False),
        lambda e, d, g, **kw: tbatch.collate_graphs_dense_sharded(e, d, g, with_clusters=True, with_edge_weights=True, with_diag_operands=False, device="cpu", **kw),
        lambda: _with_clusters(synthetic_entries(5, 30, FEAT, 3, seed=5)),
    ),
    "grids": (
        lambda e, d, g: jbatch.collate_grids_sharded(e, d, g),
        lambda e, d, g, **kw: tbatch.collate_grids_sharded(e, d, g, device="cpu", **kw),
        lambda: [{"x": np.random.default_rng(i).normal(size=(3, 4, 5, 6)).astype(np.float32), "y": float(i % 2) if i != 2 else None, "entry_name": f"g{i}"} for i in range(3)],
    ),
    "blocksparse": (
        lambda e, d, g: jbatch.collate_graphs_blocksparse_sharded(e, d, g, pad_tiles=lambda r: r + 1, pad_blocks=lambda r: r + 16),
        lambda e, d, g, **kw: tbatch.collate_graphs_blocksparse_sharded(e, d, g, pad_tiles=lambda r: r + 1, pad_blocks=lambda r: r + 16, device="cpu", **kw),
        lambda: _atomic((300, 220, 330, 40), seed=6),
    ),
    "blocksparse-ints": (
        lambda e, d, g: jbatch.collate_graphs_blocksparse_sharded(e, d, g, pad_tiles=5, pad_blocks=300),
        lambda e, d, g, **kw: tbatch.collate_graphs_blocksparse_sharded(e, d, g, pad_tiles=5, pad_blocks=300, device="cpu", **kw),
        lambda: _atomic((300, 220), seed=7),
    ),
    "diag-clustered-pure": (
        lambda e, d, g: jbatch.collate_graphs_diag_clustered_sharded(e, d, g, min_slot_nodes=1),
        lambda e, d, g, **kw: tbatch.collate_graphs_diag_clustered_sharded(e, d, g, min_slot_nodes=1, device="cpu", **kw),
        lambda: ppi_clustered_entries(5, 60, FEAT, seed=8),
    ),
    "diag-clustered-mixed-weighted": (
        lambda e, d, g: jbatch.collate_graphs_diag_clustered_sharded(e, d, g, pad_caps={"c1": lambda r: r + 3}, with_edge_weights=True),
        lambda e, d, g, **kw: tbatch.collate_graphs_diag_clustered_sharded(e, d, g, pad_caps={"c1": lambda r: r + 3}, with_edge_weights=True, device="cpu", **kw),
        lambda: ppi_clustered_entries(5, 60, FEAT, cell=6.0, seed=9),
    ),
    "clustered-blocksparse": (
        lambda e, d, g: jbatch.collate_graphs_blocksparse_clustered_sharded(e, d, g, pad_caps={"tiles": lambda r: r + 1}),
        lambda e, d, g, **kw: tbatch.collate_graphs_blocksparse_clustered_sharded(e, d, g, pad_caps={"tiles": lambda r: r + 1}, device="cpu", **kw),
        _clustered,
    ),
    "clustered-blocksparse-slot8-weighted": (
        lambda e, d, g: jbatch.collate_graphs_blocksparse_clustered_sharded(e, d, g, slot8=True, with_edge_weights=True),
        lambda e, d, g, **kw: tbatch.collate_graphs_blocksparse_clustered_sharded(e, d, g, slot8=True, with_edge_weights=True, device="cpu", **kw),
        _clustered,
    ),
    "blocked": (
        lambda e, d, g: jbatch.collate_graphs_blocked_sharded(e, d, g, pad_slabs=lambda r: r + 2),
        lambda e, d, g, **kw: tbatch.collate_graphs_blocked_sharded(e, d, g, pad_slabs=lambda r: r + 2, device="cpu", **kw),
        lambda: _atomic((600, 220, 330), seed=10, edge_dim=3),
    ),
}


@pytest.mark.parametrize("shards", [2, 3], ids=["2shards", "3shards"])
@pytest.mark.parametrize("kind", sorted(SHARDED))
def test_sharded_collate_matches_jax_field_for_field(kind, shards) -> None:
    jax_collate, port_collate, make = SHARDED[kind]
    entries = make()
    per_shard = -(-len(entries) // shards)
    want, want_names = jax_collate(entries, shards, per_shard)
    got, names = port_collate(entries, shards, per_shard)
    assert names == want_names
    assert len(got) == shards
    for d, shard in enumerate(got):
        assert_fields_equal(shard, want, d, f"{kind}[{d}]")


@pytest.mark.parametrize("own", [0, 1], ids=["shard0", "shard1"])
@pytest.mark.parametrize("kind", sorted(SHARDED))
def test_sharded_collate_of_one_shard(kind, own) -> None:
    """With ``shard=d`` a rank collates its own shard, field for field the
    JAX stack's slice ``[d]``, and takes every other shard's targets alone;
    the names are the whole batch's."""
    jax_collate, port_collate, make = SHARDED[kind]
    entries = make()
    per_shard = -(-len(entries) // 2)
    want, want_names = jax_collate(entries, 2, per_shard)
    got, names = port_collate(entries, 2, per_shard, shard=own)
    assert names == want_names
    assert_fields_equal(got[own], want, own, f"{kind}[{own}]")
    other = got[1 - own]
    assert isinstance(other, tbatch.ShardTargets)
    np.testing.assert_array_equal(other.y.numpy(), np.asarray(want.y)[1 - own])
    np.testing.assert_array_equal(other.y_mask.numpy(), np.asarray(want.y_mask)[1 - own])


@pytest.mark.parametrize("collate", ["blocksparse", "blocked", "clustered-blocksparse"])
def test_tile_balanced_collates_respect_graph_capacity(collate) -> None:
    """One big graph and many small ones fill no shard past its graph slots,
    and too many entries raise (the JAX regression test)."""
    rng = np.random.default_rng(11)
    entries = []
    for g, n in enumerate([700] + [40] * 7):
        pos = rng.uniform(0, 40, size=(n, 3))
        pairs = cKDTree(pos).query_pairs(5.0, output_type="ndarray")
        entries.append({"x": rng.normal(size=(n, 6)).astype(np.float32), "edge_index": pairs.astype(np.int64), "edge_attr": np.ones((len(pairs), 1), np.float32), "pos": pos.astype(np.float32), "y": float(g % 2), "entry_name": f"c{g}", "cluster0": np.arange(n, dtype=np.int32) // 4, "cluster1": np.arange(-(-n // 4), dtype=np.int32) // 2})
    fn = {"blocksparse": tbatch.collate_graphs_blocksparse_sharded, "blocked": tbatch.collate_graphs_blocked_sharded, "clustered-blocksparse": tbatch.collate_graphs_blocksparse_clustered_sharded}[collate]
    shards, names = fn(entries, 2, 4, device="cpu")
    assert sorted(n for n in names if n) == sorted(e["entry_name"] for e in entries)
    for shard in shards:
        assert int(shard.node_graph[shard.node_mask].max()) < 4
    with pytest.raises(ValueError, match="exceed"):
        fn(entries, 2, 2, device="cpu")


def _pairs_and_nodes(seed=1):
    batch, _ = tbatch.collate_graphs_blocksparse(_atomic(seed=seed), device="cpu")
    layout = tbatch.blocksparse_layout(_atomic(seed=seed), features=False)
    return layout["pairs"], batch.structure.padded_nodes


RANGES = {"rows-0-2": ((0, 2), None), "rows-2-6": ((2, 6), None), "bucket-2-4x0-2": ((2, 4), (0, 2)), "diag-0-3": ((0, 3), (0, 3)), "empty-bucket": ((0, 1), (5, 6))}


@pytest.mark.parametrize("kbatch", [None, 1, 2], ids=["kb-default", "kb1", "kb2"])
@pytest.mark.parametrize("rng_name", sorted(RANGES))
def test_sliced_build_and_requirements_match_jax(rng_name, kbatch) -> None:
    rows, cols = RANGES[rng_name]
    pairs, n = _pairs_and_nodes()
    kw = {"row_tile_range": rows, "col_tile_range": cols, "kbatch": kbatch}
    assert tbs.required_blocks(pairs, n, **kw) == jbs.required_blocks(pairs, n, **kw)
    want = jbs.build_blocksparse(pairs, n, pad_blocks_to=lambda r: r + 8, super_batches=2, to_device=False, **kw)
    got = tbs.build_blocksparse(pairs, n, pad_blocks_to=lambda r: r + 8, super_batches=2, device="cpu", **kw)
    assert_fields_equal(got, want, None, rng_name)
    assert got.tile_ptr.numel() == got.num_row_tiles + 1 and got.padded_nodes == (cols[1] - cols[0] if cols else got.num_tiles) * 128


def test_row_slices_and_ring_buckets_add_up_to_the_whole_spmm() -> None:
    """K5's plain version: the ranks' row slices concatenated, and each
    rank's diagonal plus off-diagonal buckets on the source blocks, give the
    whole SpMM (atol 1e-4, the JAX test's)."""
    batch, _ = tbatch.collate_graphs_blocksparse(_atomic(seed=1), device="cpu")
    num_shards = 3
    parts = tbp.partition_blocksparse_batch(batch, num_shards)
    rings = tbp.partition_blocksparse_batch_ring(batch, num_shards)
    st = parts[0].structure
    x_t = torch.from_numpy(np.random.default_rng(0).normal(size=(8, st.padded_nodes)).astype(np.float32))
    want = tbs.bcsr_spmm_kernel(batch.structure, x_t[:, : batch.structure.padded_nodes].contiguous())
    got = torch.cat([tbs.bcsr_spmm_kernel(p.structure, x_t) for p in parts], dim=1)[:, : want.shape[1]]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    rows = st.padded_rows
    blocks = x_t.reshape(8, num_shards, rows)
    ring_out = []
    for d, ring in enumerate(rings):
        acc = tbs.bcsr_spmm_kernel(ring.diag, blocks[:, d].contiguous())
        for k, bucket in enumerate(ring.off, start=1):
            acc = acc + tbs.bcsr_spmm_kernel(bucket, blocks[:, (d - k) % num_shards].contiguous())
        ring_out.append(acc)
    np.testing.assert_allclose(torch.cat(ring_out, dim=1)[:, : want.shape[1]].numpy(), want.numpy(), atol=1e-4)


@pytest.mark.parametrize("shards", [2, 3, 4], ids=["2shards", "3shards", "4shards"])
@pytest.mark.parametrize("ring", [False, True], ids=["all-gather", "ring"])
def test_edge_partition_matches_jax(ring, shards) -> None:
    entries = synthetic_entries(5, 30, FEAT, 3, seed=12)
    jbatch_, _ = jbatch.collate_graphs(entries, pad_graphs=6)
    tbatch_, _ = tbatch.collate_graphs(entries, pad_graphs=6, device="cpu")
    want = (jep.partition_graph_batch_ring if ring else jep.partition_graph_batch)(jbatch_, shards)
    got = (tep.partition_graph_batch_ring if ring else tep.partition_graph_batch)(tbatch_, shards)
    for d, part in enumerate(got):
        assert_fields_equal(part, want, d, f"part[{d}]")


@pytest.mark.parametrize("own", [0, 2], ids=["part0", "part2"])
@pytest.mark.parametrize("form", ["partitioned", "ring"])
def test_blocksparse_partition_of_one_rank(form, own) -> None:
    """With ``shard=d`` the graph-parallel collates build rank ``d``'s part
    alone, at the capacities of every part, field for field JAX's slice."""
    entries = _atomic(seed=6)
    kw = {"pad_tiles": lambda r: r + 1, "pad_graphs": 4}
    if form == "ring":
        kw |= {"pad_blocks_diag": lambda r: r + 2, "pad_blocks_off": lambda r, k: r + k}
        want, want_names = jbp.collate_graphs_blocksparse_ring(entries, 3, **kw)
        got, names = tbp.collate_graphs_blocksparse_ring(entries, 3, device="cpu", shard=own, **kw)
    else:
        want, want_names = jbp.collate_graphs_blocksparse_partitioned(entries, 3, pad_blocks=lambda r: r + 4, **kw)
        got, names = tbp.collate_graphs_blocksparse_partitioned(entries, 3, pad_blocks=lambda r: r + 4, device="cpu", shard=own, **kw)
    assert names == want_names
    assert_fields_equal(got[own], jax.tree.map(np.asarray, want), own, f"{form}[{own}]")
    assert all(isinstance(p, tbatch.ShardTargets) for d, p in enumerate(got) if d != own)


@pytest.mark.parametrize("shards", [2, 3], ids=["2shards", "3shards"])
@pytest.mark.parametrize("form", ["collated", "cut", "ring-collated", "ring-cut"])
def test_blocksparse_partitions_match_jax(form, shards) -> None:
    entries = _atomic(seed=6)
    pads = {"pad_tiles": lambda r: r + 1} if "collated" in form else {}
    if form == "collated":
        want, want_names = jbp.collate_graphs_blocksparse_partitioned(entries, shards, pad_blocks=lambda r: r + 4, pad_graphs=4, **pads)
        got, names = tbp.collate_graphs_blocksparse_partitioned(entries, shards, pad_blocks=lambda r: r + 4, pad_graphs=4, device="cpu", **pads)
        assert names == want_names
    elif form == "ring-collated":
        off = lambda r, k: r + k  # noqa: E731
        want, want_names = jbp.collate_graphs_blocksparse_ring(entries, shards, pad_blocks_diag=lambda r: r + 2, pad_blocks_off=off, pad_graphs=4, **pads)
        got, names = tbp.collate_graphs_blocksparse_ring(entries, shards, pad_blocks_diag=lambda r: r + 2, pad_blocks_off=off, pad_graphs=4, device="cpu", **pads)
        assert names == want_names
    else:
        jb, _ = jbatch.collate_graphs_blocksparse(entries)
        tb, _ = tbatch.collate_graphs_blocksparse(entries, device="cpu")
        if form == "cut":
            want, got = jbp.partition_blocksparse_batch(jb, shards), tbp.partition_blocksparse_batch(tb, shards)
        else:
            want, got = jbp.partition_blocksparse_batch_ring(jb, shards), tbp.partition_blocksparse_batch_ring(tb, shards)
    want = jax.tree.map(np.asarray, want)
    assert len(got) == shards
    for d, part in enumerate(got):
        assert_fields_equal(part, want, d, f"{form}[{d}]")
