"""Graph parallelism for the block-sparse (BCSR) path over a process group
(port of ``deeprank2_tpu/parallel/blocksparse_partition.py``).

- the row tiles are split into ``D`` contiguous ranges of one length; rank
  ``d`` owns the node rows of its range and the adjacency blocks whose
  destination row tile falls in it: the row slice ``A[r_d : r_{d+1}, :]``,
  a rectangular :class:`BlockSparseStructure` (``row_tile_range``);
- a layer transforms the rank's node block and all-gathers it; kernel K5
  then multiplies the row slice with the gathered features, with no
  further communication (:func:`bcsr_spmm_sharded`);
- backward: a row slice is not symmetric, but the whole adjacency is, so
  ``(A^T g)[rows of d] = A[rows of d, :] @ g_full``: the same gather and
  the same K5 call on the cotangent.

The ring variant (:class:`RingBlockSparseBatch`, :func:`ring_bcsr_spmm`)
splits each rank's blocks by the source's owner: the diagonal bucket
``A[d, d]`` reads only the rank's own block, and ``D - 1`` off-diagonal
buckets ``A[d, (d - k) % D]``, with columns re-based to the source's block
(``col_tile_range``), are multiplied at ring step ``k`` with the block
passed round the ranks; an empty bucket skips its K5 call (the hop runs on
every rank regardless).

The port runs one process a rank, so the collates and partitions return one
part a rank (the JAX stack's slice ``[d]``, field for field; the targets,
which JAX replicates on a shard axis, are the part's ``y``/``y_mask``);
:class:`GINetBlockSparseGP` and :class:`GINetBlockSparseRing` run over the
default process group, as the JAX models run over every device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deeprank2_tpu_torch.device import resolve_device
from deeprank2_tpu_torch.neuralnets import nn as dnn
from deeprank2_tpu_torch.neuralnets.gnn.ginet_blocksparse import GINetBlockSparse
from deeprank2_tpu_torch.ops.batch import ShardTargets, _num_graphs, _shared_cap, _targets, blocksparse_layout
from deeprank2_tpu_torch.ops.block_sparse import SUPER, BlockSparseStructure, bcsr_spmm_kernel, build_blocksparse, required_blocks
from deeprank2_tpu_torch.ops.pooling import tiled_graph_sums
from deeprank2_tpu_torch.parallel import comm


@dataclass
class PartitionedBlockSparseBatch:
    """One rank's row-tile range of a block-sparse batch."""

    x: torch.Tensor  # f32 [R*B, F] the rank's node features
    node_graph: torch.Tensor  # i32 [R*B] graph id per local node (padding = G)
    node_mask: torch.Tensor  # bool [R*B]
    y: torch.Tensor  # f32 [G] every graph's target (each rank holds them all)
    y_mask: torch.Tensor  # bool [G]
    structure: BlockSparseStructure  # the row slice A[rows of d, :]; capacities shared by the ranks
    num_graphs: int


@dataclass
class RingBlockSparseBatch:
    """One rank's row-tile range, its blocks bucketed for the ring."""

    x: torch.Tensor  # f32 [R*B, F]
    node_graph: torch.Tensor  # i32 [R*B]
    node_mask: torch.Tensor  # bool [R*B]
    y: torch.Tensor  # f32 [G]
    y_mask: torch.Tensor  # bool [G]
    diag: BlockSparseStructure  # A[d, d]
    off: tuple  # D - 1 structures in ring-step order: off[k - 1] = A[d, (d - k) % D], source-local columns
    off_has_blocks: tuple  # D - 1 bools: which buckets hold a block (host values: no device read)
    num_graphs: int
    num_shards: int


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _node_parts(xs: np.ndarray, graph_ids: np.ndarray, masks: np.ndarray, y: np.ndarray, y_mask: np.ndarray, num_shards: int, device) -> list[dict]:
    """Each rank's node arrays (contiguous row ranges) and the targets."""
    rows = xs.shape[0] // num_shards

    def part(a, d):
        return torch.from_numpy(np.ascontiguousarray(a[d * rows : (d + 1) * rows])).to(device)

    return [
        {"x": part(xs, d), "node_graph": part(graph_ids, d), "node_mask": part(masks, d), "y": torch.from_numpy(y.copy()).to(device), "y_mask": torch.from_numpy(y_mask.copy()).to(device)}
        for d in range(num_shards)
    ]


def _collate_shard_arrays(entries: list[dict], num_shards: int, block: int, pad_tiles, pad_graphs: int | None, device):
    """The collate body shared by the graph-parallel batch forms: one
    :func:`blocksparse_layout` pass, the tiles padded (``pad_tiles``, then to
    a multiple of ``num_shards``), the node arrays cut by rank. Returns
    ``(pairs, r_per, num_nodes, parts, names, num_graphs)``."""
    num_graphs, names = _num_graphs(entries, pad_graphs)
    layout = blocksparse_layout(entries, block, num_graphs)
    num_tiles = _shared_cap(pad_tiles, layout["num_tiles"])
    r_per = -(-num_tiles // num_shards)
    num_nodes = r_per * num_shards * block
    extra = num_nodes - sum(a.shape[0] for a in layout["xs"])
    xs = np.concatenate([*layout["xs"], np.zeros((extra, layout["feat_dim"]), np.float32)])
    graph_ids = np.concatenate([*layout["graph_ids"], np.full(extra, num_graphs, np.int32)])
    masks = np.concatenate([*layout["masks"], np.zeros(extra, bool)])
    parts = _node_parts(xs, graph_ids, masks, *_targets(entries, num_graphs), num_shards, resolve_device(device))
    return layout["pairs"], r_per, num_nodes, parts, names, num_graphs


def _choose_quanta(buckets, num_nodes: int, block: int, rc_ranges, target_waste: float = 0.25) -> tuple[int, int]:
    """The run quantum and grid depth ``(kbatch, super_batches)`` of a group
    of buckets that share one capacity, as the JAX package picks them: the
    largest quantum of (16, 8, 4, 2) whose padded blocks over the group stay
    within ``target_waste`` of the real count, and a depth that lets a tiny
    bucket's capacity floor be ``kbatch * super_batches``. K5 walks only the
    real blocks, so these change the structure's padding (its JAX fields),
    not the kernel's work."""
    real = sum(required_blocks(b, num_nodes, block, kbatch=1, row_tile_range=r, col_tile_range=c) for b, (r, c) in zip(buckets, rc_ranges))

    def group_cap(kb: int) -> int:
        return max(required_blocks(b, num_nodes, block, kbatch=kb, row_tile_range=r, col_tile_range=c) for b, (r, c) in zip(buckets, rc_ranges))

    kb, cap = 2, None
    for cand in (16, 8, 4, 2):
        cap = group_cap(cand)
        if cap * len(buckets) <= (1.0 + target_waste) * real:
            kb = cand
            break
    else:
        cap = group_cap(kb)
    return kb, min(SUPER, max(1, -(-cap // kb)))


def _row_slices(pairs: np.ndarray, num_nodes: int, block: int, num_shards: int, r_per: int, pad_blocks, device, only: int | None = None) -> list[BlockSparseStructure | None]:
    """Each rank's row slice at the shared capacity (rank ``only``'s alone,
    the others None, when given)."""
    ranges = [(d * r_per, (d + 1) * r_per) for d in range(num_shards)]
    kb, sb = _choose_quanta([pairs] * num_shards, num_nodes, block, [(rng, None) for rng in ranges])
    cap = _shared_cap(pad_blocks, max(required_blocks(pairs, num_nodes, block, kbatch=kb, row_tile_range=rng) for rng in ranges))
    return [
        build_blocksparse(pairs, num_nodes, block, pad_blocks_to=cap, kbatch=kb, super_batches=sb, row_tile_range=rng, device=device) if only in (None, d) else None
        for d, rng in enumerate(ranges)
    ]


def collate_graphs_blocksparse_partitioned(
    entries: list[dict],
    num_shards: int,
    block: int = 128,
    pad_tiles=None,
    pad_blocks=None,
    pad_graphs: int | None = None,
    device: str | torch.device | None = None,
    shard: int | None = None,
) -> tuple[tuple[PartitionedBlockSparseBatch, ...], list[str]]:
    """Collate entries straight into one row-tile range a rank (the Trainer's
    graph-parallel path): one layout pass feeds the rectangular builds.
    ``pad_tiles`` resolves before the rounding to a multiple of
    ``num_shards``; ``pad_blocks`` (int or ``required -> capacity``) is the
    ranks' shared block capacity. With ``shard=d`` only part ``d`` is built
    (the capacity still counts every part's blocks); the others are
    :class:`ShardTargets`."""
    pairs, r_per, num_nodes, parts, names, num_graphs = _collate_shard_arrays(entries, num_shards, block, pad_tiles, pad_graphs, device)
    structures = _row_slices(pairs, num_nodes, block, num_shards, r_per, pad_blocks, parts[0]["x"].device, only=shard)
    return tuple(PartitionedBlockSparseBatch(**p, structure=st, num_graphs=num_graphs) if st is not None else ShardTargets(p["y"], p["y_mask"]) for p, st in zip(parts, structures)), names


def _structure_pairs(st: BlockSparseStructure) -> np.ndarray:
    """Undirected node pairs of a full (square) structure: ``blocks_t[k, c,
    r] != 0`` is the edge ``row_tile[k]*B + r <- col_tile[k]*B + c``; the
    build mirrors, so one pair an undirected edge is enough."""
    k_idx, c_idx, r_idx = np.nonzero(_host(st.blocks_t))
    dst = _host(st.block_row)[k_idx].astype(np.int64) * st.block + r_idx
    src = _host(st.block_col)[k_idx].astype(np.int64) * st.block + c_idx
    directed = np.stack([dst, src], axis=1)
    return directed[directed[:, 0] <= directed[:, 1]]


def _split_batch(batch, num_shards: int) -> tuple[np.ndarray, int, int, list[dict]]:
    """An already-collated batch's pairs and node arrays, cut by rank."""
    st = batch.structure
    if not st.is_square:
        msg = "a partition needs a full (square) structure"
        raise ValueError(msg)
    r_per = -(-st.num_tiles // num_shards)
    num_nodes = r_per * num_shards * st.block

    def pad_rows(a, fill=0):
        pad = num_nodes - a.shape[0]
        return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1), constant_values=fill) if pad else a

    parts = _node_parts(
        pad_rows(_host(batch.x)), pad_rows(_host(batch.node_graph), batch.num_graphs), pad_rows(_host(batch.node_mask)), _host(batch.y), _host(batch.y_mask), num_shards, batch.x.device
    )
    return _structure_pairs(st), r_per, num_nodes, parts


def partition_blocksparse_batch(batch, num_shards: int, pad_blocks=None) -> tuple[PartitionedBlockSparseBatch, ...]:
    """Cut an already-collated ``BlockSparseBatch`` into ``num_shards``
    row-tile ranges (the API for a batch whose entries are gone; the Trainer
    collates straight into parts): the blocks are read back as node pairs
    and rebuilt a range at a time with shared capacities."""
    pairs, r_per, num_nodes, parts = _split_batch(batch, num_shards)
    structures = _row_slices(pairs, num_nodes, batch.structure.block, num_shards, r_per, pad_blocks, batch.x.device)
    return tuple(PartitionedBlockSparseBatch(**p, structure=st, num_graphs=batch.num_graphs) for p, st in zip(parts, structures))


def _build_ring_structures(pairs: np.ndarray, num_nodes: int, block: int, num_shards: int, r_per: int, pad_blocks_diag=None, pad_blocks_off=None, device=None, only: int | None = None):
    """Each rank's ``(diag, off, off_has_blocks)`` (rank ``only``'s alone,
    the others None, when given; the capacities count every rank's blocks).
    The directed edges are bucketed by (row owner, column owner) in one
    pass; each ring step ``k`` has a capacity of its own (``pad_blocks_off``
    callables get ``(required, k)``), so on banded graphs only the
    near-diagonal steps pay real block counts."""
    built = [only in (None, d) for d in range(num_shards)]
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    ranges = [(d * r_per, (d + 1) * r_per) for d in range(num_shards)]
    dst = np.concatenate([pairs[:, 0], pairs[:, 1]])
    src = np.concatenate([pairs[:, 1], pairs[:, 0]])
    key = np.minimum(dst // block // r_per, num_shards - 1) * num_shards + np.minimum(src // block // r_per, num_shards - 1)
    order = np.argsort(key, kind="stable")
    bucket_edges = np.stack([dst[order], src[order]], axis=1)
    bounds = np.searchsorted(key[order], np.arange(num_shards * num_shards + 1))

    def bucket(d: int, s: int) -> np.ndarray:
        return bucket_edges[bounds[d * num_shards + s] : bounds[d * num_shards + s + 1]]

    diag_pairs = [bucket(d, d) for d in range(num_shards)]
    kb, sb = _choose_quanta(diag_pairs, num_nodes, block, [(rng, rng) for rng in ranges])
    cap = _shared_cap(pad_blocks_diag, max(required_blocks(diag_pairs[d], num_nodes, block, kbatch=kb, row_tile_range=rng, col_tile_range=rng) for d, rng in enumerate(ranges)))
    diag = [
        build_blocksparse(diag_pairs[d], num_nodes, block, pad_blocks_to=cap, kbatch=kb, super_batches=sb, row_tile_range=rng, col_tile_range=rng, device=device) if built[d] else None
        for d, rng in enumerate(ranges)
    ]
    off = [[] for _ in range(num_shards)]
    flags = [[] for _ in range(num_shards)]
    for k in range(1, num_shards):
        sources = [(d - k) % num_shards for d in range(num_shards)]
        rc = [(ranges[d], ranges[s]) for d, s in enumerate(sources)]
        kb, sb = _choose_quanta([bucket(d, s) for d, s in enumerate(sources)], num_nodes, block, rc)
        required = max(required_blocks(bucket(d, s), num_nodes, block, kbatch=kb, row_tile_range=r, col_tile_range=c) for (d, s), (r, c) in zip(enumerate(sources), rc))
        cap = pad_blocks_off(required, k) if callable(pad_blocks_off) else _shared_cap(pad_blocks_off, required)
        for (d, s), (r, c) in zip(enumerate(sources), rc):
            flags[d].append(len(bucket(d, s)) > 0)
            if built[d]:
                off[d].append(build_blocksparse(bucket(d, s), num_nodes, block, pad_blocks_to=cap, kbatch=kb, super_batches=sb, row_tile_range=r, col_tile_range=c, device=device))
    return [(diag[d], tuple(off[d]), tuple(flags[d])) if built[d] else None for d in range(num_shards)]


def partition_blocksparse_batch_ring(batch, num_shards: int, pad_blocks_diag=None, pad_blocks_off=None) -> tuple[RingBlockSparseBatch, ...]:
    """Cut an already-collated ``BlockSparseBatch`` into ring buckets (see
    :class:`RingBlockSparseBatch`), one part a rank."""
    pairs, r_per, num_nodes, parts = _split_batch(batch, num_shards)
    rings = _build_ring_structures(pairs, num_nodes, batch.structure.block, num_shards, r_per, pad_blocks_diag, pad_blocks_off, batch.x.device)
    return tuple(RingBlockSparseBatch(**p, diag=dg, off=of, off_has_blocks=fl, num_graphs=batch.num_graphs, num_shards=num_shards) for p, (dg, of, fl) in zip(parts, rings))


def collate_graphs_blocksparse_ring(
    entries: list[dict],
    num_shards: int,
    block: int = 128,
    pad_tiles=None,
    pad_blocks_diag=None,
    pad_blocks_off=None,
    pad_graphs: int | None = None,
    device: str | torch.device | None = None,
    shard: int | None = None,
) -> tuple[tuple[RingBlockSparseBatch, ...], list[str]]:
    """Collate entries straight into ring parts, one a rank (the Trainer's
    path for :class:`GINetBlockSparseRing`); ``shard`` as in
    :func:`collate_graphs_blocksparse_partitioned`."""
    pairs, r_per, num_nodes, parts, names, num_graphs = _collate_shard_arrays(entries, num_shards, block, pad_tiles, pad_graphs, device)
    rings = _build_ring_structures(pairs, num_nodes, block, num_shards, r_per, pad_blocks_diag, pad_blocks_off, parts[0]["x"].device, only=shard)
    return tuple(
        RingBlockSparseBatch(**p, diag=ring[0], off=ring[1], off_has_blocks=ring[2], num_graphs=num_graphs, num_shards=num_shards) if ring is not None else ShardTargets(p["y"], p["y_mask"])
        for p, ring in zip(parts, rings)
    ), names


# ---------------------------------------------------------------------------
# The sharded SpMMs (autograd Functions over K5)


def _gather_columns(x_t: torch.Tensor, group) -> torch.Tensor:
    """``[F, Vd]`` on each rank to ``[F, D * Vd]``, in rank order."""
    stacked = comm.all_gather_rows(x_t[None], group)  # [D, F, Vd]
    return stacked.permute(1, 0, 2).reshape(x_t.shape[0], -1)


class _SpmmSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_t, structure, group, compute_dtype):
        ctx.structure, ctx.group, ctx.compute_dtype = structure, group, compute_dtype
        return bcsr_spmm_kernel(structure, _gather_columns(x_t, group), compute_dtype)

    @staticmethod
    def backward(ctx, grad):
        # by the whole adjacency's symmetry: the same gather and K5 call on the cotangent
        return bcsr_spmm_kernel(ctx.structure, _gather_columns(grad.contiguous(), ctx.group), ctx.compute_dtype), None, None, None


def bcsr_spmm_sharded_t(structure: BlockSparseStructure, x_t_local: torch.Tensor, group=None, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``(A @ x)[rows of this rank]`` in the transposed layout: ``x_t_local
    [F, R*B]`` (this rank's nodes) to ``[F, R*B]``, through one all-gather
    and K5 on the row slice ``structure``; differentiable w.r.t.
    ``x_t_local`` (the VJP is the same gather and K5 call on the
    cotangent, see the module docstring)."""
    return _SpmmSharded.apply(x_t_local, structure, group, compute_dtype)


def bcsr_spmm_sharded(structure: BlockSparseStructure, x_local: torch.Tensor, group=None, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Row-major :func:`bcsr_spmm_sharded_t` (the JAX function's layout):
    ``x_local [R*B, F]`` to ``[R*B, F]``."""
    return bcsr_spmm_sharded_t(structure, x_local.T.contiguous(), group, compute_dtype).T


def _ring_apply(diag, off, flags, x_t, group, compute_dtype) -> torch.Tensor:
    """``sum_s A[d, s] @ x_s`` through the ring: the diagonal bucket first,
    then ``D - 1`` hops, each bucket's K5 call skipped when it is empty."""
    acc = bcsr_spmm_kernel(diag, x_t, compute_dtype)
    buf = x_t
    for bucket, has_blocks in zip(off, flags):
        buf = comm.ring_hop(buf, group)  # after k hops: rank (d - k)'s block, bucket off[k - 1]
        if has_blocks:
            acc = acc + bcsr_spmm_kernel(bucket, buf, compute_dtype)
    return acc


class _RingSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_t, diag, off, flags, group, compute_dtype):
        ctx.args = (diag, off, flags, group, compute_dtype)
        return _ring_apply(diag, off, flags, x_t, group, compute_dtype)

    @staticmethod
    def backward(ctx, grad):
        diag, off, flags, group, compute_dtype = ctx.args
        # by the whole adjacency's symmetry: the same ring on the cotangent
        return _ring_apply(diag, off, flags, grad.contiguous(), group, compute_dtype), None, None, None, None, None


def ring_bcsr_spmm_t(diag: BlockSparseStructure, off: tuple, off_has_blocks: tuple, x_t_local: torch.Tensor, group=None, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``(A @ x)[rows of this rank]`` in the transposed layout through the
    ring: the diagonal bucket's K5 call first (no communication), then the
    transformed node block goes ``D - 1`` hops round the ranks, each hop's
    bucket multiplied by K5 unless it is empty. A rank holds one block of
    features at a time, where the all-gather holds ``D``; differentiable
    (the VJP is the same ring on the cotangent)."""
    return _RingSpmm.apply(x_t_local, diag, off, off_has_blocks, group, compute_dtype)


def ring_bcsr_spmm(diag: BlockSparseStructure, off: tuple, off_has_blocks: tuple, x_local: torch.Tensor, group=None, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Row-major :func:`ring_bcsr_spmm_t` (the JAX function's layout)."""
    return ring_bcsr_spmm_t(diag, off, off_has_blocks, x_local.T.contiguous(), group, compute_dtype).T


# ---------------------------------------------------------------------------
# The graph-parallel models


def _forward(model: GINetBlockSparse, part, spmm, group, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
    """:class:`GINetBlockSparse`'s math on one rank's part: the fused towers
    with each layer's SpMM taken by ``spmm``, the per-graph mean summed over
    the ranks, the head on every rank (dropout draws the same mask on every
    rank: the Trainer seeds each rank's generator alike)."""
    w1_t, w2_t = model.fused_weights()
    h_t = torch.relu(spmm(w1_t @ part.x.T))  # [32, R*B]
    h2_t = torch.relu(spmm(w2_t @ h_t))  # [64, R*B]
    h2_t = h2_t * part.node_mask[None, :].to(h2_t.dtype)
    sums, counts = tiled_graph_sums(h2_t, part.node_graph, part.node_mask, part.num_graphs)
    both = comm.psum(torch.cat([sums, counts[:, None]], dim=1), group)
    pooled = both[:, :-1] / both[:, -1:].clamp_min(1.0)
    out = dnn.relu(dnn.linear(model.fc1, pooled))
    out = dnn.dropout(out, model.dropout, training, generator)
    return dnn.linear(model.fc2, out)


def make_blocksparse_ginet_forward(model: GINetBlockSparse, group=None):
    """The row-partitioned forward with ``model``'s parameters:
    ``forward(part, training=False, generator=None) -> [G, out]``, equal on
    every rank."""

    def forward(part: PartitionedBlockSparseBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        return _forward(model, part, lambda x_t: bcsr_spmm_sharded_t(part.structure, x_t, group, model.compute_dtype), group, training, generator)

    return forward


def make_blocksparse_ginet_ring_forward(model: GINetBlockSparse, group=None):
    """The ring forward with ``model``'s parameters, as
    :func:`make_blocksparse_ginet_forward`."""

    def forward(part: RingBlockSparseBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        return _forward(model, part, lambda x_t: ring_bcsr_spmm_t(part.diag, part.off, part.off_has_blocks, x_t, group, model.compute_dtype), group, training, generator)

    return forward


class GINetBlockSparseGP(GINetBlockSparse):
    """Graph-parallel :class:`GINetBlockSparse`: each batch's row tiles are
    split across every rank of the default process group, so one structure
    larger than a card trains across the ranks; the Trainer collates
    straight into parts (``graph_parallel`` marker). The parameters and
    their names are the single-device model's, so checkpoints interchange."""

    graph_parallel = True

    def forward(self, part: PartitionedBlockSparseBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        return make_blocksparse_ginet_forward(self)(part, training, generator)


class GINetBlockSparseRing(GINetBlockSparse):
    """Graph-parallel :class:`GINetBlockSparse` with the ring in place of the
    all-gather: a rank holds one block of features at a time and empty
    buckets skip their K5 call; the Trainer collates into ring parts
    (``graph_parallel`` and ``ring_halo`` markers)."""

    graph_parallel = True
    ring_halo = True

    def forward(self, part: RingBlockSparseBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        return make_blocksparse_ginet_ring_forward(self)(part, training, generator)
