"""Graph batches (port of ``deeprank2_tpu/ops/batch.py``: ``bucket_size``,
``DenseGraphBatch``, ``collate_graphs_dense`` (with clusters and edge
weights), the clustered ``DiagClusteredBatch`` with
``collate_graphs_diag_clustered``, the block-sparse ``BlockSparseBatch`` and
``ClusteredBlockSparseBatch`` with their collates and the requirements
passes behind the Trainer's capacity buckets, the blocked-edge
``BlockedEdgeBatch`` with ``collate_graphs_blocked`` and
``blocked_requirements``, and the COO ``GraphBatch`` with
``collate_graphs``; the sharded collates are not ported).

The batch adjacency of collated graphs is block-diagonal: with graphs padded
to ``N`` nodes, graph ``g`` owns rows and columns ``[g*N, (g+1)*N)`` and no
edge crosses graphs. The aggregation therefore runs per graph on an int8 0/1
adjacency ``[G, N, N]`` against node features kept flat and transposed,
``x_t [F, G*N]`` (ops/diag_spmm.py); sGAT's batches add the same adjacency
weighted by each edge's scalar feature. Edges are mirrored, so every
adjacency block is symmetric. Graphs too large for ``[G, N, N]`` (atomic resolution)
collate block-sparse instead: locality-ordered, tile-padded and concatenated,
with one BCSR adjacency over the whole batch (ops/block_sparse.py). Models
whose messages read per-edge features keep the edge list itself, in
tile-sorted slabs (ops/blocked_edges.py). The COO layout, the one every
model without a layout of its own runs on, keeps the mirrored edge list
sorted by destination row (ops/segment_sorted.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deeprank2_tpu_torch.device import resolve_device
from deeprank2_tpu_torch.ops.blocked_edges import EDGE_TILE, BlockedEdgeStructure, build_blocked_edges, required_slabs
from deeprank2_tpu_torch.ops.block_sparse import DEFAULT_BLOCK, BlockSparseStructure, build_blocksparse, locality_order, required_blocks, weight_storage


def bucket_size(n: int, quantum: int = 128) -> int:
    """Round up to a coarse geometric/linear grid (same grid as the JAX package)."""
    n = max(n, 1)
    if n <= quantum:
        return quantum
    # geometric steps of 1.3x, snapped to the quantum
    size = quantum
    while size < n:
        size = int(np.ceil(size * 1.3 / quantum) * quantum)
    return size


def _tensors(dev: torch.device, **arrays) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in arrays.items()}


@dataclass
class DenseGraphBatch:
    """Block-dense batch of ``G`` graphs padded to ``N`` nodes, on one device.

    The batch holds its 0/1 adjacency once: as ``adj_i8`` beside the node
    features flat and transposed (``x_t``) where the collate shipped the
    flat route's operands (``GINetDense``), else as ``adj`` in bf16, which
    holds 0/1 without loss (the JAX package's ``adj``); the other is empty
    (``[0, 0, 0]``, and ``x_t`` ``[0, 0]``). :attr:`adjacency` is whichever
    is there. ``adj_w`` (sGAT's edge weights), ``cluster0`` and ``cluster1``
    are empty (``[G, 0, 0]``, ``[G, 0]``) unless collated."""

    x: torch.Tensor  # f32 [G, N, F] node features (padded rows 0)
    adj: torch.Tensor  # bf16 [G, N, N]; adj[g, i, j] = 1 if edge j->i (symmetric); [0, 0, 0] beside adj_i8
    pos: torch.Tensor  # f32 [G, N, 3]
    node_mask: torch.Tensor  # bool [G, N]
    y: torch.Tensor  # f32 [G] targets (0 where missing)
    y_mask: torch.Tensor  # bool [G] real-graph mask
    adj_w: torch.Tensor  # f32 [G, N, N] first edge-attr channel, duplicate pairs summed ([G, 0, 0] unweighted)
    cluster0: torch.Tensor  # i32 [G, N] local depth-0 cluster ids; padded = N ([G, 0] without clusters)
    cluster1: torch.Tensor  # i32 [G, N] depth-1 id by depth-0 cluster id; padded = N ([G, 0] without clusters)
    adj_i8: torch.Tensor  # int8 [G, N, N], the same adjacency ([0, 0, 0] without the flat route's operands)
    x_t: torch.Tensor  # f32 [F, G*N] flat transposed node features ([0, 0] without them)

    @property
    def num_graphs(self) -> int:
        return self.x.shape[0]

    @property
    def nodes_per_graph(self) -> int:
        return self.x.shape[1]

    @property
    def adjacency(self) -> torch.Tensor:
        """The 0/1 adjacency ``[G, N, N]``: ``adj``, or ``adj_i8`` where the
        batch carries the flat route's operands."""
        return self.adj if self.adj.numel() else self.adj_i8

    def to(self, device: str | torch.device) -> DenseGraphBatch:
        """A copy of the batch on ``device``."""
        dev = resolve_device(device)
        return DenseGraphBatch(**{k: getattr(self, k).to(dev) for k in self.__dataclass_fields__})


def collate_graphs_dense(
    entries: list[dict],
    pad_graphs: int | None = None,
    pad_nodes: int | None = None,
    with_clusters: bool = False,
    with_edge_weights: bool = False,
    with_diag_operands: bool = True,
    device: str | torch.device | None = None,
) -> tuple[DenseGraphBatch, list[str]]:
    """Collate entries (dicts with ``x``, ``pos``, ``edge_index``, ``y``,
    ``entry_name``) into a :class:`DenseGraphBatch` on ``device`` (CUDA
    unless ``"cpu"`` is asked for), array for array as the JAX package's.
    Edges are mirrored into a symmetric adjacency.

    ``pad_graphs`` pads the batch with empty, masked graphs; ``pad_nodes``
    bounds nodes per graph (bucketed from the data, quantum 32, when None).
    ``with_clusters`` fills ``cluster0``/``cluster1`` from the entries'
    precluster ids; ``with_edge_weights`` fills ``adj_w`` from the first
    edge-attr channel (a duplicate pair sums its weights, a self-loop's
    weight lands twice, as in the JAX package); ``with_diag_operands`` ships
    the flat route's ``adj_i8`` and ``x_t`` (the Trainer passes the model's
    ``diag_operands`` marker) and then no bf16 ``adj``: the JAX package
    ships both, but the flat route reads only ``adj_i8``, so the second copy
    would cost the loader its conversion, pinning and copy for nothing."""
    dev = resolve_device(device)
    num_real = len(entries)
    num_graphs = pad_graphs or num_real
    if num_graphs < num_real:
        msg = f"pad_graphs={num_graphs} is smaller than the {num_real} entries"
        raise ValueError(msg)
    names = [e["entry_name"] for e in entries] + [""] * (num_graphs - num_real)
    max_v = max(e["x"].shape[0] for e in entries)
    cap_n = pad_nodes or bucket_size(max_v, quantum=32)
    if max_v > cap_n:
        msg = f"graph with {max_v} nodes exceeds dense node capacity {cap_n}"
        raise ValueError(msg)
    feat_dim = entries[0]["x"].shape[1]

    x = np.zeros((num_graphs, cap_n, feat_dim), dtype=np.float32)
    adj = np.zeros((num_graphs, cap_n, cap_n), dtype=np.int8)
    pos = np.zeros((num_graphs, cap_n, 3), dtype=np.float32)
    node_mask = np.zeros((num_graphs, cap_n), dtype=bool)
    n_w = cap_n if with_edge_weights else 0
    adj_w = np.zeros((num_graphs, n_w, n_w), dtype=np.float32)
    n_c = cap_n if with_clusters else 0
    cluster0 = np.full((num_graphs, n_c), cap_n, dtype=np.int32)
    cluster1 = np.full((num_graphs, n_c), cap_n, dtype=np.int32)

    for g, entry in enumerate(entries):
        v = entry["x"].shape[0]
        x[g, :v] = entry["x"]
        pos[g, :v] = entry["pos"]
        node_mask[g, :v] = True
        und = np.asarray(entry["edge_index"], dtype=np.int64)
        if und.size:
            adj[g, und[:, 0], und[:, 1]] = 1
            adj[g, und[:, 1], und[:, 0]] = 1
            if with_edge_weights:
                ea = np.asarray(entry["edge_attr"], dtype=np.float32).reshape(len(und), -1)[:, 0]
                np.add.at(adj_w[g], (und[:, 0], und[:, 1]), ea)
                np.add.at(adj_w[g], (und[:, 1], und[:, 0]), ea)
        if with_clusters:
            c1 = np.asarray(entry["cluster1"], dtype=np.int32)
            cluster0[g, :v] = np.asarray(entry["cluster0"], dtype=np.int32)
            cluster1[g, : len(c1)] = c1
    y, y_mask = _targets(entries, num_graphs)

    adj_t = torch.from_numpy(adj)
    if with_diag_operands:
        x_t = torch.from_numpy(np.ascontiguousarray(x.reshape(num_graphs * cap_n, feat_dim).T))
        adj_i8, adj_bf16 = adj_t, torch.zeros((0, 0, 0), dtype=torch.bfloat16)
    else:
        x_t, adj_i8, adj_bf16 = torch.zeros((0, 0), dtype=torch.float32), torch.zeros((0, 0, 0), dtype=torch.int8), adj_t.to(torch.bfloat16)
    arrays = _tensors(dev, x=x, pos=pos, node_mask=node_mask, y=y, y_mask=y_mask, adj_w=adj_w, cluster0=cluster0, cluster1=cluster1)
    batch = DenseGraphBatch(**arrays, adj=adj_bf16.to(dev), adj_i8=adj_i8.to(dev), x_t=x_t.to(dev))
    return batch, names


# ---------------------------------------------------------------------------
# Graph-diagonal clustered batches (port of ``DiagClusteredBatch``,
# ``collate_graphs_diag_clustered`` and their helpers)


@dataclass
class DiagClusteredBatch:
    """Graph-diagonal clustered batch: the clustered GINet at PPI scale.

    Nodes collate cluster-major into 8-lane slots per graph, activations live
    flat and transposed (``[F, G*N]``), depth-0 pooling is the slot max of
    ops/slotpool.py plus a small member combine, and the pooled graph is a
    second graph-diagonal adjacency ``[G, K, K]`` built at collate.

    Ids are batch-global: pooled slot = ``g*K + local``, depth-1 slot from a
    running offset; padding = the target capacity (the segment ops drop it).
    sGAT's batches also carry the adjacencies weighted by the scalar edge
    feature (bf16 by default, f32 on request) and their f32 row sums; other
    batches hold them empty (``[G, 0, 0]`` and ``[0]``)."""

    x_t: torch.Tensor  # f32 [F, G*N] flat transposed features, slot order
    adj_i8: torch.Tensor  # int8 [G, N, N] symmetric 0/1
    node_mask: torch.Tensor  # bool [G, N]
    deg: torch.Tensor  # f32 [G*N] neighbour counts (FoutNet's mean denominator)
    deg_p: torch.Tensor  # f32 [G*K] pooled neighbour counts (distinct pairs)
    adj_w: torch.Tensor  # bf16/f32 [G, N, N] edge weights, duplicate pairs summed
    adj_wp: torch.Tensor  # bf16/f32 [G, K, K] pooled: member-edge weights summed per pair
    wsum: torch.Tensor  # f32 [G*N] row sums of adj_w (before its cast)
    wsum_p: torch.Tensor  # f32 [G*K] row sums of adj_wp (before its cast)
    slot_cluster: torch.Tensor  # i32 [G*N/8] slot -> global pooled slot; pad = G*K
    members0s: torch.Tensor  # i32 [G*K, S0s] slot indices per pooled slot; pad = G*N/8
    adj_p_i8: torch.Tensor  # int8 [G, K, K] pooled adjacency (distinct pairs)
    pooled_mask: torch.Tensor  # bool [G, K]
    cluster1: torch.Tensor  # i32 [G*K] pooled slot -> global depth-1 slot; pad = C1
    members1: torch.Tensor  # i32 [C1, S1] pooled slots per depth-1 slot; pad = G*K
    c1_graph: torch.Tensor  # i32 [C1] graph id per depth-1 slot; pad = G
    y: torch.Tensor  # f32 [G]
    y_mask: torch.Tensor  # bool [G]
    num_graphs: int
    # MIXED size-class region layout (empty tuple = pure slot8): per-graph
    # row caps (nb, n4, n2, n1, kbig) of the slot8 region, the 4-, 2- and
    # 1-lane regions, and the pooled capacity of the slotted segment. Each
    # region pools with its own stride (ops/slotpool.py, slot 8/4/2; the
    # 1-lane region is its own pooled value). In this layout
    # ``slot_cluster``/``members0s`` index the compact big region (slots =
    # G*nb/8, pooled = G*kbig).
    region_caps: tuple = ()

    _STATIC = ("num_graphs", "region_caps")

    @property
    def nodes_per_graph(self) -> int:
        return self.adj_i8.shape[1]

    def to(self, device: str | torch.device) -> DiagClusteredBatch:
        """A copy of the batch on ``device``."""
        dev = resolve_device(device)
        fields = {k: getattr(self, k) for k in self.__dataclass_fields__}
        return DiagClusteredBatch(**{k: v if k in self._STATIC else v.to(dev) for k, v in fields.items()})


def _resolve_cap(pad, req: int, quantum: int) -> int:
    """Requirement -> capacity: apply an int/callable pad, round to quantum."""
    if callable(pad):
        pad = pad(req)
    cap = max(req, pad or 0)
    return -(-cap // quantum) * quantum if quantum > 1 else cap


def _mixed_class(sizes: np.ndarray, min_slot_nodes: int) -> np.ndarray:
    """Size class per cluster: 8 = slotted, else the 4/2/1-lane stride that
    holds the cluster (zero-size gapped ids ride class 1: one masked lane).
    A cluster larger than 4 nodes slots whatever ``min_slot_nodes`` says."""
    return np.where(
        (sizes >= min_slot_nodes) | (sizes > 4), 8, np.where(sizes > 2, 4, np.where(sizes == 2, 2, 1))  # noqa: PLR2004
    )


def _member_matrix(ids: np.ndarray, num_clusters: int, pad_value: int, pad_s=None) -> np.ndarray:
    """Invert a cluster assignment into a [num_clusters, S] member matrix
    (padded with ``pad_value``); S is the largest cluster size, optionally
    bucketed by ``pad_s`` (int or callable). Returns shape (0, 0) when the
    matrix would exceed 8x the element count (one huge cluster — the
    segment-max path is cheaper then)."""
    ids = np.asarray(ids, dtype=np.int64)
    valid = ids < num_clusters
    counts = np.bincount(ids[valid], minlength=num_clusters)
    s = int(counts.max()) if counts.size else 0
    s = max(s, 1)
    if callable(pad_s):
        s = pad_s(s)
    elif pad_s is not None:
        s = max(s, pad_s)
    if num_clusters * s > 8 * max(len(ids), 1):
        return np.zeros((0, 0), dtype=np.int32)
    members = np.full((num_clusters, s), pad_value, dtype=np.int32)
    order = np.argsort(ids[valid], kind="stable")
    slots = np.nonzero(valid)[0][order]
    sorted_ids = ids[valid][order]
    rank = np.arange(len(slots)) - np.concatenate([[0], np.cumsum(counts)])[:-1][sorted_ids]
    members[sorted_ids, rank] = slots
    return members


def _cluster_geometry(entry: dict, block: int) -> dict:
    """Shared first half of the slot8 and mixed plans: cluster sizes, the
    cluster locality order (by centroid) and each node's rank inside its
    cluster (by the node locality order)."""
    v = entry["x"].shape[0]
    pos = np.asarray(entry["pos"], dtype=np.float64)
    c0 = np.asarray(entry["cluster0"], dtype=np.int64)
    if c0.shape[0] != v:
        msg = f"cluster0 has {c0.shape[0]} entries for {v} nodes"
        raise ValueError(msg)
    n_c0 = int(c0.max()) + 1 if c0.size else 0
    psum = np.zeros((max(n_c0, 1), 3))
    np.add.at(psum, c0, pos)
    counts = np.bincount(c0, minlength=max(n_c0, 1)).astype(np.float64)
    pmean = psum / np.maximum(counts, 1.0)[:, None]
    p_order = locality_order(pmean[:n_c0]) if n_c0 > block else np.arange(n_c0)
    sizes = counts[:n_c0].astype(np.int64)

    order = locality_order(pos) if v > block else np.arange(v)
    loc_rank = np.empty(v, dtype=np.int64)
    loc_rank[order] = np.arange(v)
    ord_in = np.lexsort((loc_rank, c0))
    starts = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    mrank = np.empty(v, dtype=np.int64)
    mrank[ord_in] = np.arange(v) - starts[c0[ord_in]]
    return {"c0": c0, "n_c0": n_c0, "sizes": sizes, "p_order": p_order, "mrank": mrank}


def _slot8_plan(entry: dict, block: int) -> dict:
    """Per-entry cluster-slot row plan (the ``slot8`` layout): nodes go
    cluster-major — clusters in their locality order, members in theirs —
    with every cluster padded to a multiple of 8 rows ("slots").

    Returns ``posmap`` (original node -> row), ``cap`` (row capacity),
    ``p_order``/``p_inv`` (the cluster locality permutation), ``slot_col``
    (slot -> local pooled slot id, -1 for trailing padding slots) and
    ``max_slots``."""
    geo = _cluster_geometry(entry, block)
    c0, n_c0, sizes, p_order = geo["c0"], geo["n_c0"], geo["sizes"], geo["p_order"]
    p_inv = np.empty(n_c0, dtype=np.int64)
    p_inv[p_order] = np.arange(n_c0)
    nslots = -(-sizes // 8)
    slot_base = np.zeros(n_c0, dtype=np.int64)
    slot_base[p_order] = np.concatenate([[0], np.cumsum(nslots[p_order])])[:-1]
    total_slots = int(nslots.sum())

    posmap = 8 * slot_base[c0] + geo["mrank"]  # cluster runs are contiguous
    cap = max(-(-(8 * total_slots) // block) * block, block)
    slot_col = np.full(cap // 8, -1, dtype=np.int64)
    slot_col[:total_slots] = np.repeat(np.arange(n_c0), nslots[p_order])
    return {
        "posmap": posmap,
        "cap": cap,
        "p_order": p_order,
        "p_inv": p_inv,
        "slot_col": slot_col,
        "max_slots": int(nslots.max()) if n_c0 else 1,
    }


def _auto_min_slot_nodes(entries: list[dict], threshold: float = 2.5) -> int:
    """Pick the layout from the batch's cluster-size distribution: pure slot8
    (1) unless padding every cluster to 8 rows would inflate the node rows
    more than ``threshold`` times, then the mixed layout (5)."""
    total = slotted = 0
    for e in entries:
        c0 = np.asarray(e["cluster0"], dtype=np.int64)
        if not c0.size:
            continue
        sizes = np.bincount(c0)
        sizes = sizes[sizes > 0]
        total += int(sizes.sum())
        slotted += int((-(-sizes // 8) * 8).sum())
    return 5 if slotted > threshold * max(total, 1) else 1


class _DepthOne:
    """Depth-1 bookkeeping shared by both layouts: the global depth-1 slot of
    each pooled slot and the graph of each depth-1 slot."""

    def __init__(self, num_graphs: int, k_cap: int):
        self.num_graphs = num_graphs
        self.k_cap = k_cap
        self.cluster1_g = np.full(num_graphs * k_cap, -1, dtype=np.int64)
        self.c1_graphs: list[np.ndarray] = []
        self.c1_off = 0

    def add(self, g: int, cluster1, pslot: np.ndarray, valid0: np.ndarray) -> None:
        """Record graph ``g``, whose depth-0 cluster ``c`` sits at local pooled
        slot ``pslot[c]`` and is real where ``valid0[c]``."""
        c1 = np.asarray(cluster1, dtype=np.int64)
        n_c0 = len(pslot)
        if c1.shape[0] != n_c0:
            msg = f"cluster1 has {c1.shape[0]} entries for {n_c0} depth-0 clusters"
            raise ValueError(msg)
        n_c1 = int(c1.max()) + 1 if c1.size else 0
        self.cluster1_g[g * self.k_cap + pslot] = np.where(valid0, c1 + self.c1_off, -1)
        cg = np.full(n_c1, -1, dtype=np.int64)
        if c1.size:
            cg[np.unique(c1)] = g
        self.c1_graphs.append(cg)
        self.c1_off += n_c1

    def arrays(self, pad_c1, pad_members1) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(cluster1, members1, c1_graph)`` with their capacities resolved."""
        c1_cap = _resolve_cap(pad_c1, max(self.c1_off, 1), 1)
        cluster1 = np.where(self.cluster1_g < 0, c1_cap, self.cluster1_g).astype(np.int32)
        c1_graph = np.full(c1_cap, self.num_graphs, dtype=np.int32)
        if self.c1_graphs:
            cg = np.concatenate(self.c1_graphs)
            c1_graph[: len(cg)] = np.where(cg < 0, self.num_graphs, cg)
        members1 = _member_matrix(cluster1, c1_cap, self.num_graphs * self.k_cap, pad_s=pad_members1)
        return cluster1, members1, c1_graph


def _fill_graph(entry: dict, g: int, posmap, pslot_of_c0, x, adj, adj_p, node_mask, n_cap: int, adj_w, adj_wp) -> None:
    """Node features, mask, and the full and pooled adjacencies of graph ``g``
    (pooled: distinct cluster pairs, self-loop pairs dropped); unless the
    f32 accumulators ``adj_w``/``adj_wp`` are empty (unweighted), their
    weights: the first edge-attr channel, summed over duplicate pairs and,
    pooled, over member edges, in the JAX package's order (a self-loop's
    weight lands twice)."""
    x[g * n_cap + posmap] = entry["x"]
    node_mask[g][posmap] = True
    und = np.asarray(entry["edge_index"], dtype=np.int64).reshape(-1, 2)
    if und.size:
        pi, pj = posmap[und[:, 0]], posmap[und[:, 1]]
        adj[g, pi, pj] = 1
        adj[g, pj, pi] = 1
        ci, cj = pslot_of_c0[und[:, 0]], pslot_of_c0[und[:, 1]]
        keep = ci != cj
        adj_p[g, ci[keep], cj[keep]] = 1
        adj_p[g, cj[keep], ci[keep]] = 1
        if adj_w.shape[1]:
            ea = np.asarray(entry["edge_attr"], dtype=np.float32).reshape(len(und), -1)[:, 0]
            np.add.at(adj_w[g], (pi, pj), ea)
            np.add.at(adj_w[g], (pj, pi), ea)
            np.add.at(adj_wp[g], (ci[keep], cj[keep]), ea[keep])
            np.add.at(adj_wp[g], (cj[keep], ci[keep]), ea[keep])


def _num_graphs(entries: list[dict], pad_graphs: int | None) -> tuple[int, list[str]]:
    num_real = len(entries)
    num_graphs = pad_graphs or num_real
    if num_real > num_graphs:
        msg = f"{num_real} entries exceed pad_graphs={num_graphs}"
        raise ValueError(msg)
    return num_graphs, [e["entry_name"] for e in entries] + [""] * (num_graphs - num_real)


def _targets(entries: list[dict], num_graphs: int) -> tuple[np.ndarray, np.ndarray]:
    y = np.zeros(num_graphs, dtype=np.float32)
    y_mask = np.zeros(num_graphs, dtype=bool)
    for g, entry in enumerate(entries):
        if entry.get("y") is not None:
            y[g] = entry["y"]
            y_mask[g] = True
    return y, y_mask


def _weight_accumulators(with_edge_weights: bool, num_graphs: int, n_cap: int, k_cap: int) -> tuple[np.ndarray, np.ndarray]:
    """f32 ``adj_w [G, N, N]`` and ``adj_wp [G, K, K]`` (``[G, 0, 0]`` unweighted)."""
    n, k = (n_cap, k_cap) if with_edge_weights else (0, 0)
    return np.zeros((num_graphs, n, n), dtype=np.float32), np.zeros((num_graphs, k, k), dtype=np.float32)


def _diag_batch(dev, x, adj, node_mask, adj_p, adj_w, adj_wp, weight_dtype, region_caps: tuple = (), **arrays) -> DiagClusteredBatch:
    """The batch on ``dev`` from the collated numpy arrays (``x`` row-major
    ``[G*N, F]``); ``deg``/``deg_p`` are the adjacencies' row sums, and
    ``wsum``/``wsum_p`` those of the f32 weight accumulators, taken before
    the cast to ``weight_dtype``."""
    weighted = adj_w.shape[1] > 0
    tensors = {
        "x_t": np.ascontiguousarray(x.T),
        "adj_i8": adj,
        "node_mask": node_mask,
        "deg": adj.astype(np.float32).sum(axis=2).reshape(-1),
        "deg_p": adj_p.astype(np.float32).sum(axis=2).reshape(-1),
        "wsum": adj_w.sum(axis=2).reshape(-1) if weighted else np.zeros(0, np.float32),
        "wsum_p": adj_wp.sum(axis=2).reshape(-1) if weighted else np.zeros(0, np.float32),
        "adj_p_i8": adj_p,
        **arrays,
    }
    return DiagClusteredBatch(
        **{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in tensors.items()},
        adj_w=torch.from_numpy(adj_w).to(weight_dtype).to(dev),  # f32 -> bf16 rounds to nearest even
        adj_wp=torch.from_numpy(adj_wp).to(weight_dtype).to(dev),
        num_graphs=adj.shape[0],
        region_caps=region_caps,
    )


def collate_graphs_diag_clustered(
    entries: list[dict],
    pad_graphs: int | None = None,
    pad_nodes=None,
    pad_clusters=None,
    pad_c1=None,
    pad_members0s=None,
    pad_members1=None,
    with_edge_weights: bool = False,
    weight_dtype: torch.dtype | None = None,
    min_slot_nodes: int | None = None,
    pad_region_caps: dict | None = None,
    device: str | torch.device | None = None,
) -> tuple[DiagClusteredBatch, list[str]]:
    """Collate entries (``x``, ``pos``, ``edge_index``, ``cluster0``,
    ``cluster1``, ``y``, ``entry_name``) into a :class:`DiagClusteredBatch` on
    ``device`` (CUDA unless ``"cpu"`` is asked for). ``pad_*`` may be ints or
    callables.

    ``min_slot_nodes`` selects the layout: ``1`` = pure slot8, ``>1`` = the
    MIXED size-class region layout (clusters below the threshold pack at
    stride 4/2/1 instead of paying 8-row slot padding), ``None`` = decide
    from the data (:func:`_auto_min_slot_nodes`). ``pad_region_caps``
    buckets the mixed layout's per-region row caps (keys big/s4/s2/s1/kbig).

    ``with_edge_weights`` adds sGAT's weighted adjacencies (``adj_w``,
    ``adj_wp``, stored as ``weight_dtype``: bf16 by default, or f32) and
    their f32 row sums (``wsum``, ``wsum_p``), array for array the JAX
    package's."""
    dev = resolve_device(device)
    weight_dtype = weight_storage(weight_dtype)
    num_graphs, names = _num_graphs(entries, pad_graphs)
    feat_dim = entries[0]["x"].shape[1]

    if min_slot_nodes is None:
        min_slot_nodes = _auto_min_slot_nodes(entries)
    if min_slot_nodes > 1:
        batch = _collate_diag_mixed(
            entries,
            num_graphs,
            feat_dim,
            min_slot_nodes,
            dev,
            pad_c1=pad_c1,
            pad_members0s=pad_members0s,
            pad_members1=pad_members1,
            pad_region_caps=pad_region_caps,
            pad_clusters=pad_clusters,
            with_edge_weights=with_edge_weights,
            weight_dtype=weight_dtype,
        )
        return batch, names
    plans = [_slot8_plan(e, 8) for e in entries]
    n_cap = _resolve_cap(pad_nodes, max(max(p["cap"] for p in plans), 8), 8)
    k_cap = _resolve_cap(pad_clusters, max(max(max(len(p["p_inv"]), 1) for p in plans), 8), 8)

    x = np.zeros((num_graphs * n_cap, feat_dim), dtype=np.float32)
    adj = np.zeros((num_graphs, n_cap, n_cap), dtype=np.int8)
    node_mask = np.zeros((num_graphs, n_cap), dtype=bool)
    slot_cluster = np.full(num_graphs * n_cap // 8, num_graphs * k_cap, dtype=np.int32)
    adj_p = np.zeros((num_graphs, k_cap, k_cap), dtype=np.int8)
    adj_w, adj_wp = _weight_accumulators(with_edge_weights, num_graphs, n_cap, k_cap)
    pooled_mask = np.zeros((num_graphs, k_cap), dtype=bool)
    depth1 = _DepthOne(num_graphs, k_cap)
    for g, entry in enumerate(entries):
        plan = plans[g]
        p_inv = plan["p_inv"]
        c0 = np.asarray(entry["cluster0"], dtype=np.int64)
        n_c0 = len(p_inv)
        _fill_graph(entry, g, plan["posmap"], p_inv[c0], x, adj, adj_p, node_mask, n_cap, adj_w, adj_wp)
        sc = plan["slot_col"]  # local pooled id per slot, -1 = padding
        base = g * n_cap // 8
        slot_cluster[base : base + len(sc)] = np.where(sc >= 0, sc + g * k_cap, num_graphs * k_cap)
        # a gapped cluster0 id would make a zero-member pooled slot; mask it
        # (and keep it out of the depth-1 mean)
        valid0 = np.bincount(c0, minlength=max(n_c0, 1))[:n_c0] > 0 if c0.size else np.ones(n_c0, bool)
        pooled_mask[g][p_inv] = valid0
        depth1.add(g, entry["cluster1"], p_inv, valid0)

    y, y_mask = _targets(entries, num_graphs)
    cluster1, members1, c1_graph = depth1.arrays(pad_c1, pad_members1)
    members0s = _member_matrix(slot_cluster, num_graphs * k_cap, num_graphs * n_cap // 8, pad_s=pad_members0s)
    batch = _diag_batch(
        dev,
        x,
        adj,
        node_mask,
        adj_p,
        adj_w,
        adj_wp,
        weight_dtype,
        slot_cluster=slot_cluster,
        members0s=members0s,
        pooled_mask=pooled_mask,
        cluster1=cluster1,
        members1=members1,
        c1_graph=c1_graph,
        y=y,
        y_mask=y_mask,
    )
    return batch, names


def _collate_diag_mixed(
    entries: list[dict],
    num_graphs: int,
    feat_dim: int,
    min_slot_nodes: int,
    dev: torch.device,
    *,
    pad_c1=None,
    pad_members0s=None,
    pad_members1=None,
    pad_region_caps: dict | None = None,
    pad_clusters=None,
    with_edge_weights: bool = False,
    weight_dtype: torch.dtype = torch.bfloat16,
) -> DiagClusteredBatch:
    """The MIXED size-class region layout (see DiagClusteredBatch.region_caps).

    Per graph, rows lay out as four fixed-cap regions
    ``[slot8 big | stride-4 | stride-2 | stride-1]`` (each cap 8-aligned and
    shared across graphs), clusters ordered by locality within each class.
    Pooled slots mirror the same segmentation (``[kbig | n4/4 | n2/2 | n1]``,
    padded groups = masked pooled slots), so depth-0 pooling is one stride-s
    slot max per region whose outputs concatenate straight into pooled order."""
    pads = dict(pad_region_caps or {})

    # ---- pass 1: per-entry class assignment + region requirements ----
    infos = []
    reqs = {"big": 8, "s4": 0, "s2": 0, "s1": 0, "kbig": 1}
    for e in entries:
        geo = _cluster_geometry(e, 8)
        n_c0, sizes, p_order = geo["n_c0"], geo["sizes"], geo["p_order"]
        cls = _mixed_class(sizes, min_slot_nodes)

        # per-class rank in locality order
        rank = np.zeros(n_c0, dtype=np.int64)
        nslots = np.zeros(n_c0, dtype=np.int64)
        slot_base = np.zeros(n_c0, dtype=np.int64)
        for sc in (8, 4, 2, 1):
            sel = p_order[cls[p_order] == sc]
            rank[sel] = np.arange(len(sel))
            if sc == 8:  # noqa: PLR2004
                ns = -(-sizes[sel] // 8)
                nslots[sel] = ns
                slot_base[sel] = np.concatenate([[0], np.cumsum(ns)])[:-1]
        reqs["big"] = max(reqs["big"], int(nslots.sum()) * 8)
        reqs["s4"] = max(reqs["s4"], 4 * int((cls == 4).sum()))  # noqa: PLR2004
        reqs["s2"] = max(reqs["s2"], 2 * int((cls == 2).sum()))  # noqa: PLR2004
        reqs["s1"] = max(reqs["s1"], int((cls == 1).sum()))
        reqs["kbig"] = max(reqs["kbig"], int((cls == 8).sum()))  # noqa: PLR2004
        infos.append({"c0": geo["c0"], "cls": cls, "rank": rank, "slot_base": slot_base, "nslots": nslots, "mrank": geo["mrank"]})

    # ---- shared caps (8-aligned so regions stay stride-aligned) ----
    nb = _resolve_cap(pads.get("big"), reqs["big"], 8)
    n4 = _resolve_cap(pads.get("s4"), reqs["s4"], 8)
    n2 = _resolve_cap(pads.get("s2"), reqs["s2"], 8)
    n1 = _resolve_cap(pads.get("s1"), reqs["s1"], 8)
    kbig = _resolve_cap(pads.get("kbig"), reqs["kbig"], 8)
    n_cap = nb + n4 + n2 + n1
    k_cap = _resolve_cap(pad_clusters, kbig + n4 // 4 + n2 // 2 + n1, 8)
    # pooled-slot and row base per class
    kbase = {8: 0, 4: kbig, 2: kbig + n4 // 4, 1: kbig + n4 // 4 + n2 // 2}
    rbase = {8: 0, 4: nb, 2: nb + n4, 1: nb + n4 + n2}

    x = np.zeros((num_graphs * n_cap, feat_dim), dtype=np.float32)
    adj = np.zeros((num_graphs, n_cap, n_cap), dtype=np.int8)
    node_mask = np.zeros((num_graphs, n_cap), dtype=bool)
    # COMPACT big-region slot map: [G*nb/8] -> [G*kbig]
    slot_cluster = np.full(num_graphs * nb // 8, num_graphs * kbig, dtype=np.int32)
    adj_p = np.zeros((num_graphs, k_cap, k_cap), dtype=np.int8)
    adj_w, adj_wp = _weight_accumulators(with_edge_weights, num_graphs, n_cap, k_cap)
    pooled_mask = np.zeros((num_graphs, k_cap), dtype=bool)
    depth1 = _DepthOne(num_graphs, k_cap)
    for g, entry in enumerate(entries):
        info = infos[g]
        c0, cls, rank = info["c0"], info["cls"], info["rank"]
        n_c0 = len(cls)

        # cluster -> local pooled slot; cluster -> first row
        pslot = np.empty(n_c0, dtype=np.int64)
        row0 = np.empty(n_c0, dtype=np.int64)
        for sc in (8, 4, 2, 1):
            sel = cls == sc
            pslot[sel] = kbase[sc] + rank[sel]
            row0[sel] = 8 * info["slot_base"][sel] if sc == 8 else rbase[sc] + sc * rank[sel]  # noqa: PLR2004
        _fill_graph(entry, g, row0[c0] + info["mrank"], pslot[c0], x, adj, adj_p, node_mask, n_cap, adj_w, adj_wp)

        # big-region slots -> compact pooled ids, in increasing slot_base
        # order (= the big clusters' locality order)
        big = np.flatnonzero(cls == 8)  # noqa: PLR2004
        if big.size:
            base = g * nb // 8
            order8 = np.argsort(info["slot_base"][big], kind="stable")
            sc8 = np.repeat(pslot[big][order8], info["nslots"][big][order8])
            slot_cluster[base : base + len(sc8)] = sc8 + g * kbig

        valid0 = np.bincount(c0, minlength=max(n_c0, 1))[:n_c0] > 0 if c0.size else np.ones(n_c0, bool)
        pooled_mask[g][pslot] = valid0
        depth1.add(g, entry["cluster1"], pslot, valid0)

    y, y_mask = _targets(entries, num_graphs)
    cluster1, members1, c1_graph = depth1.arrays(pad_c1, pad_members1)
    members0s = _member_matrix(slot_cluster, num_graphs * kbig, num_graphs * nb // 8, pad_s=pad_members0s)
    return _diag_batch(
        dev,
        x,
        adj,
        node_mask,
        adj_p,
        adj_w,
        adj_wp,
        weight_dtype,
        region_caps=(nb, n4, n2, n1, kbig),
        slot_cluster=slot_cluster,
        members0s=members0s,
        pooled_mask=pooled_mask,
        cluster1=cluster1,
        members1=members1,
        c1_graph=c1_graph,
        y=y,
        y_mask=y_mask,
    )


def diag_mixed_requirements(entries: list[dict], min_slot_nodes: int) -> dict:
    """Region requirements of the mixed layout for these entries (a shard- or
    batch-consistent cap source)."""
    reqs = {"big": 8, "s4": 0, "s2": 0, "s1": 0, "kbig": 1}
    c1_total, s1m = 0, 1
    for e in entries:
        c0 = np.asarray(e["cluster0"], dtype=np.int64)
        n_c0 = int(c0.max()) + 1 if c0.size else 0
        sizes = np.bincount(c0, minlength=max(n_c0, 1))[:n_c0]
        cls = _mixed_class(sizes, min_slot_nodes)
        reqs["big"] = max(reqs["big"], int((-(-sizes[cls == 8] // 8)).sum()) * 8)  # noqa: PLR2004
        reqs["s4"] = max(reqs["s4"], 4 * int((cls == 4).sum()))  # noqa: PLR2004
        reqs["s2"] = max(reqs["s2"], 2 * int((cls == 2).sum()))  # noqa: PLR2004
        reqs["s1"] = max(reqs["s1"], int((cls == 1).sum()))
        reqs["kbig"] = max(reqs["kbig"], int((cls == 8).sum()))  # noqa: PLR2004
        reqs["members0s_s"] = max(
            reqs.get("members0s_s", 1),
            int((-(-sizes[cls == 8] // 8)).max()) if (cls == 8).any() else 1,  # noqa: PLR2004
        )
        c1 = np.asarray(e["cluster1"], dtype=np.int64)
        if c1.size:
            c1_total += int(c1.max()) + 1
            s1m = max(s1m, int(np.bincount(c1).max()))
    reqs["c1"] = max(c1_total, 1)
    reqs["members1_s"] = s1m
    reqs.setdefault("members0s_s", 1)
    return reqs


def diag_clustered_requirements(entries: list[dict], min_slot_nodes: int = 1) -> dict:
    """Capacities the pure-slot8 :func:`collate_graphs_diag_clustered` would
    need (a grow-only bucket source). Mixed-layout requirements live in
    :func:`diag_mixed_requirements`."""
    del min_slot_nodes
    plans = [_slot8_plan(e, 8) for e in entries]
    c1_total = 0
    s1 = 1
    for e in entries:
        c1 = np.asarray(e["cluster1"], dtype=np.int64)
        if c1.size:
            c1_total += int(c1.max()) + 1
            s1 = max(s1, int(np.bincount(c1).max()))
    return {
        "nodes": max(p["cap"] for p in plans),
        "clusters": max(max(len(p["p_inv"]), 1) for p in plans),
        "c1": max(c1_total, 1),
        "members0s_s": max(p["max_slots"] for p in plans),
        "members1_s": s1,
    }


# ---------------------------------------------------------------------------
# Block-sparse batches (port of ``BlockSparseBatch``, ``blocksparse_layout``,
# ``collate_graphs_blocksparse``, ``ClusteredBlockSparseBatch`` and
# ``collate_graphs_blocksparse_clustered``)


@dataclass
class BlockSparseBatch:
    """A batch of large graphs in the block-sparse layout (ops/block_sparse.py).

    Nodes of each graph are locality-ordered, padded to a whole number of
    128-node tiles (so no adjacency block spans two graphs) and concatenated:
    the layout of atomic-resolution graphs, too big for ``[G, N, N]``."""

    x: torch.Tensor  # f32 [NT*B, F] node features in locality order (padded rows 0)
    pos: torch.Tensor  # f32 [NT*B, 3]
    node_graph: torch.Tensor  # i32 [NT*B] graph id per node; padded = G
    node_mask: torch.Tensor  # bool [NT*B]
    y: torch.Tensor  # f32 [G]
    y_mask: torch.Tensor  # bool [G]
    structure: BlockSparseStructure  # BCSR adjacency over all NT tiles
    num_graphs: int

    _STATIC = ("num_graphs",)

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    def to(self, device: str | torch.device) -> BlockSparseBatch:
        """A copy of the batch on ``device``."""
        dev = resolve_device(device)
        return type(self)(**{k: getattr(self, k) if k in self._STATIC else getattr(self, k).to(dev) for k in self.__dataclass_fields__})


def blocksparse_layout(
    entries: list[dict], block: int = 128, num_graphs: int | None = None, features: bool = True, plans: list[dict] | None = None
) -> dict:
    """The locality pass of the block-sparse collates: per entry its locality
    order, tile-padded copies of its features, positions, graph ids and mask
    (only when ``features``: the requirements passes skip them), and its
    undirected pairs remapped to batch rows. One pass backs the collates and
    their requirements, so a capacity never differs from what a collate
    needs.

    ``plans`` (the slot8 layout, :func:`_slot8_plan`) override the row
    placement: ``posmap`` maps an original node to its row (holes are
    intra-cluster padding rows) and ``cap`` is the entry's row capacity."""
    num_graphs = len(entries) if num_graphs is None else num_graphs
    feat_dim = entries[0]["x"].shape[1] if entries else 0
    xs, poss, graph_ids, masks, pairs, orders, offsets = [], [], [], [], [], [], []
    offset = 0
    for g, entry in enumerate(entries):
        v = entry["x"].shape[0]
        if plans is not None:
            posmap, cap = plans[g]["posmap"], plans[g]["cap"]
            order = None
        else:
            order = locality_order(entry["pos"]) if v > block else np.arange(v)
            posmap = np.empty(v, dtype=np.int64)
            posmap[order] = np.arange(v)
            cap = -(-v // block) * block
        und = np.asarray(entry["edge_index"], dtype=np.int64).reshape(-1, 2)
        pairs.append(posmap[und] + offset)
        orders.append(order)
        offsets.append(offset)
        if features:
            x = np.zeros((cap, feat_dim), dtype=np.float32)
            x[posmap] = entry["x"]
            pos = np.zeros((cap, 3), dtype=np.float32)
            pos[posmap] = entry["pos"]
            gid = np.full(cap, num_graphs, dtype=np.int32)
            gid[posmap] = g
            m = np.zeros(cap, dtype=bool)
            m[posmap] = True
            xs.append(x)
            poss.append(pos)
            graph_ids.append(gid)
            masks.append(m)
        offset += cap
    return {
        "xs": xs,
        "poss": poss,
        "graph_ids": graph_ids,
        "masks": masks,
        "pairs": np.concatenate(pairs) if pairs else np.zeros((0, 2), np.int64),
        "num_tiles": max(offset // block, 1),
        "feat_dim": feat_dim,
        # per-entry locality orders and batch row offsets: the clustered
        # collate remaps cluster ids through these
        "orders": orders,
        "offsets": offsets,
    }


def _capacity(pad, required: int, what: str) -> int:
    """An int or ``required -> capacity`` callable capacity against its
    requirement; None keeps the requirement."""
    if callable(pad):
        pad = pad(required)
    if pad is None:
        return required
    if pad < required:
        msg = f"{what}={pad} < required {required}"
        raise ValueError(msg)
    return pad


def _pad_rows(layout: dict, extra: int, num_graphs: int) -> None:
    """Append ``extra`` padding rows (no node, graph id ``num_graphs``) to a
    layout's feature, position, graph-id and mask columns."""
    if extra:
        layout["xs"].append(np.zeros((extra, layout["feat_dim"]), np.float32))
        layout["poss"].append(np.zeros((extra, 3), np.float32))
        layout["graph_ids"].append(np.full(extra, num_graphs, np.int32))
        layout["masks"].append(np.zeros(extra, bool))


def collate_graphs_blocksparse(
    entries: list[dict],
    pad_graphs: int | None = None,
    device: str | torch.device | None = None,
    pad_tiles=None,
    pad_blocks=None,
) -> tuple[BlockSparseBatch, list[str]]:
    """Collate entries (``x``, ``pos``, ``edge_index``, ``y``,
    ``entry_name``) into a :class:`BlockSparseBatch` on ``device`` (CUDA
    unless ``"cpu"`` is asked for); ``pad_graphs`` adds empty graphs.
    ``pad_tiles`` and ``pad_blocks`` may be ints or ``required -> capacity``
    callables (the Trainer's grow-only buckets): padding tiles are rows of no
    node, padding blocks all-zero blocks (:func:`build_blocksparse`)."""
    dev = resolve_device(device)
    num_graphs, names = _num_graphs(entries, pad_graphs)
    layout = blocksparse_layout(entries, DEFAULT_BLOCK, num_graphs)
    num_tiles = _capacity(pad_tiles, layout["num_tiles"], "pad_tiles")
    _pad_rows(layout, (num_tiles - layout["num_tiles"]) * DEFAULT_BLOCK, num_graphs)
    structure = build_blocksparse(layout["pairs"], num_nodes=num_tiles * DEFAULT_BLOCK, pad_blocks_to=pad_blocks, device=dev)
    y, y_mask = _targets(entries, num_graphs)
    arrays = _tensors(
        dev,
        x=np.concatenate(layout["xs"]),
        pos=np.concatenate(layout["poss"]),
        node_graph=np.concatenate(layout["graph_ids"]),
        node_mask=np.concatenate(layout["masks"]),
        y=y,
        y_mask=y_mask,
    )
    return BlockSparseBatch(**arrays, structure=structure, num_graphs=num_graphs), names


def blocksparse_requirements(entries: list[dict]) -> tuple[int, int]:
    """``(tiles, run-padded blocks)`` that :func:`collate_graphs_blocksparse`
    needs for these entries: the layout pass without feature copies or
    blocks (the JAX package's, for its sharded collates; here the source of
    the Trainer's bucket keys ``tiles`` and ``blocks``)."""
    layout = blocksparse_layout(entries, DEFAULT_BLOCK, features=False)
    return layout["num_tiles"], required_blocks(layout["pairs"], layout["num_tiles"] * DEFAULT_BLOCK)


@dataclass
class ClusteredBlockSparseBatch(BlockSparseBatch):
    """Block-sparse batch for the clustered models at atomic scale: the full
    graph and its depth-0 community-pooled graph both ride BCSR adjacencies,
    and every cluster lookup is built at collate.

    Pooled-node rows live in their own locality order; ``cluster0`` maps a
    full-graph row to its pooled slot. The member matrices serve the
    scatter-free max pools (ops/pooling.py:member_max_pool); shape (0, 0)
    means "use the segment max" (one pathological cluster). The slot8 fields
    are empty in the plain layout. In sGAT's batches both structures carry
    the edge weights and ``wsum``/``wsum_p`` their f32 row sums; in others
    ``wsum``/``wsum_p`` are empty."""

    deg: torch.Tensor  # f32 [NT*B] full-graph neighbour counts
    cluster0: torch.Tensor  # i32 [NT*B] row -> pooled slot; padded = NTp*B
    structure_p: BlockSparseStructure  # pooled-graph adjacency (distinct cluster pairs)
    deg_p: torch.Tensor  # f32 [NTp*B] pooled neighbour counts
    pooled_node_graph: torch.Tensor  # i32 [NTp*B]; padded = G
    pooled_node_mask: torch.Tensor  # bool [NTp*B]
    cluster1: torch.Tensor  # i32 [NTp*B] pooled slot -> depth-1 slot; padded = C1
    c1_graph: torch.Tensor  # i32 [C1] graph id per depth-1 slot; padded = G
    members0: torch.Tensor  # i32 [NTp*B, S0] rows per pooled slot; pad = NT*B
    members1: torch.Tensor  # i32 [C1, S1] pooled slots per depth-1 slot; pad = NTp*B
    slot_cluster: torch.Tensor  # i32 [NT*B/8] slot8: slot -> pooled slot; padding = NTp*B
    members0s: torch.Tensor  # i32 [NTp*B, S0s] slot8: slots per pooled slot; pad = NT*B/8
    wsum: torch.Tensor  # f32 [NT*B] weighted row sums ([0] unweighted)
    wsum_p: torch.Tensor  # f32 [NTp*B] pooled weighted row sums ([0] unweighted)


# column tiles per chunk of the clustered collate's full-graph structure (its
# consumers contract at F <= 32, so the JAX kernel's chunk is twice the default)
_CLUSTERED_CHUNK_TILES = 640


def _pooled_graph(entry: dict, block: int, plan: dict | None = None) -> dict:
    """One entry's depth-0 pooled graph for the clustered block-sparse
    layout: its clusters in their locality order (``p_order``/``p_inv``, the
    slot8 ``plan``'s when given: the same permutation), the tile-padded
    pooled row capacity ``p_cap``, and its distinct cluster pairs without
    self-loop pairs (``pairs``, local rows; ``keep`` and ``inverse`` map each
    member edge to its pair)."""
    v = entry["x"].shape[0]
    c0 = np.asarray(entry["cluster0"], dtype=np.int64)
    c1 = np.asarray(entry["cluster1"], dtype=np.int64)
    if c0.shape[0] != v:
        msg = f"cluster0 has {c0.shape[0]} entries for {v} nodes"
        raise ValueError(msg)
    n_c0 = int(c0.max()) + 1 if c0.size else 0
    if c1.shape[0] != n_c0:
        msg = f"cluster1 has {c1.shape[0]} entries for {n_c0} depth-0 clusters"
        raise ValueError(msg)
    counts = np.bincount(c0, minlength=n_c0)
    if plan is not None:
        p_order, p_inv = plan["p_order"], plan["p_inv"]
    else:
        # pooled locality order from the cluster mean positions
        psum = np.zeros((n_c0, 3))
        np.add.at(psum, c0, np.asarray(entry["pos"], dtype=np.float64))
        pmean = psum / np.maximum(counts.astype(np.float64), 1.0)[:, None]
        p_order = locality_order(pmean) if n_c0 > block else np.arange(n_c0)
        p_inv = np.empty(n_c0, dtype=np.int64)
        p_inv[p_order] = np.arange(n_c0)
    p_cap = max(-(-n_c0 // block) * block, block)
    # pooled edges: member edges mapped to clusters, self-loops dropped,
    # duplicates coalesced
    und = np.asarray(entry["edge_index"], dtype=np.int64).reshape(-1, 2)
    pi, pj = p_inv[c0[und[:, 0]]], p_inv[c0[und[:, 1]]]
    keep = pi != pj
    lo, hi = np.minimum(pi[keep], pj[keep]), np.maximum(pi[keep], pj[keep])
    uniq_key, inverse = np.unique(lo * p_cap + hi, return_inverse=True)
    return {
        "c0": c0,
        "c1": c1,
        "n_c0": n_c0,
        "n_c1": int(c1.max()) + 1 if c1.size else 0,
        "max_members": int(counts.max()) if counts.size else 0,
        "max_c1_members": int(np.bincount(c1).max()) if c1.size else 0,
        "p_order": p_order,
        "p_inv": p_inv,
        "p_cap": p_cap,
        "und": und,
        "keep": keep,
        "inverse": inverse,
        "pairs": np.stack([uniq_key // p_cap, uniq_key % p_cap], axis=1),
    }


def collate_graphs_blocksparse_clustered(
    entries: list[dict],
    pad_graphs: int | None = None,
    with_edge_weights: bool = False,
    weight_dtype: torch.dtype | None = None,
    slot8: bool = False,
    device: str | torch.device | None = None,
    pad_tiles=None,
    pad_blocks=None,
    pad_pooled_tiles=None,
    pad_pooled_blocks=None,
    pad_c1=None,
    pad_members0=None,
    pad_members1=None,
    pad_members0s=None,
) -> tuple[ClusteredBlockSparseBatch, list[str]]:
    """Collate entries (``x``, ``pos``, ``edge_index``, ``cluster0``,
    ``cluster1``, ``y``, ``entry_name``) into a
    :class:`ClusteredBlockSparseBatch` on ``device`` (CUDA unless ``"cpu"``
    is asked for), array for array as the JAX package's.

    The pooled graph keeps distinct cluster pairs and drops self-loop pairs.
    ``slot8`` lays nodes out cluster-major in 8-lane slots
    (:func:`_slot8_plan`), fills ``slot_cluster``/``members0s`` for the slot
    max-pool kernels and rounds the node capacity to whole groups of 8 tiles.

    ``with_edge_weights`` (sGAT) weights both adjacencies by the first
    edge-attr channel (``weight_dtype`` blocks: bf16 by default, or f32): a
    pooled pair carries the sum of its member edges' weights, and
    ``wsum``/``wsum_p`` are the f32 row sums, accumulated as the JAX package
    does.

    Every ``pad_*`` capacity may be an int or a ``required -> capacity``
    callable (the Trainer's grow-only buckets): tiles and pooled tiles add
    rows of no node, blocks and pooled blocks all-zero blocks, ``pad_c1``
    depth-1 slots of no graph, and ``pad_members*`` padding columns of the
    member matrices."""
    dev = resolve_device(device)
    weight_dtype = weight_storage(weight_dtype)
    block = DEFAULT_BLOCK
    num_graphs, names = _num_graphs(entries, pad_graphs)
    plans = [_slot8_plan(e, block) for e in entries] if slot8 else None
    layout = blocksparse_layout(entries, block, num_graphs, plans=plans)

    cluster0_cols, pooled_graph_ids, pooled_masks, cluster1_cols, c1_graphs, pooled_pairs, slot_cols = [], [], [], [], [], [], []
    weights_full, pooled_weights = [], []
    p_offset = c1_off = 0
    for g, entry in enumerate(entries):
        pg = _pooled_graph(entry, block, plans[g] if slot8 else None)
        c0, c1, n_c0, n_c1, p_cap, p_inv = pg["c0"], pg["c1"], pg["n_c0"], pg["n_c1"], pg["p_cap"], pg["p_inv"]
        if slot8:
            plan = plans[g]
            col = np.full(plan["cap"], -1, dtype=np.int64)
            col[plan["posmap"]] = p_inv[c0] + p_offset
            slot_cols.append(np.where(plan["slot_col"] >= 0, plan["slot_col"] + p_offset, -1))
        else:
            col = np.full(-(-c0.shape[0] // block) * block, -1, dtype=np.int64)  # -1: padding, set below
            col[: c0.shape[0]] = p_inv[c0[layout["orders"][g]]] + p_offset
        cluster0_cols.append(col)

        graph_ids = np.full(p_cap, num_graphs, dtype=np.int32)
        graph_ids[:n_c0] = g
        pooled_graph_ids.append(graph_ids)
        pooled_masks.append(np.arange(p_cap) < n_c0)
        c1_col = np.full(p_cap, -1, dtype=np.int64)
        c1_col[:n_c0] = c1[pg["p_order"]] + c1_off
        cluster1_cols.append(c1_col)
        # only depth-1 ids hit by a pooled node count toward the graph mean
        cg = np.full(n_c1, -1, dtype=np.int64)
        if c1.size:
            cg[np.unique(c1)] = g
        c1_graphs.append(cg)

        pooled_pairs.append(pg["pairs"] + p_offset)
        if with_edge_weights:
            und = pg["und"]
            w = np.asarray(entry["edge_attr"], dtype=np.float32).reshape(len(und), -1)[:, 0] if und.size else np.zeros(0, np.float32)
            weights_full.append(w)
            pw = np.zeros(len(pg["pairs"]), dtype=np.float32)
            np.add.at(pw, pg["inverse"], w[pg["keep"]])
            pooled_weights.append(pw)
        p_offset += p_cap
        c1_off += n_c1

    num_pooled_tiles = _capacity(pad_pooled_tiles, max(p_offset // block, 1), "pad_pooled_tiles")
    extra = num_pooled_tiles * block - p_offset
    if extra > 0:
        pooled_graph_ids.append(np.full(extra, num_graphs, np.int32))
        pooled_masks.append(np.zeros(extra, bool))
        cluster1_cols.append(np.full(extra, -1, np.int64))
    pooled_cap = num_pooled_tiles * block

    num_tiles = layout["num_tiles"]
    pad_tiles = pad_tiles(num_tiles) if callable(pad_tiles) else pad_tiles
    if slot8:
        # whole groups of 8 tiles (1024 lanes), as the JAX slot kernel's grid wants
        pad_tiles = -(-(num_tiles if pad_tiles is None else pad_tiles) // 8) * 8
    num_tiles = _capacity(pad_tiles, num_tiles, "pad_tiles")
    extra = (num_tiles - layout["num_tiles"]) * block
    _pad_rows(layout, extra, num_graphs)
    if extra:
        cluster0_cols.append(np.full(extra, -1, np.int64))
        if slot8:
            slot_cols.append(np.full(extra // 8, -1, np.int64))
    node_cap = num_tiles * block
    c1_cap = _capacity(pad_c1 or None, max(c1_off, 1), "pad_c1")

    cluster0 = np.concatenate(cluster0_cols)
    cluster0 = np.where(cluster0 < 0, pooled_cap, cluster0).astype(np.int32)
    cluster1 = np.concatenate(cluster1_cols)
    cluster1 = np.where(cluster1 < 0, c1_cap, cluster1).astype(np.int32)
    c1_graph = np.full(c1_cap, num_graphs, dtype=np.int32)
    if c1_graphs:
        cg = np.concatenate(c1_graphs)
        c1_graph[: len(cg)] = np.where(cg < 0, num_graphs, cg)

    pairs = layout["pairs"]
    p_pairs = np.concatenate(pooled_pairs) if pooled_pairs else np.zeros((0, 2), np.int64)
    w_full = np.concatenate(weights_full) if weights_full else None
    p_w = np.concatenate(pooled_weights) if pooled_weights else None
    structure = build_blocksparse(
        pairs,
        num_nodes=node_cap,
        pad_blocks_to=pad_blocks,
        chunk_tiles=_CLUSTERED_CHUNK_TILES,
        weights=w_full,
        weight_dtype=weight_dtype,
        device=dev,
    )
    structure_p = build_blocksparse(p_pairs, num_nodes=pooled_cap, pad_blocks_to=pad_pooled_blocks, weights=p_w, weight_dtype=weight_dtype, device=dev)
    deg = np.zeros(node_cap, dtype=np.float32)
    np.add.at(deg, pairs.reshape(-1), 1.0)
    deg_p = np.zeros(pooled_cap, dtype=np.float32)
    np.add.at(deg_p, p_pairs.reshape(-1), 1.0)
    # weighted row sums: both ends of each pair, in the JAX package's order
    wsum = np.zeros(node_cap if with_edge_weights else 0, dtype=np.float32)
    wsum_p = np.zeros(pooled_cap if with_edge_weights else 0, dtype=np.float32)
    for sums, prs, w in ((wsum, pairs, w_full), (wsum_p, p_pairs, p_w)):
        if with_edge_weights and prs.size:
            np.add.at(sums, prs[:, 0], w)
            np.add.at(sums, prs[:, 1], w)

    if slot8:
        slot_cluster = np.concatenate(slot_cols)
        slot_cluster = np.where(slot_cluster < 0, pooled_cap, slot_cluster).astype(np.int32)
        members0s = _member_matrix(slot_cluster, pooled_cap, node_cap // 8, pad_s=pad_members0s)
    else:
        slot_cluster = np.zeros(0, np.int32)
        members0s = np.zeros((0, 0), np.int32)
    y, y_mask = _targets(entries, num_graphs)
    arrays = _tensors(
        dev,
        x=np.concatenate(layout["xs"]),
        pos=np.concatenate(layout["poss"]),
        node_graph=np.concatenate(layout["graph_ids"]),
        node_mask=np.concatenate(layout["masks"]),
        y=y,
        y_mask=y_mask,
        deg=deg,
        cluster0=cluster0,
        deg_p=deg_p,
        pooled_node_graph=np.concatenate(pooled_graph_ids),
        pooled_node_mask=np.concatenate(pooled_masks),
        cluster1=cluster1,
        c1_graph=c1_graph,
        members0=_member_matrix(cluster0, pooled_cap, node_cap, pad_s=pad_members0),
        members1=_member_matrix(cluster1, c1_cap, pooled_cap, pad_s=pad_members1),
        slot_cluster=slot_cluster,
        members0s=members0s,
        wsum=wsum,
        wsum_p=wsum_p,
    )
    return ClusteredBlockSparseBatch(**arrays, structure=structure, structure_p=structure_p, num_graphs=num_graphs), names


def clustered_blocksparse_requirements(entries: list[dict], slot8: bool = False) -> dict:
    """The capacities :func:`collate_graphs_blocksparse_clustered` needs for
    these entries, by the Trainer's bucket keys: the light pass (no feature
    copies, no blocks), with the collate's per-entry cluster math and, under
    ``slot8``, its row plan (whose padding changes the tile and block
    counts)."""
    block = DEFAULT_BLOCK
    plans = [_slot8_plan(e, block) for e in entries] if slot8 else None
    layout = blocksparse_layout(entries, block, features=False, plans=plans)
    p_offset = c1_total = 0
    s0 = s1 = 1
    pooled_pairs = []
    for entry in entries:
        pg = _pooled_graph(entry, block)
        s0 = max(s0, pg["max_members"])
        s1 = max(s1, pg["max_c1_members"])
        pooled_pairs.append(pg["pairs"] + p_offset)
        p_offset += pg["p_cap"]
        c1_total += pg["n_c1"]
    pooled_tiles = max(p_offset // block, 1)
    p_pairs = np.concatenate(pooled_pairs) if pooled_pairs else np.zeros((0, 2), np.int64)
    req = {
        "tiles": layout["num_tiles"],
        "blocks": required_blocks(layout["pairs"], layout["num_tiles"] * block, chunk_tiles=_CLUSTERED_CHUNK_TILES),
        "pooled_tiles": pooled_tiles,
        "pooled_blocks": required_blocks(p_pairs, pooled_tiles * block),
        "c1": max(c1_total, 1),
        "members0_s": s0,
        "members1_s": s1,
    }
    if slot8:
        req["members0s_s"] = max(p["max_slots"] for p in plans)
    return req


# ---------------------------------------------------------------------------
# Blocked-edge batches (port of ``BlockedEdgeBatch`` and
# ``collate_graphs_blocked``)


@dataclass
class BlockedEdgeBatch(BlockSparseBatch):
    """A batch of graphs in the blocked per-edge-feature layout
    (ops/blocked_edges.py), for the VanillaNetwork family: the node layout
    and fields of :class:`BlockSparseBatch` with ``EDGE_TILE``-node tiles,
    but the edges and their features stay a list, in tile-sorted slabs."""

    structure: BlockedEdgeStructure  # sorted edge slabs over all NT tiles


def collate_graphs_blocked(
    entries: list[dict],
    pad_tiles=None,
    pad_slabs=None,
    pad_graphs: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[BlockedEdgeBatch, list[str]]:
    """Collate entries (``x``, ``pos``, ``edge_index``, ``edge_attr``, ``y``,
    ``entry_name``) into a :class:`BlockedEdgeBatch` on ``device`` (CUDA
    unless ``"cpu"`` is asked for). ``pad_tiles`` and ``pad_slabs`` may be
    ints or ``required -> capacity`` callables; ``pad_graphs`` adds empty
    graphs."""
    dev = resolve_device(device)
    num_graphs, names = _num_graphs(entries, pad_graphs)
    layout = blocksparse_layout(entries, EDGE_TILE, num_graphs)
    num_tiles = _capacity(pad_tiles, layout["num_tiles"], "pad_tiles")
    _pad_rows(layout, (num_tiles - layout["num_tiles"]) * EDGE_TILE, num_graphs)

    # edge features in the same per-entry order as the remapped pairs
    eattrs = [np.asarray(e["edge_attr"], dtype=np.float32) for e in entries]
    eattrs = [ea[:, None] if ea.ndim == 1 else ea for ea in eattrs]
    edge_dim = eattrs[0].shape[1] if eattrs else 1
    eattr = np.concatenate(eattrs) if eattrs else np.zeros((0, edge_dim), np.float32)
    structure = build_blocked_edges(layout["pairs"], eattr, num_nodes=num_tiles * EDGE_TILE, pad_slabs=pad_slabs, device=dev)
    y, y_mask = _targets(entries, num_graphs)
    arrays = _tensors(
        dev,
        x=np.concatenate(layout["xs"]),
        pos=np.concatenate(layout["poss"]),
        node_graph=np.concatenate(layout["graph_ids"]),
        node_mask=np.concatenate(layout["masks"]),
        y=y,
        y_mask=y_mask,
    )
    return BlockedEdgeBatch(**arrays, structure=structure, num_graphs=num_graphs), names


def blocked_requirements(entries: list[dict]) -> tuple[int, int]:
    """``(tiles, slabs)`` that :func:`collate_graphs_blocked` needs for these
    entries: the source of the Trainer's bucket keys ``be_tiles`` and
    ``be_slabs``."""
    layout = blocksparse_layout(entries, EDGE_TILE, features=False)
    return layout["num_tiles"], required_slabs(layout["pairs"], layout["num_tiles"] * EDGE_TILE)


# ---------------------------------------------------------------------------
# COO batches (port of ``GraphBatch`` and ``collate_graphs``)


@dataclass
class GraphBatch:
    """One padded COO batch of graphs, on one device: nodes of all graphs
    concatenated and padded to a bucketed ``V``, mirrored edges padded to a
    bucketed ``E`` and sorted by destination row (padded edges carry ``V``
    and sort last), as the JAX package's ``GraphBatch``."""

    x: torch.Tensor  # f32 [V, F] node features (padded rows 0)
    edge_index: torch.Tensor  # i32 [2, E] mirrored edges, sorted by row; padded entries = V
    edge_attr: torch.Tensor  # f32 [E, Fe]
    pos: torch.Tensor  # f32 [V, 3]
    node_graph: torch.Tensor  # i32 [V] graph id per node; padded = G
    edge_mask: torch.Tensor  # bool [E]
    node_mask: torch.Tensor  # bool [V]
    y: torch.Tensor  # f32 [G] targets (0 where missing)
    y_mask: torch.Tensor  # bool [G] real-graph mask
    cluster0: torch.Tensor  # i32 [V] batch-global depth-0 cluster ids; padded = V
    cluster1: torch.Tensor  # i32 [V] batch-global depth-1 cluster ids, indexed by depth-0 cluster; padded = V
    num_graphs: int

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]

    def to(self, device: str | torch.device) -> GraphBatch:
        """A copy of the batch on ``device``."""
        dev = resolve_device(device)
        return GraphBatch(**{k: self.num_graphs if k == "num_graphs" else getattr(self, k).to(dev) for k in self.__dataclass_fields__})


def collate_graphs(entries: list[dict], pad_graphs: int | None = None, device: str | torch.device | None = None) -> tuple[GraphBatch, list[str]]:
    """Collate entries (``x [v, F]``, ``edge_index [e, 2]`` undirected,
    ``edge_attr [e, Fe]``, ``pos [v, 3]``, ``y`` or None, optional
    ``cluster0 [v]`` and ``cluster1 [c0]``, ``entry_name``) into one padded
    :class:`GraphBatch` on ``device`` (CUDA unless ``"cpu"`` is asked for),
    array for array as the JAX package's ``collate_graphs``. Returns the batch
    and the entry names (padded graphs get "")."""
    dev = resolve_device(device)
    num_graphs, names = _num_graphs(entries, pad_graphs)

    total_v = int(sum(e["x"].shape[0] for e in entries))
    total_e = int(sum(e["edge_index"].shape[0] * 2 for e in entries))
    cap_v = bucket_size(total_v)
    cap_e = bucket_size(total_e)
    feat_dim = entries[0]["x"].shape[1]
    edge_dim = entries[0]["edge_attr"].shape[1] if entries[0]["edge_attr"].ndim == 2 else 1

    x = np.zeros((cap_v, feat_dim), dtype=np.float32)
    pos = np.zeros((cap_v, 3), dtype=np.float32)
    node_graph = np.full(cap_v, num_graphs, dtype=np.int32)
    node_mask = np.zeros(cap_v, dtype=bool)
    edge_index = np.full((2, cap_e), cap_v, dtype=np.int32)
    edge_attr = np.zeros((cap_e, edge_dim), dtype=np.float32)
    edge_mask = np.zeros(cap_e, dtype=bool)
    cluster0 = np.full(cap_v, cap_v, dtype=np.int32)
    cluster1 = np.full(cap_v, cap_v, dtype=np.int32)
    have_clusters = all(e.get("cluster0") is not None and e.get("cluster1") is not None for e in entries)

    v_off = e_off = c0_off = c1_off = 0
    for g, entry in enumerate(entries):
        v = entry["x"].shape[0]
        x[v_off : v_off + v] = entry["x"]
        pos[v_off : v_off + v] = entry["pos"]
        node_graph[v_off : v_off + v] = g
        node_mask[v_off : v_off + v] = True

        und = np.asarray(entry["edge_index"], dtype=np.int64)
        mirrored = np.concatenate([und, und[:, ::-1]], axis=0)  # [2e, 2]
        e2 = mirrored.shape[0]
        edge_index[:, e_off : e_off + e2] = (mirrored + v_off).T
        ea = np.asarray(entry["edge_attr"], dtype=np.float32)
        if ea.ndim == 1:
            ea = ea[:, None]
        edge_attr[e_off : e_off + e2] = np.concatenate([ea, ea], axis=0)
        edge_mask[e_off : e_off + e2] = True

        if have_clusters:
            c0 = np.asarray(entry["cluster0"], dtype=np.int64)
            c1 = np.asarray(entry["cluster1"], dtype=np.int64)
            n_c0 = int(c0.max()) + 1 if c0.size else 0
            n_c1 = int(c1.max()) + 1 if c1.size else 0
            cluster0[v_off : v_off + v] = c0 + c0_off
            cluster1[c0_off : c0_off + n_c0] = c1 + c1_off  # indexed by depth-0 cluster id
            c0_off += n_c0
            c1_off += n_c1
        v_off += v
        e_off += e2

    # edges sorted by destination row (padded edges carry cap_v and stay
    # last): ascending segment ids, the precondition of the sorted segment sum
    order = np.argsort(edge_index[0], kind="stable")
    y, y_mask = _targets(entries, num_graphs)
    arrays = _tensors(
        dev,
        x=x,
        edge_index=edge_index[:, order],
        edge_attr=edge_attr[order],
        pos=pos,
        node_graph=node_graph,
        edge_mask=edge_mask[order],
        node_mask=node_mask,
        y=y,
        y_mask=y_mask,
        cluster0=cluster0,
        cluster1=cluster1,
    )
    return GraphBatch(**arrays, num_graphs=num_graphs), names
