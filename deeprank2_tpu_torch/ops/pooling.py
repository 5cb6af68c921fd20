"""Community and graph pooling (port of ``deeprank2_tpu/ops/pooling.py``:
``member_max_pool``, ``diag_depth0_pool``, the fast models' shared depth-1
pool and mean ``depth1_graph_mean``, ``tiled_graph_mean_pool``,
``tiled_graph_mean_pool_rows``, the COO ``pool_edges_coalesce``,
``community_pool``, ``max_pool_x`` and ``graph_mean_pool``, and the
block-dense ``dense_segment_max`` and ``dense_community_pool``).

Conventions, as in the JAX package: cluster ids are batch-global and below
the capacity; padded rows carry out-of-range ids. Pooled features are
post-relu and masked (``h >= 0``, padded rows 0), so an empty cluster pools
to 0.
"""

from __future__ import annotations

import torch

from deeprank2_tpu_torch.ops.segment import segment_max, segment_mean, segment_min, segment_sum
from deeprank2_tpu_torch.ops.slotpool import slot_group_max


class _MemberMaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, members, cluster):
        v = h.shape[0]
        # S-leading gather [S, C, F], reduced over the leading axis
        mt = members.T
        gathered = torch.where((mt < v)[..., None], h[mt.clamp(0, v - 1)], torch.zeros((), dtype=h.dtype, device=h.device))
        pooled = gathered.amax(dim=0)
        ctx.save_for_backward(h, pooled, cluster)
        return pooled

    @staticmethod
    def backward(ctx, grad):
        h, pooled, cluster = ctx.saved_tensors
        num_c, f = pooled.shape
        # one packed [V, 2F] gather of (pooled, g) by each row's cluster
        packed = torch.cat([pooled, grad], dim=1)[cluster.clamp(0, num_c - 1)]
        winner = (h == packed[:, :f]) & (cluster < num_c)[:, None]
        return torch.where(winner, packed[:, f:], torch.zeros((), dtype=grad.dtype, device=grad.device)), None, None


def member_max_pool(h: torch.Tensor, members: torch.Tensor, cluster: torch.Tensor) -> torch.Tensor:
    """Per-cluster feature max through a member matrix: ``h [V, F]``
    (non-negative, padded rows 0), ``members [C, S]`` (row indices of each
    cluster, padding = V) and its inverse ``cluster [V]`` (padding >= C) give
    ``[C, F]``.

    The backward uses gathers only: every valid row that reaches its
    cluster's max gets the FULL cotangent (no division among ties, the JAX
    package's rule)."""
    return _MemberMaxPool.apply(h, members, cluster)


def diag_depth0_pool(h_t: torch.Tensor, batch) -> torch.Tensor:
    """Depth-0 community pooling of
    :class:`~deeprank2_tpu_torch.ops.batch.DiagClusteredBatch` activations,
    ``[F, G*N] -> [F, G*K]``.

    Pure slot8 batches: the aligned 8-lane slot max (ops/slotpool.py) and the
    per-cluster slot combine. Mixed batches (``region_caps`` set): each
    size-class region pools with its own stride (the 1-lane region is its own
    pooled value) and the per-graph segments concatenate into pooled order."""
    if not batch.region_caps:
        mask_row = batch.node_mask.to(h_t.dtype).reshape(1, -1)
        p8 = slot_group_max(h_t, mask_row)
        if batch.members0s.numel():
            hp = member_max_pool(p8.T, batch.members0s, batch.slot_cluster)  # [G*K, F]
        else:
            hp = segment_max(p8.T, batch.slot_cluster, batch.pooled_mask.numel())
        return hp.T

    nb, n4, n2, n1, kbig = batch.region_caps
    f = h_t.shape[0]
    num_graphs, k_cap = batch.pooled_mask.shape
    n_cap = batch.node_mask.shape[1]
    h3 = h_t.reshape(f, num_graphs, n_cap)
    m3 = batch.node_mask.to(h_t.dtype)

    def region(off: int, ns: int) -> tuple[torch.Tensor, torch.Tensor]:
        # a strided slice of every graph's rows: copied, since the slot
        # kernels take contiguous operands
        hs = h3[:, :, off : off + ns].contiguous().reshape(f, num_graphs * ns)
        ms = m3[:, off : off + ns].contiguous().reshape(1, num_graphs * ns)
        return hs, ms

    segs = []
    if nb:
        p8 = slot_group_max(*region(0, nb))  # [F, G*nb/8]
        if batch.members0s.numel():
            comb = member_max_pool(p8.T, batch.members0s, batch.slot_cluster)  # [G*kbig, F]
        else:  # one pathological cluster tripped the member-matrix size guard
            comb = segment_max(p8.T, batch.slot_cluster, num_graphs * kbig)
        segs.append(comb.T.reshape(f, num_graphs, kbig))
    off = nb
    for stride, ns in ((4, n4), (2, n2)):
        if ns:
            ps = slot_group_max(*region(off, ns), slot=stride)
            segs.append(ps.reshape(f, num_graphs, ns // stride))
        off += ns
    if n1:
        segs.append(h3[:, :, off : off + n1])
    hp3 = torch.cat(segs, dim=2) if len(segs) > 1 else segs[0]
    if hp3.shape[2] < k_cap:
        hp3 = torch.nn.functional.pad(hp3, (0, k_cap - hp3.shape[2]))
    return hp3.reshape(f, num_graphs * k_cap)


def depth1_graph_mean(h2_t: torch.Tensor, batch) -> torch.Tensor:
    """The clustered fast layouts' head input, ``[G, F]``: the depth-1 max
    pool of the pooled-graph activations ``h2_t [F, Vp]`` and the per-graph
    mean over the depth-1 slots (reference ``max_pool_x`` + ``scatter_mean``),
    for a :class:`~deeprank2_tpu_torch.ops.batch.DiagClusteredBatch` or a
    :class:`~deeprank2_tpu_torch.ops.batch.ClusteredBlockSparseBatch`. The
    segment max is the fallback when the collate declined the member
    matrix."""
    if batch.members1.numel():
        hc = member_max_pool(h2_t.T, batch.members1, batch.cluster1)  # [C1, F]
    else:
        hc = segment_max(h2_t.T, batch.cluster1, batch.c1_graph.shape[0])
    return segment_mean(hc, batch.c1_graph, batch.num_graphs)


def _tile_means(tile_sums: torch.Tensor, node_graph: torch.Tensor, node_mask: torch.Tensor, num_graphs: int, block: int) -> torch.Tensor:
    """Per-graph means ``[G, F]`` from per-tile sums ``[NT, F]``: a scatter of
    the ``NT`` tile partials by each tile's graph (empty tiles drop)."""
    nt = tile_sums.shape[0]
    gid = torch.where(node_mask, node_graph, torch.full_like(node_graph, num_graphs)).reshape(nt, block)
    tile_graph = gid.amin(dim=1)  # empty tiles carry num_graphs and drop
    tile_counts = node_mask.reshape(nt, block).sum(dim=1, dtype=torch.float32)
    sums = segment_sum(tile_sums, tile_graph, num_graphs)
    counts = segment_sum(tile_counts, tile_graph, num_graphs)
    return sums / counts.clamp_min(1.0)[:, None]


def tiled_graph_mean_pool(h_t: torch.Tensor, node_graph: torch.Tensor, node_mask: torch.Tensor, num_graphs: int, block: int = 128) -> torch.Tensor:
    """Per-graph masked feature mean for the block-sparse layouts, ``[G, F]``.

    ``h_t [F, NT*B]`` (padded columns zero), ``node_graph [NT*B]`` (padding
    ``>= num_graphs``) and ``node_mask [NT*B]``. The block-sparse collates
    never let a 128-node tile span two graphs, so the sum factorizes: one sum
    per tile, then a scatter of the ``NT`` tile partials only."""
    f, vpad = h_t.shape
    return _tile_means(h_t.reshape(f, vpad // block, block).sum(dim=2).T, node_graph, node_mask, num_graphs, block)


def tiled_graph_mean_pool_rows(x: torch.Tensor, node_graph: torch.Tensor, node_mask: torch.Tensor, num_graphs: int, block: int) -> torch.Tensor:
    """Row-major twin of :func:`tiled_graph_mean_pool` for ``x [NT*B, F]``
    (padded rows zero), with the same tile-aligned contract; the blocked-edge
    layout uses 256-node tiles."""
    vpad, f = x.shape
    return _tile_means(x.reshape(vpad // block, block, f).sum(dim=1), node_graph, node_mask, num_graphs, block)


# ---------------------------------------------------------------------------
# COO pooling (port of ``pool_edges_coalesce``, ``community_pool``,
# ``max_pool_x`` and ``graph_mean_pool``)


def pool_edges_coalesce(
    edge_index: torch.Tensor, edge_attr: torch.Tensor, edge_mask: torch.Tensor, cluster: torch.Tensor, capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Map edges ``[2, E]`` (padded entries out of range) to cluster pairs,
    drop self-loops, and coalesce duplicates, summing their attributes (PyG
    ``coalesce``). Returns ``(edge_index [2, E] int32, edge_attr [E, Fe],
    edge_mask [E])``: the pooled edges in ascending ``(ci, cj)`` order, the
    invalid slots last and pointing at ``capacity``, so the pooled rows stay
    sorted for the sorted segment sum."""
    num_edges = edge_index.shape[1]
    safe_nodes = edge_index.clamp(0, cluster.shape[0] - 1)
    ci, cj = cluster[safe_nodes[0]], cluster[safe_nodes[1]]
    valid = edge_mask & (ci != cj) & (ci < capacity) & (cj < capacity)

    # the JAX package's stable lexsort on (ci, cj), invalid pairs keyed
    # (capacity, capacity) so they sort last: one stable sort of an int64
    # composite key
    ci_s = torch.where(valid, ci, capacity).to(torch.int32)
    cj_s = torch.where(valid, cj, capacity).to(torch.int32)
    order = torch.sort(ci_s.long() * (capacity + 1) + cj_s.long(), stable=True).indices
    sci, scj = ci_s[order], cj_s[order]
    sorted_attr = edge_attr[order]

    first = torch.ones(min(num_edges, 1), dtype=torch.bool, device=sci.device)
    is_first = torch.cat([first, (sci[1:] != sci[:-1]) | (scj[1:] != scj[:-1])])
    group = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1  # [E] 0..K-1
    group_or_oob = torch.where(sci < capacity, group, num_edges)

    pooled_attr = segment_sum(sorted_attr, group_or_oob, num_edges)
    # representative cluster pair of each group (all members share it)
    slot_ci = segment_min(sci, group_or_oob, num_edges, capacity)
    slot_cj = segment_min(scj, group_or_oob, num_edges, capacity)
    pooled_mask = slot_ci < capacity
    # invalid slots point out of range, so downstream scatters drop them
    pooled = torch.stack([torch.where(pooled_mask, slot_ci, capacity), torch.where(pooled_mask, slot_cj, capacity)])
    return pooled, pooled_attr, pooled_mask


def community_pool(
    x: torch.Tensor,
    pos: torch.Tensor,
    edge_index: torch.Tensor,
    edge_attr: torch.Tensor,
    edge_mask: torch.Tensor,
    node_graph: torch.Tensor,
    cluster: torch.Tensor,
    num_graphs: int,
) -> tuple[torch.Tensor, ...]:
    """Pool all cluster members into single nodes (max features, mean
    position). Returns ``(x' [V, F], pos' [V, 3], edge_index' [2, E],
    edge_attr' [E, Fe], edge_mask' [E], node_graph' [V], node_mask' [V])``,
    where row c of the pooled arrays is cluster c (the same capacity V,
    empty clusters masked)."""
    capacity = x.shape[0]
    x_pooled = segment_max(x, cluster, capacity)
    pos_pooled = segment_mean(pos, cluster, capacity)
    # graph id per cluster: all members share it (empty clusters: num_graphs)
    graph_pooled = segment_min(node_graph, cluster, capacity, num_graphs)
    member_counts = segment_sum((cluster < capacity).to(torch.float32), cluster, capacity)
    ei, ea, em = pool_edges_coalesce(edge_index, edge_attr, edge_mask, cluster, capacity)
    return x_pooled, pos_pooled, ei, ea, em, graph_pooled, member_counts > 0


def max_pool_x(cluster: torch.Tensor, x: torch.Tensor, node_graph: torch.Tensor, num_graphs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster feature max and per-cluster graph id (PyG ``max_pool_x``)."""
    capacity = x.shape[0]
    return segment_max(x, cluster, capacity), segment_min(node_graph, cluster, capacity, num_graphs)


def graph_mean_pool(x: torch.Tensor, node_graph: torch.Tensor, num_graphs: int) -> torch.Tensor:
    """Mean of node features per graph (padded nodes carry out-of-range graph ids)."""
    return segment_mean(x, node_graph, num_graphs)


# ---------------------------------------------------------------------------
# Block-dense pooling (port of ``dense_segment_max`` and
# ``dense_community_pool``; see ops/batch.py:DenseGraphBatch)


def dense_segment_max(x: torch.Tensor, cluster: torch.Tensor) -> torch.Tensor:
    """Per-cluster feature max on ``[G, N, F]`` blocks with per-graph local
    cluster ids ``[G, N]`` (padding ``>= N``): ``[G, N, F]``, row ``k`` of
    graph ``g`` cluster ``k`` (empty clusters 0). The segment max of the COO
    pools, so a tied max shares its cotangent among the tied rows."""
    num_graphs, cap_n, feat = x.shape
    offsets = torch.arange(num_graphs, dtype=cluster.dtype, device=cluster.device)[:, None] * cap_n
    flat_ids = torch.where(cluster < cap_n, cluster + offsets, num_graphs * cap_n)
    return segment_max(x.reshape(num_graphs * cap_n, feat), flat_ids.reshape(-1), num_graphs * cap_n).reshape(num_graphs, cap_n, feat)


def dense_community_pool(
    x: torch.Tensor, pos: torch.Tensor, adj: torch.Tensor, cluster: torch.Tensor, adj_w: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """Community pooling on dense blocks: max features, mean positions, and
    the pooled adjacency through the one-hot congruence ``C^T A C`` (two
    batched products), the dense twin of :func:`community_pool`.

    ``x [G, N, F]``, ``pos [G, N, 3]``, ``adj [G, N, N]`` (0/1, any float or
    int type), ``cluster [G, N]`` local ids (padding ``>= N``) and optional
    edge weights ``adj_w [G, N, N]``. The pooled 0/1 adjacency marks the
    distinct cluster pairs and ``adj_w'`` sums the member edges' weights
    (PyG ``coalesce``); self-loop pairs are dropped. Returns ``(x', pos',
    adj', adj_w', node_mask')`` with rows = clusters."""
    cap_n = x.shape[1]
    # a padding id selects the extra class, which is cut off: an all-zero row
    ids = torch.where(cluster < cap_n, cluster, cap_n).long()
    onehot = torch.nn.functional.one_hot(ids, cap_n + 1)[..., :cap_n].to(x.dtype)  # [G, N, K]
    onehot_t = onehot.transpose(1, 2)

    x_pooled = dense_segment_max(x, cluster)
    counts = onehot.sum(dim=1)  # [G, K]
    pos_pooled = (onehot_t @ pos.to(x.dtype)) / counts.clamp_min(1.0)[:, :, None]
    off_diagonal = 1.0 - torch.eye(cap_n, dtype=x.dtype, device=x.device)
    member_edges = onehot_t @ adj.to(x.dtype) @ onehot  # member-edge counts per cluster pair
    adj_pooled = (member_edges > 0).to(x.dtype) * off_diagonal
    adj_w_pooled = None if adj_w is None else onehot_t @ adj_w.to(x.dtype) @ onehot * off_diagonal
    return x_pooled, pos_pooled, adj_pooled, adj_w_pooled, counts > 0
