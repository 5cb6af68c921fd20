"""Edge-partitioned graph parallelism over a process group (port of
``deeprank2_tpu/parallel/edge_partition.py``).

- node rows are sharded contiguously across the ranks; rank ``d`` owns
  ``V / D`` rows of the node features;
- edges are partitioned by their destination row's owner, so the segment
  sum of the aggregation is local;
- a layer's only communication is an all-gather of the (already
  node-transformed, low-dimensional) per-node tensor; the per-graph means
  of both towers take one psum of their sums and the node counts.

:func:`partition_graph_batch` cuts a padded :class:`GraphBatch` into one
:class:`EdgePartitionedBatch` a rank; :func:`make_edge_partitioned_ginet_forward`
runs the no-cluster GINet's two towers on a rank's part and returns the
per-graph outputs, equal on every rank. The ring variant
(:func:`partition_graph_batch_ring`, :func:`make_ring_ginet_forward`) passes
the transformed node blocks round the ranks in place of the all-gather, so
a rank holds one block at a time. The rows of a part keep the batch's
order, so every bucket's destination rows ascend and the sums run through
the sorted segment sum (kernel K7 on the card).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from deeprank2_tpu_torch.neuralnets import nn as dnn
from deeprank2_tpu_torch.ops.batch import GraphBatch
from deeprank2_tpu_torch.ops.segment import gather_rows, segment_sum
from deeprank2_tpu_torch.parallel import comm


@dataclass
class EdgePartitionedBatch:
    """One rank's part of a GraphBatch under edge partitioning (the JAX
    batch's slice ``[d]``): rows local to the rank's node base, columns
    global node indices."""

    x: torch.Tensor  # f32 [Vd, F] the rank's node features
    edge_row_local: torch.Tensor  # i32 [Ed] local destination row (padding = Vd), ascending
    edge_col: torch.Tensor  # i32 [Ed] global source node (padding = V)
    edge_attr: torch.Tensor  # f32 [Ed, Fe]
    edge_mask: torch.Tensor  # bool [Ed]
    node_graph: torch.Tensor  # i32 [Vd] graph id per local node (padding = G)
    node_mask: torch.Tensor  # bool [Vd]
    num_graphs: int


def _node_arrays(batch: GraphBatch, num_shards: int) -> tuple[int, dict]:
    """``(v_per, node arrays padded to v_per * num_shards rows)``."""
    v_per = -(-batch.num_nodes // num_shards)
    pad = v_per * num_shards - batch.num_nodes
    x = batch.x.cpu().numpy()
    node_graph = batch.node_graph.cpu().numpy()
    node_mask = batch.node_mask.cpu().numpy()
    if pad:
        x = np.pad(x, ((0, pad), (0, 0)))
        node_graph = np.pad(node_graph, (0, pad), constant_values=batch.num_graphs)
        node_mask = np.pad(node_mask, (0, pad))
    return v_per, {"x": x, "node_graph": node_graph, "node_mask": node_mask}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def partition_graph_batch(batch: GraphBatch, num_shards: int) -> tuple[EdgePartitionedBatch, ...]:
    """Cut a padded GraphBatch by node rows and destination-edge owner: one
    part a rank, on the batch's device, all with one edge capacity."""
    v_per, nodes = _node_arrays(batch, num_shards)
    rows, cols = batch.edge_index.cpu().numpy()
    mask = batch.edge_mask.cpu().numpy()
    attr = batch.edge_attr.cpu().numpy()
    owner = np.where(mask, rows // v_per, -1)
    e_per = max(max(int((owner == d).sum()) for d in range(num_shards)), 1)
    dev = batch.x.device
    parts = []
    for d in range(num_shards):
        sel = np.flatnonzero(owner == d)
        row = np.full(e_per, v_per, dtype=np.int32)
        col = np.full(e_per, v_per * num_shards, dtype=np.int32)
        ea = np.zeros((e_per, attr.shape[1]), dtype=np.float32)
        em = np.zeros(e_per, dtype=bool)
        row[: len(sel)] = rows[sel] - d * v_per
        col[: len(sel)] = cols[sel]
        ea[: len(sel)] = attr[sel]
        em[: len(sel)] = True
        own = slice(d * v_per, (d + 1) * v_per)
        parts.append(
            EdgePartitionedBatch(
                x=_tensor(nodes["x"][own], dev),
                edge_row_local=_tensor(row, dev),
                edge_col=_tensor(col, dev),
                edge_attr=_tensor(ea, dev),
                edge_mask=_tensor(em, dev),
                node_graph=_tensor(nodes["node_graph"][own], dev),
                node_mask=_tensor(nodes["node_mask"][own], dev),
                num_graphs=batch.num_graphs,
            )
        )
    return tuple(parts)


def _ginet_conv_sharded(conv, x_local: torch.Tensor, part: EdgePartitionedBatch, group) -> torch.Tensor:
    """One GINet conv on a rank's nodes: all-gather the transformed nodes,
    then the local gather and sorted segment sum (the math of
    ``neuralnets/gnn/ginet.py:ginet_conv``)."""
    fcx_full = comm.all_gather(dnn.linear(conv["fc"], x_local), group)  # [V, out]
    h = gather_rows(fcx_full, part.edge_col) * part.edge_mask[:, None]
    return segment_sum(h, part.edge_row_local, x_local.shape[0], indices_sorted=True)


def _ginet_head(model, tower, part, group) -> torch.Tensor:
    """Both towers' per-graph means over every rank's nodes (one psum of the
    two towers' sums and the node counts), then the fc1/fc2 head (no
    dropout, as the JAX forwards)."""
    mask = part.node_mask[:, None]
    sums = [segment_sum(tower(c1, c2) * mask, part.node_graph, part.num_graphs) for c1, c2 in ((model.conv1, model.conv2), (model.conv1_ext, model.conv2_ext))]
    counts = segment_sum(part.node_mask.to(sums[0].dtype), part.node_graph, part.num_graphs)
    total = comm.psum(torch.cat([*sums, counts[:, None]], dim=1), group)
    pooled = total[:, :-1] / total[:, -1:].clamp_min(1.0)
    return dnn.linear(model.fc2, torch.relu(dnn.linear(model.fc1, pooled)))


def make_edge_partitioned_ginet_forward(model, group=None):
    """The edge-partitioned forward of the no-cluster GINet (``model``, the
    port's ``ginet_nocluster.GINet``, holds the parameters):
    ``forward(part) -> [G, out]``, equal on every rank, differentiable."""

    def forward(part: EdgePartitionedBatch) -> torch.Tensor:
        def tower(conv1, conv2):
            h = torch.relu(_ginet_conv_sharded(conv1, part.x, part, group))
            return torch.relu(_ginet_conv_sharded(conv2, h, part, group))

        return _ginet_head(model, tower, part, group)

    return forward


@dataclass
class RingPartitionedBatch:
    """One rank's part for the ring: its edges bucketed by the source's
    owner, with source-local columns, so ring step ``k`` (holding rank
    ``(d - k) % D``'s node block) aggregates bucket ``(d - k) % D`` straight
    from the passed buffer."""

    x: torch.Tensor  # f32 [Vd, F]
    edge_row_local: torch.Tensor  # i32 [S, Eb] destination row, local to d (padding = Vd), ascending a bucket
    edge_col_local: torch.Tensor  # i32 [S, Eb] source row, local to s (padding = Vd)
    edge_mask: torch.Tensor  # bool [S, Eb]
    node_graph: torch.Tensor  # i32 [Vd]
    node_mask: torch.Tensor  # bool [Vd]
    num_graphs: int


def partition_graph_batch_ring(batch: GraphBatch, num_shards: int) -> tuple[RingPartitionedBatch, ...]:
    """Bucket a padded GraphBatch by (destination owner, source owner): one
    part a rank; the bucket capacity is the largest over all pairs."""
    v_per, nodes = _node_arrays(batch, num_shards)
    rows, cols = batch.edge_index.cpu().numpy()
    mask = batch.edge_mask.cpu().numpy()
    dest_owner = np.where(mask, rows // v_per, -1)
    src_owner = np.where(mask, cols // v_per, -1)
    buckets = {(d, s): np.flatnonzero((dest_owner == d) & (src_owner == s)) for d in range(num_shards) for s in range(num_shards)}
    e_cap = max(max(len(sel) for sel in buckets.values()), 1)
    dev = batch.x.device
    parts = []
    for d in range(num_shards):
        row = np.full((num_shards, e_cap), v_per, dtype=np.int32)
        col = np.full((num_shards, e_cap), v_per, dtype=np.int32)
        em = np.zeros((num_shards, e_cap), dtype=bool)
        for s in range(num_shards):
            sel = buckets[d, s]
            row[s, : len(sel)] = rows[sel] - d * v_per
            col[s, : len(sel)] = cols[sel] - s * v_per
            em[s, : len(sel)] = True
        own = slice(d * v_per, (d + 1) * v_per)
        parts.append(
            RingPartitionedBatch(
                x=_tensor(nodes["x"][own], dev),
                edge_row_local=_tensor(row, dev),
                edge_col_local=_tensor(col, dev),
                edge_mask=_tensor(em, dev),
                node_graph=_tensor(nodes["node_graph"][own], dev),
                node_mask=_tensor(nodes["node_mask"][own], dev),
                num_graphs=batch.num_graphs,
            )
        )
    return tuple(parts)


def _ginet_conv_ring(conv, x_local: torch.Tensor, part: RingPartitionedBatch, group) -> torch.Tensor:
    """One GINet conv with the ring: the transformed node block goes round
    the ranks (``D - 1`` hops; the JAX loop's last hop, whose block it
    never reads, is left out) while each step's segment sum aggregates the
    matching source bucket."""
    size, rank = comm.world(group)
    v_local = x_local.shape[0]
    buf = dnn.linear(conv["fc"], x_local)  # [Vd, out]
    acc = None
    for k in range(size):
        s = (rank - k) % size
        h = gather_rows(buf, part.edge_col_local[s]) * part.edge_mask[s][:, None]
        contrib = segment_sum(h, part.edge_row_local[s], v_local, indices_sorted=True)
        acc = contrib if acc is None else acc + contrib
        if k + 1 < size:
            buf = comm.ppermute(buf, group)  # now rank (rank - k - 1)'s block
    return acc


def make_ring_ginet_forward(model, group=None):
    """The ring forward of the no-cluster GINet: ``forward(part) -> [G, out]``,
    equal on every rank, differentiable."""

    def forward(part: RingPartitionedBatch) -> torch.Tensor:
        def tower(conv1, conv2):
            h = torch.relu(_ginet_conv_ring(conv1, part.x, part, group))
            return torch.relu(_ginet_conv_ring(conv2, h, part, group))

        return _ginet_head(model, tower, part, group)

    return forward


def edge_partition_scaling_report(num_graphs: int = 8, nodes_per_graph: int = 48, group=None, device: str | torch.device | None = None) -> dict:
    """Correctness and timing of the edge-partitioned forward against the
    single-device model, on every rank of ``group`` (call it on each):
    ``max_abs_err`` and ``seconds_per_forward`` (ten forwards, the last
    output read back)."""
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_nocluster import GINet
    from deeprank2_tpu_torch.ops.batch import collate_graphs
    from deeprank2_tpu_torch.ops.synthetic import synthetic_entries

    size, rank = comm.world(group)
    feat_dim, edge_dim = 38, 6
    model = GINet(feat_dim, 2, edge_dim, device=device, generator=torch.Generator().manual_seed(0))
    batch, _ = collate_graphs(synthetic_entries(num_graphs, nodes_per_graph, feat_dim, edge_dim), pad_graphs=num_graphs, device=device)
    part = partition_graph_batch(batch, size)[rank]
    forward = make_edge_partitioned_ginet_forward(model, group)
    with torch.no_grad():
        reference = model(batch).cpu()
        out = forward(part).cpu()
        t0 = time.perf_counter()
        for _ in range(10):
            out = forward(part)
        out = out.cpu()
        dt = (time.perf_counter() - t0) / 10
    return {"num_shards": size, "max_abs_err": float((out - reference).abs().max()), "seconds_per_forward": dt}
