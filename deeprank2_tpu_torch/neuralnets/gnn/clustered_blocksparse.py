"""Clustered GINet on block-sparse adjacencies, the atomic-scale path of the
community-pooling model (port of
``deeprank2_tpu/neuralnets/gnn/clustered_blocksparse.py``: ``_pool_max_t``
and ``GINetClusteredBlockSparse``).

Both conv layers are BCSR SpMMs (ops/block_sparse.py, kernel K5): on the
full graph and on the depth-0 pooled graph, each with the towers fused
channel-wise. Every cluster lookup is built at collate
(ops/batch.py:collate_graphs_blocksparse_clustered). The JAX ``_lin_t``
per-tower products are the fused weight products of
:meth:`GINetDense.fused_weights` here. FoutNet and sGAT on this layout come
with their slice of the port.
"""

from __future__ import annotations

import torch

from deeprank2_tpu_torch.neuralnets import nn as dnn
from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
from deeprank2_tpu_torch.ops.batch import ClusteredBlockSparseBatch
from deeprank2_tpu_torch.ops.block_sparse import bcsr_spmm_t
from deeprank2_tpu_torch.ops.pooling import member_max_pool
from deeprank2_tpu_torch.ops.segment import segment_max, segment_mean
from deeprank2_tpu_torch.ops.slotpool import slot_group_max


def _pool_max_t(h_t: torch.Tensor, batch: ClusteredBlockSparseBatch) -> torch.Tensor:
    """Depth-0 per-cluster feature max in the transposed layout,
    ``[F, V] -> [F, Vp]``.

    slot8 batches pool in two stages: the slot max-pool kernel collapses
    every aligned 8-lane slot (ops/slotpool.py), then the slot member matrix
    combines each cluster's slot partials. Other batches pool through the
    node member matrix. The segment max is the fallback when the collate
    declined to build a member matrix (one pathological cluster)."""
    num_pooled = batch.structure_p.padded_nodes
    if batch.slot_cluster.numel():
        p8 = slot_group_max(h_t, batch.node_mask.to(h_t.dtype)[None, :])  # [F, V/8]
        if batch.members0s.numel():
            return member_max_pool(p8.T, batch.members0s, batch.slot_cluster).T
        return segment_max(p8.T, batch.slot_cluster, num_pooled).T
    if batch.members0.numel():
        return member_max_pool(h_t.T, batch.members0, batch.cluster0).T
    return segment_max(h_t.T, batch.cluster0, num_pooled).T


class GINetClusteredBlockSparse(GINetDense):
    """Clustered dual-tower GINet over :class:`ClusteredBlockSparseBatch`
    (the parameter set and ``state_dict`` keys of :class:`GINetDense`)."""

    def forward(self, batch: ClusteredBlockSparseBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[G, output_shape]``. Dropout (rate 0.4) runs only when
        ``training`` and a ``generator`` on the batch's device are given.

        No mask multiply anywhere: the conv maps carry no bias, so with the
        padded rows and columns of A all zero every padded activation is
        relu(0) = 0 already, and the pools give 0 on empty clusters."""
        w1_t, w2_t = self.fused_weights()
        h_t = torch.relu(bcsr_spmm_t(batch.structure, w1_t @ batch.x.T))  # [32, V]
        hp_t = _pool_max_t(h_t, batch)  # [32, Vp]; both towers share the clusters
        h2_t = torch.relu(bcsr_spmm_t(batch.structure_p, w2_t @ hp_t))  # [64, Vp]

        # depth-1 max pool and per-graph mean (reference max_pool_x + scatter_mean)
        if batch.members1.numel():
            hc = member_max_pool(h2_t.T, batch.members1, batch.cluster1)  # [C1, 64]
        else:
            hc = segment_max(h2_t.T, batch.cluster1, batch.c1_graph.shape[0])
        pooled = segment_mean(hc, batch.c1_graph, batch.num_graphs)
        out = dnn.relu(dnn.linear(self.fc1, pooled))
        out = dnn.dropout(out, self.dropout, training, generator)
        return dnn.linear(self.fc2, out)
