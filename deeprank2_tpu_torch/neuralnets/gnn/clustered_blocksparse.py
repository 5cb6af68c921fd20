"""Clustered models on block-sparse adjacencies, the atomic-scale path of the
community-pooling family (port of
``deeprank2_tpu/neuralnets/gnn/clustered_blocksparse.py``: ``_pool_max_t``,
``GINetClusteredBlockSparse``, ``FoutNetBlockSparse`` and
``SGATBlockSparse``).

Both conv layers are BCSR SpMMs (ops/block_sparse.py, kernel K5): on the
full graph and on the depth-0 pooled graph. Every cluster lookup is built at
collate (ops/batch.py:collate_graphs_blocksparse_clustered).

- ``GINetClusteredBlockSparse``: the towers fused channel-wise; the JAX
  ``_lin_t`` per-tower products are the fused weight products of
  :meth:`GINetDense.fused_weights` here. ``compute_dtype=torch.bfloat16``
  runs both SpMMs in their bf16 form, the products in f32, as in JAX.
- ``FoutNetBlockSparse``: the neighbour mean is the row-normalised SpMM
  ``(A @ x Wn) / deg``.
- ``SGATBlockSparse``: the edge-weighted mean is
  ``(row_part * wsum + A_w @ col_part) / deg`` over a weighted BCSR
  adjacency (bf16 blocks by default; the scalar edge feature is the first
  edge-attr channel).

``compute_dtype=torch.bfloat16`` runs the SpMMs of FoutNet and sGAT in K5's
bf16 form too (int8, bf16 or f32 blocks; JAX's ``_spmm``), the weight
products in f32. They add their bias after the aggregation, so their padded
rows are not zero: both mask after each conv and after the depth-0 pool, as
the JAX package does. Each model's parameter set and ``state_dict`` keys are
its COO twin's.
"""

from __future__ import annotations

from functools import partial

import torch

from deeprank2_tpu_torch.neuralnets import nn as dnn
from deeprank2_tpu_torch.neuralnets.gnn.foutnet import FoutLayer, FoutNet, fout_layer_t
from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
from deeprank2_tpu_torch.neuralnets.gnn.sgat import SGAT, SGATLayer, sgat_layer_t
from deeprank2_tpu_torch.ops.batch import ClusteredBlockSparseBatch
from deeprank2_tpu_torch.ops.block_sparse import BlockSparseStructure, bcsr_spmm_t
from deeprank2_tpu_torch.ops.pooling import depth1_graph_mean, member_max_pool
from deeprank2_tpu_torch.ops.segment import segment_max
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

    needs_clusters = True
    dense_batches = False
    diag_operands = False
    clustered_blocksparse_batches = True  # Trainer dispatch (JAX clustered_blocksparse.py:76-78)
    clustered_blocksparse_slot8 = True

    def forward(self, batch: ClusteredBlockSparseBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[G, output_shape]``. Dropout (rate 0.4) runs only when
        ``training`` and a ``generator`` on the batch's device are given.

        No mask multiply anywhere: the conv maps carry no bias, so with the
        padded rows and columns of A all zero every padded activation is
        relu(0) = 0 already, and the pools give 0 on empty clusters."""
        w1_t, w2_t = self.fused_weights()
        cd = self.compute_dtype
        h_t = torch.relu(bcsr_spmm_t(batch.structure, w1_t @ batch.x.T, cd))  # [32, V]
        hp_t = _pool_max_t(h_t, batch)  # [32, Vp]; both towers share the clusters
        h2_t = torch.relu(bcsr_spmm_t(batch.structure_p, w2_t @ hp_t, cd))  # [64, Vp]
        out = dnn.relu(dnn.linear(self.fc1, depth1_graph_mean(h2_t, batch)))
        out = dnn.dropout(out, self.dropout, training, generator)
        return dnn.linear(self.fc2, out)


class _ClusteredBlockSparse:
    """The FoutNet and sGAT pipeline on :class:`ClusteredBlockSparseBatch`:
    conv1 on the full graph, the depth-0 max pool, conv2 on the pooled
    graph, the depth-1 pool and per-graph mean, the head. A subclass gives
    its transposed conv (``conv_t``, before the relu)."""

    needs_clusters = True
    clustered_blocksparse_batches = True  # Trainer dispatch (JAX clustered_blocksparse.py:76-78)
    clustered_blocksparse_slot8 = True

    def __init__(
        self,
        input_shape: int,
        output_shape: int = 1,
        input_shape_edge: int | None = None,
        precision: str | None = None,
        compute_dtype: torch.dtype | None = None,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        if precision not in (None, "highest"):
            msg = f"{type(self).__name__}(precision={precision!r}) is not ported; the port's SpMM is exact f32 (JAX's HIGHEST)"
            raise NotImplementedError(msg)
        super().__init__(input_shape, output_shape, input_shape_edge, device, generator)
        # JAX drops HIGHEST to DEFAULT under bf16, which the single-pass bf16 form is
        self.compute_dtype = dnn.checked_compute_dtype(self, compute_dtype)

    def conv_t(self, conv, x_t: torch.Tensor, structure: BlockSparseStructure, deg: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, batch: ClusteredBlockSparseBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[G, output_shape]`` (no dropout)."""
        h_t = torch.relu(self.conv_t(self.conv1, batch.x.T, batch.structure, batch.deg, batch.wsum)) * batch.node_mask[None, :]
        hp_t = _pool_max_t(h_t, batch) * batch.pooled_node_mask[None, :]
        h2_t = torch.relu(self.conv_t(self.conv2, hp_t, batch.structure_p, batch.deg_p, batch.wsum_p)) * batch.pooled_node_mask[None, :]
        return self.head(depth1_graph_mean(h2_t, batch))


class FoutNetBlockSparse(_ClusteredBlockSparse, FoutNet):
    """FoutNet over an unweighted :class:`ClusteredBlockSparseBatch`."""

    def conv_t(self, conv: FoutLayer, x_t: torch.Tensor, structure: BlockSparseStructure, deg: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
        return fout_layer_t(conv, x_t, partial(bcsr_spmm_t, structure, compute_dtype=self.compute_dtype), deg)


class SGATBlockSparse(_ClusteredBlockSparse, SGAT):
    """sGAT over a weighted :class:`ClusteredBlockSparseBatch`
    (``collate_graphs_blocksparse_clustered(with_edge_weights=True)``)."""

    clustered_blocksparse_edge_weights = True

    def conv_t(self, conv: SGATLayer, x_t: torch.Tensor, structure: BlockSparseStructure, deg: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
        return sgat_layer_t(conv, x_t, partial(bcsr_spmm_t, structure, compute_dtype=self.compute_dtype), deg, wsum)
