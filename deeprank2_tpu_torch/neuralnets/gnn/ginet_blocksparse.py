"""GINet on block-sparse adjacencies, the large-graph (atomic-resolution)
path (port of ``deeprank2_tpu/neuralnets/gnn/ginet_blocksparse.py``).

The no-cluster GINet's math with the aggregation as a BCSR SpMM
(ops/block_sparse.py, kernel K5) and the two towers fused, so that each layer
costs one SpMM over the concatenated tower channels:

- layer 1: ``relu(A [x W1_int || x W1_ext])`` (F -> 16 + 16 channels);
- layer 2: ``relu(A [h_int W2_int || h_ext W2_ext])`` (16 + 16 -> 32 + 32),
  masked, then the per-graph mean over tiles and the fc1/fc2 head.

The whole tower runs in the SpMM's transposed ``[C, V]`` layout. Under
``compute_dtype=torch.bfloat16`` the weight products stay f32 and only the
SpMM runs its bf16 form (the JAX ``bcsr_spmm_t(..., compute_dtype)``). The
parameter set and ``state_dict`` keys are :class:`GINetDense`'s (the JAX
model's ``init`` delegates to the COO GINet's, which has the same set).
"""

from __future__ import annotations

import torch

from deeprank2_tpu_torch.neuralnets import nn as dnn
from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
from deeprank2_tpu_torch.ops.batch import BlockSparseBatch
from deeprank2_tpu_torch.ops.block_sparse import bcsr_spmm_t
from deeprank2_tpu_torch.ops.pooling import tiled_graph_mean_pool


class GINetBlockSparse(GINetDense):
    """No-cluster GINet over :class:`BlockSparseBatch` inputs."""

    needs_clusters = False
    dense_batches = False
    diag_operands = False
    blocksparse_batches = True  # Trainer dispatch (JAX ginet_blocksparse.py:32-33)

    def forward(self, batch: BlockSparseBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[G, output_shape]``. Dropout (rate 0.4) runs only when
        ``training`` and a ``generator`` on the batch's device are given."""
        w1_t, w2_t = self.fused_weights()
        cd = self.compute_dtype
        h_t = torch.relu(bcsr_spmm_t(batch.structure, w1_t @ batch.x.T, cd))  # [32, V]
        h2_t = torch.relu(bcsr_spmm_t(batch.structure, w2_t @ h_t, cd))  # [64, V]
        h2_t = h2_t * batch.node_mask[None, :].to(h2_t.dtype)
        # the fused channels are already in the COO model's post-pool order
        pooled = tiled_graph_mean_pool(h2_t, batch.node_graph, batch.node_mask, batch.num_graphs, batch.structure.block)
        out = dnn.relu(dnn.linear(self.fc1, pooled))
        out = dnn.dropout(out, self.dropout, training, generator)
        return dnn.linear(self.fc2, out)
