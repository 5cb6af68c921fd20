"""GINet without community pooling (port of
``deeprank2_tpu/neuralnets/gnn/ginet_nocluster.py``): the COO conv layer and
dual tower of ``ginet.py``, with a per-graph mean pool instead of the
clusters."""

from __future__ import annotations

import torch
from torch import nn

from deeprank2_tpu_torch.neuralnets import nn as dnn
from deeprank2_tpu_torch.neuralnets.gnn.ginet import GINet as ClusteredGINet
from deeprank2_tpu_torch.neuralnets.gnn.ginet import ginet_conv
from deeprank2_tpu_torch.ops.batch import GraphBatch
from deeprank2_tpu_torch.ops.pooling import graph_mean_pool


class GINet(ClusteredGINet):
    """No-cluster GINet over :class:`GraphBatch` (dual tower, mean pool), with
    the parameter set and ``state_dict`` keys of the clustered GINet."""

    needs_clusters = False

    def _tower(self, conv1: nn.ModuleDict, conv2: nn.ModuleDict, batch: GraphBatch) -> torch.Tensor:
        x = dnn.relu(ginet_conv(conv1, batch.x, batch.edge_index, batch.edge_attr, batch.edge_mask))
        x = dnn.relu(ginet_conv(conv2, x, batch.edge_index, batch.edge_attr, batch.edge_mask))
        x = x * batch.node_mask[:, None]
        return graph_mean_pool(x, batch.node_graph, batch.num_graphs)
