"""GINet: edge-attention message passing with hierarchical community pooling
(port of ``deeprank2_tpu/neuralnets/gnn/ginet.py``: ``init_ginet_conv``,
``ginet_conv`` and the clustered COO ``GINet``).

The reference's attention is a softmax over the singleton feature axis of
``[E, 1]`` logits: its value is identically 1 and its Jacobian identically 0.
``ginet_conv`` therefore skips it, as the JAX package does: the message is
``fc(x)[col]`` summed onto ``row``, and ``fc_edge_attr`` and
``fc_attention`` get no gradient (the port's ``Adam`` decays such
parameters as the JAX one does). They stay in the parameter set so that
state dicts keep the reference's keys.
"""

from __future__ import annotations

import torch
from torch import nn

from deeprank2_tpu_torch.device import resolve_device
from deeprank2_tpu_torch.neuralnets import nn as dnn
from deeprank2_tpu_torch.ops.batch import GraphBatch
from deeprank2_tpu_torch.ops.pooling import community_pool, graph_mean_pool, max_pool_x
from deeprank2_tpu_torch.ops.segment import gather_rows, segment_sum


def init_ginet_conv(
    in_channels: int,
    out_channels: int,
    number_edge_features: int = 1,
    generator: torch.Generator | None = None,
    device: torch.device | None = None,
) -> nn.ModuleDict:
    """One GINet conv layer's bias-free linear maps, PyG ``uniform(in_channels, ...)``
    init (reference ginet.py:33-38): ``fc``, ``fc_edge_attr``, ``fc_attention``."""
    size = in_channels
    fe = number_edge_features
    return nn.ModuleDict(
        {
            "fc": dnn.init_linear(in_channels, out_channels, False, size, generator, device),
            "fc_edge_attr": dnn.init_linear(fe, fe, False, size, generator, device),
            "fc_attention": dnn.init_linear(2 * out_channels + fe, 1, False, size, generator, device),
        }
    )


def ginet_conv(conv: nn.ModuleDict, x: torch.Tensor, edge_index: torch.Tensor, edge_attr: torch.Tensor, edge_mask: torch.Tensor) -> torch.Tensor:
    """One GINet conv layer over padded COO arrays: ``fc(x)`` per node,
    gathered at each edge's source, masked, and summed onto the edge's
    destination by the sorted segment sum (``edge_index`` rows ascending,
    padding last). ``edge_attr`` feeds only the skipped attention."""
    row, col = edge_index[0], edge_index[1]
    fcx = dnn.linear(conv["fc"], x)  # [V, out]
    h = gather_rows(fcx, col) * edge_mask[:, None]
    return segment_sum(h, row, x.shape[0], indices_sorted=True)


class GINet(nn.Module):
    """Clustered GINet (dual tower and community pooling) over
    :class:`GraphBatch`: conv1, ``community_pool`` on ``cluster0``, conv2 on
    the pooled edges, ``max_pool_x`` on ``cluster1``, the per-graph mean, and
    the fc1/fc2 head with dropout.

    Parameter names are the reference's torch ``state_dict`` keys
    (``conv1.fc.weight [out, in]`` ... ``fc2.bias``), shared by every GINet
    of the port, so one state dict loads into each and, through
    ``neuralnets/param_interop.py``, into the JAX models. ``generator`` draws
    the initial weights (a fixed seed when None)."""

    needs_clusters = True  # Trainer dispatch attributes (JAX ginet.py:75)
    dropout = 0.4

    def __init__(
        self,
        input_shape: int,
        output_shape: int = 1,
        input_shape_edge: int = 1,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        fe = input_shape_edge
        self.input_shape = input_shape
        self.output_shape = output_shape
        self.input_shape_edge = input_shape_edge
        self.conv1 = init_ginet_conv(input_shape, 16, fe, gen, dev)
        self.conv2 = init_ginet_conv(16, 32, fe, gen, dev)
        self.conv1_ext = init_ginet_conv(input_shape, 16, fe, gen, dev)
        self.conv2_ext = init_ginet_conv(16, 32, fe, gen, dev)
        self.fc1 = dnn.init_linear(2 * 32, 128, generator=gen, device=dev)
        self.fc2 = dnn.init_linear(128, output_shape, generator=gen, device=dev)

    def _tower(self, conv1: nn.ModuleDict, conv2: nn.ModuleDict, batch: GraphBatch) -> torch.Tensor:
        x = dnn.relu(ginet_conv(conv1, batch.x, batch.edge_index, batch.edge_attr, batch.edge_mask))
        x = x * batch.node_mask[:, None]
        # community pooling on the depth-0 clusters
        x, _, ei, ea, em, node_graph, node_mask = community_pool(
            x, batch.pos, batch.edge_index, batch.edge_attr, batch.edge_mask, batch.node_graph, batch.cluster0, batch.num_graphs
        )
        x = dnn.relu(ginet_conv(conv2, x, ei, ea, em))
        x = x * node_mask[:, None]
        # depth-1 max pooling; cluster1 is indexed by depth-0 cluster id
        x, pooled_graph = max_pool_x(batch.cluster1, x, node_graph, batch.num_graphs)
        return graph_mean_pool(x, pooled_graph, batch.num_graphs)

    def forward(self, batch: GraphBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[G, output_shape]``. Dropout (rate 0.4) runs only when
        ``training`` and a ``generator`` on the batch's device are given."""
        h = torch.cat([self._tower(self.conv1, self.conv2, batch), self._tower(self.conv1_ext, self.conv2_ext, batch)], dim=1)
        h = dnn.relu(dnn.linear(self.fc1, h))
        h = dnn.dropout(h, self.dropout, training, generator)
        return dnn.linear(self.fc2, h)
