"""Vanilla message-passing GNN (port of
``deeprank2_tpu/neuralnets/gnn/vanilla_gnn.py``).

Per-edge messages ``relu(MLP([x_i ‖ x_j ‖ e_ij]))`` summed onto the edge's
first endpoint, then a node MLP over ``[x ‖ msg_sum]``; two such layers, a
graph mean pool and an output MLP. ``VanillaNetwork`` runs on the COO
layout, where the message sum is the sorted segment sum (kernel K7 of
ops/segment_sorted.py); ``VanillaNetworkBlocked`` runs the same math on the
blocked-edge layout, where the message sum is the CUDA kernel pair of
ops/vanilla.py.
"""

from __future__ import annotations

import torch
from torch import nn

from deeprank2_tpu_torch.device import resolve_device
from deeprank2_tpu_torch.neuralnets import nn as dnn
from deeprank2_tpu_torch.ops.batch import BlockedEdgeBatch, GraphBatch
from deeprank2_tpu_torch.ops.blocked_edges import EDGE_TILE, BlockedEdgeStructure, blocked_message_sum
from deeprank2_tpu_torch.ops.pooling import graph_mean_pool, tiled_graph_mean_pool_rows
from deeprank2_tpu_torch.ops.segment import gather_rows, segment_sum

MESSAGE_SIZE = 32
HIDDEN_SIZE = 128


class _ConvLayer(nn.Module):
    """One vanilla convolution's parameters, under the reference's names:
    single-Linear ``nn.Sequential`` edge and node MLPs."""

    def __init__(self, f: int, fe: int, generator: torch.Generator, device: torch.device):
        super().__init__()
        self._edge_mlp = nn.Sequential(dnn.init_linear(2 * f + fe, MESSAGE_SIZE, generator=generator, device=device))
        self._node_mlp = nn.Sequential(dnn.init_linear(f + MESSAGE_SIZE, f, generator=generator, device=device))


class VanillaNetwork(nn.Module):
    """Two vanilla convolutional layers and an MLP head (the parameter set of
    the JAX ``init``). ``state_dict`` keys are the reference's
    (``_external1._edge_mlp.0.weight`` ... ``_graph_mlp.2.bias``), which
    ``neuralnets/param_interop.py`` maps to the JAX tree with
    ``family="vanilla"``. ``generator`` draws the initial weights (a fixed
    seed when None)."""

    needs_clusters = False  # Trainer dispatch (JAX vanilla_gnn.py:25)

    def __init__(
        self,
        input_shape: int,
        output_shape: int = 1,
        input_shape_edge: int = 0,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_shape = input_shape
        self.output_shape = output_shape
        self.input_shape_edge = input_shape_edge
        self._external1 = _ConvLayer(input_shape, input_shape_edge, gen, dev)
        self._external2 = _ConvLayer(input_shape, input_shape_edge, gen, dev)
        self._graph_mlp = nn.Sequential(
            dnn.init_linear(input_shape, HIDDEN_SIZE, generator=gen, device=dev),
            nn.ReLU(),
            dnn.init_linear(HIDDEN_SIZE, output_shape, generator=gen, device=dev),
        )

    @staticmethod
    def _conv(layer: _ConvLayer, x: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        # the node parts of the edge MLP per node ([V, F] products), gathered
        # per edge: cheaper than per-edge products since E >> V
        row, col = batch.edge_index[0], batch.edge_index[1]
        w, b = layer._edge_mlp[0].weight, layer._edge_mlp[0].bias  # [M, 2F + Fe], [M]
        f = x.shape[1]
        xr = nn.functional.linear(x, w[:, :f], b)  # the bias rides the destination part
        xc = nn.functional.linear(x, w[:, f : 2 * f])
        ew = nn.functional.linear(batch.edge_attr, w[:, 2 * f :])  # [E, M]
        messages = dnn.relu(gather_rows(xr, row) + gather_rows(xc, col) + ew) * batch.edge_mask[:, None]
        msg_sums = segment_sum(messages, row, x.shape[0], indices_sorted=True)
        return dnn.relu(dnn.linear(layer._node_mlp[0], torch.cat([x, msg_sums], dim=1)))

    def forward(self, batch: GraphBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[G, output_shape]`` over a COO :class:`GraphBatch`. No
        dropout, so ``training`` and ``generator`` change nothing."""
        x = self._conv(self._external1, batch.x, batch)
        x = self._conv(self._external2, x, batch)
        means = graph_mean_pool(x * batch.node_mask[:, None], batch.node_graph, batch.num_graphs)
        return self._graph_mlp(means)


class VanillaNetworkBlocked(VanillaNetwork):
    """VanillaNetwork on :class:`BlockedEdgeBatch` inputs: the same math and
    parameter set, with each layer's message sum in kernels K6f (forward) and
    K6b (backward). ``compute_dtype=torch.bfloat16`` runs their bf16 form
    (the node products and MLPs stay f32, as in JAX). No dropout, so
    ``training`` and ``generator`` change nothing."""

    blocked_edge_batches = True  # Trainer dispatch (JAX vanilla_gnn.py:92)

    def __init__(
        self,
        input_shape: int,
        output_shape: int = 1,
        input_shape_edge: int = 0,
        compute_dtype: torch.dtype | None = None,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__(input_shape, output_shape, input_shape_edge, device, generator)
        self.compute_dtype = dnn.checked_compute_dtype(self, compute_dtype)

    def _conv_blocked(self, layer: _ConvLayer, x: torch.Tensor, structure: BlockedEdgeStructure) -> torch.Tensor:
        w, b = layer._edge_mlp[0].weight, layer._edge_mlp[0].bias  # [M, 2F + Fe], [M]
        f = x.shape[1]
        xr = nn.functional.linear(x, w[:, :f], b)  # the bias rides the destination part
        xc = nn.functional.linear(x, w[:, f : 2 * f])
        msg_sums = blocked_message_sum(structure, xr, xc, w[:, 2 * f :].T, self.compute_dtype)  # w_e [Fe, M]
        return dnn.relu(dnn.linear(layer._node_mlp[0], torch.cat([x, msg_sums], dim=1)))

    def forward(self, batch: BlockedEdgeBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[G, output_shape]``."""
        x = self._conv_blocked(self._external1, batch.x, batch.structure)
        x = self._conv_blocked(self._external2, x, batch.structure)
        # the blocked collate keeps graphs tile-disjoint: one sum per tile,
        # then a scatter of the tile partials
        mask = batch.node_mask[:, None].to(x.dtype)
        means = tiled_graph_mean_pool_rows(x * mask, batch.node_graph, batch.node_mask, batch.num_graphs, EDGE_TILE)
        return self._graph_mlp(means)
