"""AlignmentGNN (port of ``deeprank2_tpu/neuralnets/gnn/alignmentnet.py``;
reference: neuralnets/gnn/alignmentnet.py).

A research model with its own forward signature, ``forward(edges,
edge_attr, node_attr) -> (per-node outputs, attention)``: like the JAX
package's and the reference's, it takes no batch object and is not
Trainer-compatible.

Preprocessing MLPs with batch norms project edges and nodes; then
``nmb_gnn_layers`` residual layers each compute per-edge messages (a SiLU
MLP over ``[edge ‖ h_src ‖ h_dst]``), sum them per source node and apply a
residual node MLP; the last layer adds the per-node output and sigmoid
attention heads. Batch norm normalizes by the batch's own mean and biased
variance and keeps no running statistics (the JAX package's
``_batchnorm``): ``torch.nn.BatchNorm1d`` with running statistics would be
another function in evaluation mode. Gathers clip node ids to
``[0, V-1]``; the message sum drops ids ``>= V``. It is the unsorted
segment sum (``ops/segment.py``, PyTorch's ``index_add``), as JAX's
``jax.ops.segment_sum``, which reaches no Pallas kernel.

Parameter names follow the JAX tree (``preproc_edge_bn0.weight`` for its
``preproc_edge_bn0.scale``, ``layers.0.edge_mlp.1.weight``, ...), which
``neuralnets/param_interop.py`` maps with ``family="alignment"``.
"""

from __future__ import annotations

import torch
from torch import nn

from deeprank2_tpu_torch.device import resolve_device
from deeprank2_tpu_torch.neuralnets import nn as dnn
from deeprank2_tpu_torch.ops.segment import segment_sum

act_fn = nn.functional.silu


class BatchStatNorm(nn.Module):
    """Batch norm over dimension 0 with the batch's statistics (biased
    variance, eps 1e-5) and a learned ``weight`` (the JAX ``scale``) and
    ``bias``; no running statistics."""

    def __init__(self, dim: int, device: torch.device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        mean = x.mean(dim=0, keepdim=True)
        var = x.var(dim=0, keepdim=True, correction=0)
        return (x - mean) / torch.sqrt(var + eps) * self.weight + self.bias


def _mlp(dims: list[int], generator: torch.Generator, device: torch.device) -> nn.ModuleList:
    return nn.ModuleList(dnn.init_linear(dims[i], dims[i + 1], generator=generator, device=device) for i in range(len(dims) - 1))


class GNNLayer(nn.Module):
    """One AlignmentGNN layer (edge MLP, message sum, residual node MLP; the
    attention and output heads on the last layer)."""

    def __init__(
        self,
        nmb_edge_projection: int,
        nmb_hidden_attr: int,
        nmb_output_features: int,
        message_vector_length: int,
        nmb_mlp_neurons: int,
        is_last_layer: bool = True,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.is_last_layer = is_last_layer
        self.edge_mlp = _mlp([nmb_edge_projection + nmb_hidden_attr * 2, nmb_mlp_neurons, message_vector_length], gen, dev)
        self.node_bn = BatchStatNorm(message_vector_length + nmb_hidden_attr, dev)
        self.node_mlp = _mlp([message_vector_length + nmb_hidden_attr, nmb_mlp_neurons, nmb_mlp_neurons, nmb_hidden_attr], gen, dev)
        if is_last_layer:
            self.attention_mlp = _mlp([nmb_hidden_attr, nmb_mlp_neurons, 1], gen, dev)
            self.output_mlp = _mlp([nmb_hidden_attr, nmb_mlp_neurons, nmb_output_features], gen, dev)

    def edge_model(self, edge_attr: torch.Tensor, h_src: torch.Tensor, h_dst: torch.Tensor) -> torch.Tensor:
        h = act_fn(self.edge_mlp[0](torch.cat([edge_attr, h_src, h_dst], dim=1)))
        return act_fn(self.edge_mlp[1](h))

    def node_model(self, summed_edge_message: torch.Tensor, hidden_features: torch.Tensor) -> torch.Tensor:
        h = self.node_bn(torch.cat([summed_edge_message, hidden_features], dim=1))
        h = act_fn(self.node_mlp[0](h))
        h = act_fn(self.node_mlp[1](h))
        return hidden_features + self.node_mlp[2](h)

    def update_nodes(self, edges: torch.Tensor, edge_attr: torch.Tensor, hidden_features: torch.Tensor, steps: int = 1) -> torch.Tensor:
        row, col = edges[0], edges[1]
        h = hidden_features
        capacity = h.shape[0]
        for _ in range(steps):
            messages = self.edge_model(edge_attr, h[row.clamp(0, capacity - 1)], h[col.clamp(0, capacity - 1)])
            h = self.node_model(segment_sum(messages, row, capacity), h)
        return h

    def output(self, hidden_features: torch.Tensor, get_attention: bool = True):
        out = self.output_mlp[1](act_fn(self.output_mlp[0](hidden_features)))
        if get_attention:
            a = act_fn(self.attention_mlp[0](hidden_features))
            return out, torch.sigmoid(self.attention_mlp[1](a))
        return out


class SuperGNN(nn.Module):
    """Preprocessing MLPs and a stack of :class:`GNNLayer`. ``generator``
    draws the initial weights (a fixed seed when None)."""

    def __init__(
        self,
        nmb_edge_attr: int,
        nmb_node_attr: int,
        nmb_hidden_attr: int,
        nmb_mlp_neurons: int,
        nmb_edge_projection: int,
        nmb_gnn_layers: int,
        nmb_output_features: int,
        message_vector_length: int,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.preproc_edge_bn0 = BatchStatNorm(nmb_edge_attr, dev)
        self.preproc_edge_mlp = _mlp([nmb_edge_attr, nmb_mlp_neurons, nmb_edge_projection], gen, dev)
        self.preproc_edge_bn1 = BatchStatNorm(nmb_mlp_neurons, dev)
        self.preproc_node_bn0 = BatchStatNorm(nmb_node_attr, dev)
        self.preproc_node_mlp = _mlp([nmb_node_attr, nmb_mlp_neurons, nmb_hidden_attr], gen, dev)
        self.preproc_node_bn1 = BatchStatNorm(nmb_mlp_neurons, dev)
        self.layers = nn.ModuleList(
            GNNLayer(
                nmb_edge_projection,
                nmb_hidden_attr,
                nmb_output_features,
                message_vector_length,
                nmb_mlp_neurons,
                is_last_layer=(i == nmb_gnn_layers - 1),
                device=dev,
                generator=gen,
            )
            for i in range(nmb_gnn_layers)
        )

    def preprocess(self, edge_attr: torch.Tensor, node_attr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        e = self.preproc_edge_mlp[0](self.preproc_edge_bn0(edge_attr))
        e = act_fn(self.preproc_edge_mlp[1](act_fn(self.preproc_edge_bn1(e))))
        h = self.preproc_node_mlp[0](self.preproc_node_bn0(node_attr))
        h = act_fn(self.preproc_node_mlp[1](act_fn(self.preproc_node_bn1(h))))
        return e, h

    def run_through_network(self, edges: torch.Tensor, edge_attr: torch.Tensor, node_attr: torch.Tensor):
        edge_attr, node_attr = self.preprocess(edge_attr, node_attr)
        for layer in self.layers:
            node_attr = layer.update_nodes(edges, edge_attr, node_attr)
        return self.layers[-1].output(node_attr, get_attention=True)


class AlignmentGNN(SuperGNN):
    """Deep residual message-passing stack with per-node output and
    attention heads (the JAX package's constructor order)."""

    def __init__(
        self,
        nmb_edge_attr: int,
        nmb_node_attr: int,
        nmb_output_features: int,
        nmb_hidden_attr: int,
        message_vector_length: int,
        nmb_mlp_neurons: int,
        nmb_gnn_layers: int,
        nmb_edge_projection: int,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__(
            nmb_edge_attr,
            nmb_node_attr,
            nmb_hidden_attr,
            nmb_mlp_neurons,
            nmb_edge_projection,
            nmb_gnn_layers,
            nmb_output_features,
            message_vector_length,
            device,
            generator,
        )

    def forward(self, edges: torch.Tensor, edge_attr: torch.Tensor, node_attr: torch.Tensor):
        """``(per-node outputs [V, out], per-node attention [V, 1])`` for
        ``edges [2, E]`` (source row first), ``edge_attr [E, Fe]`` and
        ``node_attr [V, Fn]``."""
        return self.run_through_network(edges, edge_attr, node_attr)
