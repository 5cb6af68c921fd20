"""FoutNet (port of ``deeprank2_tpu/neuralnets/gnn/foutnet.py``: ``fout_layer``,
``fout_layer_dense``, the COO ``FoutNet``, the graph-diagonal
``FoutNetDiag`` and the block-dense ``FoutNetDense``; Fout et al., NIPS
2018).

Layer math: ``z = x Wc + mean_neighbours(x Wn) + b``. In the COO layout the
neighbour mean is one segment mean over the edge array (the unsorted sum,
as in the JAX package: no kernel); on the graph-diagonal layout it is the
row-normalised aggregation ``(A (x Wn)) / deg`` on kernel K1
(ops/diag_spmm.py); on block-dense batches the same as a batched product
(``torch.matmul``, no kernel, as in JAX). Parameter names are the reference's torch ``state_dict``
keys (``conv1.wc [in, out]``, ``conv1.wn``, ``conv1.bias`` ... ``fc2.bias``),
so one initialisation loads into every FoutNet of the port and, through
``neuralnets/param_interop.py`` (family ``"foutnet"``), into the JAX ones.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from functools import partial

import torch
from torch import nn

from deeprank2_tpu_torch.device import resolve_device
from deeprank2_tpu_torch.neuralnets import nn as dnn
from deeprank2_tpu_torch.ops.batch import DenseGraphBatch, DiagClusteredBatch, GraphBatch
from deeprank2_tpu_torch.ops.diag_spmm import diag_spmm_t
from deeprank2_tpu_torch.ops.pooling import (
    community_pool,
    dense_community_pool,
    dense_segment_max,
    depth1_graph_mean,
    diag_depth0_pool,
    graph_mean_pool,
    max_pool_x,
)
from deeprank2_tpu_torch.ops.segment import gather_rows, segment_mean


def uniform_parameter(shape: tuple, size: int, generator: torch.Generator | None, device: torch.device | None) -> nn.Parameter:
    """A parameter drawn from ``U(-1/sqrt(size), 1/sqrt(size))`` (PyG
    ``uniform(size, ...)``, the reference's conv init) on the CPU generator."""
    bound = 1.0 / math.sqrt(size)
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator).to(device))


class FoutLayer(nn.Module):
    """One Fout conv layer's parameters: ``wc`` and ``wn`` ``[in, out]`` and
    ``bias [out]``, all ``U(±1/sqrt(in))``."""

    def __init__(self, in_channels: int, out_channels: int, generator: torch.Generator | None = None, device: torch.device | None = None):
        super().__init__()
        self.wc = uniform_parameter((in_channels, out_channels), in_channels, generator, device)
        self.wn = uniform_parameter((in_channels, out_channels), in_channels, generator, device)
        self.bias = uniform_parameter((out_channels,), in_channels, generator, device)


def fout_layer(conv: FoutLayer, x: torch.Tensor, edge_index: torch.Tensor, edge_mask: torch.Tensor) -> torch.Tensor:
    """One Fout layer over padded COO arrays: ``x Wc`` plus the mean of
    ``x Wn`` over each node's neighbours (masked edges dropped) plus the bias."""
    row, col = edge_index[0], edge_index[1]
    capacity = x.shape[0]
    neigh = gather_rows(x @ conv.wn, col) * edge_mask[:, None]
    row_or_oob = torch.where(edge_mask, row, capacity)
    return x @ conv.wc + segment_mean(neigh, row_or_oob, capacity) + conv.bias


def fout_layer_dense(conv: FoutLayer, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """The Fout layer on ``[G, N, F]`` blocks: the neighbour mean is the
    row-normalised batched product ``(adj @ x Wn) / deg``, with ``deg`` the
    adjacency's row sums in f32 (exact counts)."""
    deg = adj.sum(dim=-1, dtype=torch.float32).clamp_min(1.0)  # [G, N]
    gamma = (adj.to(x.dtype) @ (x @ conv.wn)) / deg[:, :, None]
    return x @ conv.wc + gamma + conv.bias


def fout_layer_t(conv: FoutLayer, x_t: torch.Tensor, aggregate: Callable, deg: torch.Tensor) -> torch.Tensor:
    """The Fout layer on a transposed ``[F, V]`` layout, before its relu:
    ``Wcᵀ x_t + aggregate(Wnᵀ x_t) / max(deg, 1) + b``, with ``aggregate``
    the layout's symmetric SpMM (K1 on the graph-diagonal layout, K5 on BCSR)."""
    gamma = aggregate(conv.wn.T @ x_t) / deg.clamp_min(1.0)[None, :]
    return conv.wc.T @ x_t + gamma + conv.bias[:, None]


class ClusteredConvNet(nn.Module):
    """The two-conv community-pooling pipeline that FoutNet and sGAT share,
    over :class:`GraphBatch`: conv1, ``community_pool`` on ``cluster0``,
    conv2 on the pooled edges, ``max_pool_x`` on ``cluster1``, the per-graph
    mean and the fc1/fc2 head (no dropout). A subclass names its conv layer
    (``conv_layer``, 16 then 32 channels) and its COO layer (``conv``).
    ``generator`` draws the initial weights (a fixed seed when None)."""

    conv_layer: type[nn.Module]

    def __init__(
        self,
        input_shape: int,
        output_shape: int = 1,
        input_shape_edge: int | None = None,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_shape = input_shape
        self.output_shape = output_shape
        self.input_shape_edge = input_shape_edge
        self.conv1 = self.conv_layer(input_shape, 16, gen, dev)
        self.conv2 = self.conv_layer(16, 32, gen, dev)
        self.fc1 = dnn.init_linear(32, 64, generator=gen, device=dev)
        self.fc2 = dnn.init_linear(64, output_shape, generator=gen, device=dev)

    def conv(self, conv: nn.Module, x: torch.Tensor, edge_index: torch.Tensor, edge_attr: torch.Tensor, edge_mask: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def head(self, pooled: torch.Tensor) -> torch.Tensor:
        return dnn.linear(self.fc2, dnn.relu(dnn.linear(self.fc1, pooled)))

    def forward(self, batch: GraphBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[G, output_shape]``; the model has no dropout, so
        ``training`` and ``generator`` change nothing."""
        x = dnn.relu(self.conv(self.conv1, batch.x, batch.edge_index, batch.edge_attr, batch.edge_mask)) * batch.node_mask[:, None]
        x, _, ei, ea, em, node_graph, node_mask = community_pool(
            x, batch.pos, batch.edge_index, batch.edge_attr, batch.edge_mask, batch.node_graph, batch.cluster0, batch.num_graphs
        )
        x = dnn.relu(self.conv(self.conv2, x, ei, ea, em)) * node_mask[:, None]
        x, pooled_graph = max_pool_x(batch.cluster1, x, node_graph, batch.num_graphs)
        return self.head(graph_mean_pool(x, pooled_graph, batch.num_graphs))


class FoutNet(ClusteredConvNet):
    """FoutLayer x2 with community pooling (the COO model, the oracle of its
    fast twins)."""

    conv_layer = FoutLayer
    needs_clusters = True  # Trainer dispatch (JAX foutnet.py:70)

    def conv(self, conv: FoutLayer, x: torch.Tensor, edge_index: torch.Tensor, edge_attr: torch.Tensor, edge_mask: torch.Tensor) -> torch.Tensor:
        return fout_layer(conv, x, edge_index, edge_mask)


class FoutNetDiag(FoutNet):
    """FoutNet at PPI scale over :class:`DiagClusteredBatch` (port of the JAX
    ``FoutNetDiag``): the layout and pools of ``GINetClusteredDiag``, each
    conv the Fout layer with its neighbour mean on K1 (plain mode, int8
    adjacency; the pooled graph's ``adj_p_i8`` for conv2). The parameter set
    and ``state_dict`` keys are :class:`FoutNet`'s. ``compute_dtype=
    torch.bfloat16`` runs K1 in its bf16 form; the weight products stay f32
    (the JAX ``diag_spmm_t(..., compute_dtype)``). The COO :class:`FoutNet`
    takes no ``compute_dtype``, as the JAX one has none."""

    diag_clustered_batches = True  # Trainer dispatch (JAX foutnet.py:122-123)

    def __init__(
        self,
        input_shape: int,
        output_shape: int = 1,
        input_shape_edge: int | None = None,
        compute_dtype: torch.dtype | None = None,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__(input_shape, output_shape, input_shape_edge, device, generator)
        self.compute_dtype = dnn.checked_compute_dtype(self, compute_dtype)

    def forward(self, batch: DiagClusteredBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[G, output_shape]`` (no dropout)."""
        cd = self.compute_dtype
        mask_row = batch.node_mask.to(torch.float32).reshape(1, -1)
        h_t = torch.relu(fout_layer_t(self.conv1, batch.x_t, partial(diag_spmm_t, batch.adj_i8, compute_dtype=cd), batch.deg)) * mask_row
        hp_t = diag_depth0_pool(h_t, batch)  # [16, G*K]
        pooled_mask_row = batch.pooled_mask.to(torch.float32).reshape(1, -1)
        h2_t = torch.relu(fout_layer_t(self.conv2, hp_t, partial(diag_spmm_t, batch.adj_p_i8, compute_dtype=cd), batch.deg_p)) * pooled_mask_row
        return self.head(depth1_graph_mean(h2_t, batch))


class DenseClusteredConvNet:
    """The FoutNet and sGAT pipeline on a clustered :class:`DenseGraphBatch`
    (the JAX ``FoutNetDense``/``SGATDense``): conv1 on the batch adjacency,
    the dense community pool on ``cluster0``, conv2 on the pooled adjacency,
    the depth-1 max over ``cluster1``, the per-graph mean over the depth-1
    clusters and the head. A subclass gives its dense conv (``conv_dense``,
    before the relu), which reads the pooled edge weights where it has
    them. Batched products only, no kernel, as in JAX."""

    needs_clusters = True
    dense_batches = True
    clustering = "mcl"

    def conv_dense(self, conv, x: torch.Tensor, adj: torch.Tensor, adj_w: torch.Tensor | None) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, batch: DenseGraphBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[G, output_shape]`` (no dropout)."""
        from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import dense_masked_graph_mean

        if not batch.cluster0.numel():
            msg = f"{type(self).__name__} needs a clustered batch: collate with with_clusters=True"
            raise ValueError(msg)
        adj = batch.adjacency.to(batch.x.dtype)
        adj_w = batch.adj_w if getattr(self, "dense_edge_weights", False) else None
        x = torch.relu(self.conv_dense(self.conv1, batch.x, adj, adj_w)) * batch.node_mask[:, :, None]
        x, _, adj1, adj_w1, mask1 = dense_community_pool(x, batch.pos, adj, batch.cluster0, adj_w=adj_w)
        x = torch.relu(self.conv_dense(self.conv2, x, adj1, adj_w1)) * mask1[:, :, None]
        x = dense_segment_max(x, batch.cluster1)
        counts1 = dense_segment_max(mask1[:, :, None].to(x.dtype), batch.cluster1)[:, :, 0]
        return self.head(dense_masked_graph_mean(x, counts1 > 0))


class FoutNetDense(DenseClusteredConvNet, FoutNet):
    """FoutNet over a clustered :class:`DenseGraphBatch` (port of the JAX
    ``FoutNetDense``). The parameter set and ``state_dict`` keys are
    :class:`FoutNet`'s."""

    def conv_dense(self, conv: FoutLayer, x: torch.Tensor, adj: torch.Tensor, adj_w: torch.Tensor | None) -> torch.Tensor:
        return fout_layer_dense(conv, x, adj)
