"""Simplified graph attention network (port of
``deeprank2_tpu/neuralnets/gnn/sgat.py``: ``sgat_layer``,
``sgat_layer_dense``, the COO ``SGAT``, the graph-diagonal ``SGATDiag`` and
the block-dense ``SGATDense``).

Layer math: ``z_i = mean_j(e_ij * ([x_i || x_j] W)) + b``, where the scalar
edge attribute multiplies the transformed pair feature (only the row
aggregation: both edge directions are present). With ``W = [W_top; W_bot]``
the mean is ``(x_i W_top * sum_j e_ij + sum_j e_ij x_j W_bot) / deg_i``: in
the COO layout one segment mean over the edge array (the unsorted sum, no
kernel); on the graph-diagonal layout the aggregation ``A_w (x W_bot)`` of
the weighted adjacency on kernel K1 (bf16 by default) with the collate's
f32 row sums ``wsum``; on block-dense batches ``adj_w @ (x W_bot)`` as a
batched product with ``adj_w``'s row sums (no kernel, as in JAX). Parameter names are the reference's torch
``state_dict`` keys (``conv1.weight [2*in, out]``, ``conv1.bias`` ...
``fc2.bias``), so one initialisation loads into every sGAT of the port and,
through ``neuralnets/param_interop.py`` (family ``"sgat"``), into the JAX
ones.
"""

from __future__ import annotations

from collections.abc import Callable
from functools import partial

import torch
from torch import nn

from deeprank2_tpu_torch.neuralnets import nn as dnn
from deeprank2_tpu_torch.neuralnets.gnn.foutnet import ClusteredConvNet, DenseClusteredConvNet, uniform_parameter
from deeprank2_tpu_torch.ops.batch import DiagClusteredBatch
from deeprank2_tpu_torch.ops.diag_spmm import diag_spmm_t
from deeprank2_tpu_torch.ops.pooling import depth1_graph_mean, diag_depth0_pool
from deeprank2_tpu_torch.ops.segment import gather_rows, segment_mean


class SGATLayer(nn.Module):
    """One sGAT conv layer's parameters: ``weight [2*in, out]`` and ``bias
    [out]``, both ``U(±1/sqrt(2*in))``."""

    def __init__(self, in_channels: int, out_channels: int, generator: torch.Generator | None = None, device: torch.device | None = None):
        super().__init__()
        self.weight = uniform_parameter((2 * in_channels, out_channels), 2 * in_channels, generator, device)
        self.bias = uniform_parameter((out_channels,), 2 * in_channels, generator, device)


def sgat_layer(conv: SGATLayer, x: torch.Tensor, edge_index: torch.Tensor, edge_attr: torch.Tensor, edge_mask: torch.Tensor) -> torch.Tensor:
    """One sGAT layer over padded COO arrays (``edge_attr [E, 1]`` or
    ``[E, out]``, broadcast over the message)."""
    row, col = edge_index[0], edge_index[1]
    capacity, f = x.shape
    # [x_i || x_j] W == x_i W_top + x_j W_bot, each precomputed per node
    alpha = gather_rows(x @ conv.weight[:f], row) + gather_rows(x @ conv.weight[f:], col)
    alpha = edge_attr * alpha
    row_or_oob = torch.where(edge_mask, row, capacity)
    return segment_mean(alpha * edge_mask[:, None], row_or_oob, capacity) + conv.bias


def sgat_layer_dense(conv: SGATLayer, x: torch.Tensor, adj: torch.Tensor, adj_w: torch.Tensor) -> torch.Tensor:
    """The sGAT layer on ``[G, N, F]`` blocks with the scalar-edge-weighted
    adjacency ``adj_w``: ``(x W_top * sum_j a_ij + adj_w @ x W_bot) / deg``,
    ``deg`` the neighbour counts (the row sums of ``adj``, in f32)."""
    f = x.shape[-1]
    deg = adj.sum(dim=-1, dtype=torch.float32).clamp_min(1.0)  # [G, N]
    out = ((x @ conv.weight[:f]) * adj_w.sum(dim=-1)[:, :, None] + adj_w @ (x @ conv.weight[f:])) / deg[:, :, None]
    return out + conv.bias


def sgat_layer_t(conv: SGATLayer, x_t: torch.Tensor, aggregate: Callable, deg: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """The sGAT layer on a transposed ``[F, V]`` layout, before its relu:
    ``((W_topᵀ x_t) * wsum + aggregate(W_botᵀ x_t)) / max(deg, 1) + b``, with
    ``aggregate`` the layout's weighted symmetric SpMM (K1 on the
    graph-diagonal layout, K5 on BCSR) and ``wsum`` its f32 row sums."""
    if not wsum.numel():
        msg = "sGAT needs a weighted batch: collate with with_edge_weights=True"
        raise ValueError(msg)
    f = x_t.shape[0]
    row_part = conv.weight[:f].T @ x_t
    out = (row_part * wsum[None, :] + aggregate(conv.weight[f:].T @ x_t)) / deg.clamp_min(1.0)[None, :]
    return out + conv.bias[:, None]


class SGAT(ClusteredConvNet):
    """Two sGAT layers with community pooling (the COO model, the oracle of
    its fast twins); pooled edges carry the sum of their members' edge
    attributes."""

    conv_layer = SGATLayer
    needs_clusters = True  # Trainer dispatch (JAX sgat.py:62)

    def conv(self, conv: SGATLayer, x: torch.Tensor, edge_index: torch.Tensor, edge_attr: torch.Tensor, edge_mask: torch.Tensor) -> torch.Tensor:
        return sgat_layer(conv, x, edge_index, edge_attr, edge_mask)


class SGATDiag(SGAT):
    """sGAT at PPI scale over a weighted :class:`DiagClusteredBatch`
    (``collate_graphs_diag_clustered(with_edge_weights=True)``; port of the
    JAX ``SGATDiag``): the layout and pools of ``GINetClusteredDiag``, each
    conv's weighted aggregation on K1 (plain mode) over ``adj_w``, then
    ``adj_wp`` for conv2. The parameter set and ``state_dict`` keys are
    :class:`SGAT`'s. ``compute_dtype=torch.bfloat16`` runs K1 in its bf16
    form on a bf16 adjacency, and JAX's XLA fallback (adjacency, x and the
    aggregate rounded to bf16) on the f32 one of
    ``weight_dtype=torch.float32``; the weight products stay f32 (the JAX
    ``diag_spmm_t(adj_w, ..., compute_dtype)``). The COO :class:`SGAT` takes
    no ``compute_dtype``, as the JAX one has none."""

    # Trainer dispatch (JAX sgat.py:116-118)
    diag_clustered_batches = True
    diag_clustered_edge_weights = True

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
        h_t = torch.relu(sgat_layer_t(self.conv1, batch.x_t, partial(diag_spmm_t, batch.adj_w, compute_dtype=cd), batch.deg, batch.wsum)) * mask_row
        hp_t = diag_depth0_pool(h_t, batch)  # [16, G*K]
        pooled_mask_row = batch.pooled_mask.to(torch.float32).reshape(1, -1)
        h2_t = torch.relu(sgat_layer_t(self.conv2, hp_t, partial(diag_spmm_t, batch.adj_wp, compute_dtype=cd), batch.deg_p, batch.wsum_p)) * pooled_mask_row
        return self.head(depth1_graph_mean(h2_t, batch))


class SGATDense(DenseClusteredConvNet, SGAT):
    """sGAT over a clustered, edge-weighted :class:`DenseGraphBatch` (port of
    the JAX ``SGATDense``: the scalar edge feature, e.g. distance). The
    parameter set and ``state_dict`` keys are :class:`SGAT`'s."""

    dense_edge_weights = True

    def conv_dense(self, conv: SGATLayer, x: torch.Tensor, adj: torch.Tensor, adj_w: torch.Tensor | None) -> torch.Tensor:
        if adj_w is None or not adj_w.numel():
            msg = "SGATDense needs a weighted batch: collate with with_edge_weights=True"
            raise ValueError(msg)
        return sgat_layer_dense(conv, x, adj, adj_w)
