"""GINet on graph-diagonal and block-dense batches (port of
``deeprank2_tpu/neuralnets/gnn/ginet_dense.py``): the no-cluster
``GINetDense`` (its flat path ``_apply_flat``, the fused tower of its
"pallas" backend and its batched branch), ``ginet_conv_dense``,
``dense_masked_graph_mean``, the batched ``GINetClusteredDense`` and the
clustered ``GINetClusteredDiag``.

With the reference's attention identically 1.0 (see the JAX ``ginet.py``),
one conv layer is ``relu(A (x W))``. The two towers ("external" and
"internal") are fused on the weight side: ``w1 = [w1a ‖ w1b]`` and
``w2 = blockdiag(w2a, w2b)``, which is the same math as two half-width towers
concatenated at the end. By default the whole tower runs in the flat
transposed ``[C, G*N]`` layout with the per-graph aggregation in the CUDA
kernels of ops/diag_spmm.py; the weight applications are plain matrix
products, which the JAX package also leaves outside its Pallas kernels.
``set_dense_tower_backend("pallas")`` switches ``GINetDense`` to the fused
batched tower of ops/ginet_tower.py (one forward and one backward kernel a
step) wherever its shape rule holds.

Where the flat route cannot take a batch (a batch collated without its
operands, ``adj_i8`` empty, or on a CUDA device one whose ``N`` exceeds
K1's shared memory, ``ops/diag_spmm.max_nodes``), ``GINetDense`` takes the
JAX model's batched branch: the same tower as batched products on the
``[G, C, N]`` layout (``torch.matmul``; JAX computes this branch outside
any Pallas kernel too). The batched dense family (``GINetClusteredDense``
here, ``FoutNetDense``, ``SGATDense``) runs on the same products and the
dense community pool of ops/pooling.py.

``compute_dtype=torch.bfloat16`` follows the JAX models' dtype flow. In
``GINetDense`` on its flat route the features and the four conv weights are
cast to bf16, both weight products run in bf16 (``h`` is cast to bf16
before the second), and the kernels run their bf16 forms; the pooled sums
are f32. On the fused tower the f32 weights and features go to the tower's
bf16 form, which rounds inside the kernels (the JAX
``ginet_tower_pooled(..., compute_dtype)``); the head stays f32. In
``GINetClusteredDiag`` the weight products stay f32 and only the kernels
round (the JAX ``lin_t`` and ``diag_layer_t(..., compute_dtype)``).
"""

from __future__ import annotations

import torch

from deeprank2_tpu_torch.neuralnets import nn as dnn
from deeprank2_tpu_torch.neuralnets.gnn.ginet import GINet
from deeprank2_tpu_torch.ops import diag_spmm, ginet_tower
from deeprank2_tpu_torch.ops.batch import DenseGraphBatch, DiagClusteredBatch
from deeprank2_tpu_torch.ops.diag_spmm import diag_layer_pool_t, diag_layer_t
from deeprank2_tpu_torch.ops.pooling import dense_community_pool, dense_segment_max, depth1_graph_mean, diag_depth0_pool

_TOWER_BACKEND = "xla"


def set_dense_tower_backend(name: str) -> None:
    """Select the tower of :class:`GINetDense`: "xla" (the default; the flat
    graph-diagonal route, which is the JAX package's route on its device) or
    "pallas" (the fused batched tower, ops/ginet_tower.py, taken where
    ``ginet_tower.supports`` holds for the batch, else the flat route)."""
    global _TOWER_BACKEND
    if name not in ("xla", "pallas"):
        msg = f"unknown dense tower backend: {name}"
        raise ValueError(msg)
    _TOWER_BACKEND = name


def ginet_conv_dense(conv: torch.nn.ModuleDict, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """One GINet conv on ``[G, N, F]`` node blocks with a ``[G, N, N]``
    adjacency: ``adj @ fc(x)``."""
    return adj.to(x.dtype) @ dnn.linear(conv["fc"], x)


def dense_masked_graph_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the node (or cluster) axis of ``[G, N, F]`` blocks."""
    x = x * mask[:, :, None].to(x.dtype)
    return x.sum(dim=1) / mask.sum(dim=1).to(x.dtype).clamp_min(1.0)[:, None]


_MAX_NODES: dict = {}


def _flat_route_fits(batch: DenseGraphBatch, act_dtype: torch.dtype) -> bool:
    """Whether the flat route takes the batch: its operands were collated
    and, on a CUDA device, K1 holds ``N`` nodes a graph in its shared memory
    (the CPU's plain versions have no such bound)."""
    adj = batch.adj_i8
    if not adj.numel():
        return False
    if adj.device.type != "cuda":
        return True
    key = (adj.device, adj.dtype, act_dtype)
    if key not in _MAX_NODES:
        _MAX_NODES[key] = diag_spmm.max_nodes(adj.dtype, adj.device, act_dtype)
    return batch.nodes_per_graph <= _MAX_NODES[key]


class GINetDense(GINet):
    """No-cluster GINet over :class:`DenseGraphBatch` (dual tower, mean pool),
    with the parameter set of the COO :class:`GINet` (the reference's torch
    ``state_dict`` keys, ``conv1.fc.weight [out, in]`` ... ``fc2.bias``), so one
    initialization loads into every GINet of the port and, through
    ``neuralnets/param_interop.py``, into the JAX one. ``generator`` draws the
    initial weights (a fixed seed when None)."""

    # Trainer dispatch attributes (JAX ginet_dense.py:272-274)
    needs_clusters = False
    dense_batches = True
    diag_operands = True

    def __init__(
        self,
        input_shape: int,
        output_shape: int = 1,
        input_shape_edge: int = 1,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__(input_shape, output_shape, input_shape_edge, device, generator)
        self.compute_dtype = dnn.checked_compute_dtype(self, compute_dtype)

    def fused_weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The conv layers' weights with the towers fused, in torch's
        ``[out, in]`` layout: ``w1ᵀ = [w1aᵀ ; w1bᵀ]`` (32 x F) and
        ``w2ᵀ = blockdiag(w2aᵀ, w2bᵀ)`` (64 x 32: tower a reads channels 0-15,
        tower b 16-31). The conv fc maps carry no bias."""
        w1_t = torch.cat([self.conv1["fc"].weight, self.conv1_ext["fc"].weight], dim=0)
        w2_t = torch.block_diag(self.conv2["fc"].weight, self.conv2_ext["fc"].weight)
        return w1_t, w2_t

    def batched_pooled(self, batch: DenseGraphBatch) -> torch.Tensor:
        """The tower's per-graph sums ``[G, 64]`` (f32) through the JAX
        model's batched branch: ``relu(v @ A)`` twice on the ``[G, C, N]``
        layout (``A`` symmetric, so this is ``relu(A (x W))``), masked, summed
        over the nodes in f32. Under ``compute_dtype`` the features, the
        adjacency and the weights are cast to it, as in JAX."""
        w1_t, w2_t = self.fused_weights()
        adj = batch.adjacency
        x_t = batch.x.transpose(1, 2)  # [G, F, N]
        dtype = self.compute_dtype or torch.float32
        w1_t, w2_t, x_t, adj = w1_t.to(dtype), w2_t.to(dtype), x_t.to(dtype), adj.to(dtype)
        h = torch.relu((w1_t @ x_t) @ adj)  # [G, 32, N]
        h = torch.relu((w2_t @ h) @ adj)  # [G, 64, N]
        h = h * batch.node_mask[:, None, :].to(h.dtype)
        return h.float().sum(dim=2)

    def forward(self, batch: DenseGraphBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[G, output_shape]``. Dropout (rate 0.4) runs only when
        ``training`` and a ``generator`` on the batch's device are given."""
        w1_t, w2_t = self.fused_weights()
        g, n, f = batch.x.shape
        cd = self.compute_dtype
        if _TOWER_BACKEND == "pallas" and batch.adj_i8.numel() and ginet_tower.supports(g, n, f, w1_t.shape[0], w2_t.shape[0]):
            pooled = ginet_tower.ginet_tower_pooled(w1_t.T, w2_t.T, batch.x, batch.adj_i8, batch.node_mask, cd)  # [G, 64]
        elif not _flat_route_fits(batch, cd or torch.float32):
            pooled = self.batched_pooled(batch)
        elif cd is None:
            h = diag_layer_t(batch.adj_i8, batch.node_mask, w1_t @ batch.x_t)  # [32, G*N]
            pooled = diag_layer_pool_t(batch.adj_i8, batch.node_mask, w2_t @ h).T  # [G, 64]
        else:
            # bf16 weight products (bf16 out); the kernels return f32
            w1_t, w2_t, x_t = w1_t.to(cd), w2_t.to(cd), batch.x_t.to(cd)
            h = diag_layer_t(batch.adj_i8, batch.node_mask, w1_t @ x_t, cd)
            pooled = diag_layer_pool_t(batch.adj_i8, batch.node_mask, w2_t @ h.to(cd), cd).T
        counts = batch.node_mask.sum(dim=1).to(pooled.dtype).clamp_min(1.0)
        out = pooled / counts[:, None]
        out = dnn.relu(dnn.linear(self.fc1, out))
        out = dnn.dropout(out, self.dropout, training, generator)
        return dnn.linear(self.fc2, out)


class GINetClusteredDense(GINetDense):
    """Clustered GINet over a :class:`DenseGraphBatch` with clusters (port of
    the JAX ``GINetClusteredDense``): each conv ``relu(adj @ fc(x))`` with
    the towers fused channel-wise, community pooling through the one-hot
    congruence ``C^T A C`` (ops/pooling.py:dense_community_pool), a depth-1
    max over ``cluster1``, the per-graph mean over the depth-1 clusters and
    the fc1/fc2 head. Batched products only, no kernel, as in JAX. The
    parameter set and ``state_dict`` keys are :class:`GINetDense`'s; it
    takes no ``compute_dtype``, as the JAX model has none."""

    needs_clusters = True
    dense_batches = True
    diag_operands = False
    clustering = "mcl"

    def __init__(
        self,
        input_shape: int,
        output_shape: int = 1,
        input_shape_edge: int = 1,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__(input_shape, output_shape, input_shape_edge, device, generator)

    def forward(self, batch: DenseGraphBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[G, output_shape]``. Dropout (rate 0.4) runs only when
        ``training`` and a ``generator`` on the batch's device are given."""
        if not batch.cluster0.numel():
            msg = "GINetClusteredDense needs a clustered batch: collate with with_clusters=True"
            raise ValueError(msg)
        adj = batch.adjacency.to(batch.x.dtype)
        fcx = torch.cat([dnn.linear(self.conv1["fc"], batch.x), dnn.linear(self.conv1_ext["fc"], batch.x)], dim=-1)
        h = torch.relu(adj @ fcx) * batch.node_mask[:, :, None]  # [G, N, 32]
        # pooling is channel-wise and the pooled graph tower-independent:
        # one community pool serves both towers
        h, _, adj1, _, mask1 = dense_community_pool(h, batch.pos, adj, batch.cluster0)
        fcx2 = torch.cat([dnn.linear(self.conv2["fc"], h[..., :16]), dnn.linear(self.conv2_ext["fc"], h[..., 16:])], dim=-1)
        h = torch.relu(adj1 @ fcx2) * mask1[:, :, None]  # [G, N, 64]
        # depth-1 max pool; cluster1 is indexed by depth-0 cluster id
        h = dense_segment_max(h, batch.cluster1)
        counts1 = dense_segment_max(mask1[:, :, None].to(h.dtype), batch.cluster1)[:, :, 0]
        out = dnn.relu(dnn.linear(self.fc1, dense_masked_graph_mean(h, counts1 > 0)))
        out = dnn.dropout(out, self.dropout, training, generator)
        return dnn.linear(self.fc2, out)


class GINetClusteredDiag(GINetDense):
    """Clustered GINet at PPI scale over :class:`DiagClusteredBatch` (port of
    the JAX ``GINetClusteredDiag``): the reference's flagship training
    configuration on the graph-diagonal machinery.

    Both conv layers are graph-diagonal aggregations with the relu and mask
    fused (ops/diag_spmm.py; the pooled graph is a second, smaller
    ``[G, K, K]`` adjacency built at collate). Depth-0 community pooling is
    the slot max-pool kernel plus a member combine (ops/pooling.py), depth-1
    pooling a member max over the pooled slots, then a per-graph mean and the
    fc1/fc2 head. The parameter set and ``state_dict`` keys are
    :class:`GINetDense`'s (the JAX model's ``init`` delegates to the COO
    GINet's, which has the same set)."""

    needs_clusters = True
    dense_batches = False
    diag_operands = False
    diag_clustered_batches = True  # Trainer dispatch (JAX ginet_dense.py:205-206)

    def forward(self, batch: DiagClusteredBatch, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[G, output_shape]``. Dropout (rate 0.4) runs only when
        ``training`` and a ``generator`` on the batch's device are given."""
        w1_t, w2_t = self.fused_weights()
        cd = self.compute_dtype
        h_t = diag_layer_t(batch.adj_i8, batch.node_mask, w1_t @ batch.x_t, cd)  # [32, G*N]
        hp_t = diag_depth0_pool(h_t, batch)  # [32, G*K]
        h2_t = diag_layer_t(batch.adj_p_i8, batch.pooled_mask, w2_t @ hp_t, cd)  # [64, G*K]
        out = dnn.relu(dnn.linear(self.fc1, depth1_graph_mean(h2_t, batch)))
        out = dnn.dropout(out, self.dropout, training, generator)
        return dnn.linear(self.fc2, out)
