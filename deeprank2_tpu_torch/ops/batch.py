"""Block-dense graph batches (port of ``deeprank2_tpu/ops/batch.py``:
``bucket_size``, ``DenseGraphBatch``, ``collate_graphs_dense``).

The batch adjacency of collated graphs is block-diagonal: with graphs padded
to ``N`` nodes, graph ``g`` owns rows and columns ``[g*N, (g+1)*N)`` and no
edge crosses graphs. The aggregation therefore runs per graph on an int8 0/1
adjacency ``[G, N, N]`` against node features kept flat and transposed,
``x_t [F, G*N]`` (ops/diag_spmm.py). Edges are mirrored, so every adjacency
block is symmetric.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deeprank2_tpu_torch.device import resolve_device


def bucket_size(n: int, quantum: int = 128) -> int:
    """Round up to a coarse geometric/linear grid (same grid as the JAX package)."""
    n = max(n, 1)
    if n <= quantum:
        return quantum
    # geometric steps of 1.3x, snapped to the quantum
    size = quantum
    while size < n:
        size = int(np.ceil(size * 1.3 / quantum) * quantum)
    return size


@dataclass
class DenseGraphBatch:
    """Block-dense batch of ``G`` graphs padded to ``N`` nodes, on one device."""

    x: torch.Tensor  # f32 [G, N, F] node features (padded rows 0)
    adj_i8: torch.Tensor  # int8 [G, N, N]; adj[g, i, j] = 1 if edge j->i (symmetric)
    x_t: torch.Tensor  # f32 [F, G*N] flat transposed node features
    node_mask: torch.Tensor  # bool [G, N]
    y: torch.Tensor  # f32 [G] targets (0 where missing)
    y_mask: torch.Tensor  # bool [G] real-graph mask

    @property
    def num_graphs(self) -> int:
        return self.x.shape[0]

    @property
    def nodes_per_graph(self) -> int:
        return self.x.shape[1]

    def to(self, device: str | torch.device) -> DenseGraphBatch:
        """A copy of the batch on ``device``."""
        dev = resolve_device(device)
        return DenseGraphBatch(**{k: getattr(self, k).to(dev) for k in self.__dataclass_fields__})


def collate_graphs_dense(
    entries: list[dict],
    pad_graphs: int | None = None,
    pad_nodes: int | None = None,
    with_clusters: bool = False,
    with_edge_weights: bool = False,
    device: str | torch.device | None = None,
) -> tuple[DenseGraphBatch, list[str]]:
    """Collate entries (dicts with ``x``, ``edge_index``, ``y``, ``entry_name``)
    into a :class:`DenseGraphBatch` on ``device`` (CUDA unless ``"cpu"`` is
    asked for). Edges are mirrored into a symmetric adjacency.

    ``pad_graphs`` pads the batch with empty, masked graphs; ``pad_nodes``
    bounds nodes per graph (bucketed from the data, quantum 32, when None).
    Cluster ids and edge-weighted adjacencies belong to later slices of the
    port and raise ``NotImplementedError``."""
    if with_clusters or with_edge_weights:
        msg = "clustered and edge-weighted dense batches are not ported yet"
        raise NotImplementedError(msg)
    dev = resolve_device(device)
    num_real = len(entries)
    num_graphs = pad_graphs or num_real
    if num_graphs < num_real:
        msg = f"pad_graphs={num_graphs} is smaller than the {num_real} entries"
        raise ValueError(msg)
    names = [e["entry_name"] for e in entries] + [""] * (num_graphs - num_real)
    max_v = max(e["x"].shape[0] for e in entries)
    cap_n = pad_nodes or bucket_size(max_v, quantum=32)
    if max_v > cap_n:
        msg = f"graph with {max_v} nodes exceeds dense node capacity {cap_n}"
        raise ValueError(msg)
    feat_dim = entries[0]["x"].shape[1]

    x = np.zeros((num_graphs, cap_n, feat_dim), dtype=np.float32)
    adj = np.zeros((num_graphs, cap_n, cap_n), dtype=np.int8)
    node_mask = np.zeros((num_graphs, cap_n), dtype=bool)
    y = np.zeros(num_graphs, dtype=np.float32)
    y_mask = np.zeros(num_graphs, dtype=bool)

    for g, entry in enumerate(entries):
        v = entry["x"].shape[0]
        x[g, :v] = entry["x"]
        node_mask[g, :v] = True
        und = np.asarray(entry["edge_index"], dtype=np.int64)
        if und.size:
            adj[g, und[:, 0], und[:, 1]] = 1
            adj[g, und[:, 1], und[:, 0]] = 1
        if entry.get("y") is not None:
            y[g] = entry["y"]
            y_mask[g] = True

    x_t = np.ascontiguousarray(x.reshape(num_graphs * cap_n, feat_dim).T)
    batch = DenseGraphBatch(
        x=torch.from_numpy(x).to(dev),
        adj_i8=torch.from_numpy(adj).to(dev),
        x_t=torch.from_numpy(x_t).to(dev),
        node_mask=torch.from_numpy(node_mask).to(dev),
        y=torch.from_numpy(y).to(dev),
        y_mask=torch.from_numpy(y_mask).to(dev),
    )
    return batch, names
