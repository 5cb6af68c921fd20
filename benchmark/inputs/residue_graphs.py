"""Residue-level interface graphs, made from ``--seed`` on the device in a
few large calls and copied to the host once.

The traffic file's ``graphs.sizes`` lists ``[nodes, undirected edges]`` of
real graphs; every size takes an equal share of the ``count`` graphs (the
same share for every seed), in an order drawn from the seed. A graph of
``n`` nodes and ``e`` edges is a contact graph: ``n`` points drawn
uniformly in a cube, joined by their ``e`` closest pairs. Node features,
edge features and positions are standard normal beside that (positions:
the drawn points), the target is ``g % 2``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DATASET = "GraphDataset"


@dataclass
class Graphs:
    """``count`` graphs as flat host arrays, each graph's rows in turn."""

    x: np.ndarray  # f32 [sum V, F]
    pos: np.ndarray  # f32 [sum V, 3]
    edges: np.ndarray  # i64 [sum E, 2] undirected, each graph's local ids, ascending
    edge_attr: np.ndarray  # f32 [sum E, Fe]
    node_counts: np.ndarray  # i64 [G]
    edge_counts: np.ndarray  # i64 [G]
    y: np.ndarray  # f32 [G]

    @property
    def count(self) -> int:
        return len(self.node_counts)

    def node_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.node_counts)])

    def edge_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.edge_counts)])


def make(count: int, traffic: dict, config: dict, seed: int, device: torch.device) -> Graphs:
    sizes = [(int(n), int(e)) for n, e in traffic["graphs"]["sizes"]]
    gen = torch.Generator(device=device).manual_seed(seed)
    kind = (torch.arange(count, device=device) % len(sizes))[torch.randperm(count, generator=gen, device=device)]
    nodes = torch.tensor([n for n, _ in sizes], device=device)[kind]
    edges_of = torch.tensor([e for _, e in sizes], device=device)[kind]
    node_off = torch.cumsum(nodes, 0) - nodes
    edge_off = torch.cumsum(edges_of, 0) - edges_of
    total_v, total_e = int(nodes.sum()), int(edges_of.sum())
    pos = torch.empty(total_v, 3, device=device)
    edges = torch.empty(total_e, 2, dtype=torch.int64, device=device)
    for k, (n, e) in enumerate(sizes):
        graphs = torch.nonzero(kind == k)[:, 0]
        if not len(graphs):
            continue
        points = torch.rand(len(graphs), n, 3, generator=gen, device=device)
        dist = torch.cdist(points, points)
        upper = torch.triu(torch.ones(n, n, dtype=torch.bool, device=device), diagonal=1)
        dist = dist.masked_fill(~upper, float("inf")).reshape(len(graphs), n * n)
        pairs = torch.sort(torch.topk(dist, e, dim=1, largest=False).indices, dim=1).values
        pos[(node_off[graphs, None] + torch.arange(n, device=device)).reshape(-1)] = points.reshape(-1, 3)
        rows = (edge_off[graphs, None] + torch.arange(e, device=device)).reshape(-1)
        edges[rows] = torch.stack([pairs // n, pairs % n], dim=2).reshape(-1, 2)
    x = torch.randn(total_v, int(config["node_features"]), generator=gen, device=device)
    edge_attr = torch.randn(total_e, int(config["edge_features"]), generator=gen, device=device)
    y = (torch.arange(count) % 2).to(torch.float32)
    return Graphs(x.cpu().numpy(), pos.cpu().numpy(), edges.cpu().numpy(), edge_attr.cpu().numpy(), nodes.cpu().numpy(), edges_of.cpu().numpy(), y.numpy())


def entries(graphs: Graphs, names: list[str]):
    """Each graph's datasets in the deeprank layout, by entry name."""
    nodes, edges = graphs.node_offsets(), graphs.edge_offsets()
    for g, name in enumerate(names):
        v, e = slice(nodes[g], nodes[g + 1]), slice(edges[g], edges[g + 1])
        yield (
            name,
            {
                "node_features/features": graphs.x[v],
                "node_features/_position": graphs.pos[v],
                "edge_features/_index": graphs.edges[e],
                "edge_features/attributes": graphs.edge_attr[e],
                "target_values/binary": graphs.y[g],
            },
        )
