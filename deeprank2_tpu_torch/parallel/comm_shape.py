"""The communication shape of the parallel paths (port of
``deeprank2_tpu/parallel/comm_shape.py``).

The JAX package compiles each sharded program and counts the collectives of
its optimized HLO. The port runs them: each report runs one step of a path
on every rank of the process group (call it on each) and reads
``parallel/comm.py``'s counters, by HLO kind (``all-reduce``,
``all-gather``, ``collective-permute``, with each call's result bytes), in
the JAX reports' form. Their inputs are the JAX reports' (the same seeds
and sizes), so a test can hold each count against JAX's at the same world
size. Two differences of form, by design:

- the data-parallel step also all-gathers its predictions ``[D, G, out]``:
  a rank of an SPMD run sees only its own, where JAX's controller reads the
  sharded array;
- the rings make ``D - 1`` hops a layer, where JAX's loop body runs its hop
  ``D`` times (the last one's block is never read) but the HLO holds it
  once; at ``D = 2`` both count one a layer.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from deeprank2_tpu_torch.parallel import comm


def _counted(fn) -> dict:
    comm.reset_counts()
    fn()
    return comm.snapshot()


def dp_train_report(graphs_per_shard: int = 4, nodes: int = 32, group=None, device: str | torch.device | None = None) -> dict[str, Any]:
    """Collectives of one dense data-parallel train step at this world size."""
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
    from deeprank2_tpu_torch.ops.batch import collate_graphs_dense_sharded
    from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
    from deeprank2_tpu_torch.ops.optim import Adam
    from deeprank2_tpu_torch.ops.synthetic import synthetic_entries
    from deeprank2_tpu_torch.parallel.dp import make_dp_train_step
    from deeprank2_tpu_torch.parallel.probes import classif_loss

    size, rank = comm.world(group)
    feat_dim, edge_dim = 7, 3
    model = GINetDense(feat_dim, 2, edge_dim, device=device)
    step = make_dp_train_step(classif_loss(model, CrossEntropyLoss()), Adam(model.parameters(), lr=1e-3), group)
    entries = synthetic_entries(graphs_per_shard * size, nodes, feat_dim, edge_dim, seed=3)
    shards, _ = collate_graphs_dense_sharded(entries, size, graphs_per_shard, pad_nodes=nodes, device=device)
    stats = _counted(lambda: step(shards[rank], torch.Generator().manual_seed(1)))
    return {"path": "dp_dense_train", "shards": size, **stats}


def edge_partition_report(ring: bool = False, num_graphs: int = 4, nodes_per_graph: int = 48, group=None, device: str | torch.device | None = None) -> dict[str, Any]:
    """Collectives of one edge-partitioned (or ring) GINet forward."""
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_nocluster import GINet
    from deeprank2_tpu_torch.ops.batch import collate_graphs
    from deeprank2_tpu_torch.ops.synthetic import synthetic_entries
    from deeprank2_tpu_torch.parallel import edge_partition as ep

    size, rank = comm.world(group)
    feat_dim, edge_dim = 7, 3
    batch, _ = collate_graphs(synthetic_entries(num_graphs, nodes_per_graph, feat_dim, edge_dim, seed=5), device=device)
    model = GINet(feat_dim, 2, edge_dim, device=device)
    if ring:
        part, fwd = ep.partition_graph_batch_ring(batch, size)[rank], ep.make_ring_ginet_forward(model, group)
    else:
        part, fwd = ep.partition_graph_batch(batch, size)[rank], ep.make_edge_partitioned_ginet_forward(model, group)
    with torch.no_grad():
        stats = _counted(lambda: fwd(part))
    return {"path": "ring_halo_fwd" if ring else "edge_partition_fwd", "shards": size, **stats}


def blocksparse_ring_report(seed: int = 1, group=None, device: str | torch.device | None = None) -> dict[str, Any]:
    """Collectives of one block-sparse ring forward."""
    from scipy.spatial import cKDTree

    from deeprank2_tpu_torch.neuralnets.gnn.ginet_blocksparse import GINetBlockSparse
    from deeprank2_tpu_torch.ops.batch import collate_graphs_blocksparse
    from deeprank2_tpu_torch.parallel import blocksparse_partition as bp

    size, rank = comm.world(group)
    rng = np.random.default_rng(seed)
    entries = []
    for g in range(2):
        n = 260 + 40 * g
        pos = rng.uniform(0, 25, size=(n, 3))
        pairs = cKDTree(pos).query_pairs(5.0, output_type="ndarray")
        entries.append(
            {
                "x": rng.normal(size=(n, 7)).astype(np.float32),
                "edge_index": pairs.astype(np.int64),
                "edge_attr": rng.normal(size=(len(pairs), 3)).astype(np.float32),
                "pos": pos.astype(np.float32),
                "y": float(g % 2),
                "entry_name": f"g{g}",
            }
        )
    batch, _ = collate_graphs_blocksparse(entries, device=device)
    part = bp.partition_blocksparse_batch_ring(batch, size)[rank]
    fwd = bp.make_blocksparse_ginet_ring_forward(GINetBlockSparse(7, 2, 3, device=device), group)
    with torch.no_grad():
        stats = _counted(lambda: fwd(part))
    return {"path": "blocksparse_ring_fwd", "shards": size, **stats}
