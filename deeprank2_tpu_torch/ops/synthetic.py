"""Synthetic graph entries shaped like featurized PPI data (benchmarks, smoke
runs). A numpy-only copy of ``deeprank2_tpu/ops/synthetic.py``: the same seed
gives the same entries in both packages."""

from __future__ import annotations

import numpy as np


def synthetic_entries(
    num_graphs: int,
    nodes_per_graph: int,
    feat_dim: int = 38,
    edge_dim: int = 6,
    seed: int = 0,
) -> list[dict]:
    """Entries compatible with :func:`deeprank2_tpu_torch.ops.batch.collate_graphs_dense`:
    a ring plus random chords per graph (~8 edges/node, like interface contact
    graphs), with depth-0/depth-1 cluster assignments."""
    rng = np.random.default_rng(seed)
    entries = []
    for g in range(num_graphs):
        v = nodes_per_graph
        ring = np.stack([np.arange(v), (np.arange(v) + 1) % v], axis=1)
        chords = rng.integers(0, v, size=(v * 3, 2))
        chords = chords[chords[:, 0] != chords[:, 1]]
        und = np.unique(np.sort(np.concatenate([ring, chords]), axis=1), axis=0)
        cluster0 = np.arange(v) // 4
        n_c0 = int(cluster0.max()) + 1
        entries.append(
            {
                "x": rng.normal(size=(v, feat_dim)).astype(np.float32),
                "edge_index": und.astype(np.int64),
                "edge_attr": rng.normal(size=(len(und), edge_dim)).astype(np.float32),
                "pos": rng.normal(size=(v, 3)).astype(np.float32),
                "y": float(g % 2),
                "cluster0": cluster0,
                "cluster1": np.arange(n_c0) // 4,
                "entry_name": f"synth-{g}",
            }
        )
    return entries
