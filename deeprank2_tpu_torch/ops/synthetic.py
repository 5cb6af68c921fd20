"""Synthetic graph entries shaped like featurized PPI data (benchmarks, smoke
runs). Numpy-only copies of ``deeprank2_tpu/ops/synthetic.py``, of the
clustered PPI generator of ``tests/perf/diag_clustered_perf.py`` and of the
atomic-scale generators of ``tests/perf/blocksparse_perf.py`` and
``tests/perf/clustered_bcsr_perf.py``: the same seed gives the same entries
in both packages. ``signed_int8_blocks`` (the port's own) makes BCSR blocks
with signed int8 weights for the kernel checks."""

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


def ppi_clustered_entries(num_graphs: int = 512, nodes: int = 160, feat_dim: int = 38, cell: float = 10.0, seed: int = 0) -> list[dict]:
    """Spatial PPI-like graphs for the clustered models: ``nodes`` points in a
    24 Å box, edges between points closer than 5 Å, depth-0 clusters by
    ``cell`` Å grid cell (about 6 nodes at 10 Å, under 3 at 6 Å) and depth-1
    clusters by ``2 * cell`` Å cells of the cluster centroids."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    entries = []
    for g in range(num_graphs):
        pos = rng.uniform(0, 24, (nodes, 3)).astype(np.float32)
        pairs = cKDTree(pos).query_pairs(5.0, output_type="ndarray")
        cell0 = np.floor(pos / cell).astype(np.int64)
        _, c0 = np.unique(cell0[:, 0] * 10000 + cell0[:, 1] * 100 + cell0[:, 2], return_inverse=True)
        n_c0 = int(c0.max()) + 1
        psum = np.zeros((n_c0, 3))
        np.add.at(psum, c0, pos)
        pmean = psum / np.bincount(c0, minlength=n_c0)[:, None]
        cell1 = np.floor(pmean / (2 * cell)).astype(np.int64)
        _, c1 = np.unique(cell1[:, 0] * 10000 + cell1[:, 1] * 100 + cell1[:, 2], return_inverse=True)
        entries.append(
            {
                "x": rng.normal(size=(nodes, feat_dim)).astype(np.float32),
                "edge_index": pairs.astype(np.int64),
                "edge_attr": rng.uniform(0.5, 3.0, size=(len(pairs), 1)).astype(np.float32),
                "pos": pos,
                "y": float(g % 2),
                "cluster0": c0.astype(np.int32),
                "cluster1": c1.astype(np.int32),
                "entry_name": f"g{g}",
            }
        )
    return entries


def geometric_entry(n: int, feat_dim: int = 38, edge_dim: int = 6, seed: int = 0) -> dict:
    """One atomic-resolution-sized graph: ``n`` points at about protein atom
    density (0.09 per Å³) in a cube, edges between points closer than 4.5 Å
    (about 33 directed edges per node)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    side = (n / 0.09) ** (1 / 3)
    pos = rng.uniform(0, side, size=(n, 3))
    pairs = cKDTree(pos).query_pairs(4.5, output_type="ndarray")
    return {
        "x": rng.normal(size=(n, feat_dim)).astype(np.float32),
        "edge_index": pairs.astype(np.int64),
        "edge_attr": rng.normal(size=(len(pairs), edge_dim)).astype(np.float32),
        "pos": pos.astype(np.float32),
        "y": 1.0,
        "entry_name": "slab",
    }


def clustered_entry(n: int, feat_dim: int = 38, edge_dim: int = 1, seed: int = 0) -> dict:
    """:func:`geometric_entry` with two-depth spatial clusters: depth-0 by
    8 Å grid cell, depth-1 by 16 Å cells of the cluster centroids; edge
    attributes made positive (a scalar edge weight for sGAT)."""
    entry = geometric_entry(n, feat_dim, edge_dim, seed)
    pos = entry["pos"]
    cell0 = np.floor(pos / 8.0).astype(np.int64)
    _, c0 = np.unique(cell0[:, 0] * 1_000_000 + cell0[:, 1] * 1000 + cell0[:, 2], return_inverse=True)
    n_c0 = int(c0.max()) + 1
    psum = np.zeros((n_c0, 3))
    np.add.at(psum, c0, pos)
    pmean = psum / np.bincount(c0, minlength=n_c0)[:, None]
    cell1 = np.floor(pmean / 16.0).astype(np.int64)
    _, c1 = np.unique(cell1[:, 0] * 1_000_000 + cell1[:, 1] * 1000 + cell1[:, 2], return_inverse=True)
    entry["cluster0"] = c0.astype(np.int32)
    entry["cluster1"] = c1.astype(np.int32)
    entry["edge_attr"] = np.abs(entry["edge_attr"]) + 0.1
    return entry


def signed_int8_blocks(blocks: np.ndarray, tile_blocks: np.ndarray, seed: int = 0) -> np.ndarray:
    """A copy of int8 0/1 BCSR blocks ``[NB, B, B]`` whose every other nonzero
    block (by position in ``tile_blocks``) has its edges reweighted from
    {-2, -1, 1, 3}: some blocks stay 0/1, the others are mixed."""
    rng = np.random.default_rng(seed)
    out = np.array(blocks, dtype=np.int8)
    mixed = np.asarray(tile_blocks)[::2]
    weights = np.array([-2, -1, 1, 3], np.int8)[rng.integers(0, 4, out[mixed].shape)]
    out[mixed] = np.where(out[mixed] != 0, weights, out[mixed])
    return out
