"""Community detection (MCL / Louvain) and host-side cluster pooling.

Replaces the reference's networkx + markov_clustering + python-louvain stack
(deeprank2/utils/community_pooling.py) with in-repo numpy implementations.
These run at *featurization/precluster* time; the in-model pooling lives in
ops/pooling.py. The port's copy of ``deeprank2_tpu/utils/community_pooling.py``
(numpy only), without its JAX-side ``community_pooling``, whose work
``ops/pooling.community_pool`` does in the port.

MCL follows the markov_clustering package's default algorithm: add self loops,
column-normalize, iterate expansion (matrix square) + inflation (elementwise
square, renormalize) with pruning until convergence; clusters are the attractor
rows' non-zero columns. Note MCL expansion is literally SpMM — the same
primitive as the GNN aggregation.
"""

from __future__ import annotations

import numpy as np


def plot_graph(edge_index: np.ndarray, num_nodes: int, cluster: np.ndarray, fname: str | None = None) -> None:
    """Draw the graph colored by cluster (reference: community_pooling.py:18-21)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import networkx as nx

    g = nx.Graph()
    g.add_nodes_from(range(num_nodes))
    edges = np.asarray(edge_index)
    if edges.size:
        if edges.shape[0] == 2 and edges.shape[1] != 2:
            edges = edges.T
        g.add_edges_from((int(i), int(j)) for i, j in edges if i != j)
    pos = nx.spring_layout(g, iterations=200)
    nx.draw(g, pos, node_color=list(np.asarray(cluster)))
    if fname:
        plt.savefig(fname)
        plt.close()
    else:  # pragma: no cover - interactive use
        plt.show()


def _adjacency(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Dense symmetric 0/1 adjacency from an edge list ([E, 2] or [2, E])."""
    a = np.zeros((num_nodes, num_nodes), dtype=np.float64)
    edges = np.asarray(edge_index)
    if edges.size:
        if edges.shape[0] == 2 and edges.shape[1] != 2:
            edges = edges.T
        for i, j in edges:
            if i != j:
                a[i, j] = 1.0
                a[j, i] = 1.0
    return a


def run_mcl(
    matrix: np.ndarray,
    expansion: int = 2,
    inflation: float = 2.0,
    loop_value: float = 1.0,
    iterations: int = 100,
    pruning_threshold: float = 0.001,
    convergence_tolerance: float = 1e-8,
) -> np.ndarray:
    """Markov clustering on a dense adjacency matrix; returns the steady-state matrix."""
    m = np.array(matrix, dtype=np.float64)
    np.fill_diagonal(m, loop_value)
    # column normalize
    m = m / np.maximum(m.sum(axis=0, keepdims=True), 1e-12)

    for _ in range(iterations):
        last = m.copy()
        m = np.linalg.matrix_power(m, expansion)  # expansion (SpMM^k)
        m = np.power(m, inflation)  # inflation
        m = m / np.maximum(m.sum(axis=0, keepdims=True), 1e-12)
        m[m < pruning_threshold] = 0.0
        m = m / np.maximum(m.sum(axis=0, keepdims=True), 1e-12)
        if np.allclose(m, last, atol=convergence_tolerance):
            break
    return m


def get_clusters(matrix: np.ndarray) -> list[tuple[int, ...]]:
    """Attractor-based cluster extraction (markov_clustering.get_clusters parity)."""
    attractors = np.flatnonzero(matrix.diagonal() > 0)
    clusters = set()
    for a in attractors:
        members = tuple(np.flatnonzero(matrix[a] > 0).tolist())
        clusters.add(members)
    return sorted(clusters)


def louvain_partition(edge_index: np.ndarray, num_nodes: int, seed: int = 0) -> dict[int, int]:
    """Greedy-modularity Louvain partition (python-louvain ``best_partition`` equivalent)."""
    a = _adjacency(edge_index, num_nodes)
    rng = np.random.RandomState(seed)

    node_to_comm = np.arange(num_nodes)
    total_weight = a.sum() / 2.0
    if total_weight == 0:
        return {i: i for i in range(num_nodes)}

    degrees = a.sum(axis=1)
    # sigma[c] = total degree of community c, maintained incrementally so a
    # node visit costs O(degree) instead of O(N) per candidate community
    sigma = degrees.copy()
    improved = True
    while improved:
        improved = False
        for node in rng.permutation(num_nodes):
            current = node_to_comm[node]
            neighbors = np.flatnonzero(a[node])
            if neighbors.size == 0:
                continue
            k_i = degrees[node]
            weights = a[node, neighbors]
            # links from `node` into each neighboring community
            link: dict[int, float] = {}
            for comm, w in zip(node_to_comm[neighbors], weights):
                link[comm] = link.get(comm, 0.0) + w

            # gain of staying: node removed from its community first
            best_comm = current
            best_gain = link.get(current, 0.0) - (sigma[current] - k_i) * k_i / (2.0 * total_weight)
            for comm, in_links in link.items():
                if comm == current:
                    continue
                gain = in_links - sigma[comm] * k_i / (2.0 * total_weight)
                if gain > best_gain:
                    best_gain, best_comm = gain, comm
            if best_comm != current:
                sigma[current] -= k_i
                sigma[best_comm] += k_i
                node_to_comm[node] = best_comm
                improved = True

    # relabel communities consecutively
    uniq = {c: i for i, c in enumerate(np.unique(node_to_comm))}
    return {i: uniq[c] for i, c in enumerate(node_to_comm)}


def community_detection(
    edge_index: np.ndarray,
    num_nodes: int,
    edge_attr: np.ndarray | None = None,  # noqa: ARG001 (parity; detection is unweighted like the trainer's use)
    method: str = "mcl",
) -> np.ndarray:
    """Cluster assignment per node via MCL or Louvain (reference: community_pooling.py:96-165)."""
    if method == "louvain":
        part = louvain_partition(edge_index, num_nodes)
        return np.array([part[i] for i in range(num_nodes)], dtype=np.int64)

    if method == "mcl":
        a = _adjacency(edge_index, num_nodes)
        result = run_mcl(a)
        clusters = get_clusters(result)
        index = np.zeros(num_nodes, dtype=np.int64)
        for ic, members in enumerate(clusters):
            index[list(members)] = ic
        return index

    msg = f"Clustering method {method} not supported"
    raise ValueError(msg)


def community_pooling_host(cluster: np.ndarray, edge_index: np.ndarray) -> tuple[np.ndarray, int]:
    """Host-side edge pooling for hierarchical pre-clustering.

    Relabels clusters consecutively (sorted order — PyG ``consecutive_cluster``
    parity), maps edges to cluster pairs, drops self loops, dedups.

    Returns (pooled_edge_index [P, 2], num_clusters).
    """
    uniq, consecutive = np.unique(cluster, return_inverse=True)
    edges = np.asarray(edge_index)
    if edges.size == 0:
        return np.zeros((0, 2), dtype=np.int64), len(uniq)
    if edges.shape[0] == 2 and edges.shape[1] != 2:
        edges = edges.T
    pooled = consecutive[edges]
    pooled = pooled[pooled[:, 0] != pooled[:, 1]]
    if pooled.size == 0:
        return np.zeros((0, 2), dtype=np.int64), len(uniq)
    pooled = np.unique(pooled, axis=0)
    return pooled, len(uniq)


def community_detection_per_batch(
    edge_index: np.ndarray,
    batch: np.ndarray,
    num_nodes: int,
    edge_attr: np.ndarray | None = None,
    method: str = "mcl",
) -> np.ndarray:
    """Cluster each graph of a batch independently, with batch-global cluster ids
    (reference: community_pooling.py:30-93).

    Args:
        edge_index: [E, 2] or [2, E] batch-global edge list.
        batch: int [V] graph id per node.
        num_nodes: total node count across the batch.
        edge_attr: ignored (parity — detection is unweighted, like the trainer's use).
        method: ``"mcl"`` or ``"louvain"``.

    Returns:
        int64 [V] cluster id per node; ids of graph g start after graph g-1's.
    """
    edges = np.asarray(edge_index)
    if edges.size and edges.shape[0] == 2 and edges.shape[1] != 2:
        edges = edges.T
    if edges.size:  # drop padded slots (OOB node ids mark padding)
        edges = edges[(edges[:, 0] < num_nodes) & (edges[:, 1] < num_nodes)]
    batch = np.asarray(batch)
    cluster = np.zeros(num_nodes, dtype=np.int64)
    offset = 0
    for g in np.unique(batch):
        node_ids = np.flatnonzero(batch == g)
        local = np.full(num_nodes, -1, dtype=np.int64)
        local[node_ids] = np.arange(node_ids.size)
        if edges.size:
            own = (batch[edges[:, 0]] == g) & (batch[edges[:, 1]] == g)
            local_edges = local[edges[own]]
        else:
            local_edges = np.zeros((0, 2), dtype=np.int64)
        sub = community_detection(local_edges, node_ids.size, edge_attr=None, method=method)
        cluster[node_ids] = sub + offset
        offset += int(sub.max()) + 1 if sub.size else 0
    return cluster


def get_preloaded_cluster(cluster: np.ndarray, batch: np.ndarray) -> np.ndarray:
    """Offset per-graph cluster ids to be batch-global (reference: community_pooling.py:23)."""
    cluster = np.array(cluster)
    nbatch = int(batch.max()) + 1
    for ib in range(1, nbatch):
        cluster[batch == ib] += int(cluster[batch == ib - 1].max()) + 1
    return cluster
