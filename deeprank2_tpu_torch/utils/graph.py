"""Array-first featured graphs.

The reference builds graphs as dicts of per-node/per-edge Python objects
(deeprank2/utils/graph.py); here a :class:`Graph` holds index arrays into a
``StructureArrays`` plus dense feature matrices, so feature modules are
vectorized and batching is a concatenation of arrays.

Behavioral parity points (vs deeprank2/utils/graph.py:320-381):
- nodes are residues or atoms; an edge connects nodes whose (atom) distance is
  below ``max_edge_length``; residue graphs derive edges from atom pairs mapped
  to residue pairs;
- nodes that end up without any edge are dropped, and node order equals first
  appearance in the lexicographically sorted edge list (this matches the
  reference's dict-insertion order, so HDF5 files are byte-comparable);
- HDF5 layout: ``<id>/node_features/*``, ``<id>/edge_features/*``,
  ``<id>/target_values/*`` with ``_name``/``_chain_id``/``_index`` metadata.

``h5py`` loads inside the functions that read or write files, so a graph is
built and mapped to a grid on a machine without it; the writers take a
``utils/store.py:MemoryStore`` in place of a path.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np

from deeprank2_tpu_torch.domain import edgestorage as Efeat
from deeprank2_tpu_torch.domain import nodestorage as Nfeat
from deeprank2_tpu_torch.domain import targetstorage as targets
from deeprank2_tpu_torch.molstruct.structure import StructureArrays
from deeprank2_tpu_torch.utils.store import MemoryStore, open_store

_log = logging.getLogger(__name__)


@dataclass
class Graph:
    """A featured geometric graph over a structure.

    Attributes:
        id: entry name (query id).
        node_type: ``"atom"`` or ``"residue"``.
        arrays: the backing structure table.
        node_indices: int64 [V] indices into ``arrays`` (atom or residue indices).
        edge_index: int64 [E, 2] pairs of *node* positions (undirected, i<j,
            lexicographically sorted).
        node_features: name -> float64 [V] or [V, K].
        edge_features: name -> float64 [E] or [E, K].
        targets: target name -> scalar.
        center: [3] grid-mapping center.
    """

    id: str
    node_type: str
    arrays: StructureArrays
    node_indices: np.ndarray
    edge_index: np.ndarray
    # CSR of the atoms belonging to each node. For atom graphs each node owns
    # exactly its own atom. For residue graphs this may be a *subset* of the
    # residue's atoms: PPI graphs only carry interface contact atoms per residue
    # (reference parity: buildgraph.py:95-116 builds the contact structure from
    # contact-atom rows only), which restricts edge-energy sums and centers.
    node_atom_indices: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    node_atom_start: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    node_atom_count: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    node_features: dict[str, np.ndarray] = field(default_factory=dict)
    edge_features: dict[str, np.ndarray] = field(default_factory=dict)
    targets: dict[str, float] = field(default_factory=dict)
    center: np.ndarray = field(default_factory=lambda: np.zeros(3))

    @property
    def num_nodes(self) -> int:
        return int(self.node_indices.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[0])

    @property
    def nodes(self) -> list[Node]:
        """Per-node views (reference-style access; columns stay the storage)."""
        return [Node(self, v) for v in range(self.num_nodes)]

    @property
    def edges(self) -> list[Edge]:
        """Per-edge views (reference-style access; columns stay the storage)."""
        return [Edge(self, e) for e in range(self.num_edges)]

    # ------------------------------------------------------------------
    # Reference-style per-node/per-edge access & mutation
    # (reference: utils/graph.py:109-122 — the migration surface for user
    # code written against the reference's dict-of-objects Graph; the
    # vectorized pipeline itself never calls these)
    # ------------------------------------------------------------------
    def get_node(self, id_) -> Node:
        """Node view for an :class:`Atom`/:class:`Residue` (KeyError if absent)."""
        if isinstance(id_, Node):
            return id_
        backing = getattr(id_, "_arrays", None)
        if backing is self.arrays:
            hits = np.flatnonzero(self.node_indices == id_.index)
            if hits.size:
                return Node(self, int(hits[0]))
            raise KeyError(id_)
        # views into a different (equal) structure: match by identity semantics
        for v in range(self.num_nodes):
            node = Node(self, v)
            if node.id == id_:
                return node
        raise KeyError(id_)

    def get_edge(self, id_) -> Edge:
        """Edge view for a :class:`Contact` (unordered; KeyError if absent)."""
        if isinstance(id_, Edge):
            return id_
        i = self.get_node(id_.item1).index
        j = self.get_node(id_.item2).index
        lo, hi = (i, j) if i <= j else (j, i)
        hits = np.flatnonzero((self.edge_index[:, 0] == lo) & (self.edge_index[:, 1] == hi))
        if hits.size:
            return Edge(self, int(hits[0]))
        raise KeyError(id_)

    def add_node(self, node) -> Node:
        """Append a node for an :class:`Atom`/:class:`Residue` view (idempotent,
        like the reference's dict insert). Existing feature columns get a zero
        row; residue nodes own the residue's full atom set."""
        id_ = node.id if isinstance(node, Node) else node
        try:
            return self.get_node(id_)
        except KeyError:
            pass
        if getattr(id_, "_arrays", None) is not self.arrays:
            msg = "can only add nodes backed by this graph's structure arrays"
            raise ValueError(msg)
        self.node_indices = np.append(self.node_indices, np.int64(id_.index))
        if self.node_type == "atom":
            atoms = np.array([id_.index], dtype=np.int64)
        else:
            start = int(self.arrays.res_atom_start[id_.index])
            count = int(self.arrays.res_atom_count[id_.index])
            atoms = np.arange(start, start + count, dtype=np.int64)
        self.node_atom_start = np.append(self.node_atom_start, np.int64(self.node_atom_indices.shape[0]))
        self.node_atom_count = np.append(self.node_atom_count, np.int64(atoms.shape[0]))
        self.node_atom_indices = np.concatenate([self.node_atom_indices, atoms])
        for name, col in self.node_features.items():
            pad = np.zeros((1,) + col.shape[1:], dtype=col.dtype)
            self.node_features[name] = np.concatenate([col, pad])
        return Node(self, self.num_nodes - 1)

    def add_edge(self, edge) -> Edge:
        """Append an edge for a :class:`Contact` whose endpoints are already
        nodes (idempotent). Existing edge-feature columns get a zero row."""
        id_ = edge.id if isinstance(edge, Edge) else edge
        try:
            return self.get_edge(id_)
        except KeyError:
            pass
        i = self.get_node(id_.item1).index
        j = self.get_node(id_.item2).index
        lo, hi = (i, j) if i <= j else (j, i)
        self.edge_index = np.concatenate([self.edge_index, np.array([[lo, hi]], dtype=np.int64)])
        for name, col in self.edge_features.items():
            pad = np.zeros((1,) + col.shape[1:], dtype=col.dtype)
            self.edge_features[name] = np.concatenate([col, pad])
        return Edge(self, self.num_edges - 1)

    # ------------------------------------------------------------------
    # Derived node-level columns
    # ------------------------------------------------------------------
    @property
    def node_residue_indices(self) -> np.ndarray:
        """int [V] residue index per node (identity for residue graphs)."""
        if self.node_type == "residue":
            return self.node_indices
        return self.arrays.atom_residue[self.node_indices]

    @property
    def node_chain_indices(self) -> np.ndarray:
        return self.arrays.res_chain[self.node_residue_indices]

    def positions(self) -> np.ndarray:
        """float64 [V, 3] node positions (atom position / residue center).

        Residue centers follow reference semantics (molstruct/residue.py:97-117):
        CB position, else CA, else mean — over the node's atom subset.
        """
        if self.node_type == "atom":
            return self.arrays.positions[self.node_indices]
        sa = self.arrays
        out = np.zeros((self.num_nodes, 3), dtype=np.float64)
        for v in range(self.num_nodes):
            start = int(self.node_atom_start[v])
            count = int(self.node_atom_count[v])
            atoms = self.node_atom_indices[start : start + count]
            names = sa.atom_names[atoms]
            placed = False
            for target in ("CB", "CA"):
                hits = np.flatnonzero(names == target)
                if hits.size:
                    out[v] = sa.positions[atoms[int(hits[0])]]
                    placed = True
                    break
            if not placed:
                out[v] = sa.positions[atoms].mean(axis=0)
        return out

    def node_names(self) -> list[str]:
        """Human-readable node ids, identical to the reference's ``str(node.id)``."""
        sa = self.arrays
        names = []
        if self.node_type == "atom":
            for a in self.node_indices:
                r = sa.atom_residue[a]
                names.append(f"{sa.id} {sa.chain_ids[sa.res_chain[r]]} {_number_string(sa, r)} {sa.atom_names[a]}")
        else:
            for r in self.node_indices:
                names.append(f"{sa.id} {sa.chain_ids[sa.res_chain[r]]} {_number_string(sa, r)}")
        return names

    def node_chain_ids(self) -> list[str]:
        sa = self.arrays
        return [sa.chain_ids[c] for c in self.node_chain_indices]

    def get_all_chains(self) -> list[str]:
        return sorted(set(self.node_chain_ids()))

    def has_nan(self) -> bool:
        """Whether any feature value is NaN."""
        for data in self.node_features.values():
            if np.any(np.isnan(data)):
                return True
        return any(np.any(np.isnan(data)) for data in self.edge_features.values())

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @staticmethod
    def build_graph(
        arrays: StructureArrays,
        node_indices: np.ndarray,
        node_type: str,
        graph_id: str,
        max_edge_length: float,
        atom_subset: np.ndarray | None = None,
    ) -> Graph:
        """Build the geometric graph over the given atoms or residues.

        Args:
            arrays: backing structure.
            node_indices: candidate atom indices (``node_type="atom"``) or
                residue indices (``node_type="residue"``).
            node_type: "atom" or "residue".
            graph_id: entry name.
            max_edge_length: max distance (Å) between nodes to create an edge.
            atom_subset: for residue graphs, restrict each residue to these
                atoms (e.g. interface contact atoms for PPI queries). Defaults
                to all atoms of each residue.

        Returns:
            Graph with nodes ordered by first appearance in the sorted edge
            list (reference parity; see module docstring).
        """
        from scipy.spatial import cKDTree

        node_indices = np.asarray(sorted(set(int(i) for i in node_indices)), dtype=np.int64)

        if node_type == "atom":
            atom_indices = node_indices
            owner = np.arange(len(node_indices))  # atom -> candidate-node position
        elif node_type == "residue":
            if atom_subset is not None:
                atom_indices = np.asarray(sorted(set(int(a) for a in atom_subset)), dtype=np.int64)
                res_pos = {int(r): i for i, r in enumerate(node_indices)}
                owner = np.array([res_pos[int(arrays.atom_residue[a])] for a in atom_indices], dtype=np.int64)
            else:
                atom_indices = np.concatenate(
                    [
                        np.arange(
                            arrays.res_atom_start[r],
                            arrays.res_atom_start[r] + arrays.res_atom_count[r],
                        )
                        for r in node_indices
                    ]
                ).astype(np.int64)
                owner = np.repeat(np.arange(len(node_indices)), arrays.res_atom_count[node_indices])
        else:
            msg = f"Unknown node_type: {node_type}"
            raise TypeError(msg)

        positions = arrays.positions[atom_indices]
        tree = cKDTree(positions)
        pairs = tree.query_pairs(max_edge_length, output_type="ndarray")  # i<j atom-pair positions

        if node_type == "residue":
            pairs = owner[pairs]
            pairs = pairs[pairs[:, 0] != pairs[:, 1]]
            pairs = np.sort(pairs, axis=1)
            pairs = np.unique(pairs, axis=0)
        else:
            pairs = np.unique(np.sort(pairs, axis=1), axis=0)

        # node order = first appearance scanning sorted (i, j) pairs
        seen: dict[int, int] = {}
        for v in pairs.reshape(-1):
            if int(v) not in seen:
                seen[int(v)] = len(seen)
        kept = np.fromiter(seen.keys(), dtype=np.int64, count=len(seen))
        remap = np.full(len(node_indices), -1, dtype=np.int64)
        remap[kept] = np.arange(len(kept))

        # per-node atom CSR (in kept-node order)
        if node_type == "atom":
            kept_atoms = node_indices[kept]
            node_atom_indices = kept_atoms
            node_atom_count = np.ones(len(kept), dtype=np.int64)
            node_atom_start = np.arange(len(kept), dtype=np.int64)
        else:
            atoms_by_node: list[list[int]] = [[] for _ in range(len(kept))]
            for pos, a in zip(owner, atom_indices):
                new_pos = remap[pos]
                if new_pos >= 0:
                    atoms_by_node[new_pos].append(int(a))
            node_atom_count = np.array([len(x) for x in atoms_by_node], dtype=np.int64)
            node_atom_start = np.concatenate([[0], np.cumsum(node_atom_count[:-1])]).astype(np.int64) if len(kept) else np.zeros(0, dtype=np.int64)
            node_atom_indices = np.array([a for x in atoms_by_node for a in x], dtype=np.int64)

        graph = Graph(
            id=graph_id,
            node_type=node_type,
            arrays=arrays,
            node_indices=node_indices[kept],
            edge_index=remap[pairs] if len(pairs) else np.zeros((0, 2), dtype=np.int64),
            node_atom_indices=node_atom_indices,
            node_atom_start=node_atom_start,
            node_atom_count=node_atom_count,
        )
        graph.node_features[Nfeat.POSITION] = graph.positions()
        return graph

    # ------------------------------------------------------------------
    # HDF5 serialization (reference-compatible layout)
    # ------------------------------------------------------------------
    def write_to_hdf5(self, hdf5_path: str) -> None:
        """Write the featured graph to HDF5 in the deeprank layout (or into
        a ``utils/store.py:MemoryStore``)."""
        with open_store(hdf5_path, "a") as hdf5_file:
            graph_group = hdf5_file.require_group(self.id)
            node_group = graph_group.create_group(Nfeat.NODE)
            edge_group = graph_group.create_group(Efeat.EDGE)

            names = np.array(self.node_names()).astype("S")
            node_group.create_dataset(Nfeat.NAME, data=names)
            chain_ids = np.array(self.node_chain_ids()).astype("S")
            node_group.create_dataset(Nfeat.CHAINID, data=chain_ids)

            for feature_name, data in self.node_features.items():
                node_group.create_dataset(feature_name, data=data)

            node_name_strs = self.node_names()
            edge_names = [f"{node_name_strs[i]}-{node_name_strs[j]}" for i, j in self.edge_index]
            edge_group.create_dataset(Efeat.NAME, data=np.array(edge_names).astype("S"))
            edge_group.create_dataset(Efeat.INDEX, data=self.edge_index)

            for feature_name, data in self.edge_features.items():
                edge_group.create_dataset(feature_name, data=data)

            score_group = graph_group.create_group(targets.VALUES)
            for target_name, target_data in self.targets.items():
                score_group.create_dataset(target_name, data=target_data)

    # ------------------------------------------------------------------
    # Grid mapping
    # ------------------------------------------------------------------
    def map_to_grid(self, grid, method, augmentation=None) -> None:
        """Accumulate all node and edge features onto a 3D grid.

        Every channel is mapped in ONE pass over the node positions: the grid
        kernel depends only on the source position, and each edge contributes
        its value at both endpoint positions (reference semantics,
        graph.py:161-208) — so edge channels are first scatter-summed onto
        their endpoint nodes and then share the nodes' kernel matrix. This
        turns the reference's per-point x per-feature hot loop into a single
        [V, G] kernel evaluation + one matmul.
        """
        from deeprank2_tpu_torch.utils.grid import rotate_points

        def channel_matrix(features: dict[str, np.ndarray]) -> tuple[list[str], np.ndarray]:
            names: list[str] = []
            columns: list[np.ndarray] = []
            for feature_name, values in features.items():
                values = np.asarray(values, dtype=np.float64)
                if values.ndim == 1:
                    names.append(feature_name)
                    columns.append(values[:, None])
                else:
                    names.extend(f"{feature_name}_{k:03d}" for k in range(values.shape[1]))
                    columns.append(values)
            return names, (np.concatenate(columns, axis=1) if columns else np.zeros((0, 0)))

        names: list[str] = []
        columns: list[np.ndarray] = []
        if self.num_edges and self.edge_features:
            e_names, e_matrix = channel_matrix(self.edge_features)
            node_acc = np.zeros((self.num_nodes, e_matrix.shape[1]))
            np.add.at(node_acc, self.edge_index[:, 0], e_matrix)
            np.add.at(node_acc, self.edge_index[:, 1], e_matrix)
            names += e_names
            columns.append(node_acc)
        if self.node_features:
            n_names, n_matrix = channel_matrix(self.node_features)
            names += n_names
            columns.append(n_matrix)
        if not names:
            return

        positions = self.positions()
        if augmentation is not None:
            positions = rotate_points(positions, augmentation.axis, augmentation.angle, self.center)
        grid.map_channels_batch(positions, names, np.concatenate(columns, axis=1), method)

    @staticmethod
    def _find_unused_augmentation_name(unaugmented_id: str, hdf5_path: str) -> str:
        prefix = f"{unaugmented_id}_"
        taken: list[str] = []
        if isinstance(hdf5_path, MemoryStore) or os.path.isfile(hdf5_path):
            with open_store(hdf5_path) as hdf5_file:
                taken = [name for name in hdf5_file if name.startswith(prefix)]
        count = 0
        while f"{prefix}{count:03}" in taken:
            count += 1
        return f"{prefix}{count:03}"

    def write_as_grid_to_hdf5(self, hdf5_path: str, settings, method, augmentation=None) -> str:
        """Map to a grid and store it (``<id>/grid_points``, ``<id>/mapped_features``)."""
        from deeprank2_tpu_torch.utils.grid import Grid

        id_ = self.id
        if augmentation is not None:
            id_ = self._find_unused_augmentation_name(id_, hdf5_path)

        grid = Grid(id_, list(self.center), settings)
        self.map_to_grid(grid, method, augmentation)
        grid.to_hdf5(hdf5_path)

        with open_store(hdf5_path, "a") as hdf5_file:
            grp = hdf5_file[id_]
            targets_group = grp.require_group(targets.VALUES)
            for target_name, target_data in self.targets.items():
                if target_name not in targets_group:
                    targets_group.create_dataset(target_name, data=target_data)
                else:
                    targets_group[target_name][()] = target_data

        return hdf5_path


class Node:
    """Read view of one node of a :class:`Graph` (reference: utils/graph.py:53-91).

    The array-first Graph stores features column-wise; this view exposes the
    reference's per-node surface (``id``, ``type``, ``features``, ``position``)
    for user code and migration. Rows of multi-column features are numpy views,
    so in-place writes propagate back into the graph's columns (scalar features
    come back as numpy scalars — write those via the column).
    """

    __slots__ = ("graph", "index")

    def __init__(self, graph: Graph, index: int):
        self.graph = graph
        self.index = int(index)

    @property
    def id(self):
        """The backing :class:`Atom` or :class:`Residue` view."""
        sa = self.graph.arrays
        if self.graph.node_type == "atom":
            return sa.atom_view(int(self.graph.node_indices[self.index]))
        return sa.residue_view(int(self.graph.node_indices[self.index]))

    @property
    def type(self) -> str:
        """``"atom"`` or ``"residue"``."""
        return self.graph.node_type

    @property
    def features(self) -> dict[str, np.ndarray]:
        return {name: data[self.index] for name, data in self.graph.node_features.items()}

    @property
    def position(self) -> np.ndarray:
        return np.asarray(self.graph.node_features[Nfeat.POSITION][self.index])

    def add_feature(self, feature_name: str, feature_function) -> None:
        """Evaluate ``feature_function(self.id)`` and store the 1-D result
        (reference: utils/graph.py:75-88). Writes land in the graph's column
        storage; a new column is zero-initialized for the other nodes."""
        value = np.asarray(feature_function(self.id), dtype=np.float64)
        if value.ndim != 1:
            shape_s = "x".join(str(s) for s in value.shape)
            msg = f"Expected a 1-dimensional array for feature {feature_name}, but got {shape_s}"
            raise ValueError(msg)
        col = self.graph.node_features.get(feature_name)
        if col is None:
            shape = (self.graph.num_nodes,) if value.size == 1 else (self.graph.num_nodes, value.size)
            col = np.zeros(shape, dtype=np.float64)
            self.graph.node_features[feature_name] = col
        width = 1 if col.ndim == 1 else col.shape[1]
        if value.size != width:
            msg = f"feature {feature_name} has width {width}, got a length-{value.size} value"
            raise ValueError(msg)
        col[self.index] = value[0] if col.ndim == 1 else value

    def has_nan(self) -> bool:
        return any(np.any(np.isnan(v)) for v in self.features.values())

    def __repr__(self) -> str:
        return f"Node({self.id!r})"


class Edge:
    """Read view of one edge of a :class:`Graph` (reference: utils/graph.py:28-51)."""

    __slots__ = ("graph", "index")

    def __init__(self, graph: Graph, index: int):
        self.graph = graph
        self.index = int(index)

    @property
    def id(self):
        """An :class:`AtomicContact` / :class:`ResidueContact` over the node views."""
        from deeprank2_tpu_torch.molstruct.pair import AtomicContact, ResidueContact

        i, j = self.graph.edge_index[self.index]
        node_i, node_j = Node(self.graph, int(i)).id, Node(self.graph, int(j)).id
        cls = AtomicContact if self.graph.node_type == "atom" else ResidueContact
        return cls(node_i, node_j)

    @property
    def features(self) -> dict[str, np.ndarray]:
        return {name: data[self.index] for name, data in self.graph.edge_features.items()}

    @property
    def position1(self) -> np.ndarray:
        return np.asarray(self.graph.node_features[Nfeat.POSITION][int(self.graph.edge_index[self.index, 0])])

    @property
    def position2(self) -> np.ndarray:
        return np.asarray(self.graph.node_features[Nfeat.POSITION][int(self.graph.edge_index[self.index, 1])])

    def add_feature(self, feature_name: str, feature_function) -> None:
        """Evaluate ``feature_function(self.id)`` and store it (reference:
        utils/graph.py:35-39 — edge features are scalars there; length-K
        arrays get a [E, K] column here)."""
        value = np.asarray(feature_function(self.id), dtype=np.float64).reshape(-1)
        col = self.graph.edge_features.get(feature_name)
        if col is None:
            shape = (self.graph.num_edges,) if value.size == 1 else (self.graph.num_edges, value.size)
            col = np.zeros(shape, dtype=np.float64)
            self.graph.edge_features[feature_name] = col
        width = 1 if col.ndim == 1 else col.shape[1]
        if value.size != width:
            msg = f"feature {feature_name} has width {width}, got a length-{value.size} value"
            raise ValueError(msg)
        col[self.index] = value[0] if col.ndim == 1 else value

    def has_nan(self) -> bool:
        return any(np.any(np.isnan(v)) for v in self.features.values())

    def __repr__(self) -> str:
        return f"Edge({self.id!r})"


def _number_string(sa: StructureArrays, residue_index: int) -> str:
    icode = sa.res_icodes[residue_index]
    number = sa.res_numbers[residue_index]
    return f"{number}{icode}" if icode is not None else str(number)
