"""SASA and buried surface area node features (reference: features/surfacearea.py).

- ``sasa``: solvent-accessible surface area of the node (atom area, or summed
  residue-atom areas) computed on the *full* PDB structure.
- ``bsa``: buried surface area = per-chain monomer area - complex area, where
  both are computed over only the atoms present in the graph (reference parity:
  add_bsa builds its freesasa structures from graph-node atoms,
  surfacearea.py:41-123).

Backed by the in-repo Shrake-Rupley kernel (utils/sasa.py) instead of the
freesasa C library.
"""

from __future__ import annotations

import numpy as np

from deeprank2_tpu_torch.domain import nodestorage as Nfeat
from deeprank2_tpu_torch.utils.graph import Graph
from deeprank2_tpu_torch.utils.sasa import atom_radii, shrake_rupley


def _node_area_sums(graph: Graph, per_atom_areas: np.ndarray) -> np.ndarray:
    """Sum per-atom areas over each node's atom subset."""
    sums = np.zeros(graph.num_nodes, dtype=np.float64)
    for v in range(graph.num_nodes):
        start = int(graph.node_atom_start[v])
        count = int(graph.node_atom_count[v])
        atoms = graph.node_atom_indices[start : start + count]
        sums[v] = per_atom_areas[atoms].sum()
    return sums


def add_sasa(pdb_path: str, graph: Graph) -> None:  # noqa: ARG001 (structure already parsed)
    """SASA on the full structure; per-node atom or residue-sum areas.

    For residue nodes the area covers the *whole* residue (all its atoms in
    the structure), matching freesasa's ``resi`` selection in the reference.
    """
    sa = graph.arrays
    # full structure occludes, but only the graph's atoms are read: a compute
    # mask drops most of the per-atom point loops (values identical)
    mask = np.zeros(sa.num_atoms, dtype=bool)
    if graph.node_type == "atom":
        mask[graph.node_indices] = True
    else:
        for r in graph.node_indices:
            start = int(sa.res_atom_start[r])
            mask[start : start + int(sa.res_atom_count[r])] = True
    areas = shrake_rupley(sa.positions, atom_radii(np.asarray(sa.elements)), compute_mask=mask)

    if graph.node_type == "atom":
        values = areas[graph.node_indices]
    else:
        values = np.zeros(graph.num_nodes, dtype=np.float64)
        for v, r in enumerate(graph.node_indices):
            start = int(sa.res_atom_start[r])
            count = int(sa.res_atom_count[r])
            values[v] = areas[start : start + count].sum()

    if np.any(np.isnan(values)):
        msg = "SASA computation returned NaN"
        raise ValueError(msg)
    graph.node_features[Nfeat.SASA] = values


def add_bsa(graph: Graph) -> None:
    """BSA = monomer SASA - complex SASA over the graph's atom subset."""
    sa = graph.arrays
    graph_atoms = np.unique(graph.node_atom_indices)
    radii_full = atom_radii(np.asarray(sa.elements))

    # complex: all graph atoms together
    mask_complex = np.zeros(sa.num_atoms, dtype=bool)
    mask_complex[graph_atoms] = True
    complex_areas = shrake_rupley(sa.positions, np.where(mask_complex, radii_full, 0.0))

    # monomers: graph atoms of each chain alone
    atom_chain = sa.atom_chain
    monomer_areas = np.zeros(sa.num_atoms, dtype=np.float64)
    for chain_index in np.unique(atom_chain[graph_atoms]):
        mask = mask_complex & (atom_chain == chain_index)
        chain_areas = shrake_rupley(sa.positions, np.where(mask, radii_full, 0.0))
        monomer_areas[mask] = chain_areas[mask]

    bsa_atoms = monomer_areas - complex_areas
    graph.node_features[Nfeat.BSA] = _node_area_sums(graph, bsa_atoms)


def add_features(
    pdb_path: str,
    graph: Graph,
    single_amino_acid_variant=None,  # noqa: ARG001
) -> None:
    """Calculates the Buried Surface Area (BSA) and the Solvent Accessible Surface Area (SASA)."""
    add_bsa(graph)
    add_sasa(pdb_path, graph)
