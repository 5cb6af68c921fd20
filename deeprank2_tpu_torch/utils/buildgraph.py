"""Structure loading and neighborhood/contact search over ``StructureArrays``.

Replaces the reference's pdb2sql-backed helpers (deeprank2/utils/buildgraph.py)
with KD-tree searches over the position arrays.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from deeprank2_tpu_torch.io.pdb import parse_pdb
from deeprank2_tpu_torch.molstruct.structure import StructureArrays


def get_structure(pdb_path: str, id_: str | None = None) -> StructureArrays:
    """Parse a PDB file into a structure table (reference: buildgraph.py:80)."""
    return parse_pdb(pdb_path, id_)


def get_contact_atoms(
    arrays: StructureArrays,
    chain_ids: list[str],
    influence_radius: float,
) -> np.ndarray:
    """Atom indices at the interface between two chains.

    An atom of either chain is a contact atom when it lies within
    ``influence_radius`` of any atom of the other chain
    (reference: buildgraph.py:95-116 via pdb2sql.interface.get_contact_atoms).

    Returns:
        int64 array of atom indices (chain-1 contacts first, then chain 2,
        each in file order — matching the reference's ordering).
    """
    chain_idx = {cid: arrays.chain_ids.index(cid) for cid in chain_ids}
    atom_chain = arrays.atom_chain
    sel1 = np.flatnonzero(atom_chain == chain_idx[chain_ids[0]])
    sel2 = np.flatnonzero(atom_chain == chain_idx[chain_ids[1]])
    if sel1.size == 0 or sel2.size == 0:
        return np.zeros(0, dtype=np.int64)

    tree1 = cKDTree(arrays.positions[sel1])
    tree2 = cKDTree(arrays.positions[sel2])

    d1, _ = tree2.query(arrays.positions[sel1], k=1, distance_upper_bound=influence_radius)
    d2, _ = tree1.query(arrays.positions[sel2], k=1, distance_upper_bound=influence_radius)

    contacts1 = sel1[np.isfinite(d1) & (d1 <= influence_radius)]
    contacts2 = sel2[np.isfinite(d2) & (d2 <= influence_radius)]
    return np.concatenate([contacts1, contacts2]).astype(np.int64)


def get_surrounding_residues(
    arrays: StructureArrays,
    residue_index: int,
    radius: float,
) -> np.ndarray:
    """Residue indices with any atom within ``radius`` of the given residue's atoms.

    (reference: buildgraph.py:176-206; includes the residue itself.)
    """
    start = int(arrays.res_atom_start[residue_index])
    count = int(arrays.res_atom_count[residue_index])
    center_positions = arrays.positions[start : start + count]

    tree = cKDTree(center_positions)
    d, _ = tree.query(arrays.positions, k=1, distance_upper_bound=radius)
    near_atoms = np.isfinite(d) & (d < radius)
    return np.unique(arrays.atom_residue[near_atoms]).astype(np.int64)


def get_residue_contact_pairs(
    arrays: StructureArrays,
    chain_id1: str,
    chain_id2: str,
    influence_radius: float,
) -> np.ndarray:
    """Unique residue-index pairs (one per chain) within ``influence_radius``.

    (reference: buildgraph.py:119-158.)

    Returns:
        int64 [P, 2] array of (chain-1 residue index, chain-2 residue index).
    """
    chain_idx1 = arrays.chain_ids.index(chain_id1)
    chain_idx2 = arrays.chain_ids.index(chain_id2)
    atom_chain = arrays.atom_chain
    sel1 = np.flatnonzero(atom_chain == chain_idx1)
    sel2 = np.flatnonzero(atom_chain == chain_idx2)
    if sel1.size == 0 or sel2.size == 0:
        return np.zeros((0, 2), dtype=np.int64)

    tree1 = cKDTree(arrays.positions[sel1])
    tree2 = cKDTree(arrays.positions[sel2])
    pairs = tree1.query_ball_tree(tree2, influence_radius)

    res_pairs = set()
    for i, neighbors in enumerate(pairs):
        r1 = int(arrays.atom_residue[sel1[i]])
        for j in neighbors:
            res_pairs.add((r1, int(arrays.atom_residue[sel2[j]])))
    if not res_pairs:
        return np.zeros((0, 2), dtype=np.int64)
    return np.array(sorted(res_pairs), dtype=np.int64)
