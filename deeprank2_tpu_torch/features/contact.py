"""Edge physics features: distance, Coulomb, Lennard-Jones, covalent/same-chain flags.

Vectorized re-implementation of the reference semantics
(deeprank2/features/contact.py):

- Coulomb: ``q_i q_j * 332.0636 / d`` (no distance cutoff).
- Lennard-Jones 12-6 with arithmetic-mean sigma and geometric-mean epsilon;
  same-chain pairs closer than 4.2 Å use the 1-4 parameter set, same-chain
  pairs closer than 3.6 Å get both energies zeroed (1-2/1-3 bonded exclusion).
- Atomic edges carry the pair values; residue edges carry min distance and
  summed energies over all inter-residue atom pairs.
- ``covalent`` = distance < 2.1 Å and same chain; ``same_chain``/``same_res``
  flags. (The reference computes atomic-edge ``same_chain`` by comparing atom 1's
  chain with itself — always true (contact.py:119); we compare the two atoms'
  chains, which is the intended semantics.)

Instead of the reference's full N x N distance/energy matrices over every atom
touched by any edge, energies are computed only for the per-edge atom pairs
(identical results, O(edge pairs) instead of O(N^2) memory).
"""

from __future__ import annotations

import numpy as np

from deeprank2_tpu_torch.domain import edgestorage as Efeat
from deeprank2_tpu_torch.utils.graph import Graph

covalent_cutoff = 2.1
cutoff_13 = 3.6
cutoff_14 = 4.2
EPSILON0 = 1.0
COULOMB_CONSTANT = 332.0636


def _pair_energies(
    arrays,
    ff_params: dict[str, np.ndarray],
    atoms_i: np.ndarray,
    atoms_j: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(distance, E_elec, E_vdw) for atom index pairs, applying 1-3/1-4 rules."""
    d = np.linalg.norm(arrays.positions[atoms_i] - arrays.positions[atoms_j], axis=1)

    charge = ff_params["charge"]
    e_elec = charge[atoms_i] * charge[atoms_j] * COULOMB_CONSTANT / (EPSILON0 * d)

    sig = 0.5 * (ff_params["sig_main"][atoms_i] + ff_params["sig_main"][atoms_j])
    eps = np.sqrt(ff_params["eps_main"][atoms_i] * ff_params["eps_main"][atoms_j])
    e_vdw = 4.0 * eps * ((sig / d) ** 12 - (sig / d) ** 6)

    sig14 = 0.5 * (ff_params["sig_14"][atoms_i] + ff_params["sig_14"][atoms_j])
    eps14 = np.sqrt(ff_params["eps_14"][atoms_i] * ff_params["eps_14"][atoms_j])
    e_vdw_14 = 4.0 * eps14 * ((sig14 / d) ** 12 - (sig14 / d) ** 6)

    atom_chain = arrays.atom_chain
    same_chain = atom_chain[atoms_i] == atom_chain[atoms_j]
    pair_14 = (d < cutoff_14) & same_chain
    pair_13 = (d < cutoff_13) & same_chain

    e_vdw = np.where(pair_14, e_vdw_14, e_vdw)
    e_vdw = np.where(pair_13, 0.0, e_vdw)
    e_elec = np.where(pair_13, 0.0, e_elec)
    return d, e_elec, e_vdw


def add_features(
    pdb_path: str,  # noqa: ARG001 (plugin contract)
    graph: Graph,
    single_amino_acid_variant=None,  # noqa: ARG001
) -> None:  # noqa: D103
    from deeprank2_tpu_torch.utils.parsing import forcefield as ff

    sa = graph.arrays
    if graph.num_edges == 0:
        for name in (Efeat.SAMECHAIN, Efeat.DISTANCE, Efeat.ELEC, Efeat.VDW, Efeat.COVALENT):
            graph.edge_features[name] = np.zeros(0, dtype=np.float64)
        if graph.node_type == "atom":
            graph.edge_features[Efeat.SAMERES] = np.zeros(0, dtype=np.float64)
        return

    ff_params = ff.atomic_forcefield.assign(sa)
    edge_index = graph.edge_index

    if graph.node_type == "atom":
        atoms_i = graph.node_indices[edge_index[:, 0]]
        atoms_j = graph.node_indices[edge_index[:, 1]]
        d, e_elec, e_vdw = _pair_energies(sa, ff_params, atoms_i, atoms_j)

        same_res = sa.atom_residue[atoms_i] == sa.atom_residue[atoms_j]
        same_chain = sa.atom_chain[atoms_i] == sa.atom_chain[atoms_j]

        graph.edge_features[Efeat.SAMERES] = same_res.astype(np.float64)
        graph.edge_features[Efeat.SAMECHAIN] = same_chain.astype(np.float64)
        graph.edge_features[Efeat.DISTANCE] = d
        graph.edge_features[Efeat.ELEC] = e_elec
        graph.edge_features[Efeat.VDW] = e_vdw

    else:  # residue edges: expand to per-edge atom pairs, then segment-reduce
        # use the graph's per-node atom subset (PPI graphs restrict residues to
        # their contact atoms — reference parity, see utils/graph.py)
        node_i = edge_index[:, 0]
        node_j = edge_index[:, 1]
        count_i = graph.node_atom_count[node_i]
        count_j = graph.node_atom_count[node_j]
        start_i = graph.node_atom_start[node_i]
        start_j = graph.node_atom_start[node_j]

        pairs_per_edge = count_i * count_j
        total = int(pairs_per_edge.sum())
        edge_of_pair = np.repeat(np.arange(graph.num_edges), pairs_per_edge)

        # atom index arrays: for edge e, all (a_i, a_j) in atoms(i) x atoms(j)
        offsets = np.concatenate([[0], np.cumsum(pairs_per_edge)[:-1]])
        local = np.arange(total) - offsets[edge_of_pair]
        a_i = graph.node_atom_indices[start_i[edge_of_pair] + local // count_j[edge_of_pair]]
        a_j = graph.node_atom_indices[start_j[edge_of_pair] + local % count_j[edge_of_pair]]

        d, e_elec, e_vdw = _pair_energies(sa, ff_params, a_i, a_j)

        num_edges = graph.num_edges
        min_d = np.full(num_edges, np.inf)
        np.minimum.at(min_d, edge_of_pair, d)
        sum_elec = np.zeros(num_edges)
        np.add.at(sum_elec, edge_of_pair, e_elec)
        sum_vdw = np.zeros(num_edges)
        np.add.at(sum_vdw, edge_of_pair, e_vdw)

        same_chain = sa.res_chain[graph.node_indices[node_i]] == sa.res_chain[graph.node_indices[node_j]]
        graph.edge_features[Efeat.SAMECHAIN] = same_chain.astype(np.float64)
        graph.edge_features[Efeat.DISTANCE] = min_d
        graph.edge_features[Efeat.ELEC] = sum_elec
        graph.edge_features[Efeat.VDW] = sum_vdw

    graph.edge_features[Efeat.COVALENT] = (
        (graph.edge_features[Efeat.DISTANCE] < covalent_cutoff) & (graph.edge_features[Efeat.SAMECHAIN] > 0)
    ).astype(np.float64)
