"""Node features from atom/residue identity (reference: deeprank2/features/components.py).

Atom graphs get: element one-hot, PDB occupancy, forcefield atomic charge.
All graphs get residue-level features: residue-type one-hot, charge, polarity
one-hot, size, mass, pI, H-bond donor/acceptor counts; plus variant difference
features for single-residue-variant queries.
"""

from __future__ import annotations

import numpy as np

from deeprank2_tpu_torch.domain import nodestorage as Nfeat
from deeprank2_tpu_torch.molstruct.aminoacid import (
    AA_CHARGE,
    AA_HB_ACCEPTORS,
    AA_HB_DONORS,
    AA_MASS,
    AA_PI,
    AA_SIZE,
    aa_onehot,
    polarity_onehot,
)
from deeprank2_tpu_torch.molstruct.structure import element_onehot
from deeprank2_tpu_torch.utils.graph import Graph


def add_features(
    pdb_path: str,  # noqa: ARG001 (plugin contract)
    graph: Graph,
    single_amino_acid_variant=None,
) -> None:  # noqa: D103
    sa = graph.arrays
    res_idx = graph.node_residue_indices
    aa_ids = sa.res_aa_ids[res_idx]
    if np.any(aa_ids < 0):
        bad = res_idx[aa_ids < 0][0]
        msg = f"Node residue {sa.res_numbers[bad]} has no amino acid type; cannot compute component features."
        raise ValueError(msg)

    if graph.node_type == "atom":
        from deeprank2_tpu_torch.utils.parsing import forcefield as ff

        atoms = graph.node_indices
        graph.node_features[Nfeat.ATOMTYPE] = element_onehot(sa.elements[atoms])
        graph.node_features[Nfeat.PDBOCCUPANCY] = sa.occupancies[atoms].astype(np.float64)
        charges = ff.atomic_forcefield.assign(sa)["charge"]
        graph.node_features[Nfeat.ATOMCHARGE] = charges[atoms]

    graph.node_features[Nfeat.RESTYPE] = aa_onehot(aa_ids)
    graph.node_features[Nfeat.RESCHARGE] = AA_CHARGE[aa_ids]
    graph.node_features[Nfeat.POLARITY] = polarity_onehot(aa_ids)
    graph.node_features[Nfeat.RESSIZE] = AA_SIZE[aa_ids]
    graph.node_features[Nfeat.RESMASS] = AA_MASS[aa_ids]
    graph.node_features[Nfeat.RESPI] = AA_PI[aa_ids]
    graph.node_features[Nfeat.HBDONORS] = AA_HB_DONORS[aa_ids]
    graph.node_features[Nfeat.HBACCEPTORS] = AA_HB_ACCEPTORS[aa_ids]

    if single_amino_acid_variant is not None:
        wildtype = single_amino_acid_variant.wildtype_amino_acid
        variant = single_amino_acid_variant.variant_amino_acid
        variant_res_index = single_amino_acid_variant.residue.index

        is_variant = res_idx == variant_res_index  # [V] bool
        n = graph.num_nodes

        variantres = aa_onehot(aa_ids)
        variantres[is_variant] = variant.onehot
        graph.node_features[Nfeat.VARIANTRES] = variantres

        graph.node_features[Nfeat.DIFFCHARGE] = np.where(is_variant, variant.charge - wildtype.charge, 0.0)
        diffpol = np.zeros((n, 4), dtype=np.float64)
        diffpol[is_variant] = variant.polarity.onehot - wildtype.polarity.onehot
        graph.node_features[Nfeat.DIFFPOLARITY] = diffpol
        graph.node_features[Nfeat.DIFFSIZE] = np.where(is_variant, float(variant.size - wildtype.size), 0.0)
        graph.node_features[Nfeat.DIFFMASS] = np.where(is_variant, variant.mass - wildtype.mass, 0.0)
        graph.node_features[Nfeat.DIFFPI] = np.where(is_variant, variant.pI - wildtype.pI, 0.0)
        graph.node_features[Nfeat.DIFFHBDONORS] = np.where(
            is_variant, float(variant.hydrogen_bond_donors - wildtype.hydrogen_bond_donors), 0.0
        )
        graph.node_features[Nfeat.DIFFHBACCEPTORS] = np.where(
            is_variant, float(variant.hydrogen_bond_acceptors - wildtype.hydrogen_bond_acceptors), 0.0
        )
