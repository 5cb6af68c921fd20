"""PSSM conservation node features (reference: deeprank2/features/conservation.py).

Each node gets the 20-dim PSSM profile of its residue (columns ordered by
three-letter amino-acid code) and the information content; SRV queries also get
wildtype conservation and variant-wildtype difference on the variant node.
"""

from __future__ import annotations

import numpy as np

from deeprank2_tpu_torch.domain import nodestorage as Nfeat
from deeprank2_tpu_torch.utils.graph import Graph
from deeprank2_tpu_torch.utils.parsing.pssm import pssm_profile_matrix


def add_features(
    pdb_path: str,  # noqa: ARG001 (plugin contract)
    graph: Graph,
    single_amino_acid_variant=None,
) -> None:  # noqa: D103
    sa = graph.arrays
    res_idx = graph.node_residue_indices
    n = graph.num_nodes

    profiles = np.zeros((n, 20), dtype=np.float64)
    infocontent = np.zeros(n, dtype=np.float64)

    # per-chain vectorized lookup
    for chain_index, chain_id in enumerate(sa.chain_ids):
        sel = np.flatnonzero(sa.res_chain[res_idx] == chain_index)
        if sel.size == 0:
            continue
        table = sa.pssms.get(chain_id)
        if table is None:
            msg = f"No pssm file found for Chain {sa.id} {chain_id}."
            raise FileNotFoundError(msg)
        rows = res_idx[sel]
        prof, ic, found = pssm_profile_matrix(table, sa.res_numbers[rows], sa.res_icodes[rows])
        if not found.all():
            missing = rows[~found][0]
            msg = f"Residue {chain_id} {sa.res_numbers[missing]} not found in PSSM table"
            raise KeyError(msg)
        profiles[sel] = prof
        infocontent[sel] = ic

    graph.node_features[Nfeat.PSSM] = profiles
    graph.node_features[Nfeat.INFOCONTENT] = infocontent

    if single_amino_acid_variant is not None:
        variant_res_index = single_amino_acid_variant.residue.index
        is_variant = res_idx == variant_res_index

        conservation = np.zeros(n, dtype=np.float64)
        diff_conservation = np.zeros(n, dtype=np.float64)
        if is_variant.any():
            row = single_amino_acid_variant.residue.get_pssm()
            wt = row.get_conservation(single_amino_acid_variant.wildtype_amino_acid)
            var = row.get_conservation(single_amino_acid_variant.variant_amino_acid)
            conservation[is_variant] = wt
            diff_conservation[is_variant] = var - wt

        graph.node_features[Nfeat.CONSERVATION] = conservation
        graph.node_features[Nfeat.DIFFCONSERVATION] = diff_conservation
