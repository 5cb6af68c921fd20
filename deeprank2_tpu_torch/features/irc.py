"""Inter-residue contact (IRC) node features for PPI queries
(reference: features/irc.py).

Counts, per interface residue, the 5.5 Å cross-chain residue contacts in total
and split by the 10 unordered polarity pairs. SRV queries skip this module
(reference parity: irc.py:104).
"""

from __future__ import annotations

import logging
from itertools import combinations_with_replacement

import numpy as np

from deeprank2_tpu_torch.domain import nodestorage as Nfeat
from deeprank2_tpu_torch.molstruct.aminoacid import AA_POLARITY, Polarity
from deeprank2_tpu_torch.utils.buildgraph import get_residue_contact_pairs
from deeprank2_tpu_torch.utils.graph import Graph

_log = logging.getLogger(__name__)
SAFE_MIN_CONTACTS = 5
CUTOFF = 5.5

POLARITY_PAIRS = list(combinations_with_replacement(Polarity, 2))
POLARITY_PAIR_NAMES = [f"irc_{a.name.lower()}_{b.name.lower()}" for a, b in POLARITY_PAIRS]


def get_IRCs(arrays, chains: list[str], cutoff: float = CUTOFF) -> tuple[np.ndarray, np.ndarray]:
    """Contact-density matrices per residue.

    Returns:
        totals: [R] total cross-chain contacts per residue.
        by_polarity: [R, 4] contacts per partner polarity class.
    """
    totals = np.zeros(arrays.num_residues, dtype=np.float64)
    by_polarity = np.zeros((arrays.num_residues, 4), dtype=np.float64)

    pairs = get_residue_contact_pairs(arrays, chains[0], chains[1], cutoff)
    for r1, r2 in pairs:
        aa1 = int(arrays.res_aa_ids[r1])
        aa2 = int(arrays.res_aa_ids[r2])
        if aa1 < 0 or aa2 < 0:
            continue  # skip non-amino-acid residues
        totals[r1] += 1
        totals[r2] += 1
        by_polarity[r1, AA_POLARITY[aa2]] += 1
        by_polarity[r2, AA_POLARITY[aa1]] += 1
    return totals, by_polarity


def add_features(
    pdb_path: str,
    graph: Graph,
    single_amino_acid_variant=None,
) -> None:  # noqa: D103
    if single_amino_acid_variant:  # variant queries do not use this feature
        return

    chains = graph.get_all_chains()
    totals, by_polarity = get_IRCs(graph.arrays, chains)

    res_idx = graph.node_residue_indices
    aa_ids = graph.arrays.res_aa_ids[res_idx]

    for name in Nfeat.IRC_FEATURES:
        graph.node_features[name] = np.zeros(graph.num_nodes, dtype=np.float64)

    graph.node_features[Nfeat.IRCTOTAL] = totals[res_idx]
    own_polarity = np.where(aa_ids >= 0, AA_POLARITY[np.maximum(aa_ids, 0)], -1)
    for (pol_a, pol_b), name in zip(POLARITY_PAIRS, POLARITY_PAIR_NAMES):
        values = np.zeros(graph.num_nodes, dtype=np.float64)
        is_a = own_polarity == pol_a.value
        is_b = own_polarity == pol_b.value
        values[is_a] = by_polarity[res_idx[is_a], pol_b.value]
        # for mixed pairs a node of polarity b counts its contacts of polarity a
        values[is_b & ~is_a] = by_polarity[res_idx[is_b & ~is_a], pol_a.value]
        graph.node_features[name] = values

    total_contacts = int((totals[res_idx] > 0).sum())
    if total_contacts < SAFE_MIN_CONTACTS:
        _log.warning(f"Few ({total_contacts}) contacts detected for {pdb_path}.")
