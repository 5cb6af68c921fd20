"""Secondary-structure node feature (reference: features/secondary_structure.py).

3-class one-hot per node: HELIX ('GHI'), STRAND ('BE'), COIL (' -STP'),
assigned by the in-repo Kabsch-Sander implementation (utils/secstructure.py)
instead of the external mkdssp binary (so no HEADER/CRYST1 pdb auto-fixing is
needed either).
"""

from __future__ import annotations

from enum import Enum

import numpy as np

from deeprank2_tpu_torch.domain import nodestorage as Nfeat
from deeprank2_tpu_torch.utils.graph import Graph
from deeprank2_tpu_torch.utils.secstructure import assign_secondary_structure


class DSSPError(Exception):
    """Raised if the secondary-structure assignment fails."""


class SecondarySctructure(Enum):  # (sic — reference spelling kept for API parity)
    """A residue's secondary structure type."""

    HELIX = 0  # 'GHI'
    STRAND = 1  # 'BE'
    COIL = 2  # ' -STP'

    @property
    def onehot(self) -> np.ndarray:
        t = np.zeros(3)
        t[self.value] = 1.0
        return t


def _classify_secstructure(subtype: str) -> SecondarySctructure | None:
    if subtype in "GHI":
        return SecondarySctructure.HELIX
    if subtype in "BE":
        return SecondarySctructure.STRAND
    if subtype in " -STP":
        return SecondarySctructure.COIL
    return None


def add_features(
    pdb_path: str,
    graph: Graph,
    single_amino_acid_variant=None,  # noqa: ARG001
) -> None:  # noqa: D103
    letters = assign_secondary_structure(graph.arrays)

    res_idx = graph.node_residue_indices
    onehots = np.zeros((graph.num_nodes, 3), dtype=np.float64)
    for v, r in enumerate(res_idx):
        letter = letters.get(int(r), " ")
        cls = _classify_secstructure(letter)
        if cls is None:
            msg = f"Unknown secondary structure type ({letter}) detected on residue {r} of {pdb_path}."
            raise ValueError(msg)
        onehots[v] = cls.onehot
    graph.node_features[Nfeat.SECSTRUCT] = onehots
