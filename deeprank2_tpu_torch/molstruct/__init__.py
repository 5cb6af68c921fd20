from deeprank2_tpu_torch.molstruct.aminoacid import AminoAcid, Polarity
from deeprank2_tpu_torch.molstruct.structure import (
    Atom,
    AtomicElement,
    Chain,
    PDBStructure,
    Residue,
    SingleResidueVariant,
    StructureArrays,
)

__all__ = [
    "AminoAcid",
    "Polarity",
    "Atom",
    "AtomicElement",
    "Chain",
    "PDBStructure",
    "Residue",
    "SingleResidueVariant",
    "StructureArrays",
]
