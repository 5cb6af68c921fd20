"""Amino-acid vocabulary.

Unlike the reference's per-instance object attributes (deeprank2/molstruct/aminoacid.py,
deeprank2/domain/aminoacidlist.py), properties here are column arrays indexed by a dense
amino-acid id, so feature kernels can look up whole structures with one ``np.take``.
Lightweight ``AminoAcid`` views preserve the reference's public API
(``alanine``, ``amino_acids_by_code``, ``convert_aa_nomenclature`` ...).
"""

from __future__ import annotations

from enum import Enum
from typing import Literal

import numpy as np


class Polarity(Enum):
    """One-hot encoded amino-acid polarity class."""

    NONPOLAR = 0
    POLAR = 1
    NEGATIVE = 2
    POSITIVE = 3

    @property
    def onehot(self) -> np.ndarray:
        t = np.zeros(4)
        t[self.value] = 1.0
        return t


class AminoAcid:
    """A view row of the amino-acid table.

    Args mirror the reference API (deeprank2/molstruct/aminoacid.py:23): name,
    three/one-letter code, charge, polarity, size (heavy side-chain atoms), mass
    (residue mass in Da), pI, hydrogen-bond donor/acceptor counts and the dense
    one-hot ``index``.
    """

    __slots__ = (
        "name",
        "three_letter_code",
        "one_letter_code",
        "charge",
        "polarity",
        "size",
        "mass",
        "pI",
        "hydrogen_bond_donors",
        "hydrogen_bond_acceptors",
        "index",
    )

    def __init__(  # noqa: PLR0913
        self,
        name: str,
        three_letter_code: str,
        one_letter_code: str,
        charge: float,
        polarity: Polarity,
        size: int,
        mass: float,
        pI: float,  # noqa: N803
        hydrogen_bond_donors: int,
        hydrogen_bond_acceptors: int,
        index: int,
    ):
        self.name = name
        self.three_letter_code = three_letter_code
        self.one_letter_code = one_letter_code
        self.charge = charge
        self.polarity = polarity
        self.size = size
        self.mass = mass
        self.pI = pI
        self.hydrogen_bond_donors = hydrogen_bond_donors
        self.hydrogen_bond_acceptors = hydrogen_bond_acceptors
        self.index = index

    @property
    def onehot(self) -> np.ndarray:
        a = np.zeros(20)
        a[self.index] = 1.0
        return a

    def __hash__(self) -> int:
        return hash(self.name)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, AminoAcid):
            return other.name == self.name
        return NotImplemented

    def __repr__(self) -> str:
        return self.three_letter_code


# The 20 canonical amino acids (+ SEC/PYL aliases below). Values follow the public
# physico-chemical reference data also used by the reference framework
# (deeprank2/domain/aminoacidlist.py:39-349): charge from the OPLS topology sums,
# polarity per standard biochemistry classification, size = heavy side-chain atom
# count, mass = average residue mass (Da), pI, and H-bond donor/acceptor counts.
#   name, three, one, charge, polarity, size, mass, pI, hb_don, hb_acc, index
_P = Polarity
_AA_RECORDS = [
    ("Alanine", "ALA", "A", 0.0, _P.NONPOLAR, 1, 71.1, 6.00, 0, 0, 0),
    ("Cysteine", "CYS", "C", 0.0, _P.POLAR, 2, 103.2, 5.07, 0, 0, 1),
    ("Aspartate", "ASP", "D", -1.0, _P.NEGATIVE, 4, 115.1, 2.77, 0, 4, 2),
    ("Glutamate", "GLU", "E", -1.0, _P.NEGATIVE, 5, 129.1, 3.22, 0, 4, 3),
    ("Phenylalanine", "PHE", "F", 0.0, _P.NONPOLAR, 7, 147.2, 5.48, 0, 0, 4),
    ("Glycine", "GLY", "G", 0.0, _P.NONPOLAR, 0, 57.1, 5.97, 0, 0, 5),
    ("Histidine", "HIS", "H", 1.0, _P.POSITIVE, 6, 137.1, 7.59, 1, 1, 6),
    ("Isoleucine", "ILE", "I", 0.0, _P.NONPOLAR, 4, 113.2, 6.02, 0, 0, 7),
    ("Lysine", "LYS", "K", 1.0, _P.POSITIVE, 5, 128.2, 9.74, 3, 0, 8),
    ("Leucine", "LEU", "L", 0.0, _P.NONPOLAR, 4, 113.2, 5.98, 0, 0, 9),
    ("Methionine", "MET", "M", 0.0, _P.NONPOLAR, 4, 131.2, 5.74, 0, 0, 10),
    ("Asparagine", "ASN", "N", 0.0, _P.POLAR, 4, 114.1, 5.41, 2, 2, 11),
    ("Proline", "PRO", "P", 0.0, _P.NONPOLAR, 3, 97.1, 6.30, 0, 0, 12),
    ("Glutamine", "GLN", "Q", 0.0, _P.POLAR, 5, 128.1, 5.65, 2, 2, 13),
    ("Arginine", "ARG", "R", 1.0, _P.POSITIVE, 7, 156.2, 10.76, 5, 0, 14),
    ("Serine", "SER", "S", 0.0, _P.POLAR, 2, 87.1, 5.68, 1, 2, 15),
    ("Threonine", "THR", "T", 0.0, _P.POLAR, 3, 101.1, 5.60, 1, 2, 16),
    ("Tryptophan", "TRP", "W", 0.0, _P.NONPOLAR, 10, 186.2, 5.89, 1, 0, 18),
    ("Tyrosine", "TYR", "Y", 0.0, _P.POLAR, 8, 163.2, 5.66, 1, 1, 19),
    ("Valine", "VAL", "V", 0.0, _P.NONPOLAR, 3, 99.1, 5.96, 0, 0, 17),
]

# Non-canonical amino acids; one-hot indexed as their canonical analogues
# (SEC->CYS, PYL->LYS) like the reference does. Excluded from `amino_acids`.
_NONCANONICAL_RECORDS = [
    ("Selenocysteine", "SEC", "U", 0.0, _P.POLAR, 2, 150.0, 5.47, 1, 2, 1),
    ("Pyrrolysine", "PYL", "O", 0.0, _P.POLAR, 13, 255.32, 7.394, 1, 4, 8),
]


def _build() -> tuple[list[AminoAcid], dict]:
    canonical = [AminoAcid(*rec) for rec in _AA_RECORDS]
    extra = [AminoAcid(*rec) for rec in _NONCANONICAL_RECORDS]
    # canonical list sorted alphabetically by full name (matches reference ordering)
    canonical.sort(key=lambda aa: aa.name)
    return canonical, extra


amino_acids, _noncanonical_amino_acids = _build()
selenocysteine, pyrrolysine = _noncanonical_amino_acids

amino_acids_by_code = {aa.three_letter_code: aa for aa in amino_acids}
amino_acids_by_letter = {aa.one_letter_code: aa for aa in amino_acids}
amino_acids_by_name = {aa.name: aa for aa in amino_acids}

# named singletons (user-facing, e.g. for SingleResidueVariantQuery)
alanine = amino_acids_by_code["ALA"]
arginine = amino_acids_by_code["ARG"]
asparagine = amino_acids_by_code["ASN"]
aspartate = amino_acids_by_code["ASP"]
cysteine = amino_acids_by_code["CYS"]
glutamate = amino_acids_by_code["GLU"]
glutamine = amino_acids_by_code["GLN"]
glycine = amino_acids_by_code["GLY"]
histidine = amino_acids_by_code["HIS"]
isoleucine = amino_acids_by_code["ILE"]
leucine = amino_acids_by_code["LEU"]
lysine = amino_acids_by_code["LYS"]
methionine = amino_acids_by_code["MET"]
phenylalanine = amino_acids_by_code["PHE"]
proline = amino_acids_by_code["PRO"]
serine = amino_acids_by_code["SER"]
threonine = amino_acids_by_code["THR"]
tryptophan = amino_acids_by_code["TRP"]
tyrosine = amino_acids_by_code["TYR"]
valine = amino_acids_by_code["VAL"]

# ---------------------------------------------------------------------------
# Column arrays, indexed by *table id* = position in `amino_acids` (alphabetical
# by name). This is the array-native access path used by feature kernels; the
# dense one-hot `index` is a separate column.
# ---------------------------------------------------------------------------
NUM_AMINO_ACIDS = len(amino_acids)

AA_CHARGE = np.array([aa.charge for aa in amino_acids], dtype=np.float64)
AA_POLARITY = np.array([aa.polarity.value for aa in amino_acids], dtype=np.int32)
AA_SIZE = np.array([aa.size for aa in amino_acids], dtype=np.float64)
AA_MASS = np.array([aa.mass for aa in amino_acids], dtype=np.float64)
AA_PI = np.array([aa.pI for aa in amino_acids], dtype=np.float64)
AA_HB_DONORS = np.array([aa.hydrogen_bond_donors for aa in amino_acids], dtype=np.float64)
AA_HB_ACCEPTORS = np.array([aa.hydrogen_bond_acceptors for aa in amino_acids], dtype=np.float64)
AA_ONEHOT_INDEX = np.array([aa.index for aa in amino_acids], dtype=np.int32)
AA_THREE_LETTER = [aa.three_letter_code for aa in amino_acids]

# table id by three-letter code (canonical only); -1 = unknown residue type
AA_ID_BY_CODE = {aa.three_letter_code: i for i, aa in enumerate(amino_acids)}

# PSSM profile column ordering: amino acids sorted by three-letter code
# (reference semantics: deeprank2/features/conservation.py:15)
PSSM_AA_ORDER = sorted(range(NUM_AMINO_ACIDS), key=lambda i: amino_acids[i].three_letter_code)


def aa_onehot(aa_ids: np.ndarray) -> np.ndarray:
    """One-hot [N, 20] encoding for an array of amino-acid table ids (-1 -> all zeros)."""
    aa_ids = np.asarray(aa_ids)
    out = np.zeros((aa_ids.shape[0], 20), dtype=np.float64)
    valid = aa_ids >= 0
    out[valid, AA_ONEHOT_INDEX[aa_ids[valid]]] = 1.0
    return out


def polarity_onehot(aa_ids: np.ndarray) -> np.ndarray:
    """One-hot [N, 4] polarity encoding for amino-acid table ids (-1 -> all zeros)."""
    aa_ids = np.asarray(aa_ids)
    out = np.zeros((aa_ids.shape[0], 4), dtype=np.float64)
    valid = aa_ids >= 0
    out[valid, AA_POLARITY[aa_ids[valid]]] = 1.0
    return out


def convert_aa_nomenclature(aa: str, output_format: Literal[0, 1, 3] = 0) -> str:
    """Convert between 1-letter codes, 3-letter codes and full amino-acid names.

    Mirrors the reference API (deeprank2/domain/aminoacidlist.py:382).
    """
    try:
        if len(aa) == 1:
            entry = next(e for e in amino_acids if e.one_letter_code.lower() == aa.lower())
        elif len(aa) == 3:  # noqa: PLR2004
            entry = next(e for e in amino_acids if e.three_letter_code.lower() == aa.lower())
        else:
            entry = next(e for e in amino_acids if e.name.lower() == aa.lower())
    except StopIteration as e:
        msg = f"{aa} is not a valid amino acid."
        raise ValueError(msg) from e

    if not output_format:
        return entry.name
    if output_format == 3:  # noqa: PLR2004
        return entry.three_letter_code
    if output_format == 1:
        return entry.one_letter_code
    msg = f"output_format {output_format} not recognized. Must be 0 (name), 1 (one-letter) or 3 (three-letter)."
    raise ValueError(msg)
