"""Array-native molecular structure model.

The reference stores structures as per-atom Python objects
(deeprank2/molstruct/{structure,residue,atom}.py); here the source of truth is
``StructureArrays``, a struct-of-arrays table: positions ``[N,3]``, element ids
``[N]``, residue ids ``[N]``, with per-residue and per-chain side tables. Feature
kernels consume these arrays directly (vectorized / jit-able); the familiar
``PDBStructure``/``Chain``/``Residue``/``Atom`` API is provided as lightweight
views over the same arrays so user-facing behavior matches the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from deeprank2_tpu_torch.molstruct.aminoacid import AA_ID_BY_CODE, AminoAcid, amino_acids


class AtomicElement(Enum):
    """One-hot encoded atomic element vocabulary (reference: molstruct/atom.py:15)."""

    C = 1
    O = 2  # noqa: E741
    N = 3
    S = 4
    P = 5
    H = 6

    @property
    def onehot(self) -> np.ndarray:
        value = np.zeros(max(el.value for el in AtomicElement))
        value[self.value - 1] = 1.0
        return value


NUM_ELEMENTS = len(AtomicElement)


def element_onehot(element_ids: np.ndarray) -> np.ndarray:
    """One-hot ``[N, 6]`` encoding for element ids (``AtomicElement.value``, 1-based)."""
    element_ids = np.asarray(element_ids)
    out = np.zeros((element_ids.shape[0], NUM_ELEMENTS), dtype=np.float64)
    out[np.arange(element_ids.shape[0]), element_ids - 1] = 1.0
    return out


@dataclass
class StructureArrays:
    """Struct-of-arrays representation of a (multi-chain) protein structure.

    Atom-level columns (length N):
        positions: float64 [N, 3] xyz coordinates in Å.
        atom_names: object array of PDB atom names (e.g. "CA", "OXT").
        elements: int8, ``AtomicElement.value`` codes (1..6).
        occupancies: float64 PDB occupancy.
        atom_residue: int32 index into the residue tables.

    Residue-level columns (length R):
        res_numbers: int32 PDB residue sequence numbers.
        res_icodes: object array of insertion codes (None if absent).
        res_aa_ids: int32 amino-acid table id (-1 for non-amino-acid residues).
        res_chain: int32 index into the chain tables.
        res_atom_start / res_atom_count: CSR layout of atoms per residue
            (atoms of one residue are contiguous).

    Chain-level columns (length C):
        chain_ids: list of chain identifier strings.
    """

    id: str
    positions: np.ndarray
    atom_names: np.ndarray
    elements: np.ndarray
    occupancies: np.ndarray
    atom_residue: np.ndarray
    res_numbers: np.ndarray
    res_icodes: np.ndarray
    res_aa_ids: np.ndarray
    res_chain: np.ndarray
    res_atom_start: np.ndarray
    res_atom_count: np.ndarray
    chain_ids: list[str]
    # per-chain PSSM tables: chain_id -> PssmTable (set by the query pipeline)
    pssms: dict = field(default_factory=dict)

    @property
    def num_atoms(self) -> int:
        return self.positions.shape[0]

    @property
    def num_residues(self) -> int:
        return self.res_numbers.shape[0]

    @property
    def num_chains(self) -> int:
        return len(self.chain_ids)

    # ------------------------------------------------------------------
    # Derived per-atom columns used by feature kernels
    # ------------------------------------------------------------------
    @property
    def atom_chain(self) -> np.ndarray:
        """int32 [N] chain index per atom."""
        return self.res_chain[self.atom_residue]

    @property
    def atom_aa_ids(self) -> np.ndarray:
        """int32 [N] amino-acid table id per atom (-1 unknown)."""
        return self.res_aa_ids[self.atom_residue]

    def residue_centers(self) -> np.ndarray:
        """float64 [R, 3] residue center positions (CB, else CA, else atom mean).

        Matches reference semantics (molstruct/residue.py:97-117).
        """
        centers = np.zeros((self.num_residues, 3), dtype=np.float64)
        counts = np.maximum(self.res_atom_count, 1)
        # default: mean of atom positions (segment mean over the CSR layout)
        sums = np.zeros((self.num_residues, 3), dtype=np.float64)
        np.add.at(sums, self.atom_residue, self.positions)
        centers = sums / counts[:, None]
        # override with CA, then CB where present
        for name in ("CA", "CB"):
            sel = np.flatnonzero(self.atom_names == name)
            if sel.size:
                res_idx = self.atom_residue[sel]
                # first occurrence wins (reference takes the first matching atom)
                first = np.full(self.num_residues, -1, dtype=np.int64)
                for a in sel[::-1]:
                    first[self.atom_residue[a]] = a
                has = first >= 0
                centers[has] = self.positions[first[has]]
        return centers

    # ------------------------------------------------------------------
    # Object views (API parity with the reference)
    # ------------------------------------------------------------------
    def to_structure(self) -> PDBStructure:
        return PDBStructure(self)

    def residue_view(self, residue_index: int) -> Residue:
        return Residue(self, int(residue_index))

    def atom_view(self, atom_index: int) -> Atom:
        return Atom(self, int(atom_index))

    def find_residue(self, chain_id: str, number: int, insertion_code: str | None = None) -> int:
        """Index of the residue with the given chain/number/insertion code, or -1."""
        try:
            chain_idx = self.chain_ids.index(chain_id)
        except ValueError:
            return -1
        for r in np.flatnonzero(self.res_chain == chain_idx):
            if self.res_numbers[r] == number and self.res_icodes[r] == insertion_code:
                return int(r)
        return -1


class PDBStructure:
    """View of a whole structure (API parity with reference molstruct/structure.py:13)."""

    def __init__(self, arrays: StructureArrays):
        self._arrays = arrays

    @property
    def arrays(self) -> StructureArrays:
        return self._arrays

    @property
    def id(self) -> str:
        return self._arrays.id

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PDBStructure):
            return self.id == other.id
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.id)

    def __repr__(self) -> str:
        return self.id

    def has_chain(self, chain_id: str) -> bool:
        return chain_id in self._arrays.chain_ids

    def get_chain(self, chain_id: str) -> Chain:
        if chain_id not in self._arrays.chain_ids:
            raise KeyError(chain_id)
        return Chain(self._arrays, self._arrays.chain_ids.index(chain_id))

    @property
    def chains(self) -> list[Chain]:
        return [Chain(self._arrays, i) for i in range(self._arrays.num_chains)]

    def get_atoms(self) -> list[Atom]:
        return [Atom(self._arrays, i) for i in range(self._arrays.num_atoms)]


class Chain:
    """View of one chain."""

    def __init__(self, arrays: StructureArrays, chain_index: int):
        self._arrays = arrays
        self._index = chain_index

    @property
    def model(self) -> PDBStructure:
        return PDBStructure(self._arrays)

    @property
    def id(self) -> str:
        return self._arrays.chain_ids[self._index]

    @property
    def index(self) -> int:
        return self._index

    @property
    def pssm(self):
        return self._arrays.pssms.get(self.id)

    @pssm.setter
    def pssm(self, value) -> None:
        self._arrays.pssms[self.id] = value

    @property
    def residues(self) -> list[Residue]:
        return [Residue(self._arrays, int(r)) for r in np.flatnonzero(self._arrays.res_chain == self._index)]

    def has_residue(self, residue_number: int, insertion_code: str | None = None) -> bool:
        return self._arrays.find_residue(self.id, residue_number, insertion_code) >= 0

    def get_residue(self, residue_number: int, insertion_code: str | None = None) -> Residue:
        r = self._arrays.find_residue(self.id, residue_number, insertion_code)
        if r < 0:
            raise KeyError((residue_number, insertion_code))
        return Residue(self._arrays, r)

    def get_atoms(self) -> list[Atom]:
        sel = np.flatnonzero(self._arrays.atom_chain == self._index)
        return [Atom(self._arrays, int(a)) for a in sel]

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Chain):
            return self._arrays.id == other._arrays.id and self.id == other.id
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.id)

    def __repr__(self) -> str:
        return f"{self._arrays.id} {self.id}"


class Residue:
    """View of one residue."""

    def __init__(self, arrays: StructureArrays, residue_index: int):
        self._arrays = arrays
        self._index = residue_index

    @property
    def index(self) -> int:
        return self._index

    @property
    def chain(self) -> Chain:
        return Chain(self._arrays, int(self._arrays.res_chain[self._index]))

    @property
    def number(self) -> int:
        return int(self._arrays.res_numbers[self._index])

    @property
    def insertion_code(self) -> str | None:
        return self._arrays.res_icodes[self._index]

    @property
    def amino_acid(self) -> AminoAcid | None:
        aa_id = int(self._arrays.res_aa_ids[self._index])
        return None if aa_id < 0 else amino_acids[aa_id]

    @property
    def atoms(self) -> list[Atom]:
        start = int(self._arrays.res_atom_start[self._index])
        count = int(self._arrays.res_atom_count[self._index])
        return [Atom(self._arrays, a) for a in range(start, start + count)]

    @property
    def number_string(self) -> str:
        icode = self.insertion_code
        return f"{self.number}{icode}" if icode is not None else str(self.number)

    def get_pssm(self):
        pssm = self._arrays.pssms.get(self.chain.id)
        if pssm is None:
            msg = f"No pssm file found for Chain {self.chain}."
            raise FileNotFoundError(msg)
        return pssm[self]

    def get_center(self) -> np.ndarray:
        """CB position, else CA position, else mean of atom positions."""
        start = int(self._arrays.res_atom_start[self._index])
        count = int(self._arrays.res_atom_count[self._index])
        if count == 0:
            msg = f"Cannot get the center position from {self}, because it has no atoms"
            raise ValueError(msg)
        names = self._arrays.atom_names[start : start + count]
        for target in ("CB", "CA"):
            hits = np.flatnonzero(names == target)
            if hits.size:
                return self._arrays.positions[start + int(hits[0])]
        return self._arrays.positions[start : start + count].mean(axis=0)

    @property
    def position(self) -> np.ndarray:
        return self.get_center()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Residue):
            return self.chain == other.chain and self.number == other.number and self.insertion_code == other.insertion_code
        return NotImplemented

    def __hash__(self) -> int:
        return hash((self.number, self.insertion_code))

    def __repr__(self) -> str:
        return f"{self.chain} {self.number_string}"


class Atom:
    """View of one atom."""

    def __init__(self, arrays: StructureArrays, atom_index: int):
        self._arrays = arrays
        self._index = atom_index

    @property
    def index(self) -> int:
        return self._index

    @property
    def name(self) -> str:
        return self._arrays.atom_names[self._index]

    @property
    def element(self) -> AtomicElement:
        return AtomicElement(int(self._arrays.elements[self._index]))

    @property
    def occupancy(self) -> float:
        return float(self._arrays.occupancies[self._index])

    @property
    def position(self) -> np.ndarray:
        return self._arrays.positions[self._index]

    @property
    def residue(self) -> Residue:
        return Residue(self._arrays, int(self._arrays.atom_residue[self._index]))

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Atom):
            return self.residue == other.residue and self.name == other.name
        return NotImplemented

    def __hash__(self) -> int:
        return hash((tuple(self.position), self.element, self.name))

    def __repr__(self) -> str:
        return f"{self.residue} {self.name}"


class SingleResidueVariant:
    """A single-residue mutation of a structure (reference: molstruct/residue.py:120)."""

    def __init__(self, residue: Residue, variant_amino_acid: AminoAcid):
        self._residue = residue
        self._variant_amino_acid = variant_amino_acid

    @property
    def residue(self) -> Residue:
        return self._residue

    @property
    def variant_amino_acid(self) -> AminoAcid:
        return self._variant_amino_acid

    @property
    def wildtype_amino_acid(self) -> AminoAcid:
        return self._residue.amino_acid


def aa_id_from_code(res_name: str) -> int:
    """Amino-acid table id from a three-letter residue code (-1 if unknown)."""
    return AA_ID_BY_CODE.get(res_name, -1)
