"""PSSM data containers (reference: deeprank2/utils/pssmdata.py)."""

from __future__ import annotations


class PssmRow:
    """One position-specific scoring matrix row."""

    def __init__(self, conservations: dict, information_content: float, amino_acid=None):
        self._conservations = conservations
        self._information_content = information_content
        self._amino_acid = amino_acid

    @property
    def conservations(self) -> dict:
        return self._conservations

    @property
    def information_content(self) -> float:
        return self._information_content

    @property
    def amino_acid(self):
        """The amino acid the chain is expected to have at this position."""
        return self._amino_acid

    def get_conservation(self, amino_acid) -> float:
        return self._conservations[amino_acid]


class PssmTable:
    """Scoring table for one chain, keyed by (residue number, insertion code)."""

    def __init__(self, rows: dict | None = None):
        self._rows = rows if rows is not None else {}

    def __contains__(self, residue) -> bool:
        return self._key(residue) in self._rows

    def __getitem__(self, residue) -> PssmRow:
        return self._rows[self._key(residue)]

    def get(self, number: int, icode: str | None = None) -> PssmRow | None:
        return self._rows.get((number, icode))

    @staticmethod
    def _key(residue) -> tuple[int, str | None]:
        if isinstance(residue, tuple):
            return residue
        return (residue.number, residue.insertion_code)

    def update(self, other: PssmTable) -> None:
        """Merge two non-overlapping scoring tables."""
        self._rows.update(other._rows)

    def items(self):
        return self._rows.items()
