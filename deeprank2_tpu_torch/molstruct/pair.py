"""Unordered pairs and contacts.

The array-first graph (utils/graph.py) stores contacts as index arrays, so
these classes are off the hot path; they exist for user code that manipulates
individual contacts and for API compatibility with the reference's
``Pair``/``Contact`` types.
"""

from __future__ import annotations

from abc import ABC
from typing import Any


class Pair:
    """Two items treated as an unordered set: hashing and equality ignore order."""

    __slots__ = ("item1", "item2")

    def __init__(self, item1: Any, item2: Any):
        self.item1 = item1
        self.item2 = item2

    def _canonical(self) -> tuple[str, str]:
        first, second = str(self.item1), str(self.item2)
        return (first, second) if first <= second else (second, first)

    def __hash__(self) -> int:
        return hash("".join(self._canonical()))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Pair):
            return NotImplemented
        same = self.item1 == other.item1 and self.item2 == other.item2
        swapped = self.item1 == other.item2 and self.item2 == other.item1
        return same or swapped

    def __iter__(self):
        yield self.item1
        yield self.item2

    def __repr__(self) -> str:
        return f"{self.item1}{self.item2}"


class Contact(Pair, ABC):
    """Marker base for residue/atom contacts."""


class ResidueContact(Contact):
    """An unordered contact between two residues."""

    @property
    def residue1(self):
        return self.item1

    @property
    def residue2(self):
        return self.item2


class AtomicContact(Contact):
    """An unordered contact between two atoms."""

    @property
    def atom1(self):
        return self.item1

    @property
    def atom2(self):
        return self.item2
