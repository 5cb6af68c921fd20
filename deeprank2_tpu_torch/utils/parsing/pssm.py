"""PSSM file parsing into array-backed tables.

File format (reference: deeprank2/utils/parsing/pssm.py:10): whitespace table with
a header row naming columns ``pdbresi pdbresn seqresi seqresn A R N ... V IC``.
Rows are keyed by (pdb residue number, insertion code).
"""

from __future__ import annotations

from typing import IO

import numpy as np

from deeprank2_tpu_torch.molstruct.aminoacid import amino_acids, amino_acids_by_letter
from deeprank2_tpu_torch.utils.pssmdata import PssmRow, PssmTable


def parse_pssm(file_: IO[str], chain=None) -> PssmTable:
    """Read a per-chain PSSM file into a :class:`PssmTable`.

    Args:
        file_: the open pssm file.
        chain: accepted for API parity with the reference; rows are keyed by
            (residue number, insertion code) so the chain object is not needed.

    Returns:
        The position-specific scoring table.
    """
    header = next(file_).split()
    col = {name.strip(): i for i, name in enumerate(header)}

    rows: dict[tuple[int, str | None], PssmRow] = {}
    for line in file_:
        fields = line.split()
        if not fields:
            continue
        number_string = fields[col["pdbresi"]]
        if number_string[-1].isalpha():
            number = int(number_string[:-1])
            icode: str | None = number_string[-1]
        else:
            number = int(number_string)
            icode = None

        # expected amino acid at this position (validates against the pdb)
        amino_acid = amino_acids_by_letter[fields[col["pdbresn"]]]

        conservations = {aa: float(fields[col[aa.one_letter_code]]) for aa in amino_acids}
        information_content = float(fields[col["IC"]])
        rows[(number, icode)] = PssmRow(conservations, information_content, amino_acid)

    return PssmTable(rows)


def pssm_profile_matrix(table: PssmTable, res_numbers: np.ndarray, res_icodes: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized per-residue lookup: ``(profiles [R,20], information_content [R], found [R])``.

    Profile columns are ordered by three-letter code (reference semantics:
    deeprank2/features/conservation.py:15).
    """
    from deeprank2_tpu_torch.molstruct.aminoacid import PSSM_AA_ORDER

    n = len(res_numbers)
    profiles = np.zeros((n, 20), dtype=np.float64)
    infocontent = np.zeros(n, dtype=np.float64)
    found = np.zeros(n, dtype=bool)
    order = [amino_acids[i] for i in PSSM_AA_ORDER]
    for r in range(n):
        row = table.get(int(res_numbers[r]), res_icodes[r])
        if row is None:
            continue
        found[r] = True
        profiles[r] = [row.conservations[aa] for aa in order]
        infocontent[r] = row.information_content
    return profiles, infocontent, found
