"""In-repo PDB parser producing ``StructureArrays``.

Replaces the reference's pdb2sql (SQLite) dependency (reference call sites:
deeprank2/utils/buildgraph.py:31-92). Behavior notes vs the reference:

- Only ``ATOM`` records of the first model are read (pdb2sql default).
- Alternate locations: atoms with an altLoc other than '', 'A' are skipped, and
  when two atoms of the same (residue, name) appear, the highest-occupancy one
  wins (reference: buildgraph.py:18-28). The reference additionally *stops
  parsing the whole structure* at the first non-'A' altLoc record
  (buildgraph.py:51 ``return`` inside the loop) — that is a reference bug we do
  not reproduce.
- Unknown chemical elements raise ``KeyError`` like the reference
  (buildgraph.py:73); the query pipeline catches this per query.
"""

from __future__ import annotations

import numpy as np

from deeprank2_tpu_torch.molstruct.structure import AtomicElement, StructureArrays, aa_id_from_code

_ELEMENT_VALUES = {el.name: el.value for el in AtomicElement}


def _parse_pdb_native(pdb_path: str, id_: str) -> StructureArrays:
    """The C++ parser (csrc/pdb_parser.cpp); raises if it cannot be built."""
    import ctypes
    import os

    from deeprank2_tpu_torch.ops import _build

    lib = _build.host_library("pdb_parser")

    # capacity upper bound: an ATOM record is >= 54 bytes + newline
    cap = max(os.path.getsize(pdb_path) // 50 + 16, 64)
    positions = np.zeros((cap, 3), dtype=np.float64)
    name_bytes = np.zeros((cap, 8), dtype=np.uint8)
    elements = np.zeros(cap, dtype=np.int8)
    occupancies = np.zeros(cap, dtype=np.float64)
    atom_residue = np.zeros(cap, dtype=np.int32)
    res_numbers = np.zeros(cap, dtype=np.int32)
    res_icode_bytes = np.zeros(cap, dtype=np.uint8)
    res_name_bytes = np.zeros((cap, 4), dtype=np.uint8)
    res_chain = np.zeros(cap, dtype=np.int32)
    chain_bytes = np.zeros(256, dtype=np.uint8)
    counts = np.zeros(3, dtype=np.int64)

    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_char_p = ctypes.POINTER(ctypes.c_char)
    c_i8_p = ctypes.POINTER(ctypes.c_int8)
    c_i32_p = ctypes.POINTER(ctypes.c_int32)
    c_i64_p = ctypes.POINTER(ctypes.c_int64)

    rc = lib.pdb_parse(
        pdb_path.encode(),
        positions.ctypes.data_as(c_double_p),
        name_bytes.ctypes.data_as(c_char_p),
        elements.ctypes.data_as(c_i8_p),
        occupancies.ctypes.data_as(c_double_p),
        atom_residue.ctypes.data_as(c_i32_p),
        res_numbers.ctypes.data_as(c_i32_p),
        res_icode_bytes.ctypes.data_as(c_char_p),
        res_name_bytes.ctypes.data_as(c_char_p),
        res_chain.ctypes.data_as(c_i32_p),
        chain_bytes.ctypes.data_as(c_char_p),
        counts.ctypes.data_as(c_i64_p),
        ctypes.c_int64(cap),
        ctypes.c_int64(cap),
        ctypes.c_int64(256),
    )
    if rc == -1:
        raise FileNotFoundError(pdb_path)
    if rc <= -1000:
        msg = f"unknown chemical element on line {-rc - 1000} of {pdb_path}"
        raise KeyError(msg)
    if rc < 0:
        # the capacities are upper bounds (an ATOM record per 50 bytes, a
        # chain per byte value), so this is a fault, not a large file
        msg = f"the native PDB parser ran out of capacity on {pdb_path} (code {rc})"
        raise RuntimeError(msg)

    n_atoms, n_res, n_chains = (int(v) for v in counts)
    # vectorized bytes -> str decode (S dtype drops trailing NULs)
    atom_names = name_bytes[:n_atoms].view("S8").ravel().astype(str).astype(object)
    res_names = res_name_bytes[:n_res].view("S4").ravel().astype(str)
    res_icodes = np.array([chr(b) if b else None for b in res_icode_bytes[:n_res]], dtype=object)
    chain_ids = [chr(b) for b in chain_bytes[:n_chains]]

    atom_residue_arr = atom_residue[:n_atoms]
    order = np.argsort(atom_residue_arr, kind="stable")
    atom_residue_arr = atom_residue_arr[order]
    res_atom_count = np.bincount(atom_residue_arr, minlength=n_res).astype(np.int32)
    res_atom_start = np.concatenate([[0], np.cumsum(res_atom_count[:-1])]).astype(np.int32)

    return StructureArrays(
        id=id_,
        positions=positions[:n_atoms][order],
        atom_names=atom_names[order],
        elements=elements[:n_atoms][order],
        occupancies=occupancies[:n_atoms][order],
        atom_residue=atom_residue_arr,
        res_numbers=res_numbers[:n_res].copy(),
        res_icodes=res_icodes,
        res_aa_ids=np.array([aa_id_from_code(code) for code in res_names], dtype=np.int32),
        res_chain=res_chain[:n_res].copy(),
        res_atom_start=res_atom_start,
        res_atom_count=res_atom_count,
        chain_ids=chain_ids,
    )


def _guess_element(atom_name: str) -> str:
    """Element symbol from a PDB atom name, for files without an element column.

    PDB atom names are right-padded/element-aligned; for standard amino-acid
    atoms the element is the first alphabetic character (after any leading digit,
    e.g. ``1HB1`` -> H).
    """
    for ch in atom_name:
        if ch.isalpha():
            return ch.upper()
    return atom_name.strip().upper()


def parse_pdb(pdb_path: str, id_: str | None = None) -> StructureArrays:
    """Parse a PDB file into a ``StructureArrays`` table.

    Runs the C++ parser (csrc/pdb_parser.cpp, built with ``g++`` at its first
    use; a failed build raises). :func:`parse_pdb_ref` is its plain version
    and gives identical results.

    Args:
        pdb_path: path to the .pdb file.
        id_: structure identifier; defaults to the file stem.

    Returns:
        The parsed structure (first model, ATOM records only).
    """
    import os

    if id_ is None:
        id_ = os.path.splitext(os.path.basename(pdb_path))[0]
    return _parse_pdb_native(pdb_path, id_)


def parse_pdb_ref(pdb_path: str, id_: str | None = None) -> StructureArrays:
    """The plain (pure-Python) version of :func:`parse_pdb`, which the tests
    and ``chip_smoke.py`` hold the C++ parser against."""
    import os

    if id_ is None:
        id_ = os.path.splitext(os.path.basename(pdb_path))[0]

    positions: list[tuple[float, float, float]] = []
    atom_names: list[str] = []
    elements: list[int] = []
    occupancies: list[float] = []
    atom_residue: list[int] = []

    res_numbers: list[int] = []
    res_icodes: list[str | None] = []
    res_aa_ids: list[int] = []
    res_chain: list[int] = []

    chain_ids: list[str] = []
    chain_index: dict[str, int] = {}
    residue_index: dict[tuple[str, int, str | None], int] = {}
    # (residue_idx, atom_name) -> atom array index, for altLoc resolution
    atom_index: dict[tuple[int, str], int] = {}

    with open(pdb_path, encoding="utf-8") as f:
        for line in f:
            record = line[:6]
            if record == "ENDMDL":
                break  # first model only
            if record != "ATOM  ":
                continue

            altloc = line[16].strip()
            if altloc not in ("", "A"):
                continue

            atom_name = line[12:16].strip()
            res_name = line[17:20].strip()
            chain_id = line[21].strip()
            res_seq = int(line[22:26])
            icode = line[26].strip() or None
            x = float(line[30:38])
            y = float(line[38:46])
            z = float(line[46:54])
            occ_str = line[54:60].strip()
            occ = float(occ_str) if occ_str else 1.0
            element = line[76:78].strip().upper() if len(line) >= 78 else ""
            if not element:
                element = _guess_element(atom_name)
            element_value = _ELEMENT_VALUES[element]  # KeyError for unknown elements

            ch_key = chain_id
            if ch_key not in chain_index:
                chain_index[ch_key] = len(chain_ids)
                chain_ids.append(ch_key)

            res_key = (chain_id, res_seq, icode)
            if res_key not in residue_index:
                residue_index[res_key] = len(res_numbers)
                res_numbers.append(res_seq)
                res_icodes.append(icode)
                res_aa_ids.append(aa_id_from_code(res_name))
                res_chain.append(chain_index[ch_key])
            r = residue_index[res_key]

            akey = (r, atom_name)
            if akey in atom_index:
                # duplicate atom name within a residue: keep highest occupancy
                prev = atom_index[akey]
                if occupancies[prev] < occ:
                    positions[prev] = (x, y, z)
                    occupancies[prev] = occ
                continue

            atom_index[akey] = len(atom_names)
            positions.append((x, y, z))
            atom_names.append(atom_name)
            elements.append(element_value)
            occupancies.append(occ)
            atom_residue.append(r)

    n_res = len(res_numbers)
    atom_residue_arr = np.asarray(atom_residue, dtype=np.int32)

    # Reorder atoms so each residue's atoms are contiguous (CSR layout). PDB files
    # are normally already ordered this way; a stable sort keeps in-residue order.
    order = np.argsort(atom_residue_arr, kind="stable")
    atom_residue_arr = atom_residue_arr[order]
    res_atom_count = np.bincount(atom_residue_arr, minlength=n_res).astype(np.int32)
    res_atom_start = np.concatenate([[0], np.cumsum(res_atom_count[:-1])]).astype(np.int32)

    return StructureArrays(
        id=id_,
        positions=np.asarray(positions, dtype=np.float64).reshape(-1, 3)[order],
        atom_names=np.asarray(atom_names, dtype=object)[order],
        elements=np.asarray(elements, dtype=np.int8)[order],
        occupancies=np.asarray(occupancies, dtype=np.float64)[order],
        atom_residue=atom_residue_arr,
        res_numbers=np.asarray(res_numbers, dtype=np.int32),
        res_icodes=np.asarray(res_icodes, dtype=object),
        res_aa_ids=np.asarray(res_aa_ids, dtype=np.int32),
        res_chain=np.asarray(res_chain, dtype=np.int32),
        res_atom_start=res_atom_start,
        res_atom_count=res_atom_count,
        chain_ids=chain_ids,
    )
