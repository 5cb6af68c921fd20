"""Docking-model structure similarity: lrmsd, irmsd, fnat, DockQ.

In-repo replacement for pdb2sql's ``StructureSimilarity`` (used by the
reference's tools/target.py:80-123):

- ``lrmsd``: superpose decoy on reference over *receptor* (first chain)
  backbone atoms, then backbone RMSD of the ligand (second chain).
- ``irmsd``: reference-defined interface residues (10 Å cross-chain atom
  contacts); minimal backbone RMSD over the interface after superposition on
  the same atoms.
- ``fnat``: fraction of the reference's 5 Å cross-chain residue contacts
  preserved in the decoy.
- ``DockQ = (fnat + 1/(1+(irmsd/1.5)^2) + 1/(1+(lrmsd/8.5)^2)) / 3``.

Atoms are matched between decoy and reference by (chain, residue number,
insertion code, atom name).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from deeprank2_tpu_torch.io.pdb import parse_pdb
from deeprank2_tpu_torch.molstruct.structure import StructureArrays

BACKBONE_ATOMS = ("C", "CA", "N", "O")
IZONE_CUTOFF = 10.0
FNAT_CUTOFF = 5.0


def superpose(mobile: np.ndarray, target: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Kabsch (SVD) superposition: returns (rotation [3,3], translation [3])
    minimizing RMSD of ``mobile @ R.T + t`` onto ``target``."""
    mob_center = mobile.mean(axis=0)
    tgt_center = target.mean(axis=0)
    h = (mobile - mob_center).T @ (target - tgt_center)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    trans = tgt_center - rot @ mob_center
    return rot, trans


def rmsd(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(((a - b) ** 2).sum(axis=1).mean()))


def superposed_rmsd(mobile: np.ndarray, target: np.ndarray) -> float:
    rot, trans = superpose(mobile, target)
    return rmsd(mobile @ rot.T + trans, target)


def _atom_key_table(arrays: StructureArrays) -> dict[tuple, int]:
    """(chain, resnum, icode, atom name) -> atom index."""
    table = {}
    for a in range(arrays.num_atoms):
        r = arrays.atom_residue[a]
        key = (
            arrays.chain_ids[arrays.res_chain[r]],
            int(arrays.res_numbers[r]),
            arrays.res_icodes[r],
            arrays.atom_names[a],
        )
        table[key] = a
    return table


def _cross_chain_residue_contacts(arrays: StructureArrays, chain1: str, chain2: str, cutoff: float) -> set[tuple]:
    """Unordered set of ((chain, num, icode), (chain, num, icode)) contact pairs."""
    c1 = arrays.chain_ids.index(chain1)
    c2 = arrays.chain_ids.index(chain2)
    atom_chain = arrays.atom_chain
    sel1 = np.flatnonzero(atom_chain == c1)
    sel2 = np.flatnonzero(atom_chain == c2)
    tree1 = cKDTree(arrays.positions[sel1])
    tree2 = cKDTree(arrays.positions[sel2])
    pairs = tree1.query_ball_tree(tree2, cutoff)

    def res_key(a: int) -> tuple:
        r = arrays.atom_residue[a]
        return (arrays.chain_ids[arrays.res_chain[r]], int(arrays.res_numbers[r]), arrays.res_icodes[r])

    contacts = set()
    for i, neighbors in enumerate(pairs):
        if not neighbors:
            continue
        k1 = res_key(sel1[i])
        for j in neighbors:
            contacts.add((k1, res_key(sel2[j])))
    return contacts


class _ReferenceBundle:
    """Everything decoy-independent about a native structure: the parsed
    arrays, the atom lookup table, the interface zone, and the native
    contact set. The in-memory analog of the reference's ``<ref>.lzone`` /
    ``.izone`` file cache (reference tools/target.py:107-110) — scoring
    hundreds of decoys of one complex parses and zones the native once."""

    def __init__(self, arrays: StructureArrays):
        if arrays.num_chains < 2:  # noqa: PLR2004 — same message as StructureSimilarity
            msg = "Both structures need at least two chains for interface scores."
            raise ValueError(msg)
        self.arrays = arrays
        self.atom_table = _atom_key_table(arrays)
        chain1, chain2 = arrays.chain_ids[:2]
        self.native_contacts = _cross_chain_residue_contacts(arrays, chain1, chain2, FNAT_CUTOFF)
        izone_contacts = _cross_chain_residue_contacts(arrays, chain1, chain2, IZONE_CUTOFF)
        self.izone = {k for pair in izone_contacts for k in pair}


_REF_CACHE: dict[str, _ReferenceBundle] = {}
_REF_CACHE_MAX = 16


def reference_bundle(ref_path: str) -> _ReferenceBundle:
    """Cached :class:`_ReferenceBundle` for a native-structure path."""
    bundle = _REF_CACHE.get(ref_path)
    if bundle is None:
        if len(_REF_CACHE) >= _REF_CACHE_MAX:
            _REF_CACHE.pop(next(iter(_REF_CACHE)))
        bundle = _ReferenceBundle(parse_pdb(ref_path))
        _REF_CACHE[ref_path] = bundle
    return bundle


class StructureSimilarity:
    """Compares a docking decoy against the native (reference) structure."""

    def __init__(self, decoy_path: str, ref_path: str, enforce_residue_matching: bool = False):  # noqa: ARG002
        self.decoy = parse_pdb(decoy_path) if isinstance(decoy_path, str) else decoy_path
        if isinstance(ref_path, str):
            bundle = reference_bundle(ref_path)
            self.ref = bundle.arrays
            self._ref_bundle = bundle
        else:
            self.ref = ref_path
            self._ref_bundle = None
        if self.ref.num_chains < 2 or self.decoy.num_chains < 2:  # noqa: PLR2004
            msg = "Both structures need at least two chains for interface scores."
            raise ValueError(msg)
        self._decoy_atoms = _atom_key_table(self.decoy)
        self._ref_atoms = self._ref_bundle.atom_table if self._ref_bundle else _atom_key_table(self.ref)

    # ------------------------------------------------------------------
    def _matched_backbone(self, residue_filter=None) -> tuple[np.ndarray, np.ndarray, list[tuple]]:
        """Matched decoy/ref backbone coordinate arrays (+ their residue keys)."""
        decoy_pos, ref_pos, keys = [], [], []
        for key, ref_idx in self._ref_atoms.items():
            chain, num, icode, name = key
            if name not in BACKBONE_ATOMS:
                continue
            if residue_filter is not None and (chain, num, icode) not in residue_filter:
                continue
            decoy_idx = self._decoy_atoms.get(key)
            if decoy_idx is None:
                continue
            decoy_pos.append(self.decoy.positions[decoy_idx])
            ref_pos.append(self.ref.positions[ref_idx])
            keys.append(key)
        return np.asarray(decoy_pos), np.asarray(ref_pos), keys

    def compute_izone(self, cutoff: float = IZONE_CUTOFF) -> set[tuple]:
        """Interface residues of the reference: any cross-chain atom within cutoff."""
        if self._ref_bundle is not None and cutoff == IZONE_CUTOFF:
            return self._ref_bundle.izone
        chain1, chain2 = self.ref.chain_ids[:2]
        contacts = _cross_chain_residue_contacts(self.ref, chain1, chain2, cutoff)
        zone = set()
        for k1, k2 in contacts:
            zone.add(k1)
            zone.add(k2)
        return zone

    def compute_irmsd_fast(self, method: str = "svd", izone=None, cutoff: float = IZONE_CUTOFF) -> float:  # noqa: ARG002
        """Interface RMSD: minimal backbone RMSD over reference interface residues."""
        zone = izone if izone is not None else self.compute_izone(cutoff)
        decoy_pos, ref_pos, _ = self._matched_backbone(residue_filter=zone)
        if len(decoy_pos) == 0:
            msg = "No matched interface backbone atoms between decoy and reference."
            raise ValueError(msg)
        return superposed_rmsd(decoy_pos, ref_pos)

    def compute_lrmsd_fast(self, method: str = "svd", lzone=None) -> float:  # noqa: ARG002
        """Ligand RMSD: superpose on receptor backbone, RMSD of ligand backbone.

        Receptor = first chain, ligand = second chain (pdb2sql convention).
        """
        receptor, ligand = self.ref.chain_ids[:2]
        decoy_pos, ref_pos, keys = self._matched_backbone()
        chains = np.array([k[0] for k in keys])
        rec = chains == receptor
        lig = chains == ligand
        if rec.sum() == 0 or lig.sum() == 0:
            msg = "Missing receptor or ligand backbone atoms."
            raise ValueError(msg)
        rot, trans = superpose(decoy_pos[rec], ref_pos[rec])
        moved = decoy_pos[lig] @ rot.T + trans
        return rmsd(moved, ref_pos[lig])

    def compute_fnat_fast(self, cutoff: float = FNAT_CUTOFF) -> float:
        """Fraction of native cross-chain residue contacts preserved in the decoy."""
        chain1, chain2 = self.ref.chain_ids[:2]
        if self._ref_bundle is not None and cutoff == FNAT_CUTOFF:
            native = self._ref_bundle.native_contacts
        else:
            native = _cross_chain_residue_contacts(self.ref, chain1, chain2, cutoff)
        decoy = _cross_chain_residue_contacts(self.decoy, chain1, chain2, cutoff)
        if not native:
            msg = "Reference structure has no cross-chain contacts."
            raise ValueError(msg)
        return len(native & decoy) / len(native)

    @staticmethod
    def compute_DockQScore(fnat: float, lrmsd: float, irmsd: float, d_lrmsd: float = 8.5, d_irmsd: float = 1.5) -> float:  # noqa: N802
        """DockQ (Basu & Wallner 2016)."""

        def scale(rms: float, d: float) -> float:
            return 1.0 / (1.0 + (rms / d) ** 2)

        return (fnat + scale(lrmsd, d_lrmsd) + scale(irmsd, d_irmsd)) / 3.0
