"""Forcefield file-format parsers and the vectorized ``AtomicForcefield`` lookup.

The default forcefield (OPLS-like HADDOCK ``protein-allhdg5`` parameters, the
same physical data the reference ships in deeprank2/domain/forcefield/) is
bundled as a pre-converted JSON table; the parsers below let users load their
own CNS/HADDOCK-format files instead.

Semantics notes vs the reference (deeprank2/utils/parsing/__init__.py:16-111):
- residue-class patches (NTER/CTER/...) override topology charges and vdW types.
  The reference applies a matching patch action to *every* atom of the residue,
  ignoring the action's atom selection (``get_charge`` never compares
  ``action.selection.atom_name`` to the atom) — a reference bug. We apply patch
  actions only to the atom they name, which is the physically correct behavior.
- unknown atoms get charge 0.0 and vdW (0,0,0,0) with a warning, like the
  reference.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from enum import Enum
from typing import IO

import numpy as np

_log = logging.getLogger(__name__)

_DEFAULT_FORCEFIELD_JSON = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "domain",
    "forcefield",
    "opls_allhdg.json",
)


@dataclass
class VanderwaalsParam:
    """Lennard-Jones parameters for one atom type (main + 1-4 variants)."""

    epsilon_main: float = 0.0
    sigma_main: float = 0.0
    epsilon_14: float = 0.0
    sigma_14: float = 0.0

    def as_tuple(self) -> tuple[float, float, float, float]:
        return (self.epsilon_main, self.sigma_main, self.epsilon_14, self.sigma_14)


class PatchActionType(Enum):
    MODIFY = 1
    ADD = 2
    DELETE = 3


@dataclass
class PatchAction:
    """One action of a residue patch: modify/add an atom's type and/or charge."""

    residue_class: str
    action: PatchActionType
    atom_name: str
    type_: str | None
    charge: float | None


@dataclass
class ResidueClassCriterium:
    """Criteria deciding whether a residue belongs to a patch class (e.g. NTER)."""

    class_name: str
    amino_acid_names: str | list[str]  # "all" or explicit three-letter codes
    present_atom_names: list[str]
    absent_atom_names: list[str]

    def matches(self, amino_acid_name: str, atom_names: list[str]) -> bool:
        if self.amino_acid_names != "all" and amino_acid_name not in self.amino_acid_names:
            return False
        if any(name in atom_names for name in self.absent_atom_names):
            return False
        return all(name in atom_names for name in self.present_atom_names)


class TopParser:
    """Parses CNS residue-topology lines: ``RES atom NAME type=T charge=Q end``.

    Returns a dict ``(residue_name, atom_name) -> {"type": str, "charge": float}``.
    """

    @staticmethod
    def parse(file_: IO[str]) -> dict[tuple[str, str], dict]:
        import re

        result: dict[tuple[str, str], dict] = {}
        for raw in file_:
            line = raw.split("!")[0].strip()
            if not line:
                continue
            line = re.sub(r"\s*=\s*", "=", line)  # collapse whitespace around '='
            tokens = line.split()
            if len(tokens) < 3 or tokens[1].lower() != "atom":
                msg = f"Unmatched top line: {raw}"
                raise ValueError(msg)
            residue_name = tokens[0].upper()
            atom_name = tokens[2].upper()
            fields: dict = {}
            for token in tokens[3:]:
                if token.lower() == "end":
                    break
                if "=" not in token:
                    continue
                key, value = token.split("=", 1)
                value = value.strip("()")
                try:
                    fields[key.lower()] = float(value)
                except ValueError:
                    fields[key.lower()] = value
            result[(residue_name, atom_name)] = fields
        return result


class ParamParser:
    """Parses CNS non-bonded parameter lines: ``NONBonded TYPE eps sigma eps14 sigma14``."""

    @staticmethod
    def parse(file_: IO[str]) -> dict[str, VanderwaalsParam]:
        result: dict[str, VanderwaalsParam] = {}
        for raw in file_:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            tokens = line.split()
            if tokens[0] != "NONBonded":
                msg = f"Unparsable param line: {raw}"
                raise ValueError(msg)
            _, type_, eps, sig, eps14, sig14 = tokens[:6]
            result[type_] = VanderwaalsParam(float(eps), float(sig), float(eps14), float(sig14))
        return result


class PatchParser:
    """Parses patch lines: ``CLASS ACTION ATOM NAME [TYPE=T] [CHARGE=Q]``."""

    @staticmethod
    def parse(file_: IO[str]) -> list[PatchAction]:
        import re

        result: list[PatchAction] = []
        for raw in file_:
            line = raw.strip()
            if not line or line.startswith(("#", "!")):
                continue
            line = re.sub(r"\s*=\s*", "=", line)
            tokens = line.split()
            if len(tokens) < 4 or tokens[2].upper() != "ATOM":
                msg = f"Unmatched patch action: {raw!r}"
                raise ValueError(msg)
            residue_class = tokens[0]
            try:
                action = PatchActionType[tokens[1].upper()]
            except KeyError as e:
                msg = f"Unmatched residue action: {tokens[1]!r}"
                raise ValueError(msg) from e
            atom_name = tokens[3]
            type_: str | None = None
            charge: float | None = None
            for token in tokens[4:]:
                if "=" not in token:
                    continue
                key, value = token.split("=", 1)
                if key.upper() == "TYPE":
                    type_ = value
                elif key.upper() == "CHARGE":
                    charge = float(value)
            result.append(PatchAction(residue_class, action, atom_name, type_, charge))
        return result


class ResidueClassParser:
    """Parses residue-class lines: ``CLASS: name=ALL|RES present(A, B) absent(C)``."""

    @staticmethod
    def parse(file_: IO[str]) -> list[ResidueClassCriterium]:
        result: list[ResidueClassCriterium] = []
        for raw in file_:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            head, _, rest = line.partition(":")
            class_name = head.strip()
            present: list[str] = []
            absent: list[str] = []
            names: str | list[str] = "all"
            # split "name=... present(...) absent(...)" clauses
            rest = rest.replace("(", " ( ").replace(")", " ) ")
            tokens = rest.split()
            i = 0
            while i < len(tokens):
                token = tokens[i]
                if token.startswith("name="):
                    value = token[len("name=") :].strip()
                    names = "all" if value.lower() == "all" else [v.strip() for v in value.split(",")]
                elif token in ("present", "absent"):
                    target = present if token == "present" else absent
                    assert tokens[i + 1] == "("
                    i += 2
                    while tokens[i] != ")":
                        target.append(tokens[i].rstrip(","))
                        i += 1
                i += 1
            result.append(ResidueClassCriterium(class_name, names, present, absent))
        return result


class AtomicForcefield:
    """Charge and Lennard-Jones parameter lookup for protein atoms.

    Loads either a pre-converted JSON table (default: bundled OPLS/allhdg data)
    or raw CNS/HADDOCK files via the parsers above. The work-horse API is
    :meth:`assign`, which annotates a whole ``StructureArrays`` in one pass and
    returns dense per-atom parameter columns for the vectorized physics kernels.
    """

    def __init__(
        self,
        top_rows: dict[tuple[str, str], dict] | None = None,
        patch_actions: list[PatchAction] | None = None,
        residue_classes: list[ResidueClassCriterium] | None = None,
        vdw_params: dict[str, VanderwaalsParam] | None = None,
        json_path: str | None = None,
    ):
        if top_rows is None:
            data = json.load(open(json_path or _DEFAULT_FORCEFIELD_JSON, encoding="utf-8"))
            top_rows = {(res, atom): fields for res, atoms in data["topology"].items() for atom, fields in atoms.items()}
            patch_actions = [
                PatchAction(
                    p["class"],
                    PatchActionType[p["action"]],
                    p["atom"],
                    p.get("type"),
                    p.get("charge"),
                )
                for p in data["patches"]
            ]
            residue_classes = [
                ResidueClassCriterium(c["name"], c["amino_acids"], c["present"], c["absent"]) for c in data["residue_classes"]
            ]
            vdw_params = {t: VanderwaalsParam(*v) for t, v in data["vdw"].items()}

        self._top_rows = top_rows
        self._patch_actions = patch_actions or []
        self._residue_class_criteria = residue_classes or []
        self._vanderwaals_parameters = vdw_params or {}

    @classmethod
    def from_files(cls, top_path: str, param_path: str, patch_path: str | None = None, residue_class_path: str | None = None) -> AtomicForcefield:
        with open(top_path, encoding="utf-8") as f:
            top_rows = TopParser.parse(f)
        with open(param_path, encoding="utf-8") as f:
            vdw = ParamParser.parse(f)
        patches: list[PatchAction] = []
        if patch_path:
            with open(patch_path, encoding="utf-8") as f:
                patches = PatchParser.parse(f)
        classes: list[ResidueClassCriterium] = []
        if residue_class_path:
            with open(residue_class_path, encoding="utf-8") as f:
                classes = ResidueClassParser.parse(f)
        return cls(top_rows, patches, classes, vdw)

    def to_json(self, path: str) -> None:
        """Serialize to the bundled-JSON schema."""
        topology: dict[str, dict[str, dict]] = {}
        for (res, atom), fields in self._top_rows.items():
            topology.setdefault(res, {})[atom] = fields
        data = {
            "topology": topology,
            "patches": [
                {
                    "class": p.residue_class,
                    "action": p.action.name,
                    "atom": p.atom_name,
                    **({"type": p.type_} if p.type_ is not None else {}),
                    **({"charge": p.charge} if p.charge is not None else {}),
                }
                for p in self._patch_actions
            ],
            "residue_classes": [
                {
                    "name": c.class_name,
                    "amino_acids": c.amino_acid_names,
                    "present": c.present_atom_names,
                    "absent": c.absent_atom_names,
                }
                for c in self._residue_class_criteria
            ],
            "vdw": {t: list(v.as_tuple()) for t, v in self._vanderwaals_parameters.items()},
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=1)

    # ------------------------------------------------------------------
    # Per-residue patch-class resolution
    # ------------------------------------------------------------------
    def _find_matching_residue_class(self, amino_acid_code: str, atom_names: list[str]) -> str | None:
        for criterium in self._residue_class_criteria:
            if criterium.matches(amino_acid_code, atom_names):
                return criterium.class_name
        return None

    def _lookup(self, amino_acid_code: str | None, atom_name: str, residue_atom_names: list[str]) -> tuple[float | None, str | None]:
        """(charge, vdw_type) for one atom, applying topology then patches."""
        charge: float | None = None
        type_: str | None = None
        if amino_acid_code is not None:
            row = self._top_rows.get((amino_acid_code, atom_name))
            if row is not None:
                charge = float(row["charge"])
                type_ = row.get("type")
            residue_class = self._find_matching_residue_class(amino_acid_code, residue_atom_names)
            if residue_class is not None:
                for action in self._patch_actions:
                    if (
                        action.residue_class == residue_class
                        and action.action in (PatchActionType.MODIFY, PatchActionType.ADD)
                        and action.atom_name == atom_name
                    ):
                        if action.charge is not None:
                            charge = action.charge
                        if action.type_ is not None:
                            type_ = action.type_
        return charge, type_

    # ------------------------------------------------------------------
    # Object API (parity with reference AtomicForcefield)
    # ------------------------------------------------------------------
    def get_charge(self, atom) -> float:
        """Charge of one ``Atom`` view (reference: parsing/__init__.py:81-111)."""
        residue = atom.residue
        aa = residue.amino_acid
        code = aa.three_letter_code if aa is not None else None
        charge, _ = self._lookup(code, atom.name, [a.name for a in residue.atoms])
        if charge is None:
            _log.warning(f"Atom {atom} is unknown to the forcefield, charge set to 0.0.")
            return 0.0
        return charge

    def get_vanderwaals_parameters(self, atom) -> VanderwaalsParam:
        """LJ parameters of one ``Atom`` view (reference: parsing/__init__.py:44-79)."""
        residue = atom.residue
        aa = residue.amino_acid
        code = aa.three_letter_code if aa is not None else None
        _, type_ = self._lookup(code, atom.name, [a.name for a in residue.atoms])
        if type_ is None or type_ not in self._vanderwaals_parameters:
            _log.warning(f"Atom {atom} is unknown to the forcefield, vdW parameters set to 0.")
            return VanderwaalsParam()
        return self._vanderwaals_parameters[type_]

    # ------------------------------------------------------------------
    # Array API (the hot path)
    # ------------------------------------------------------------------
    def assign(self, arrays) -> dict[str, np.ndarray]:
        """Dense per-atom parameter columns for a whole ``StructureArrays``.

        Returns ``{"charge": [N], "eps_main": [N], "sig_main": [N],
        "eps_14": [N], "sig_14": [N]}`` float64 arrays. Results are cached on
        the structure and per-residue lookups are memoized by
        (aa code, atom-name set) — structures repeat the same 20 residue types.
        """
        cached = getattr(arrays, "_forcefield_params", None)
        if cached is not None and cached[0] is self:
            return cached[1]

        from deeprank2_tpu_torch.molstruct.aminoacid import AA_THREE_LETTER

        n = arrays.num_atoms
        charge = np.zeros(n, dtype=np.float64)
        vdw = np.zeros((n, 4), dtype=np.float64)

        residue_cache: dict[tuple, tuple] = {}
        for r in range(arrays.num_residues):
            start = int(arrays.res_atom_start[r])
            count = int(arrays.res_atom_count[r])
            aa_id = int(arrays.res_aa_ids[r])
            code = AA_THREE_LETTER[aa_id] if aa_id >= 0 else None
            names = tuple(arrays.atom_names[start : start + count])
            key = (code, names)
            hit = residue_cache.get(key)
            if hit is None:
                charges_r = np.zeros(count)
                vdw_r = np.zeros((count, 4))
                for offset, name in enumerate(names):
                    c, t = self._lookup(code, name, list(names))
                    if c is not None:
                        charges_r[offset] = c
                    if t is not None and t in self._vanderwaals_parameters:
                        vdw_r[offset] = self._vanderwaals_parameters[t].as_tuple()
                hit = (charges_r, vdw_r)
                residue_cache[key] = hit
            charge[start : start + count] = hit[0]
            vdw[start : start + count] = hit[1]

        params = {
            "charge": charge,
            "eps_main": vdw[:, 0],
            "sig_main": vdw[:, 1],
            "eps_14": vdw[:, 2],
            "sig_14": vdw[:, 3],
        }
        arrays._forcefield_params = (self, params)
        return params


_atomic_forcefield: AtomicForcefield | None = None


def __getattr__(name: str):
    """Lazy singleton: the default forcefield JSON is only loaded on first use."""
    if name == "atomic_forcefield":
        global _atomic_forcefield
        if _atomic_forcefield is None:
            _atomic_forcefield = AtomicForcefield()
        return _atomic_forcefield
    msg = f"module {__name__!r} has no attribute {name!r}"
    raise AttributeError(msg)
