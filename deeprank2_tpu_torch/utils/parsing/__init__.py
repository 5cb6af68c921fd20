"""Parsers for CNS/HADDOCK-style forcefield file formats and PSSM files.

Covers the four formats the reference consumes (reference:
deeprank2/utils/parsing/{top,vdwparam,patch,residue}.py): residue topology
(``*.top``), non-bonded parameters (``*.param``), terminal/special patches
(``patch.top``) and residue-class criteria (``residue-classes``).
"""

from deeprank2_tpu_torch.utils.parsing.forcefield import (
    AtomicForcefield,
    ParamParser,
    PatchActionType,
    PatchParser,
    ResidueClassParser,
    TopParser,
    VanderwaalsParam,
)
from deeprank2_tpu_torch.utils.parsing.pssm import parse_pssm


def __getattr__(name: str):
    """Lazily expose the default forcefield singleton."""
    if name == "atomic_forcefield":
        from deeprank2_tpu_torch.utils.parsing import forcefield

        return forcefield.atomic_forcefield
    msg = f"module {__name__!r} has no attribute {name!r}"
    raise AttributeError(msg)

__all__ = [
    "AtomicForcefield",
    "ParamParser",
    "PatchActionType",
    "PatchParser",
    "ResidueClassParser",
    "TopParser",
    "VanderwaalsParam",
    "atomic_forcefield",
    "parse_pssm",
]
