"""Rigid-body docking-decoy generation for accuracy/parity corpora.

The reference's benchmark protocol labels docking models against their bound
native with ``StructureSimilarity`` (reference deeprank2/tools/target.py:
80-123); its test corpus ships only four pre-made 1ATN decoys. This module
manufactures arbitrarily many decoys offline by rigid-body perturbation of
one chain — graded rotation + translation magnitudes sweep the models from
near-native (irmsd < 1 Å) to incorrect (irmsd > 10 Å), so the derived
``binary = irmsd < 4`` labels are class-balanced and every docking metric
(lrmsd/irmsd/fnat/dockq/capri) takes informative values.

Perturbation is applied at the PDB **text** level: only the coordinate
columns (31-54) of the moved chain's ATOM/HETATM records change; every other
byte of the file is preserved, so the decoys stay atom-for-atom matchable
with the native (the similarity module matches by (chain, residue number,
insertion code, atom name)).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def _rotation_matrix(axis: np.ndarray, angle_rad: float) -> np.ndarray:
    """Rodrigues rotation about a unit axis."""
    axis = axis / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle_rad) * k + (1.0 - np.cos(angle_rad)) * (k @ k)


def perturb_chain(pdb_path: str | Path, out_path: str | Path, chain_id: str, angle_deg: float, translation: np.ndarray, seed: int = 0) -> None:
    """Write a copy of ``pdb_path`` with ``chain_id`` rigidly moved: rotated
    ``angle_deg`` about a seed-deterministic axis through the chain's
    centroid, then shifted by ``translation`` (Å)."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    rot = _rotation_matrix(axis, np.deg2rad(angle_deg))

    lines = Path(pdb_path).read_text().splitlines(keepends=True)
    coords, idxs = [], []
    for i, line in enumerate(lines):
        if line.startswith(("ATOM  ", "HETATM")) and len(line) >= 54 and line[21] == chain_id:
            coords.append([float(line[30:38]), float(line[38:46]), float(line[46:54])])
            idxs.append(i)
    if not coords:
        msg = f"chain {chain_id!r} has no ATOM records in {pdb_path}"
        raise ValueError(msg)
    pos = np.asarray(coords)
    center = pos.mean(axis=0)
    moved = (pos - center) @ rot.T + center + np.asarray(translation, dtype=np.float64)

    for j, i in enumerate(idxs):
        line = lines[i]
        x, y, z = moved[j]
        lines[i] = f"{line[:30]}{x:8.3f}{y:8.3f}{z:8.3f}{line[54:]}"
    Path(out_path).write_text("".join(lines))


def rigid_body_decoys(
    pdb_path: str | Path,
    chain_id: str,
    out_dir: str | Path,
    count: int = 25,
    seed: int = 0,
    max_angle_deg: float = 50.0,
    max_translation: float = 12.0,
) -> list[str]:
    """Generate ``count`` graded rigid-body decoys of ``pdb_path`` by moving
    ``chain_id``; decoy ``i`` gets magnitude ``(i+1)/count`` of the maximum
    rotation/translation (plus a seed-deterministic direction), so the set
    sweeps near-native -> incorrect. Files are cached: an existing decoy file
    is not rewritten (generation is deterministic in (seed, i)).

    Returns the decoy paths (``<stem>_rb<i>.pdb`` under ``out_dir``).
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(pdb_path).stem
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(count):
        out = out_dir / f"{stem}_rb{i}.pdb"
        direction = rng.normal(size=3)  # drawn unconditionally: keeps the stream aligned with cache hits
        direction /= np.linalg.norm(direction)
        if not out.exists():
            frac = (i + 1) / count
            perturb_chain(
                pdb_path,
                out,
                chain_id,
                angle_deg=frac * max_angle_deg,
                translation=frac * max_translation * direction,
                seed=seed * 10_000 + i,
            )
        paths.append(str(out))
    return paths
