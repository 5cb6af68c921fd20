"""Residue depth and half-sphere exposure node features (reference: features/exposure.py).

- ``res_depth``: mean distance of the residue's atoms to the nearest
  molecular-surface point. The reference uses Bio.PDB ResidueDepth over an
  MSMS SES; the default here is the in-repo SAS point cloud (utils/sasa.py),
  which sits one probe radius outside the SES — so the probe radius is
  subtracted from the SAS distances (floored at 0) to approximate SES depth.
  ``set_depth_method("ses_edt")`` switches to the exact grid-EDT SES
  (utils/ses.py, MSMS-faithful including reentrant surface, ~1 s/structure
  slower). No external binary and no 20 s SIGALRM timeout to need.
- ``hse``: half-sphere exposure (Hamelryck 2005) from CA-only coordinates
  (Bio.PDB HSExposureCA semantics): a pseudo-CB direction from the two chain
  neighbors splits a 12 Å sphere; counts of CA atoms in the upper/lower halves
  plus the pseudo-CB/CB angle. Chain-terminal residues get (0, 0, 0).
  ``set_hse_method("atomic")`` switches to an atomic-resolution variant
  (extension beyond the reference) that counts every other-residue atom
  instead of CA atoms only.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from deeprank2_tpu_torch.domain import nodestorage as Nfeat
from deeprank2_tpu_torch.utils.graph import Graph
from deeprank2_tpu_torch.utils.sasa import surface_points

HSE_RADIUS = 12.0

_DEPTH_METHOD = "sas_offset"
_HSE_METHOD = "ca"


def set_hse_method(name: str) -> None:
    """Half-sphere-exposure backend: "ca" (default; Bio.PDB HSExposureCA
    parity — neighbor CA atoms counted in each half sphere) or "atomic"
    (extension beyond the reference: ALL atoms of other residues are counted,
    resolving burial differences between residues whose CA environments
    match; same pseudo-CB splitting plane and 12 Å radius)."""
    global _HSE_METHOD
    if name not in ("ca", "atomic"):
        msg = f"unknown hse method: {name}"
        raise ValueError(msg)
    _HSE_METHOD = name


def set_depth_method(name: str) -> None:
    """Residue-depth backend: "sas_offset" (default, fast SAS-point-cloud
    approximation) or "ses_edt" (exact grid-EDT solvent-excluded surface)."""
    global _DEPTH_METHOD
    if name not in ("sas_offset", "ses_edt"):
        msg = f"unknown depth method: {name}"
        raise ValueError(msg)
    _DEPTH_METHOD = name


def _ca_table(arrays) -> tuple[np.ndarray, np.ndarray]:
    """(residue indices with a CA, CA positions) in residue order."""
    from deeprank2_tpu_torch.utils.secstructure import first_atom_per_residue

    first = first_atom_per_residue(arrays, ("CA",))["CA"]
    res_ids = np.flatnonzero(first >= 0)
    return res_ids, arrays.positions[first[res_ids]].astype(np.float64).reshape(-1, 3)


def compute_hse(arrays) -> dict[int, tuple[float, float, float]]:
    """(hse_up, hse_down, pseudo-CB angle) per residue index (vectorized)."""
    ca_res, ca_pos = _ca_table(arrays)
    num_ca = len(ca_res)
    if num_ca < 3:  # noqa: PLR2004
        return {}
    res_chain = arrays.res_chain

    # pseudo-CB direction for interior residues with same-chain neighbors
    d1 = ca_pos[:-2] - ca_pos[1:-1]
    d3 = ca_pos[2:] - ca_pos[1:-1]
    n1 = np.linalg.norm(d1, axis=1)
    n3 = np.linalg.norm(d3, axis=1)
    ok = (n1 > 0) & (n3 > 0)
    pcb = np.zeros((num_ca, 3))
    pcb[1:-1][ok] = -(d1[ok] / n1[ok, None] + d3[ok] / n3[ok, None])
    pnorm = np.linalg.norm(pcb, axis=1)
    same_chain = np.zeros(num_ca, dtype=bool)
    same_chain[1:-1] = (res_chain[ca_res[:-2]] == res_chain[ca_res[1:-1]]) & (res_chain[ca_res[2:]] == res_chain[ca_res[1:-1]])
    valid = same_chain & (pnorm > 0)
    pcb[valid] = pcb[valid] / pnorm[valid, None]

    # count neighbors in the upper/lower half spheres
    up = np.zeros(num_ca)
    down = np.zeros(num_ca)
    if _HSE_METHOD == "atomic":
        # extension: every atom of OTHER residues within the sphere counts.
        # One batched ball query over the valid residues only (invalid ones
        # are dropped from the returned dict anyway).
        atom_tree = cKDTree(arrays.positions.astype(np.float64))
        atom_res = arrays.atom_residue
        query_idx = np.flatnonzero(valid)
        if len(query_idx):
            neigh_lists = atom_tree.query_ball_point(ca_pos[query_idx], HSE_RADIUS, workers=-1)
            for k, neigh in zip(query_idx, neigh_lists, strict=True):
                neigh = np.asarray(neigh, dtype=np.int64)
                neigh = neigh[atom_res[neigh] != ca_res[k]]
                if len(neigh) == 0:
                    continue
                side = ((arrays.positions[neigh].astype(np.float64) - ca_pos[k]) * pcb[k]).sum(axis=1) > 0
                up[k] = side.sum()
                down[k] = len(side) - side.sum()
    else:
        tree = cKDTree(ca_pos)
        pairs = tree.query_pairs(HSE_RADIUS, output_type="ndarray")  # i < j
        if len(pairs):
            i, j = pairs[:, 0], pairs[:, 1]
            direction = ca_pos[j] - ca_pos[i]
            side_i = (pcb[i] * direction).sum(axis=1) > 0  # j seen from i
            side_j = (pcb[j] * -direction).sum(axis=1) > 0  # i seen from j
            np.add.at(up, i, side_i)
            np.add.at(down, i, ~side_i)
            np.add.at(up, j, side_j)
            np.add.at(down, j, ~side_j)

    # angle between pseudo-CB and the actual CB-CA direction (0 if no CB)
    from deeprank2_tpu_torch.utils.secstructure import first_atom_per_residue

    valid_idx = np.flatnonzero(valid)
    first_cb = first_atom_per_residue(arrays, ("CB",))["CB"][ca_res[valid_idx]]
    angles = np.zeros(len(valid_idx))
    has_cb = first_cb >= 0
    if has_cb.any():
        cb = arrays.positions[first_cb[has_cb]].astype(np.float64) - ca_pos[valid_idx[has_cb]]
        cb_norm = np.linalg.norm(cb, axis=1)
        cos = np.zeros(len(cb))
        ok_cb = cb_norm > 0
        cos[ok_cb] = (pcb[valid_idx[has_cb]][ok_cb] * (cb[ok_cb] / cb_norm[ok_cb, None])).sum(axis=1)
        a = np.zeros(len(cb))
        a[ok_cb] = np.arccos(np.clip(cos[ok_cb], -1.0, 1.0))
        angles[has_cb] = a

    return {int(ca_res[i]): (float(up[i]), float(down[i]), float(angles[k])) for k, i in enumerate(valid_idx)}


def add_features(
    pdb_path: str,  # noqa: ARG001 (structure already parsed)
    graph: Graph,
    single_amino_acid_variant=None,  # noqa: ARG001
) -> None:  # noqa: D103
    sa = graph.arrays
    res_idx = graph.node_residue_indices
    if _DEPTH_METHOD == "ses_edt":
        from deeprank2_tpu_torch.utils.sasa import atom_radii
        from deeprank2_tpu_torch.utils.ses import atom_ses_depth

        atom_depth = atom_ses_depth(sa.positions, atom_radii(np.asarray(sa.elements)))
        depth_atoms = np.arange(sa.num_atoms)
    else:
        surface = surface_points(sa)
        if len(surface) == 0:
            msg = "Empty solvent-accessible surface; cannot compute residue depth."
            raise ValueError(msg)
        surface_tree = cKDTree(surface)

        # residue depth per residue: mean over its atoms' nearest-surface
        # distances, queried only for the graph residues' atoms (the only
        # ones read below). SAS points sit one probe radius outside the
        # SES -> subtract it (floor 0) to approximate MSMS SES depth.
        from deeprank2_tpu_torch.utils.sasa import PROBE_RADIUS

        need = np.zeros(sa.num_atoms, dtype=bool)
        for r in np.unique(res_idx):
            start = int(sa.res_atom_start[r])
            need[start : start + int(sa.res_atom_count[r])] = True
        depth_atoms = np.flatnonzero(need)
        atom_depth, _ = surface_tree.query(sa.positions[depth_atoms], k=1)
        atom_depth = np.maximum(atom_depth - PROBE_RADIUS, 0.0)
    res_depth = np.zeros(sa.num_residues, dtype=np.float64)
    np.add.at(res_depth, sa.atom_residue[depth_atoms], atom_depth)
    res_depth = res_depth / np.maximum(sa.res_atom_count, 1)

    hse = compute_hse(sa)
    graph.node_features[Nfeat.RESDEPTH] = res_depth[res_idx]
    hse_matrix = np.zeros((graph.num_nodes, 3), dtype=np.float64)
    for v, r in enumerate(res_idx):
        if int(r) in hse:
            hse_matrix[v] = hse[int(r)]
    graph.node_features[Nfeat.HSE] = hse_matrix
