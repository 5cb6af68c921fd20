"""Grid-based solvent-excluded surface (SES) residue depth.

MSMS replacement for exact residue depth (reference:
deeprank2/features/exposure.py:10-11,52 runs Bio.PDB ``ResidueDepth`` over an
MSMS reduced surface).  The default depth feature uses the faster SAS-offset
approximation (utils/sasa.py:surface_points); this module provides the exact
SES via an EDTSurf-style Euclidean distance transform:

1. stamp every atom's probe-inflated sphere (r_i + probe) onto a boolean
   voxel grid -> the region where a probe *center* cannot sit;
2. the EDT of that region gives each voxel's distance to the nearest legal
   probe-center position; voxels farther than ``probe`` are solvent-excluded
   interior (a probe sphere can never touch them) — this reproduces both the
   contact and the reentrant (rolling) parts of the SES;
3. a second EDT over the interior measures each interior voxel's distance to
   the SES boundary = its depth; atoms sample this field at their position.

Accuracy is O(spacing); the default 0.75 Å tracks MSMS-style depths well
below the feature's learned-signal scale (test oracle: isolated spheres,
where SES depth at the center is exactly the vdW radius).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from deeprank2_tpu_torch.utils.sasa import PROBE_RADIUS

DEFAULT_SPACING = 0.75


def atom_ses_depth(
    positions: np.ndarray,
    radii: np.ndarray,
    probe_radius: float = PROBE_RADIUS,
    spacing: float = DEFAULT_SPACING,
) -> np.ndarray:
    """Distance (Å) from each atom position to the solvent-excluded surface.

    Atoms with ``radius <= 0`` (hydrogens) do not shape the surface but still
    get a depth sampled at their position (clipped at 0 outside the SES).
    """
    positions = np.asarray(positions, dtype=np.float64)
    radii = np.asarray(radii, dtype=np.float64)
    active = radii > 0
    if not active.any():
        return np.zeros(len(positions), dtype=np.float64)
    pos = positions[active]
    rad = radii[active]

    margin = float(rad.max()) + probe_radius + 2.0 * spacing
    lo = pos.min(axis=0) - margin
    extent = pos.max(axis=0) + margin - lo
    # bound the voxel count (the EDT fields are f64): coarsen spacing for
    # very large complexes rather than allocating multi-GB grids
    max_voxels = 32e6
    min_spacing = float(np.cbrt(np.prod(extent) / max_voxels))
    spacing = max(spacing, min_spacing)
    shape = np.ceil(extent / spacing).astype(int) + 1

    # 1. stamp probe-inflated spheres, vectorized per unique radius
    blocked = np.zeros(shape, dtype=bool)
    for r_value in np.unique(rad):
        sel = rad == r_value
        inflated = r_value + probe_radius
        reach = int(np.ceil(inflated / spacing)) + 1
        axis = np.arange(-reach, reach + 1)
        offs = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), axis=-1).reshape(-1, 3)  # [K,3]
        # pre-filter the offset cube to the reachable ball (cuts K ~2x)
        offs = offs[(offs**2).sum(axis=1) * spacing**2 <= (inflated + spacing * np.sqrt(3.0)) ** 2]
        frac = (pos[sel] - lo) / spacing  # float voxel coords [M,3]
        base = np.floor(frac).astype(int)
        # exact per-atom distance test against the off-grid sphere center,
        # accumulated per axis in f32 (no [M,K,3] materialization)
        sub = ((frac - base) * spacing).astype(np.float32)  # [M,3]
        ogrid = (offs * spacing).astype(np.float32)  # [K,3]
        d2 = (ogrid[None, :, 0] - sub[:, None, 0]) ** 2
        d2 += (ogrid[None, :, 1] - sub[:, None, 1]) ** 2
        d2 += (ogrid[None, :, 2] - sub[:, None, 2]) ** 2
        m, k = np.nonzero(d2 <= np.float32(inflated**2))
        ijk = base[m] + offs[k]  # only the selected voxels
        blocked[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True

    # 2. SES interior: farther than one probe radius from any legal probe center
    dist_to_probe_center = ndimage.distance_transform_edt(blocked, sampling=spacing)
    interior = dist_to_probe_center > probe_radius

    # 3. depth field: interior distance to the SES boundary
    depth_field = ndimage.distance_transform_edt(interior, sampling=spacing)

    voxels = np.rint((positions - lo) / spacing).astype(int)
    voxels = np.clip(voxels, 0, np.asarray(shape) - 1)
    return depth_field[voxels[:, 0], voxels[:, 1], voxels[:, 2]]
