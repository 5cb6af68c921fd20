"""Solvent-accessible surface area (Shrake-Rupley) in vectorized numpy.

Replaces the freesasa C dependency (reference: deeprank2/features/surfacearea.py).
Like freesasa's default setup, hydrogens are excluded and a 1.4 Å probe is
used; radii follow the ProtOr-like per-element values. The C++ kernel
(csrc/sasa.cpp) computes it; ``shrake_rupley_ref`` is its numpy plain version.

Also provides surface point sampling used as the MSMS-surface replacement for
residue-depth (features/exposure.py).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

PROBE_RADIUS = 1.4

# per-element vdW radii (Å), ProtOr-flavored
ELEMENT_RADII = {
    1: 1.80,  # C
    2: 1.40,  # O
    3: 1.60,  # N
    4: 1.85,  # S
    5: 1.80,  # P
    6: 0.00,  # H (excluded)
}

_N_SPHERE_POINTS = 256


def _fibonacci_sphere(n: int) -> np.ndarray:
    """[n, 3] quasi-uniform points on the unit sphere."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    golden = np.pi * (1.0 + np.sqrt(5.0))
    theta = golden * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=1,
    )


_SPHERE = _fibonacci_sphere(_N_SPHERE_POINTS)


def atom_radii(elements: np.ndarray) -> np.ndarray:
    """vdW radius per atom from element ids (H -> 0, excluded)."""
    radii = np.zeros(len(elements), dtype=np.float64)
    for element_value, r in ELEMENT_RADII.items():
        radii[elements == element_value] = r
    return radii


def shrake_rupley(
    positions: np.ndarray,
    radii: np.ndarray,
    n_points: int = _N_SPHERE_POINTS,
    probe_radius: float = PROBE_RADIUS,
    return_points: bool = False,
    compute_mask: np.ndarray | None = None,
):
    """Per-atom SASA (Å^2) for atoms with positive radius.

    Runs the C++ cell-list kernel (csrc/sasa.cpp, built with ``g++`` at its
    first use; a failed build raises). :func:`shrake_rupley_ref` is its numpy
    plain version (identical results).

    Args:
        positions: [N, 3] atom coordinates.
        radii: [N] vdW radii; atoms with radius <= 0 are ignored entirely.
        n_points: sphere test points per atom.
        probe_radius: solvent probe radius.
        return_points: also return the exposed surface points [P, 3]
            (the solvent-accessible surface point cloud).
        compute_mask: optional [N] bool — compute areas only for flagged
            atoms (all atoms still occlude, so flagged values are identical
            to a full run; the rest stay 0).

    Returns:
        areas [N] (zero for ignored atoms), and optionally the exposed points.
    """
    sphere = _SPHERE if n_points == _N_SPHERE_POINTS else _fibonacci_sphere(n_points)
    return _native_shrake_rupley(positions, radii, sphere, probe_radius, return_points, compute_mask)


def shrake_rupley_ref(
    positions: np.ndarray,
    radii: np.ndarray,
    n_points: int = _N_SPHERE_POINTS,
    probe_radius: float = PROBE_RADIUS,
    return_points: bool = False,
    compute_mask: np.ndarray | None = None,
):
    """The plain (numpy) version of :func:`shrake_rupley`, same arguments."""
    sphere = _SPHERE if n_points == _N_SPHERE_POINTS else _fibonacci_sphere(n_points)
    active = np.flatnonzero(radii > 0)  # occluder set: ALL positive-radius atoms
    areas = np.zeros(len(positions), dtype=np.float64)
    if active.size == 0:
        return (areas, np.zeros((0, 3))) if return_points else areas

    pos = positions[active]
    rad = radii[active] + probe_radius
    tree = cKDTree(pos)
    max_r = rad.max()

    exposed_points = [] if return_points else None
    targets = range(len(pos)) if compute_mask is None else np.flatnonzero(compute_mask[active])

    # neighbor lists once; per-atom vectorized occlusion test
    neighbor_lists = tree.query_ball_tree(tree, 2.0 * max_r)
    for k in targets:
        neighbors = [j for j in neighbor_lists[k] if j != k]
        test_points = pos[k] + rad[k] * sphere  # [P, 3]
        if neighbors:
            npos = pos[neighbors]
            nrad = rad[neighbors]
            d2 = ((test_points[:, None, :] - npos[None, :, :]) ** 2).sum(-1)  # [P, M]
            buried = (d2 < (nrad**2)[None, :]).any(axis=1)
        else:
            buried = np.zeros(len(test_points), dtype=bool)
        frac = 1.0 - buried.mean()
        areas[active[k]] = 4.0 * np.pi * rad[k] ** 2 * frac
        if return_points and (~buried).any():
            exposed_points.append(test_points[~buried])

    if return_points:
        points = np.concatenate(exposed_points) if exposed_points else np.zeros((0, 3))
        return areas, points
    return areas


def _native_shrake_rupley(positions, radii, sphere, probe_radius, return_points, compute_mask=None):
    """The C++ kernel (csrc/sasa.cpp); raises if it cannot be built."""
    import ctypes

    from deeprank2_tpu_torch.ops import _build

    lib = _build.host_library("sasa")

    n = len(positions)
    n_points = len(sphere)
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    radii = np.ascontiguousarray(radii, dtype=np.float64)
    sphere = np.ascontiguousarray(sphere, dtype=np.float64)
    areas = np.zeros(n, dtype=np.float64)

    dptr = ctypes.POINTER(ctypes.c_double)
    points_buf = np.zeros((n * n_points, 3), dtype=np.float64) if return_points else None
    count = ctypes.c_int64(0)
    mask_arr = None if compute_mask is None else np.ascontiguousarray(compute_mask, dtype=np.uint8)
    lib.sasa_compute(
        positions.ctypes.data_as(dptr),
        radii.ctypes.data_as(dptr),
        ctypes.c_int(n),
        sphere.ctypes.data_as(dptr),
        ctypes.c_int(n_points),
        ctypes.c_double(probe_radius),
        areas.ctypes.data_as(dptr),
        points_buf.ctypes.data_as(dptr) if return_points else None,
        ctypes.byref(count) if return_points else None,
        mask_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)) if mask_arr is not None else None,
    )
    if return_points:
        return areas, points_buf[: count.value].copy()
    return areas


def structure_sasa(arrays, atom_subset: np.ndarray | None = None) -> np.ndarray:
    """Per-atom SASA over a ``StructureArrays`` (or a subset of its atoms).

    Returns a full-length [num_atoms] array (zeros outside the subset).
    """
    positions = arrays.positions
    radii = atom_radii(np.asarray(arrays.elements))
    if atom_subset is not None:
        mask = np.zeros(arrays.num_atoms, dtype=bool)
        mask[atom_subset] = True
        radii = np.where(mask, radii, 0.0)
    return shrake_rupley(positions, radii)


def surface_points(arrays) -> np.ndarray:
    """Solvent-accessible surface point cloud of the whole structure.

    The MSMS-surface stand-in for residue-depth (Bio.PDB ResidueDepth parity
    up to the SAS/SES difference — distances are offset by roughly the probe
    radius, which is uniform and harmless for a learned feature).
    """
    radii = atom_radii(np.asarray(arrays.elements))
    _, points = shrake_rupley(arrays.positions, radii, n_points=64, return_points=True)
    return points
