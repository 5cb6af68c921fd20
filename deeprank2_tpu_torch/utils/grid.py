"""3D-grid rasterization of point features.

Re-implements the reference's grid mapping (deeprank2/utils/grid.py) with a
batched formulation: the reference maps one point x one feature at a time over
the full grid (grid.py:272-311, the featurization hot loop); here all points are
mapped at once — the Gaussian map becomes ``values.T @ exp(-beta * D)``, one
matmul per feature block, chunked over points to bound memory.

Map methods (reference: grid.py:22-31):
- GAUSSIAN / FAST_GAUSSIAN: ``value * exp(-beta * distance)`` (fast variant
  truncated at 5 Å).
- BSP_LINE: cubic B-spline kernel on grid-resolution-scaled offsets. (The
  reference calls ``scipy.interpolate.BSpline(grid, order)`` which is not a
  valid constructor invocation; we implement the intended Cox-de Boor basis.)
- NEAREST_NEIGHBOURS: distributes the value over the 8 surrounding grid points
  with inverse-distance weights. (The reference's implementation compares the y
  and z axes against the x coordinate and weights *proportionally* to distance —
  grid.py:205-241 — which we treat as a bug and do not reproduce.)
"""

from __future__ import annotations

import itertools
import logging
from enum import Enum

import numpy as np

from deeprank2_tpu_torch.domain import gridstorage
from deeprank2_tpu_torch.utils.store import open_store

_log = logging.getLogger(__name__)

_POINT_CHUNK = 256  # points per kernel-matrix chunk (memory bound)


class MapMethod(Enum):
    """Grid mapping method."""

    GAUSSIAN = 1
    FAST_GAUSSIAN = 2
    BSP_LINE = 3
    NEAREST_NEIGHBOURS = 4


class Augmentation:
    """A rotation around an axis, applied to points before grid mapping."""

    def __init__(self, axis: np.ndarray, angle: float):
        self._axis = axis
        self._angle = angle

    @property
    def axis(self) -> np.ndarray:
        return self._axis

    @property
    def angle(self) -> float:
        return self._angle


def random_rotation_axis_angle(seed: int | None = None) -> tuple[np.ndarray, float]:
    """A uniformly random rotation axis and angle (replaces pdb2sql.transform.get_rot_axis_angle)."""
    rng = np.random.RandomState(seed)
    # uniform direction on the sphere
    angle1 = 2 * np.pi * rng.rand()
    z = 2 * rng.rand() - 1
    r = np.sqrt(1 - z * z)
    axis = np.array([r * np.cos(angle1), r * np.sin(angle1), z])
    angle = 2 * np.pi * rng.rand()
    return axis, angle


def rotation_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation matrix for a rotation of ``angle`` around ``axis``."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    ux, uy, uz = axis
    c, s = np.cos(angle), np.sin(angle)
    cc = 1.0 - c
    return np.array(
        [
            [c + ux * ux * cc, ux * uy * cc - uz * s, ux * uz * cc + uy * s],
            [uy * ux * cc + uz * s, c + uy * uy * cc, uy * uz * cc - ux * s],
            [uz * ux * cc - uy * s, uz * uy * cc + ux * s, c + uz * uz * cc],
        ]
    )


def rotate_points(points: np.ndarray, axis: np.ndarray, angle: float, center: np.ndarray) -> np.ndarray:
    """Rotate ``[P, 3]`` points around an axis through ``center``."""
    rot = rotation_matrix(axis, angle)
    return (points - center) @ rot.T + center


class GridSettings:
    """Grid geometry: per-axis point counts and box sizes in Å (reference: grid.py:50)."""

    def __init__(self, points_counts: list[int], sizes: list[float]):
        if len(points_counts) != 3 or len(sizes) != 3:  # noqa: PLR2004
            msg = "Incorrect grid dimensions."
            raise ValueError(msg)
        self._points_counts = points_counts
        self._sizes = sizes

    @property
    def resolutions(self) -> list[float]:
        return [self._sizes[i] / self._points_counts[i] for i in range(3)]

    @property
    def sizes(self) -> list[float]:
        return self._sizes

    @property
    def points_counts(self) -> list[int]:
        return self._points_counts


class Grid:
    """A 3D volumetric representation of a graph's features."""

    def __init__(self, id_: str, center: list[float], settings: GridSettings):
        self.id = id_
        self._center = np.array(center, dtype=np.float64)
        self._settings = settings
        self._set_mesh(self._center, settings)
        self._features: dict[str, np.ndarray] = {}

    def _set_mesh(self, center: np.ndarray, settings: GridSettings) -> None:
        """Axis coordinates: box centered on ``center`` (reference: grid.py:102-120)."""
        axes = []
        for dim in range(3):
            half_size = settings.sizes[dim] / 2
            low = center[dim] - half_size
            high = low + (settings.points_counts[dim] - 1.0) * settings.resolutions[dim]
            axes.append(np.linspace(low, high, num=settings.points_counts[dim]))
        self._xs, self._ys, self._zs = axes

    @property
    def center(self) -> np.ndarray:
        return self._center

    @property
    def xs(self) -> np.ndarray:
        return self._xs

    @property
    def ys(self) -> np.ndarray:
        return self._ys

    @property
    def zs(self) -> np.ndarray:
        return self._zs

    # reference-parity aliases (reference grid.py: Grid.xgrid/ygrid/zgrid)
    xgrid = xs
    ygrid = ys
    zgrid = zs

    @property
    def shape(self) -> tuple[int, int, int]:
        return (len(self._xs), len(self._ys), len(self._zs))

    @property
    def features(self) -> dict[str, np.ndarray]:
        return self._features

    def add_feature_values(self, feature_name: str, data: np.ndarray) -> None:
        """Accumulate (+=) grid-point values for a feature channel."""
        if feature_name not in self._features:
            self._features[feature_name] = data
        else:
            self._features[feature_name] += data

    # ------------------------------------------------------------------
    # Batched kernels
    # ------------------------------------------------------------------
    def _grid_points(self) -> np.ndarray:
        if not hasattr(self, "_grid_points_cache"):
            gx, gy, gz = np.meshgrid(self._xs, self._ys, self._zs, indexing="ij")
            pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)  # [G, 3]
            self._grid_points_cache = pts
            # f32 kernel path: coordinates relative to the grid center keep
            # magnitudes ~ the box size, so the |p|^2+|g|^2-2p.g expansion does
            # not cancel catastrophically in single precision
            rel = (pts - self._center[None, :]).astype(np.float32)
            self._grid_rel_cache = rel
            self._grid_sqnorm_cache = (rel**2).sum(axis=1)
        return self._grid_points_cache

    def _kernel_gaussian(self, points: np.ndarray, truncate: float | None = None) -> np.ndarray:
        """``[P, G]`` f32 Gaussian kernel matrix ``exp(-beta * |p - g|)`` (beta = 1).

        Runs the C++ kernel (csrc/grid_kernels.cpp, built with ``g++`` at its
        first use; a failed build raises): per-axis distance decomposition
        over the structured grid + libmvec-vectorized exp, ~4x the numpy
        plain version :meth:`_kernel_gaussian_ref` (the featurization hot spot).
        """
        return self._kernel_gaussian_native(points, truncate)

    def _kernel_gaussian_ref(self, points: np.ndarray, truncate: float | None = None) -> np.ndarray:
        """The plain (numpy) version of :meth:`_kernel_gaussian`: distances via
        ``|p|^2 + |g|^2 - 2 p.g`` on center-relative f32 coordinates — one
        [P,3]x[3,G] matmul instead of a [P,G,3] broadcast intermediate."""
        beta = np.float32(1.0)
        self._grid_points()
        rel = (points - self._center[None, :]).astype(np.float32)
        d2 = (rel**2).sum(axis=1)[:, None] + self._grid_sqnorm_cache[None, :] - np.float32(2.0) * (rel @ self._grid_rel_cache.T)
        d = np.sqrt(np.maximum(d2, np.float32(0.0)))
        k = np.exp(-beta * d)
        if truncate is not None:
            k = np.where(d < truncate, k, np.float32(0.0))
        return k

    def _kernel_gaussian_ref_tolerance(self, points: np.ndarray) -> np.ndarray:
        """``[P, G]`` bound on ``|_kernel_gaussian - _kernel_gaussian_ref|``.

        tests/utils/test_grid.py's gate (``np.allclose``: rtol 1e-5, atol
        1e-8) plus the plain version's own f32 error in the distance: its
        center-relative coordinates are rounded (2 eps s) and the expansion
        ``|p|^2 + |g|^2 - 2 p.g`` cancels terms of size s^2 (4 eps s^2 in d^2,
        so 4 eps s^2 / (d + 2 sqrt(eps) s) in d), with s = |p - c| + |g - c|
        and eps = 2^-24. An error dd in d moves ``exp(-d)`` by ``exp(-d) dd``.
        """
        eps = 2.0**-24
        grid_points = self._grid_points()
        d = np.sqrt(((points[:, None, :] - grid_points[None, :, :]) ** 2).sum(-1))
        s = np.linalg.norm(points - self._center, axis=1)[:, None] + np.linalg.norm(grid_points - self._center, axis=1)[None, :]
        dd = eps * (2.0 * s + 4.0 * s * s / (d + 2.0 * np.sqrt(eps) * s))
        k = np.exp(-d)
        return 1e-5 * k + 1e-8 + k * dd

    def _kernel_gaussian_native(self, points: np.ndarray, truncate: float | None) -> np.ndarray:
        import ctypes

        from deeprank2_tpu_torch.ops import _build

        lib = _build.host_library("grid_kernels")
        points = np.ascontiguousarray(points, dtype=np.float64)
        xs = np.ascontiguousarray(self._xs, dtype=np.float64)
        ys = np.ascontiguousarray(self._ys, dtype=np.float64)
        zs = np.ascontiguousarray(self._zs, dtype=np.float64)
        out = np.empty((points.shape[0], len(xs) * len(ys) * len(zs)), dtype=np.float32)
        dptr = ctypes.POINTER(ctypes.c_double)
        lib.gaussian_kernel_grid(
            points.ctypes.data_as(dptr),
            ctypes.c_int(points.shape[0]),
            xs.ctypes.data_as(dptr),
            ctypes.c_int(len(xs)),
            ys.ctypes.data_as(dptr),
            ctypes.c_int(len(ys)),
            zs.ctypes.data_as(dptr),
            ctypes.c_int(len(zs)),
            ctypes.c_double(truncate if truncate is not None else -1.0),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out

    def _kernel_bspline(self, points: np.ndarray) -> np.ndarray:
        """``[P, G]`` separable cubic B-spline kernel on resolution-scaled offsets."""

        def bspline3(t: np.ndarray) -> np.ndarray:
            at = np.abs(t)
            out = np.zeros_like(at)
            inner = at < 1.0
            outer = (at >= 1.0) & (at < 2.0)
            out[inner] = (4.0 - 6.0 * at[inner] ** 2 + 3.0 * at[inner] ** 3) / 6.0
            out[outer] = (2.0 - at[outer]) ** 3 / 6.0
            return out

        res = self._settings.resolutions
        kx = bspline3((points[:, 0:1] - self._xs[None, :]) / res[0])  # [P, Nx]
        ky = bspline3((points[:, 1:2] - self._ys[None, :]) / res[1])
        kz = bspline3((points[:, 2:3] - self._zs[None, :]) / res[2])
        return np.einsum("pi,pj,pk->pijk", kx, ky, kz).reshape(points.shape[0], -1)

    def _kernel_nearest(self, points: np.ndarray) -> np.ndarray:
        """``[P, G]`` sparse-as-dense kernel over the 2 nearest grid points per axis."""
        num_points = points.shape[0]
        out = np.zeros((num_points, *self.shape))
        axes = (self._xs, self._ys, self._zs)
        for p in range(num_points):
            idx, wts = [], []
            for dim in range(3):
                dist = np.abs(axes[dim] - points[p, dim])
                nearest2 = np.argsort(dist)[:2]
                inv = 1.0 / np.maximum(dist[nearest2], 1e-12)
                idx.append(nearest2)
                wts.append(inv / inv.sum())
            for (i, j, k), (wi, wj, wk) in zip(
                itertools.product(*idx),
                itertools.product(*wts),
            ):
                out[p, i, j, k] += wi * wj * wk
        return out.reshape(num_points, -1)

    def atomic_density_koes(self, position: np.ndarray, vanderwaals_radius: float) -> np.ndarray:
        """Koes et al. atomic density (arXiv:1612.02751 eq. 1) on the grid.

        (Present-but-unused in the reference's ``map_feature``; kept for parity.)
        """
        gx, gy, gz = np.meshgrid(self._xs, self._ys, self._zs, indexing="ij")
        d = np.sqrt((gx - position[0]) ** 2 + (gy - position[1]) ** 2 + (gz - position[2]) ** 2)
        out = np.zeros_like(d)
        close = d < vanderwaals_radius
        far = (d >= vanderwaals_radius) & (d < 1.5 * vanderwaals_radius)
        out[close] = np.exp(-2.0 * d[close] ** 2 / vanderwaals_radius**2)
        e2 = np.e**2
        out[far] = 4.0 / e2 / vanderwaals_radius**2 * d[far] ** 2 - 12.0 / e2 / vanderwaals_radius * d[far] + 9.0 / e2
        return out

    # ------------------------------------------------------------------
    # Mapping
    # ------------------------------------------------------------------
    def map_channels_batch(
        self,
        points: np.ndarray,
        channel_names: list[str],
        values: np.ndarray,
        method: MapMethod,
    ) -> None:
        """Map many channels sharing the same points in one pass.

        The kernel matrix depends only on the points, so it is computed once
        per point chunk and applied to every channel as one matmul — the grid
        featurization hot loop (the reference maps one point x one feature at
        a time, grid.py:272-311).

        Args:
            points: ``[P, 3]`` positions.
            channel_names: ``C`` output channel names.
            values: ``[P, C]`` channel values per point.
            method: kernel choice.
        """
        values = np.asarray(values, dtype=np.float64)
        total = np.zeros((len(channel_names), int(np.prod(self.shape))))
        for start in range(0, points.shape[0], _POINT_CHUNK):
            chunk = slice(start, start + _POINT_CHUNK)
            if method == MapMethod.GAUSSIAN:
                kernel = self._kernel_gaussian(points[chunk])
            elif method == MapMethod.FAST_GAUSSIAN:
                kernel = self._kernel_gaussian(points[chunk], truncate=5.0)
            elif method == MapMethod.BSP_LINE:
                kernel = self._kernel_bspline(points[chunk])
            elif method == MapMethod.NEAREST_NEIGHBOURS:
                kernel = self._kernel_nearest(points[chunk])
            else:
                msg = f"Unknown map method: {method}"
                raise ValueError(msg)
            # f32 matmul per chunk, f64 accumulation across chunks
            total += values[chunk].astype(np.float32).T @ kernel.astype(np.float32, copy=False)

        for c, name in enumerate(channel_names):
            self.add_feature_values(name, total[c].reshape(self.shape))

    def map_feature_batch(
        self,
        points: np.ndarray,
        feature_name: str,
        values: np.ndarray,
        method: MapMethod,
    ) -> None:
        """Map all points of one feature onto the grid in one shot.

        Args:
            points: ``[P, 3]`` positions.
            values: ``[P]`` scalars or ``[P, K]`` vectors; vector features become
                channels named ``{feature_name}_{k:03d}`` (reference: grid.py:292).
            method: kernel choice.
        """
        values = np.asarray(values, dtype=np.float64)
        if values.ndim == 1:
            channel_names = [feature_name]
            values = values[:, None]
        else:
            channel_names = [f"{feature_name}_{k:03d}" for k in range(values.shape[1])]
        self.map_channels_batch(points, channel_names, values, method)

    def map_feature(self, position: np.ndarray, feature_name: str, feature_value, method: MapMethod) -> None:
        """Single-point mapping (reference-API convenience wrapper)."""
        value = np.atleast_1d(np.asarray(feature_value, dtype=np.float64))
        if value.ndim == 1 and value.shape[0] > 1:
            self.map_feature_batch(np.asarray(position)[None, :], feature_name, value[None, :], method)
        else:
            self.map_feature_batch(np.asarray(position)[None, :], feature_name, value.reshape(1), method)

    def to_hdf5(self, hdf5_path: str) -> None:
        """Write grid data in the deeprank layout (``grid_points``,
        ``mapped_features``), to a file or a ``utils/store.py:MemoryStore``."""
        with open_store(hdf5_path, "a") as hdf5_file:
            grid_group = hdf5_file.require_group(self.id)

            points_group = grid_group.require_group("grid_points")
            points_group.create_dataset("x", data=self._xs)
            points_group.create_dataset("y", data=self._ys)
            points_group.create_dataset("z", data=self._zs)
            points_group.create_dataset("center", data=self._center)

            features_group = grid_group.require_group(gridstorage.MAPPED_FEATURES)
            for feature_name, feature_data in self._features.items():
                # lzf like the reference (grid.py:313), but one chunk per
                # dataset + byte shuffle: h5py's chunk guessing splits a
                # 31.5k-point box into many filter invocations, and
                # unshuffled f64 compresses poorly — measured on the SRV
                # protocol, guess-chunks 182 ms / 10.9 MB vs one-chunk+
                # shuffle 112 ms / 5.8 MB per structure. Filters are
                # self-describing HDF5, so any reader (including the
                # reference's) consumes these files unchanged.
                features_group.create_dataset(
                    feature_name,
                    data=feature_data,
                    compression="lzf",
                    shuffle=True,
                    chunks=feature_data.shape,
                )
