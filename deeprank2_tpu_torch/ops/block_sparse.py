"""Spatial locality order (port of ``deeprank2_tpu/ops/block_sparse.py``:
``locality_order`` and ``_CELL`` only).

The clustered collates order clusters and cluster members by this
permutation, so it must give the JAX package's order bit for bit. The BCSR
SpMM of that module belongs to a later slice of the port.
"""

from __future__ import annotations

import numpy as np

_CELL = 8.0  # Å — locality-sort cell size (≈ 2x the atomic contact cutoff)


def locality_order(positions: np.ndarray, cell: float = _CELL) -> np.ndarray:
    """Node permutation that clusters spatial neighbours: lexsort by ``cell``
    grid cell, then by coordinates within the cell."""
    pos = np.asarray(positions, dtype=np.float64)
    q = np.floor(pos / cell).astype(np.int64)
    return np.lexsort((pos[:, 2], pos[:, 1], pos[:, 0], q[:, 2], q[:, 1], q[:, 0]))
