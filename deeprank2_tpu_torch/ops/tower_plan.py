"""The rules of the fused towers' shared-memory plans (``csrc/tower_common.cuh``),
mirrored for the shape rules of ``ops/ginet_tower.py`` and ``ops/diag_spmm.py``."""

from __future__ import annotations

# the per-block shared-memory limit of an H100 (232,448 bytes, opt-in)
SMEM_LIMIT = 232_448


def round16(v: int) -> int:
    """``v`` rounded up to a multiple of 16: a plan's part in bytes
    (csrc/tower_common.cuh:take), or a count of rows, features or channels
    padded to the 16-wide tiles."""
    return (v + 15) // 16 * 16


def row_bytes(cols: int, elem_bytes: int) -> int:
    """A slab row of ``cols`` elements of ``elem_bytes`` bytes, padded to an
    odd number of 16-byte units (csrc/tower_common.cuh:row_elems)."""
    units = (cols * elem_bytes + 15) // 16
    return (units if units % 2 else units + 1) * 16
