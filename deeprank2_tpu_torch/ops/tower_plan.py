"""The rules of the fused towers' shared-memory plans (``csrc/tower_common.cuh``),
mirrored for the shape rules of ``ops/ginet_tower.py`` and ``ops/diag_spmm.py``:
the row and part rules every plan follows, and the plan that K8f, K8b and
K9f share (:func:`plan_bytes`)."""

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


# the warps of one block of the tower kernels (csrc/tower_common.cuh:WARPS)
WARPS = 8


def plan_bytes(nodes: int, feat: int, c1: int, c2: int, elem_bytes: int, forward: bool) -> int:
    """Shared memory of one block on ``csrc/tower_common.cuh:plan``, the
    forward's (K8f and K9f) or the batched backward's (K8b); ``elem_bytes``
    4 in the f32 form, 2 in the bf16 form. Nodes, features and channels
    padded to 16; the adjacency's bit rows ``[N, words]`` and the mask's bits
    ``[words]`` (uint32); the backward's signs of h2 ``[c2p, words]``
    (uint32) and dpooled ``[c2p]`` (f32), or the forward's warp sums of the
    pool ``[8, c2p]`` (f32); then, of ``elem_bytes`` each, w1 ``[kx, ld(c1p)]``,
    w2 ``[c1p, ld(c2p)]``, the wide slab ``[rows, ld(max(c2p, kx))]`` (the
    forward keeps fcx beside x in it, ``ld(max(c2p, kx + c1p))``, and has no
    third slab) and ``[rows, ld(c1p)]`` (the backward twice), each row padded
    to an odd number of 16-byte units and each part to 16 bytes."""

    def row(cols: int) -> int:
        return row_bytes(cols, elem_bytes)

    rows, kx, c1p, c2p, words = round16(nodes), round16(feat), round16(c1), round16(c2), (nodes + 31) // 32
    if forward:
        parts = (4 * nodes * words, 4 * words, 4 * WARPS * c2p, kx * row(c1p), c1p * row(c2p), rows * row(max(c2p, kx + c1p)), rows * row(c1p))
    else:
        parts = (4 * nodes * words, 4 * words, 4 * c2p * words, 4 * c2p, kx * row(c1p), c1p * row(c2p), rows * row(max(c2p, kx)), rows * row(c1p), rows * row(c1p))
    return sum(round16(b) for b in parts)
