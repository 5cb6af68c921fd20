"""Blocked per-edge-feature message passing (port of
``deeprank2_tpu/ops/blocked_edges.py``): the fast path for models whose
messages read per-edge features, VanillaNetwork's
``relu(MLP([x_i ‖ x_j ‖ e_ij]))`` summed onto the destination node.

The layout is the JAX package's, field for field: directed (mirrored) edges
sorted by (row tile, column tile) with ``EDGE_TILE``-node tiles; each tile
pair's run padded to a ``SUB_E`` multiple and cut into sub-blocks of one
source tile each; ``K_SUB`` sub-blocks that share a destination tile make one
``TILE_E``-edge slab. Padded edge slots carry the row sentinel ``EDGE_TILE``.

The CUDA kernels (ops/vanilla.py, ``csrc/blocked_edges.cu``) walk the real
edges of each destination node instead of the slabs, through an index built
here: ``row_ptr``/``edge_order``, the edge slots of each destination node in
slot order. Sentinels and capacity-pad slabs are never listed.

:func:`blocked_message_sum` is differentiable in ``xr``, ``xc`` and ``w_e``
through the kernels; :func:`blocked_message_sum_ref` is its plain PyTorch
version (the JAX ``blocked_message_sum_xla``). ``compute_dtype=torch.bfloat16``
selects the kernels' single-pass bf16 form (the JAX ``_make_gdot`` bf16
branch): every operand (``xr``, ``xc``, ``w_e``, the edge features and the
cotangent) is rounded to bf16, each message is rounded to bf16 before it is
summed, and every sum is f32.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from deeprank2_tpu_torch.device import resolve_device
from deeprank2_tpu_torch.ops.diag_spmm import activation_dtype, round_to

EDGE_TILE = 256  # nodes per tile
TILE_E = 1024  # edge slots per slab (one destination tile each)
K_SUB = 4  # sub-blocks per slab, one source tile each
SUB_E = TILE_E // K_SUB


@dataclass(frozen=True)
class BlockedEdgeStructure:
    """Row-major sorted edge slabs plus static geometry, on one device.

    The first six fields are the JAX structure's, array for array: slab
    ``s`` covers edge slots ``[s*TILE_E, (s+1)*TILE_E)`` with destination
    tile ``step_row[s]``; its ``K_SUB`` sub-blocks have source tiles
    ``sub_col[s*K_SUB : (s+1)*K_SUB]``; padded slots hold the row sentinel
    ``EDGE_TILE``. ``row_ptr`` and ``edge_order`` are the CUDA kernels'
    index: the slots of the real edges into global node ``v`` are
    ``edge_order[row_ptr[v]:row_ptr[v + 1]]``, ascending."""

    row_local: torch.Tensor  # i32 [E_cap] destination within its tile; sentinel EDGE_TILE
    col_local: torch.Tensor  # i32 [E_cap] source within its tile
    eattr_t: torch.Tensor  # f32 [Fe_pad, E_cap] edge features, transposed
    step_row: torch.Tensor  # i32 [NS] destination tile per slab
    sub_col: torch.Tensor  # i32 [NS * K_SUB] source tile per sub-block
    out_visited: torch.Tensor  # bool [num_node_tiles] row tiles the TPU kernel writes
    row_ptr: torch.Tensor  # i32 [padded_nodes + 1] start of each node's edges in edge_order
    edge_order: torch.Tensor  # i32 [real edges] slots by (destination node, slot)
    num_node_tiles: int
    edge_dim: int  # un-padded Fe

    _STATIC = ("num_node_tiles", "edge_dim")

    @property
    def padded_nodes(self) -> int:
        return self.num_node_tiles * EDGE_TILE

    @property
    def num_slabs(self) -> int:
        return self.step_row.shape[0]

    def to(self, device: str | torch.device) -> BlockedEdgeStructure:
        """A copy of the structure on ``device``."""
        dev = resolve_device(device)
        return BlockedEdgeStructure(**{f.name: getattr(self, f.name) if f.name in self._STATIC else getattr(self, f.name).to(dev) for f in fields(self)})


def _fe_pad(edge_dim: int) -> int:
    return edge_dim + (-edge_dim) % 8


def _group_layout(rows: np.ndarray, cols: np.ndarray, num_tiles: int):
    """Sorted group geometry shared by :func:`build_blocked_edges` and :func:`required_slabs`.

    Returns (order, uniq keys, real counts, SUB_E-padded counts, per-row-tile
    slab count after K_SUB alignment, total slab count)."""
    rt, ct = rows // EDGE_TILE, cols // EDGE_TILE
    key = rt * num_tiles + ct
    order = np.argsort(key, kind="stable")
    uniq, counts = np.unique(key[order], return_counts=True)
    pad_counts = -(-counts // SUB_E) * SUB_E
    # sub-blocks per row tile, padded so that slabs never straddle row tiles
    subs_per_row = np.zeros(num_tiles, dtype=np.int64)
    np.add.at(subs_per_row, uniq // num_tiles, pad_counts // SUB_E)
    slabs_per_row = -(-subs_per_row // K_SUB)
    ns = max(int(slabs_per_row.sum()), 1)
    return order, uniq, counts, pad_counts, slabs_per_row, ns


def _mirrored(und_pairs: np.ndarray, num_nodes: int) -> tuple[np.ndarray, np.ndarray, int]:
    und = np.asarray(und_pairs, dtype=np.int64).reshape(-1, 2)
    num_tiles = max(-(-num_nodes // EDGE_TILE), 1)
    return np.concatenate([und[:, 0], und[:, 1]]), np.concatenate([und[:, 1], und[:, 0]]), num_tiles


def required_slabs(und_pairs: np.ndarray, num_nodes: int) -> int:
    """The slab count :func:`build_blocked_edges` would produce."""
    rows, cols, num_tiles = _mirrored(und_pairs, num_nodes)
    return _group_layout(rows, cols, num_tiles)[5]


def build_blocked_edges(
    und_pairs: np.ndarray,
    edge_attr: np.ndarray,
    num_nodes: int,
    pad_slabs=None,
    device: str | torch.device | None = None,
) -> BlockedEdgeStructure:
    """Blocked-edge structure from *undirected* node pairs and their edge
    features (mirrored here: both directions get the same features), on
    ``device`` (CUDA unless ``"cpu"`` is asked for). Node indices should
    already be in the locality order; ``num_nodes`` is rounded up to whole
    ``EDGE_TILE`` tiles. ``pad_slabs`` buckets the slab capacity (an int or a
    ``required -> capacity`` callable)."""
    dev = resolve_device(device)
    und = np.asarray(und_pairs, dtype=np.int64).reshape(-1, 2)
    eattr = np.asarray(edge_attr, dtype=np.float32)
    if eattr.ndim != 2:
        eattr = eattr.reshape(len(und), 1) if len(und) else eattr.reshape(0, 1)
    if und.size and (und.max() >= num_nodes or und.min() < 0):
        msg = f"edge index out of range: max {und.max()} for {num_nodes} nodes"
        raise ValueError(msg)
    tile = EDGE_TILE
    rows, cols, num_tiles = _mirrored(und, num_nodes)
    ea2 = np.concatenate([eattr, eattr], axis=0)
    fe = eattr.shape[1]

    order, uniq, counts, pad_counts, slabs_per_row, ns = _group_layout(rows, cols, num_tiles)
    if callable(pad_slabs):
        pad_slabs = pad_slabs(ns)
    if pad_slabs is not None and pad_slabs < ns:
        msg = f"pad_slabs={pad_slabs} < required {ns}"
        raise ValueError(msg)
    ns_cap = ns if pad_slabs is None else pad_slabs
    e_cap = ns_cap * TILE_E

    row_local = np.full(e_cap, tile, dtype=np.int32)  # sentinel
    col_local = np.zeros(e_cap, dtype=np.int32)
    eattr_t = np.zeros((_fe_pad(fe), e_cap), dtype=np.float32)
    step_row = np.zeros(ns_cap, dtype=np.int32)
    sub_col = np.zeros(ns_cap * K_SUB, dtype=np.int32)
    out_visited = np.zeros(num_tiles, dtype=bool)

    # slab layout: row tiles ascending, each owning slabs_per_row[r] slabs;
    # the sub-blocks of that row's groups fill them in column order
    slab_start_of_row = np.concatenate([[0], np.cumsum(slabs_per_row)])[:-1]
    sub_cursor = np.zeros(num_tiles, dtype=np.int64)
    pos = 0
    for g, (k, cnt) in enumerate(zip(uniq, counts)):
        r_tile, c_tile = int(k // num_tiles), int(k % num_tiles)
        sel = order[pos : pos + cnt]
        pos += cnt
        sub0 = int(slab_start_of_row[r_tile] * K_SUB + sub_cursor[r_tile])
        nsub = int(pad_counts[g]) // SUB_E
        s = sub0 * SUB_E
        row_local[s : s + cnt] = rows[sel] % tile
        col_local[s : s + cnt] = cols[sel] % tile
        eattr_t[:fe, s : s + cnt] = ea2[sel].T
        sub_col[sub0 : sub0 + nsub] = c_tile
        sub_cursor[r_tile] += nsub
        out_visited[r_tile] = True

    for r in range(num_tiles):
        n_slab = int(slabs_per_row[r])
        if n_slab == 0:
            continue
        s0 = int(slab_start_of_row[r])
        step_row[s0 : s0 + n_slab] = r
        # dummy sub-blocks at the end of a row's run repeat its last real
        # column tile (their slots are all sentinels)
        filled, total = int(sub_cursor[r]), n_slab * K_SUB
        if filled < total:
            last_col = sub_col[s0 * K_SUB + filled - 1] if filled else 0
            sub_col[s0 * K_SUB + filled : s0 * K_SUB + total] = last_col

    # trailing capacity-pad slabs repeat the last real slab's tiles
    step_row[ns:] = step_row[ns - 1]
    sub_col[ns * K_SUB :] = sub_col[ns * K_SUB - 1]
    if not len(uniq):
        out_visited[0] = True

    # the CUDA kernels' index: real slots by (destination node, slot)
    slots = np.flatnonzero(row_local < tile)
    grow = step_row[slots // TILE_E].astype(np.int64) * tile + row_local[slots]
    edge_order = slots[np.argsort(grow, kind="stable")].astype(np.int32)
    row_ptr = np.zeros(num_tiles * tile + 1, dtype=np.int32)
    row_ptr[1:] = np.cumsum(np.bincount(grow, minlength=num_tiles * tile))

    arrays = {
        "row_local": row_local,
        "col_local": col_local,
        "eattr_t": eattr_t,
        "step_row": step_row,
        "sub_col": sub_col,
        "out_visited": out_visited,
        "row_ptr": row_ptr,
        "edge_order": edge_order,
    }
    return BlockedEdgeStructure(
        **{name: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for name, a in arrays.items()},
        num_node_tiles=num_tiles,
        edge_dim=fe,
    )


def global_indices(structure: BlockedEdgeStructure) -> tuple[torch.Tensor, torch.Tensor]:
    """(row, col) global node indices (int64) per edge slot; sentinel rows map
    to ``padded_nodes`` (one past the end, for scatter dropping)."""
    slab = structure.step_row.long().repeat_interleave(TILE_E)
    grow = slab * EDGE_TILE + structure.row_local
    grow = torch.where(structure.row_local >= EDGE_TILE, structure.padded_nodes, grow)
    gcol = structure.sub_col.long().repeat_interleave(SUB_E) * EDGE_TILE + structure.col_local
    return grow, gcol


def edge_term(eattr_t: torch.Tensor, w_e: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``e_attr(e) · w_e`` for every edge slot, ``[E, M]`` from ``eattr_t
    [Fe, E]`` and ``w_e [Fe, M]``: the products and the running sum over the
    ``Fe`` channels rounded one by one in channel order, as the CUDA kernels
    compute it. So a kernel and the plain versions see bit-identical
    pre-activations, and agree on every relu' (a flipped relu' would move a
    gradient by a whole cotangent entry). The bf16 form rounds both operands
    to bf16 first (each product is then exact in f32)."""
    act = activation_dtype(compute_dtype)
    eattr_t, w_e = round_to(eattr_t, act), round_to(w_e, act)
    ew = eattr_t.new_zeros((eattr_t.shape[1], w_e.shape[1]))
    for k in range(w_e.shape[0]):
        ew = ew + eattr_t[k][:, None] * w_e[k]
    return ew


def pre_activations(structure: BlockedEdgeStructure, xr: torch.Tensor, xc: torch.Tensor, w_e: torch.Tensor, compute_dtype=None):
    """``(grow, gcol, pre)``: the slots' global indices and
    ``pre = xr[row] + xc[col] + e_attr · w_e`` per slot (``[E_cap, M]``;
    sentinel slots read row ``padded_nodes - 1`` and must be masked); the
    bf16 form rounds ``xr``, ``xc`` and the edge term's operands to bf16."""
    act = activation_dtype(compute_dtype)
    grow, gcol = global_indices(structure)
    row = grow.clamp(max=structure.padded_nodes - 1)
    pre = round_to(xr, act)[row] + round_to(xc, act)[gcol] + edge_term(structure.eattr_t[: structure.edge_dim], w_e, act)
    return grow, gcol, pre


def blocked_message_sum_ref(structure: BlockedEdgeStructure, xr: torch.Tensor, xc: torch.Tensor, w_e: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`blocked_message_sum` (the JAX
    ``blocked_message_sum_xla``): gathers, relu, the sentinel mask and an
    ``index_add`` onto the destination rows; differentiable by autograd. The
    bf16 form rounds the operands (:func:`pre_activations`) and each message
    as the kernel does; autograd through its roundings is not the kernels'
    VJP (``ops/vanilla.py:blocked_bwd_kernel_ref`` is)."""
    act = activation_dtype(compute_dtype)
    v_pad = structure.padded_nodes
    grow, _, pre = pre_activations(structure, xr, xc, w_e, act)
    msg = round_to(torch.relu(pre), act) * (grow < v_pad)[:, None].to(pre.dtype)
    return pre.new_zeros((v_pad + 1, xr.shape[1])).index_add(0, grow, msg)[:v_pad]


def blocked_message_sum(
    structure: BlockedEdgeStructure,
    xr: torch.Tensor,
    xc: torch.Tensor,
    w_e: torch.Tensor,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``out[v] = sum_{e: row(e)=v} relu(xr[v] + xc[col(e)] + e_attr(e) @ w_e)``

    ``xr``/``xc``: ``[padded_nodes, M]`` per-node message parts (destination
    and source; precompute ``x @ w_row + bias`` and ``x @ w_col`` outside:
    the bias must ride one of them, nothing is added here). ``w_e``:
    ``[edge_dim, M]``. Differentiable in ``xr``, ``xc`` and ``w_e`` (edge
    features are data): forward kernel K6f, backward kernel K6b
    (ops/vanilla.py), in the form ``compute_dtype`` selects (None or
    float32: f32; bfloat16: the single-pass bf16 form); tensors on the CPU
    take their plain versions."""
    activation_dtype(compute_dtype)
    if xr.shape[0] != structure.padded_nodes or xc.shape[0] != structure.padded_nodes:
        msg = f"xr/xc must have {structure.padded_nodes} rows, got {xr.shape[0]}/{xc.shape[0]}"
        raise ValueError(msg)
    if w_e.shape[0] != structure.edge_dim:
        msg = f"w_e expects {structure.edge_dim} edge channels, got {w_e.shape[0]}"
        raise ValueError(msg)
    from deeprank2_tpu_torch.ops.vanilla import _BlockedMessageSum

    return _BlockedMessageSum.apply(xr.contiguous(), xc.contiguous(), w_e.contiguous(), structure, compute_dtype)
