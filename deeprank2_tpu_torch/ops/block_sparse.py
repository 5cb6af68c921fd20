"""Block-sparse (BCSR) adjacency SpMM, the large-graph aggregation path (port
of ``deeprank2_tpu/ops/block_sparse.py``: ``locality_order``,
``BlockSparseStructure``, ``build_blocksparse`` for the unweighted and the
weighted symmetric adjacency, and ``bcsr_spmm``/``bcsr_spmm_t`` over kernel
K5).

Atomic-resolution graphs (10^4-10^5 nodes) are too large for the dense
``[G, N, N]`` adjacency. Nodes are ordered by spatial locality
(:func:`locality_order`), the adjacency is cut into 128 x 128 blocks and
only the nonzero blocks are kept (about 1-2 % of them on locality-ordered
atomic graphs), stored transposed: ``blocks_t[k][c, r]`` is the weight of
the edge from node ``block_col[k]*128 + c`` to node ``block_row[k]*128 + r``
(int8 0/1 unweighted; bf16 or f32 edge weights for sGAT).

The SpMM runs in the transposed layout ``[F, nodes] -> [F, rows]``:

    out[f, r*128 + i] = sum_k sum_c x[f, block_col[k]*128 + c] * blocks_t[k][c, i]

over the blocks ``k`` whose ``block_row`` is ``r`` (the oracle
``bcsr_spmm_xla``). On a CUDA device it runs in the kernel of
``csrc/bcsr_spmm.cu`` (``bcsr_spmm_kernel``), which walks each destination
row tile's nonzero blocks through the per-tile index ``tile_ptr`` /
``tile_blocks`` built here, and in each block only its nonzero entries:
each output is one f32 chain over the tile's blocks in ``tile_blocks``
order, then the source rows ``c`` ascending (``bcsr_spmm_order_ref`` is
that loop). Edges are mirrored, so ``A^T = A`` and the VJP is the same SpMM
applied to the cotangent.

``compute_dtype=torch.bfloat16`` selects the kernel's single-pass bf16 form
(the JAX ``_kernel_stream``'s non-split branch): ``x`` is rounded to bf16,
the blocks are cast to bf16 (exact for int8 and bf16 blocks, rounded to
nearest even for f32 ones) and the products accumulate in f32. The default
is the f32 form, exact up to summation order.

The wrapper takes the plain PyTorch version (``bcsr_spmm_kernel_ref``) for
tensors on the CPU, launches the kernel for tensors on a CUDA device, and
raises for anything else; it counts its launches in :data:`launches`, and by
form in :data:`launches_by_dtype`, keyed ``"<block type>/<activation type>"``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields

import numpy as np
import torch

from deeprank2_tpu_torch.device import resolve_device
from deeprank2_tpu_torch.ops import _build
from deeprank2_tpu_torch.ops.diag_spmm import ACT_DTYPES, _operand, _require, _route, activation_dtype, form_name, round_to

SOURCE = "bcsr_spmm"
DEFAULT_BLOCK = 128
KBATCH = 8  # run-padding quantum: each (chunk, row tile) run is padded to a multiple
SUPER = 16  # KBATCH sub-batches per step of the JAX kernel's grid: the capacity quantum is KBATCH*SUPER blocks
CHUNK_TILES = 320  # column tiles per chunk of the JAX kernel's x^T (blocks are sorted by chunk first)
_CELL = 8.0  # Å — locality-sort cell size (≈ 2x the atomic contact cutoff)

# the block types the kernel takes, by their code in csrc/bcsr_spmm.cu
BLOCK_DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
# the storage types of a weighted adjacency (the JAX ``weight_dtype``)
WEIGHT_DTYPES = (torch.bfloat16, torch.float32)

# kernel launches since the last reset_launches(), by kernel and by form
# (every block type in both the f32 and the bf16 form)
launches = {"bcsr_spmm_kernel": 0}
launches_by_dtype = {"bcsr_spmm_kernel": {form_name(d, a): 0 for a in ACT_DTYPES for d in BLOCK_DTYPES}}


def weight_storage(weight_dtype: torch.dtype | None) -> torch.dtype:
    """The storage type of a weighted adjacency: ``weight_dtype``, bf16 when
    None (the JAX package's default); anything but bf16 and f32 raises."""
    if weight_dtype is None:
        return torch.bfloat16
    if weight_dtype not in WEIGHT_DTYPES:
        msg = f"weight_dtype must be one of {WEIGHT_DTYPES}, got {weight_dtype}"
        raise ValueError(msg)
    return weight_dtype


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        for form in launches_by_dtype[name]:
            launches_by_dtype[name][form] = 0


def locality_order(positions: np.ndarray, cell: float = _CELL) -> np.ndarray:
    """Node permutation that clusters spatial neighbours: lexsort by ``cell``
    grid cell, then by coordinates within the cell."""
    pos = np.asarray(positions, dtype=np.float64)
    q = np.floor(pos / cell).astype(np.int64)
    return np.lexsort((pos[:, 2], pos[:, 1], pos[:, 0], q[:, 2], q[:, 1], q[:, 0]))


@dataclass(frozen=True)
class BlockSparseStructure:
    """BCSR adjacency of one (batched) graph, blocks sorted by (column chunk,
    row tile), on one device.

    The first six fields are the JAX structure's, array for array: each
    (chunk, row tile) run is zero-padded to a ``kbatch`` multiple, trailing
    capacity-pad batches route to the last real run, and ``visited`` marks
    the (chunk, row tile) slabs the TPU kernel writes. ``tile_ptr`` and
    ``tile_blocks`` are the CUDA kernel's index: the nonzero blocks of row
    tile ``r`` are ``tile_blocks[tile_ptr[r]:tile_ptr[r + 1]]`` (pad blocks
    are all zero and left out)."""

    blocks_t: torch.Tensor  # [NB, B, B] int8 0/1, or bf16/f32 weights; NB a kbatch*super_batches multiple
    block_row: torch.Tensor  # i32 [NB] destination row tile (zero pads keep their run's row)
    block_col: torch.Tensor  # i32 [NB] source column tile (zero pads: first tile of their chunk)
    batch_row: torch.Tensor  # i32 [NB/kbatch] destination row tile per batch
    batch_chunk: torch.Tensor  # i32 [NB/kbatch] source column chunk per batch
    visited: torch.Tensor  # bool [C, R] (chunk, row tile) slabs holding a run
    tile_ptr: torch.Tensor  # i32 [R + 1] start of each row tile's blocks in tile_blocks
    tile_blocks: torch.Tensor  # i32 [nonzero blocks] block ids by (row tile, chunk, column tile)
    num_tiles: int
    num_chunks: int
    block: int
    num_row_tiles: int
    symmetric: bool
    kbatch: int
    super_batches: int
    chunk_tiles: int

    _STATIC = ("num_tiles", "num_chunks", "block", "num_row_tiles", "symmetric", "kbatch", "super_batches", "chunk_tiles")

    @property
    def num_blocks(self) -> int:
        return self.blocks_t.shape[0]

    @property
    def padded_nodes(self) -> int:
        return self.num_tiles * self.block

    @property
    def padded_rows(self) -> int:
        return self.num_row_tiles * self.block

    def to(self, device: str | torch.device) -> BlockSparseStructure:
        """A copy of the structure on ``device``."""
        dev = resolve_device(device)
        return BlockSparseStructure(**{f.name: getattr(self, f.name) if f.name in self._STATIC else getattr(self, f.name).to(dev) for f in fields(self)})


def required_blocks(und_pairs: np.ndarray, num_nodes: int, block: int = DEFAULT_BLOCK, kbatch: int | None = None, chunk_tiles: int | None = None) -> int:
    """The run-padded block count :func:`build_blocksparse` would store for
    these (locality-ordered) pairs before its capacity rounding: the light
    requirements pass behind the Trainer's block buckets. ``kbatch=1`` gives
    the real (unique) block count; ``chunk_tiles`` must be the build's."""
    kb = kbatch or KBATCH
    ct = chunk_tiles or CHUNK_TILES
    und = np.asarray(und_pairs, dtype=np.int64).reshape(-1, 2)
    num_tiles = max(-(-num_nodes // block), 1)
    bi = np.concatenate([und[:, 0], und[:, 1]]) // block
    bj = np.concatenate([und[:, 1], und[:, 0]]) // block
    uniq = np.unique(((bj // ct) * num_tiles + bi) * num_tiles + bj)
    if not uniq.size:
        return kb
    _, counts = np.unique(uniq // num_tiles, return_counts=True)
    return max(int((-(-counts // kb) * kb).sum()), kb)


def build_blocksparse(
    und_pairs: np.ndarray,
    num_nodes: int,
    block: int = DEFAULT_BLOCK,
    pad_blocks_to=None,
    kbatch: int | None = None,
    super_batches: int | None = None,
    chunk_tiles: int | None = None,
    weights: np.ndarray | None = None,
    weight_dtype: torch.dtype | None = None,
    device: str | torch.device | None = None,
) -> BlockSparseStructure:
    """BCSR structure from *undirected* node-index pairs (mirrored here, so
    the adjacency is symmetric), on ``device`` (CUDA unless ``"cpu"`` is
    asked for). Node indices must already be in the locality order;
    ``num_nodes`` is rounded up to a whole number of tiles.

    ``weights`` (f32, one per pair) builds the *weighted* symmetric
    adjacency of sGAT: entries (i, j) and (j, i) both carry the pair's
    weight, and duplicate pairs add up, in f32 and in the JAX package's
    order (a self-loop's weight is added twice). The blocks are stored as
    ``weight_dtype``: ``torch.bfloat16`` (the default, rounded to nearest
    even as the JAX package's ``ml_dtypes`` cast) or ``torch.float32``.

    ``pad_blocks_to`` (an int, or a ``required -> capacity`` callable such as
    the Trainer's grow-only buckets, given the run-padded block count of
    :func:`required_blocks`) stores that many blocks at least, rounded up to
    the ``kbatch * super_batches`` quantum; the extra blocks are all zero.
    Row and column slices (the parallel paths) are not ported yet."""
    dev = resolve_device(device)
    und = np.asarray(und_pairs, dtype=np.int64).reshape(-1, 2)
    num_tiles = max(-(-num_nodes // block), 1)
    rows = np.concatenate([und[:, 0], und[:, 1]])
    cols = np.concatenate([und[:, 1], und[:, 0]])
    wvals = None
    if weights is not None:
        weight_dtype = weight_storage(weight_dtype)
        w = np.asarray(weights, dtype=np.float32).reshape(-1)
        if w.shape[0] != und.shape[0]:
            msg = f"weights has {w.shape[0]} entries for {und.shape[0]} pairs"
            raise ValueError(msg)
        wvals = np.concatenate([w, w])
    if rows.size and (rows.max() >= num_nodes or rows.min() < 0):
        msg = f"edge index out of range: max {rows.max()} for {num_nodes} nodes"
        raise ValueError(msg)

    bi, bj = rows // block, cols // block
    num_row_tiles = num_tiles
    ct = chunk_tiles or CHUNK_TILES
    num_chunks = -(-num_tiles // ct)
    chunk = bj // ct
    key = (chunk * num_row_tiles + bi) * num_tiles + bj
    order = np.argsort(key, kind="stable")
    uniq_key, inverse_sorted = np.unique(key[order], return_inverse=True)
    nb = len(uniq_key)

    uniq_col = (uniq_key % num_tiles).astype(np.int32)
    uniq_row = ((uniq_key // num_tiles) % num_row_tiles).astype(np.int32)
    uniq_chunk = (uniq_key // (num_tiles * num_row_tiles)).astype(np.int32)

    # one group = one (chunk, row tile) run, padded to a kbatch multiple with
    # zero blocks so that the JAX kernel's batches never straddle runs
    kb = kbatch or KBATCH
    group_key = uniq_chunk.astype(np.int64) * num_row_tiles + uniq_row
    group_ids, group_counts = np.unique(group_key, return_counts=True)
    pad_counts = -(-group_counts // kb) * kb
    group_start = np.concatenate([[0], np.cumsum(pad_counts)])[:-1]
    nb_pad = max(int(pad_counts.sum()), kb)
    if callable(pad_blocks_to):
        pad_blocks_to = pad_blocks_to(nb_pad)
    if (pad_blocks_to or 0) and pad_blocks_to < nb_pad:
        msg = f"pad_blocks={pad_blocks_to} < required {nb_pad}"
        raise ValueError(msg)
    sb = super_batches or SUPER
    cap = -(-max(pad_blocks_to or 0, nb_pad) // (kb * sb)) * (kb * sb)

    blocks = np.zeros((cap, block, block), dtype=np.int8 if wvals is None else np.float32)
    block_row = np.zeros(cap, dtype=np.int32)
    block_col = np.zeros(cap, dtype=np.int32)
    block_chunk = np.zeros(cap, dtype=np.int32)
    visited = np.zeros((num_chunks, num_row_tiles), dtype=bool)
    for gi, g in enumerate(group_ids):
        g_chunk, g_row = int(g // num_row_tiles), int(g % num_row_tiles)
        s, c = group_start[gi], pad_counts[gi]
        block_row[s : s + c] = g_row
        block_chunk[s : s + c] = g_chunk
        block_col[s : s + c] = g_chunk * ct  # zero pads point into their chunk
        visited[g_chunk, g_row] = True

    # slot of each unique block: its group's start plus its rank inside
    rank = np.arange(nb) - np.searchsorted(group_key, group_key, side="left")
    slot = (group_start[np.searchsorted(group_ids, group_key)] + rank) if nb else np.zeros(0, np.int64)
    block_col[slot] = uniq_col

    k = np.empty(len(key), dtype=np.int64)
    k[order] = slot[inverse_sorted]
    # transposed fill: [slot, col within, row within]
    if len(key) and wvals is None:
        blocks[k, cols % block, rows % block] = 1
    elif len(key):
        np.add.at(blocks, (k, cols % block, rows % block), wvals)

    batch_row = block_row[::kb].astype(np.int32)
    batch_chunk = block_chunk[::kb].astype(np.int32)
    # trailing capacity-pad batches route to the last real batch's run, and
    # their block_col points into that run's chunk
    nbatch_real = nb_pad // kb
    batch_row[nbatch_real:] = batch_row[max(nbatch_real - 1, 0)]
    batch_chunk[nbatch_real:] = batch_chunk[max(nbatch_real - 1, 0)]
    block_col[nb_pad:] = batch_chunk[max(nbatch_real - 1, 0)] * ct
    if nb == 0:
        visited[0, 0] = True  # the JAX kernel's artificial zero batch writes slab (0, 0)

    # the CUDA kernel's index: the real blocks of each row tile, by (row,
    # chunk, column). The zero blocks, run padding and capacity padding
    # alike, are left out: K5 walks only the blocks listed here, so padding
    # costs it neither a read nor a launch, and a capacity bucket changes no
    # bit of its result (each output's chain of terms is the same).
    by_row = np.lexsort((slot, uniq_row)) if nb else np.zeros(0, np.int64)
    tile_blocks = slot[by_row].astype(np.int32)
    tile_ptr = np.zeros(num_row_tiles + 1, dtype=np.int32)
    tile_ptr[1:] = np.cumsum(np.bincount(uniq_row, minlength=num_row_tiles))

    arrays = {
        "block_row": block_row,
        "block_col": block_col,
        "batch_row": batch_row,
        "batch_chunk": batch_chunk,
        "visited": visited,
        "tile_ptr": tile_ptr,
        "tile_blocks": tile_blocks,
    }
    blocks_t = torch.from_numpy(blocks)
    if wvals is not None:
        blocks_t = blocks_t.to(weight_dtype)  # f32 -> bf16 rounds to nearest even
    return BlockSparseStructure(
        blocks_t=blocks_t.to(dev),
        **{name: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for name, a in arrays.items()},
        num_tiles=num_tiles,
        num_chunks=num_chunks,
        block=block,
        num_row_tiles=num_row_tiles,
        symmetric=True,
        kbatch=kb,
        super_batches=sb,
        chunk_tiles=ct,
    )


def _lib() -> ctypes.CDLL:
    lib = _build.library(SOURCE)
    if lib.bcsr_spmm_kernel.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bcsr_spmm_kernel.argtypes = [p, i, p, p, p, p, i, p, i, p, i, i, i, i, p]
        lib.bcsr_spmm_kernel.restype = i
    return lib


# ---------------------------------------------------------------------------
# K5: bcsr_spmm_kernel (replaces deeprank2_tpu/ops/block_sparse.py:_kernel_stream)


def bcsr_spmm_kernel_ref(structure: BlockSparseStructure, x_t: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`bcsr_spmm_kernel` (the JAX
    ``bcsr_spmm_xla`` in the transposed layout): gather the source tiles, one
    batched block product, then a sum over ``block_row``. The bf16 form
    rounds ``x_t`` and the blocks to bf16 and sums in f32."""
    nt, b = structure.num_tiles, structure.block
    f = x_t.shape[0]
    act = activation_dtype(compute_dtype)
    x_t = round_to(x_t, act)
    gathered = x_t.reshape(f, nt, b)[:, structure.block_col.long().clamp(0, nt - 1)]  # [F, NB, c]
    blocks = structure.blocks_t
    if blocks.dtype == torch.float32:
        blocks = round_to(blocks, act)  # int8 and bf16 blocks are exact in bf16
    prod = torch.einsum("kcr,fkc->fkr", blocks.to(x_t.dtype), gathered)  # [F, NB, r]
    out = x_t.new_zeros((f, structure.num_row_tiles, b)).index_add(1, structure.block_row.long(), prod)
    return out.reshape(f, structure.padded_rows)


def bcsr_spmm_order_ref(structure: BlockSparseStructure, x_t: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """The kernel's summation order as a plain float32 loop: over the block
    positions of each row tile in ``tile_blocks`` order, then the source rows
    ``c`` ascending, one add of ``blocks_t[k][c, :] * x`` a term, vectorised
    over row tiles, features and destination nodes. For 0/1 blocks each term
    is exact, so one add is the kernel's ``fmaf`` and the two agree bit for
    bit; for other weights the product here is rounded before the add. The
    bf16 form rounds ``x_t`` (and f32 blocks) to bf16 first, as the kernel."""
    nt, b, r = structure.num_tiles, structure.block, structure.num_row_tiles
    f = x_t.shape[0]
    act = activation_dtype(compute_dtype)
    xs = round_to(x_t, act).float().reshape(f, nt, b)
    blocks = structure.blocks_t
    if blocks.dtype == torch.float32:
        blocks = round_to(blocks, act)
    ptr = structure.tile_ptr.long()
    counts = ptr[1:] - ptr[:-1]
    out = torch.zeros((f, r, b), dtype=torch.float32, device=x_t.device)
    for pos in range(int(counts.max().item()) if r else 0):
        tiles = torch.nonzero(counts > pos).flatten()
        k = structure.tile_blocks.long()[ptr[tiles] + pos]
        src = xs[:, structure.block_col.long()[k]]  # [F, tiles, c]
        blk = blocks[k].float()  # [tiles, c, i]
        acc = out[:, tiles]
        for c in range(b):
            acc = acc + blk[None, :, c, :] * src[:, :, c, None]
        out[:, tiles] = acc
    return out.reshape(f, structure.padded_rows)


def bcsr_spmm_kernel(structure: BlockSparseStructure, x_t: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """``A @ x`` in the transposed layout: ``x_t [F, padded_nodes]`` (f32)
    to ``[F, padded_rows]`` (f32), for int8 (0/1, or any signed value, taken
    at that value), bf16 or f32 blocks. The f32 form takes each weight at
    its exact f32 value, so the result is exact up to summation order;
    ``compute_dtype=torch.bfloat16`` runs the bf16 form (``x_t`` f32 or
    bf16, rounded to bf16; f32 blocks rounded to bf16).

    The CUDA kernel first copies ``x_t`` node-major into a scratch tensor
    (``[padded_nodes, F rounded up to 4]``, allocated here each call), then
    multiplies only the nonzero entries, in the order of
    :func:`bcsr_spmm_order_ref`. So an Inf or NaN in ``x_t`` under a zero
    weight adds nothing there (as in cuSPARSE), where the plain version's
    dense product turns it into NaN; on finite inputs skipping a zero
    changes no bit of the sum."""
    if x_t.dim() != 2:
        msg = f"expected x_t [F, padded_nodes], got shape {tuple(x_t.shape)}"
        raise ValueError(msg)
    f = x_t.shape[0]
    dev = x_t.device
    act = activation_dtype(compute_dtype)
    x_t = _operand(x_t, "x_t", act, (f, structure.padded_nodes), dev)
    nb, b = structure.num_blocks, structure.block
    blocks = structure.blocks_t
    if blocks.dtype not in BLOCK_DTYPES:
        msg = f"blocks_t must be one of {tuple(BLOCK_DTYPES)}, got {blocks.dtype}"
        raise TypeError(msg)
    _require(blocks, "blocks_t", blocks.dtype, (nb, b, b), dev)
    for name in ("block_col", "tile_ptr", "tile_blocks"):
        t = getattr(structure, name)
        _require(t, name, torch.int32, tuple(t.shape), dev)
    if not _route(dev):
        return bcsr_spmm_kernel_ref(structure, x_t, act)
    if b != DEFAULT_BLOCK:
        msg = f"the CUDA kernel takes {DEFAULT_BLOCK}-node blocks, got {b}"
        raise ValueError(msg)
    lib = _lib()
    with torch.cuda.device(dev):
        out = torch.empty((f, structure.padded_rows), dtype=torch.float32, device=dev)
        ldn = -(-f // 4) * 4
        x_nodes = torch.empty((structure.padded_nodes, ldn), dtype=x_t.dtype, device=dev)  # the kernel's node-major x
        code = lib.bcsr_spmm_kernel(
            blocks.data_ptr(),
            BLOCK_DTYPES[blocks.dtype],
            structure.block_col.data_ptr(),
            structure.tile_ptr.data_ptr(),
            structure.tile_blocks.data_ptr(),
            x_t.data_ptr(),
            ACT_DTYPES[act],
            x_nodes.data_ptr(),
            ldn,
            out.data_ptr(),
            structure.num_row_tiles,
            f,
            structure.padded_nodes,
            structure.padded_rows,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, code, "bcsr_spmm_kernel")
    launches["bcsr_spmm_kernel"] += 1
    launches_by_dtype["bcsr_spmm_kernel"][form_name(blocks.dtype, act)] += 1
    return out


# ---------------------------------------------------------------------------
# Differentiable SpMM (the JAX package's custom_vjp functions)


class _BcsrSpmmT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_t, structure, compute_dtype):
        ctx.structure = structure
        ctx.compute_dtype = compute_dtype
        return bcsr_spmm_kernel(structure, x_t, compute_dtype)

    @staticmethod
    def backward(ctx, grad):
        return bcsr_spmm_kernel(ctx.structure, grad.contiguous(), ctx.compute_dtype), None, None


def _check_width(structure: BlockSparseStructure, width: int, what: str) -> None:
    if width != structure.padded_nodes:
        msg = f"{what} has {width} nodes; the structure expects {structure.padded_nodes}"
        raise ValueError(msg)


def bcsr_spmm_t(structure: BlockSparseStructure, x_t: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``A @ x`` with transposed ``[F, padded_nodes] -> [F, padded_rows]``
    input and output (the layout the kernel computes in), differentiable
    w.r.t. ``x_t``: the VJP is the same SpMM of the cotangent (A is
    symmetric), in the same kernel form (``compute_dtype``, see
    :func:`bcsr_spmm_kernel`)."""
    _check_width(structure, x_t.shape[1], "x_t")
    return _BcsrSpmmT.apply(x_t, structure, compute_dtype)


def bcsr_spmm_t_ref(structure: BlockSparseStructure, x_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bcsr_spmm_t` (autograd through the
    gather, einsum and index_add)."""
    _check_width(structure, x_t.shape[1], "x_t")
    return bcsr_spmm_kernel_ref(structure, x_t)


def bcsr_spmm(structure: BlockSparseStructure, x: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``A @ x`` for row-major ``x [padded_nodes, F]``: :func:`bcsr_spmm_t`
    between two transposes."""
    _check_width(structure, x.shape[0], "x")
    return _BcsrSpmmT.apply(x.T.contiguous(), structure, compute_dtype).T
