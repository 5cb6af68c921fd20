"""Blocked per-edge-feature message passing kernels (counterpart of
``deeprank2_tpu/ops/pallas_vanilla.py``, as ops/slotpool.py is of
``pallas_slotpool.py``).

Two CUDA kernels in ``csrc/blocked_edges.cu`` compute
:func:`deeprank2_tpu_torch.ops.blocked_edges.blocked_message_sum`:

- ``blocked_fwd_kernel`` (K6f):
  ``out[v] = sum_{e: row(e)=v} relu(xr[v] + xc[col e] + e_attr(e) · w_e)``;
- ``blocked_bwd_kernel`` (K6b): with ``dmsg(e) = g[row e] ⊙ [pre(e) > 0]``,
  ``dxr`` scatters ``dmsg`` by row, ``dw_e = sum_e e_attr(e) ⊗ dmsg(e)``,
  and ``dxc`` is the same sum scattered by column, which the kernel forms
  at each row from the edge's mirror message (the structure is closed under
  mirroring with equal features), as the TPU kernel does.

Both have two forms, chosen by ``compute_dtype``: f32, and the single-pass
bf16 form of the JAX kernels (``_make_gdot``'s bf16 branch): the wrapper
hands the kernel bf16 copies of ``xr``, ``xc``, ``w_e`` and ``g``, the
kernel rounds the edge features to bf16 as it reads them, the forward rounds
each message ``relu(pre)`` to bf16 before its f32 sum, and every other sum
is f32. In the backward ``dmsg = bf16(g[row]) ⊙ [pre > 0]`` is a bf16 value
already, so JAX's two roundings of it (for the scatter, and for the ``dw_e``
contraction) change nothing.

Each wrapper takes its plain PyTorch version (``*_ref``) for tensors on the
CPU, launches its kernel for tensors on a CUDA device, and raises for
anything else; each counts its launches in :data:`launches`, and by
activation type in :data:`launches_by_dtype`.
"""

from __future__ import annotations

import ctypes

import torch

from deeprank2_tpu_torch.ops import _build
from deeprank2_tpu_torch.ops.blocked_edges import BlockedEdgeStructure, blocked_message_sum_ref, global_indices, pre_activations
from deeprank2_tpu_torch.ops.diag_spmm import ACT_DTYPES, _operand, _require, _route, activation_dtype, dtype_name, round_to

SOURCE = "blocked_edges"
MAX_EDGE_DIM = 8  # edge channels the kernels hold in registers
MAX_BWD_BLOCKS = 2048  # rows of the backward's dw_e partials (the kernel uses at most this many blocks)

# kernel launches since the last reset_launches(), by kernel and by
# activation type ("float32", "bfloat16")
launches = {"blocked_fwd_kernel": 0, "blocked_bwd_kernel": 0}
launches_by_dtype = {k: {dtype_name(a): 0 for a in ACT_DTYPES} for k in launches}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        for form in launches_by_dtype[name]:
            launches_by_dtype[name][form] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library(SOURCE)
    if lib.blocked_fwd_kernel.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        edges = [p, p, p, p, p, ll, i]  # row_ptr, edge_order, col_local, sub_col, eattr_t, E_cap, Fe
        lib.blocked_fwd_kernel.argtypes = [*edges, i, p, p, p, p, i, i, p]
        lib.blocked_fwd_kernel.restype = i
        lib.blocked_bwd_kernel.argtypes = [*edges, i, p, p, p, p, p, p, p, i, p, i, i, p]
        lib.blocked_bwd_kernel.restype = i
    return lib


def _check(structure: BlockedEdgeStructure, act: torch.dtype, xr: torch.Tensor, xc: torch.Tensor, w_e: torch.Tensor, g: torch.Tensor | None = None) -> list:
    """Device, dtype, shape and contiguity of every operand; returns ``xr``,
    ``xc``, ``w_e`` (and ``g``) as the form of activation type ``act``
    reads them (bf16 copies in the bf16 form)."""
    if xr.dim() != 2:
        msg = f"expected xr [padded_nodes, M], got shape {tuple(xr.shape)}"
        raise ValueError(msg)
    dev = xr.device
    v, m = structure.padded_nodes, xr.shape[1]
    shapes = {"xr": (v, m), "xc": (v, m), "w_e": (structure.edge_dim, m), "g": (v, m)}
    ops = [_operand(t, name, act, shapes[name], dev) for name, t in zip(shapes, (xr, xc, w_e, g)) if t is not None]
    _require(structure.eattr_t, "eattr_t", torch.float32, tuple(structure.eattr_t.shape), dev)
    for name in ("row_ptr", "edge_order", "col_local", "sub_col"):
        t = getattr(structure, name)
        _require(t, name, torch.int32, tuple(t.shape), dev)
    return ops


def _edge_args(structure: BlockedEdgeStructure) -> list:
    return [
        structure.row_ptr.data_ptr(),
        structure.edge_order.data_ptr(),
        structure.col_local.data_ptr(),
        structure.sub_col.data_ptr(),
        structure.eattr_t.data_ptr(),
        structure.eattr_t.shape[1],
        structure.edge_dim,
    ]


def _cuda_lib(structure: BlockedEdgeStructure) -> ctypes.CDLL:
    if structure.edge_dim > MAX_EDGE_DIM:
        msg = f"the CUDA kernels take at most {MAX_EDGE_DIM} edge channels, got {structure.edge_dim}"
        raise ValueError(msg)
    return _lib()


# ---------------------------------------------------------------------------
# K6f: blocked_fwd_kernel (replaces deeprank2_tpu/ops/pallas_vanilla.py:_fwd_kernel)


def blocked_fwd_kernel_ref(structure: BlockedEdgeStructure, xr: torch.Tensor, xc: torch.Tensor, w_e: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`blocked_fwd_kernel` (the oracle
    ``blocked_message_sum_ref``)."""
    return blocked_message_sum_ref(structure, xr, xc, w_e, compute_dtype)


def _count(kernel: str, act: torch.dtype) -> None:
    launches[kernel] += 1
    launches_by_dtype[kernel][dtype_name(act)] += 1


def blocked_fwd_kernel(structure: BlockedEdgeStructure, xr: torch.Tensor, xc: torch.Tensor, w_e: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """``out [padded_nodes, M]`` (f32): the message sum of every node over
    its incoming edges, from f32 ``xr``, ``xc [padded_nodes, M]`` and
    ``w_e [Fe, M]`` (bf16 too in the bf16 form, ``compute_dtype=
    torch.bfloat16``). Nodes without an edge get exact zeros."""
    act = activation_dtype(compute_dtype)
    xr, xc, w_e = _check(structure, act, xr, xc, w_e)
    dev = xr.device
    if not _route(dev):
        return blocked_fwd_kernel_ref(structure, xr, xc, w_e, act)
    lib = _cuda_lib(structure)
    with torch.cuda.device(dev):
        out = torch.empty(xr.shape, dtype=torch.float32, device=dev)
        code = lib.blocked_fwd_kernel(
            *_edge_args(structure),
            ACT_DTYPES[act],
            xr.data_ptr(),
            xc.data_ptr(),
            w_e.data_ptr(),
            out.data_ptr(),
            structure.padded_nodes,
            xr.shape[1],
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, code, "blocked_fwd_kernel")
    _count("blocked_fwd_kernel", act)
    return out


# ---------------------------------------------------------------------------
# K6b: blocked_bwd_kernel (replaces deeprank2_tpu/ops/pallas_vanilla.py:_bwd_kernel)


def blocked_bwd_kernel_ref(
    structure: BlockedEdgeStructure, xr: torch.Tensor, xc: torch.Tensor, w_e: torch.Tensor, g: torch.Tensor, compute_dtype=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`blocked_bwd_kernel`: ``dmsg = g[row] ⊙
    [pre > 0]`` per real edge, scattered by row (``dxr``) and by column
    (``dxc``), and ``dw_e = e_attrᵀ dmsg``; the bf16 form rounds every
    operand (``g`` and the edge features too) to bf16."""
    act = activation_dtype(compute_dtype)
    v_pad = structure.padded_nodes
    grow, gcol, pre = pre_activations(structure, xr, xc, w_e, act)
    g = round_to(g, act)
    row = grow.clamp(max=v_pad - 1)
    dmsg = g[row] * ((pre > 0) & (grow < v_pad)[:, None]).to(g.dtype)
    dxr = g.new_zeros(g.shape).index_add(0, row, dmsg)
    dxc = g.new_zeros(g.shape).index_add(0, gcol, dmsg)
    return dxr, dxc, round_to(structure.eattr_t[: structure.edge_dim], act) @ dmsg


def dw_error_scale(structure: BlockedEdgeStructure, g: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """``Σ_e |e_attr(e)| ⊗ |g[row e]|`` over the real edges, ``[Fe, M]`` (both
    rounded to bf16 in the bf16 form): the scale of the rounding error of
    ``dw_e``'s f32 sum of one product per edge, in any summation order (the
    tolerance scale when two orders are compared)."""
    act = activation_dtype(compute_dtype)
    v_pad = structure.padded_nodes
    grow, _ = global_indices(structure)
    g = round_to(g, act)
    ga = g.abs()[grow.clamp(max=v_pad - 1)] * (grow < v_pad)[:, None].to(g.dtype)
    return round_to(structure.eattr_t[: structure.edge_dim], act).abs() @ ga


def blocked_bwd_kernel(
    structure: BlockedEdgeStructure, xr: torch.Tensor, xc: torch.Tensor, w_e: torch.Tensor, g: torch.Tensor, compute_dtype=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dxr, dxc, dw_e)`` (f32): the gradients of ``sum(g ⊙ out)`` for the
    forward of :func:`blocked_fwd_kernel`, with the cotangent ``g
    [padded_nodes, M]`` (f32), in the form ``compute_dtype`` selects. One
    launch runs the per-node pass and the reduction of ``dw_e``'s per-block
    partials."""
    act = activation_dtype(compute_dtype)
    xr, xc, w_e, g = _check(structure, act, xr, xc, w_e, g)
    dev = xr.device
    if not _route(dev):
        return blocked_bwd_kernel_ref(structure, xr, xc, w_e, g, act)
    lib = _cuda_lib(structure)
    fe, m = structure.edge_dim, xr.shape[1]
    with torch.cuda.device(dev):
        dxr = torch.empty(xr.shape, dtype=torch.float32, device=dev)
        dxc = torch.empty(xc.shape, dtype=torch.float32, device=dev)
        dw_e = torch.empty((fe, m), dtype=torch.float32, device=dev)
        partials = torch.empty((MAX_BWD_BLOCKS, fe, m), dtype=torch.float32, device=dev)
        code = lib.blocked_bwd_kernel(
            *_edge_args(structure),
            ACT_DTYPES[act],
            xr.data_ptr(),
            xc.data_ptr(),
            w_e.data_ptr(),
            g.data_ptr(),
            dxr.data_ptr(),
            dxc.data_ptr(),
            partials.data_ptr(),
            MAX_BWD_BLOCKS,
            dw_e.data_ptr(),
            structure.padded_nodes,
            m,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, code, "blocked_bwd_kernel")
    _count("blocked_bwd_kernel", act)
    return dxr, dxc, dw_e


# ---------------------------------------------------------------------------
# The differentiable message sum (the JAX package's custom_vjp)


class _BlockedMessageSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xr, xc, w_e, structure, compute_dtype):
        ctx.structure = structure
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(xr, xc, w_e)
        return blocked_fwd_kernel(structure, xr, xc, w_e, compute_dtype)

    @staticmethod
    def backward(ctx, grad):
        xr, xc, w_e = ctx.saved_tensors
        dxr, dxc, dw_e = blocked_bwd_kernel(ctx.structure, xr, xc, w_e, grad.contiguous(), ctx.compute_dtype)
        return dxr, dxc, dw_e, None, None
