"""Fused two-layer GINet tower on batched ``[G, N, F]`` graphs (port of
``deeprank2_tpu/ops/pallas_ginet.py``).

Per graph, with the towers fused on the weight side (``w1 [F, C1]``,
``w2 [C1, C2]``, see ``GINetDense``):

    h1 = relu(A (x w1));  h2 = relu(A (h1 w2)) * mask;  pooled = sum_n h2

runs in the CUDA kernels of ``csrc/ginet_tower.cu``, one thread block per
graph on one shared-memory plan, every intermediate in shared memory:
``ginet_tower_fwd_kernel`` (two graphs an SM in f32, four in bf16; only the
``[G, C2]`` pooled sums written, summed over the nodes in a fixed order)
and ``ginet_tower_bwd_kernel`` (two graphs an SM in f32, three in bf16; it
recomputes h1 and h2 from the same resident adjacency through the
forward's code, runs its node products on the tensor cores in the bf16 form
and every other product in register tiles, and returns the weight
gradients, summed over graphs in a fixed order). ``x``, the adjacency and
the mask are batch data: their cotangents are zeros, as in the JAX package.

``compute_dtype=torch.bfloat16`` selects the single-pass bf16 form of both
kernels (the JAX kernels with ``compute_dtype=bfloat16``): every matmul
operand of the Pallas bodies (``x``, ``w1``, ``fcx``, ``h1``, ``w2``,
``fcx2``; in the backward ``dpooled ⊙ [h2 > 0]``, ``dfcx2``, ``dh1`` and
``dfcx1``) is rounded to bf16 once, as it is staged or produced; the inputs,
every sum and the results are f32. The default is the f32 form.

Each kernel wrapper takes its plain PyTorch version (``*_ref``) for tensors
on the CPU, launches its kernel for tensors on a CUDA device, and raises for
anything else; each counts its kernel launches in :data:`launches`, and by
form in :data:`launches_by_dtype` (``"int8/bfloat16"``: the adjacency type,
then the activation type).
"""

from __future__ import annotations

import ctypes

import torch

from deeprank2_tpu_torch.ops import _build
from deeprank2_tpu_torch.ops.diag_spmm import ACT_DTYPES, _require, _route, activation_dtype, form_name, round_to
from deeprank2_tpu_torch.ops.tower_plan import SMEM_LIMIT, plan_bytes

SOURCE = "ginet_tower"

# kernel launches since the last reset_launches(), by kernel and by form
launches = {"ginet_tower_fwd_kernel": 0, "ginet_tower_bwd_kernel": 0}
launches_by_dtype = {k: {form_name(torch.int8, a): 0 for a in ACT_DTYPES} for k in launches}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for forms in launches_by_dtype.values():
        for form in forms:
            forms[form] = 0


def _count(kernel: str, act: torch.dtype) -> None:
    launches[kernel] += 1
    launches_by_dtype[kernel][form_name(torch.int8, act)] += 1


def smem_bytes(nodes: int, feat: int, c1: int, c2: int, elem_bytes: int = 4) -> int:
    """Shared memory of one block of the forward kernel: the backward's plan
    (:func:`bwd_smem_bytes`) with the signs and dpooled replaced by the warp
    sums of the pool, ``[8, c2p]`` f32, and fcx kept beside x in the wide
    slab (``[rows, ld(max(c2p, kx + c1p))]``) in place of the third slab."""
    return plan_bytes(nodes, feat, c1, c2, elem_bytes, forward=True)


def bwd_smem_bytes(nodes: int, feat: int, c1: int, c2: int, elem_bytes: int = 4) -> int:
    """Shared memory of one block of the backward kernel (the plan of
    ``csrc/tower_common.cuh:plan``; ``elem_bytes`` 4 in the f32 form,
    2 in the bf16 form): nodes, features and channels padded to 16; the
    adjacency's bit rows ``[N, words]``, the mask's bits ``[words]``, the
    signs of h2 ``[c2p, words]`` (uint32) and dpooled ``[c2p]`` (f32); then,
    of ``elem_bytes`` each, w1 ``[kx, ldw1]``, w2 ``[c1p, ldw2]`` and the
    slabs ``[rows, ldp]`` and twice ``[rows, ldh]``, each row padded to an
    odd number of 16-byte units and each part to 16 bytes."""
    return plan_bytes(nodes, feat, c1, c2, elem_bytes, forward=False)


def supports(num_graphs: int, nodes: int, feat: int = 38, c1: int = 32, c2: int = 64) -> bool:
    """The kernels' shape rule: at least one graph, and one graph's forward
    and backward each in the shared memory of one block,
    ``smem_bytes(nodes, feat, c1, c2) <= SMEM_LIMIT`` and the same of
    ``bwd_smem_bytes`` (their f32 forms, the larger). At GINetDense's widths
    (F=38, C1=32, C2=64) that is N <= 352 nodes a graph, where both plans
    end; there is no rule on the number of graphs."""
    fits = smem_bytes(nodes, feat, c1, c2) <= SMEM_LIMIT and bwd_smem_bytes(nodes, feat, c1, c2) <= SMEM_LIMIT
    return num_graphs >= 1 and nodes >= 1 and fits


def _lib() -> ctypes.CDLL:
    lib = _build.library(SOURCE)
    if lib.ginet_tower_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ginet_tower_fwd.argtypes = [p, p, i, p, p, p, p, i, i, i, i, i, p]
        lib.ginet_tower_fwd.restype = i
        lib.ginet_tower_bwd.argtypes = [p, p, i, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.ginet_tower_bwd.restype = i
    return lib


def _dims(w1: torch.Tensor, w2: torch.Tensor, x: torch.Tensor, adj_i8: torch.Tensor, mask: torch.Tensor) -> tuple[int, int, int, int, int]:
    """``(G, N, F, C1, C2)`` of the kernels' operands, checked."""
    if x.dim() != 3 or w1.dim() != 2 or w2.dim() != 2:
        msg = f"expected w1 [F, C1], w2 [C1, C2] and x [G, N, F], got {tuple(w1.shape)}, {tuple(w2.shape)} and {tuple(x.shape)}"
        raise ValueError(msg)
    g, n, f = x.shape
    c1, c2 = w1.shape[1], w2.shape[1]
    dev = x.device
    _require(x, "x", torch.float32, (g, n, f), dev)
    _require(adj_i8, "adj_i8", torch.int8, (g, n, n), dev)
    _require(mask, "mask", torch.bool, (g, n), dev)
    _require(w1, "w1", torch.float32, (f, c1), dev)
    _require(w2, "w2", torch.float32, (c1, c2), dev)
    return g, n, f, c1, c2


# ---------------------------------------------------------------------------
# K8f: ginet_tower_fwd_kernel (replaces deeprank2_tpu/ops/pallas_ginet.py:_fwd_kernel)


def ginet_tower_fwd_kernel_ref(w1: torch.Tensor, w2: torch.Tensor, x: torch.Tensor, adj_i8: torch.Tensor, mask: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`ginet_tower_fwd_kernel` (the JAX
    ``ginet_tower_pooled_reference``; the bf16 form rounds where the JAX
    kernel casts to bf16)."""
    act = activation_dtype(compute_dtype)

    def r(t):
        return round_to(t, act)

    adj = adj_i8.to(torch.float32)
    h1 = torch.relu(adj @ r(r(x.float()) @ r(w1)))
    h2 = torch.relu(adj @ r(r(h1) @ r(w2))) * mask.to(torch.float32)[:, :, None]
    return h2.sum(dim=1)


def ginet_tower_fwd_kernel(w1: torch.Tensor, w2: torch.Tensor, x: torch.Tensor, adj_i8: torch.Tensor, mask: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Pooled sums ``[G, C2]`` (f32) of the fused tower: ``w1 [F, C1]``,
    ``w2 [C1, C2]``, ``x [G, N, F]`` (f32), ``adj_i8 [G, N, N]`` (int8 0/1,
    symmetric), ``mask [G, N]`` (bool). ``compute_dtype=torch.bfloat16``
    runs the bf16 form."""
    act = activation_dtype(compute_dtype)
    g, n, f, c1, c2 = _dims(w1, w2, x, adj_i8, mask)
    dev = x.device
    if not _route(dev):
        return ginet_tower_fwd_kernel_ref(w1, w2, x, adj_i8, mask, act)
    lib = _lib()
    with torch.cuda.device(dev):
        pooled = torch.empty((g, c2), dtype=torch.float32, device=dev)
        code = lib.ginet_tower_fwd(
            adj_i8.data_ptr(), x.data_ptr(), ACT_DTYPES[act], mask.data_ptr(), w1.data_ptr(), w2.data_ptr(), pooled.data_ptr(),
            g, n, f, c1, c2, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, code, "ginet_tower_fwd_kernel")
    _count("ginet_tower_fwd_kernel", act)
    return pooled


# ---------------------------------------------------------------------------
# K8b: ginet_tower_bwd_kernel (replaces deeprank2_tpu/ops/pallas_ginet.py:_bwd_kernel)


def _bwd_terms(w1, w2, x, adj_i8, mask, dpooled, act):
    """The per-graph factors of the weight gradients: ``(x, dfcx1, h1, dfcx2)``
    with ``dw1 = Σ_g x[g]ᵀ dfcx1[g]`` and ``dw2 = Σ_g h1[g]ᵀ dfcx2[g]``, each
    as the form ``act`` takes it into the products (rounded to bf16 in the
    bf16 form)."""

    def r(t):
        return round_to(t, act)

    adj = adj_i8.to(torch.float32)
    x, w2 = r(x.float()), r(w2)
    h1 = r(torch.relu(adj @ r(x @ r(w1))))
    h2 = torch.relu(adj @ r(h1 @ w2)) * mask.to(torch.float32)[:, :, None]
    # adj is symmetric: adjᵀ v == adj v
    dfcx2 = r(adj @ r(dpooled[:, None, :] * (h2 > 0).to(torch.float32)))
    dh1 = (dfcx2 @ w2.T) * (h1 > 0).to(torch.float32)
    return x, r(adj @ r(dh1)), h1, dfcx2


def ginet_tower_bwd_kernel_ref(w1, w2, x, adj_i8, mask, dpooled, compute_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ginet_tower_bwd_kernel`."""
    x, dfcx1, h1, dfcx2 = _bwd_terms(w1, w2, x, adj_i8, mask, dpooled, activation_dtype(compute_dtype))
    return torch.einsum("gnf,gnc->fc", x, dfcx1), torch.einsum("gnc,gnd->cd", h1, dfcx2)


def dw_error_scale(w1, w2, x, adj_i8, mask, dpooled, compute_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Σ_g |x[g]|ᵀ |dfcx1[g]|, Σ_g |h1[g]|ᵀ |dfcx2[g]|)``: the sums of the
    absolute values of the products that make ``dw1`` and ``dw2`` (in the
    form ``compute_dtype`` selects), the scale of the rounding error of their
    f32 sums in any order (the tolerance scale when two orders are
    compared)."""
    x, dfcx1, h1, dfcx2 = _bwd_terms(w1, w2, x, adj_i8, mask, dpooled, activation_dtype(compute_dtype))
    return torch.einsum("gnf,gnc->fc", x.abs(), dfcx1.abs()), torch.einsum("gnc,gnd->cd", h1.abs(), dfcx2.abs())


def ginet_tower_bwd_kernel(w1, w2, x, adj_i8, mask, dpooled, compute_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dw1 [F, C1], dw2 [C1, C2])``: the gradients of ``sum(dpooled ⊙
    pooled)`` for the forward of :func:`ginet_tower_fwd_kernel`, with the
    cotangent ``dpooled [G, C2]`` (f32), summed over graphs, in the form
    ``compute_dtype`` selects."""
    act = activation_dtype(compute_dtype)
    g, n, f, c1, c2 = _dims(w1, w2, x, adj_i8, mask)
    dev = x.device
    _require(dpooled, "dpooled", torch.float32, (g, c2), dev)
    if not _route(dev):
        return ginet_tower_bwd_kernel_ref(w1, w2, x, adj_i8, mask, dpooled, act)
    lib = _lib()
    entries = f * c1 + c1 * c2
    with torch.cuda.device(dev):
        part = torch.empty((g, entries), dtype=torch.float32, device=dev)
        out = torch.empty(entries, dtype=torch.float32, device=dev)
        code = lib.ginet_tower_bwd(
            adj_i8.data_ptr(), x.data_ptr(), ACT_DTYPES[act], mask.data_ptr(), w1.data_ptr(), w2.data_ptr(), dpooled.data_ptr(),
            part.data_ptr(), out.data_ptr(), g, n, f, c1, c2, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, code, "ginet_tower_bwd_kernel")
    _count("ginet_tower_bwd_kernel", act)
    return out[: f * c1].view(f, c1), out[f * c1 :].view(c1, c2)


# ---------------------------------------------------------------------------
# The differentiable tower (the JAX package's custom_vjp)


class _GINetTowerPooled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w1, w2, x, adj_i8, mask, compute_dtype):
        ctx.save_for_backward(w1, w2, x, adj_i8, mask)
        ctx.compute_dtype = compute_dtype
        return ginet_tower_fwd_kernel(w1, w2, x, adj_i8, mask, compute_dtype)

    @staticmethod
    def backward(ctx, dpooled):
        w1, w2, x, adj_i8, mask = ctx.saved_tensors
        dw1, dw2 = ginet_tower_bwd_kernel(w1, w2, x, adj_i8, mask, dpooled.contiguous(), ctx.compute_dtype)
        # x is batch data: a zero cotangent, as the JAX custom_vjp returns
        dx = torch.zeros_like(x) if ctx.needs_input_grad[2] else None
        return dw1, dw2, dx, None, None, None


def ginet_tower_pooled(w1: torch.Tensor, w2: torch.Tensor, x: torch.Tensor, adj_i8: torch.Tensor, mask: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Masked-sum pooled output ``[G, C2]`` of the fused two-layer GINet
    tower (divide by the node counts outside for the mean), differentiable
    w.r.t. ``w1 [F, C1]`` and ``w2 [C1, C2]``; ``x [G, N, F]`` gets a zero
    cotangent, ``adj_i8 [G, N, N]`` (int8 0/1, symmetric) and ``mask [G, N]``
    (bool) none. ``compute_dtype=torch.bfloat16`` runs the kernels' bf16
    form (the JAX ``ginet_tower_pooled(..., compute_dtype=bfloat16)``)."""
    return _GINetTowerPooled.apply(w1.contiguous(), w2.contiguous(), x, adj_i8, mask, compute_dtype)


def ginet_tower_pooled_ref(w1: torch.Tensor, w2: torch.Tensor, x: torch.Tensor, adj_i8: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ginet_tower_pooled` in its f32 form
    (autograd through the plain ops; the JAX ``ginet_tower_pooled_reference``)."""
    return ginet_tower_fwd_kernel_ref(w1, w2, x, adj_i8, mask)
