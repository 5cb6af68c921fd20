"""Slot max pooling (port of ``deeprank2_tpu/ops/pallas_slotpool.py``).

The clustered collates lay nodes out cluster-major in aligned groups of
``slot`` lanes (8 in the slot8 layout; 4 and 2 in the mixed layout's
size-class regions), members padded with masked zero lanes. Depth-0
community pooling then factorizes into a max over every aligned group of
the flat transposed activation ``[F, V] -> [F, V/slot]`` (this module) and a
small member combine (ops/pooling.py).

Two CUDA kernels in ``csrc/slotpool.cu`` compute it: ``slot_fwd_kernel``
(the group max) and ``slot_bwd_kernel`` (its backward: every valid lane
equal to its group's max gets the full cotangent, no division among ties,
as in the JAX package). Each wrapper takes its plain PyTorch version
(``*_ref``) for tensors on the CPU, launches its kernel for tensors on a
CUDA device, and raises for anything else; each counts its kernel launches
in :data:`launches`.
"""

from __future__ import annotations

import ctypes

import torch

from deeprank2_tpu_torch.ops import _build
from deeprank2_tpu_torch.ops.diag_spmm import _require, _route

SOURCE = "slotpool"
SLOT = 8
SLOTS = (2, 4, 8)

# kernel launches since the last reset_launches(), by kernel
launches = {"slot_fwd_kernel": 0, "slot_bwd_kernel": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library(SOURCE)
    if lib.slot_fwd_kernel.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.slot_fwd_kernel.argtypes = [p, p, i, i, i, p]
        lib.slot_fwd_kernel.restype = i
        lib.slot_bwd_kernel.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.slot_bwd_kernel.restype = i
    return lib


def _dims(h_t: torch.Tensor, slot: int) -> tuple[int, int]:
    """``(F, V)`` of ``h_t``, which must be f32 ``[F, V]`` with ``V % slot == 0``."""
    if slot not in SLOTS:
        msg = f"slot must be one of {SLOTS}, got {slot}"
        raise ValueError(msg)
    if h_t.dim() != 2:
        msg = f"expected h_t [F, V], got shape {tuple(h_t.shape)}"
        raise ValueError(msg)
    f, v = h_t.shape
    if v == 0 or v % slot:
        msg = f"the activation width {v} is not a positive multiple of slot={slot}"
        raise ValueError(msg)
    _require(h_t, "h_t", torch.float32, (f, v), h_t.device)
    return f, v


def _aligned(*tensors: torch.Tensor) -> None:
    """The kernels load groups as 16-byte vectors."""
    for t in tensors:
        if t.data_ptr() % 16:
            msg = "the slot kernels need 16-byte aligned tensors (a fresh or contiguous copy is)"
            raise ValueError(msg)


# ---------------------------------------------------------------------------
# K3: slot_fwd_kernel (replaces deeprank2_tpu/ops/pallas_slotpool.py:_fwd_kernel)


def slot_fwd_kernel_ref(h_t: torch.Tensor, slot: int = SLOT) -> torch.Tensor:
    """Plain PyTorch version of :func:`slot_fwd_kernel`."""
    f, v = h_t.shape
    return h_t.reshape(f, v // slot, slot).amax(dim=2)


def slot_fwd_kernel(h_t: torch.Tensor, slot: int = SLOT) -> torch.Tensor:
    """Max over every aligned ``slot``-lane group of ``h_t [F, V]`` (f32):
    ``[F, V/slot]``. No mask is read: ``h_t`` is post-relu and masked, so an
    empty group pools to 0."""
    f, v = _dims(h_t, slot)
    if not _route(h_t.device):
        return slot_fwd_kernel_ref(h_t, slot)
    lib = _lib()
    dev = h_t.device
    with torch.cuda.device(dev):
        pooled = torch.empty((f, v // slot), dtype=torch.float32, device=dev)
        _aligned(h_t, pooled)
        code = lib.slot_fwd_kernel(h_t.data_ptr(), pooled.data_ptr(), f, v, slot, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, code, "slot_fwd_kernel")
    launches["slot_fwd_kernel"] += 1
    return pooled


# ---------------------------------------------------------------------------
# K4: slot_bwd_kernel (replaces deeprank2_tpu/ops/pallas_slotpool.py:_bwd_kernel)


def slot_bwd_kernel_ref(h_t: torch.Tensor, mask_row: torch.Tensor, pooled: torch.Tensor, g: torch.Tensor, slot: int = SLOT) -> torch.Tensor:
    """Plain PyTorch version of :func:`slot_bwd_kernel`."""
    f, v = h_t.shape
    h3 = h_t.reshape(f, v // slot, slot)
    m3 = mask_row.reshape(1, v // slot, slot)
    eq = (h3 == pooled[:, :, None]).to(h_t.dtype) * m3
    return (eq * g[:, :, None]).reshape(f, v)


def slot_bwd_kernel(h_t: torch.Tensor, mask_row: torch.Tensor, pooled: torch.Tensor, g: torch.Tensor, slot: int = SLOT) -> torch.Tensor:
    """Backward of the group max: ``dh[f, v] = [h == pooled(group)] ⊙ mask ⊙
    g(group)`` with ``mask_row [1, V]`` f32 (real lanes 1), ``pooled`` and
    the cotangent ``g`` ``[F, V/slot]``. Every valid lane that ties for its
    group's max gets the full cotangent."""
    f, v = _dims(h_t, slot)
    dev = h_t.device
    _require(mask_row, "mask_row", torch.float32, (1, v), dev)
    _require(pooled, "pooled", torch.float32, (f, v // slot), dev)
    _require(g, "g", torch.float32, (f, v // slot), dev)
    if not _route(dev):
        return slot_bwd_kernel_ref(h_t, mask_row, pooled, g, slot)
    lib = _lib()
    with torch.cuda.device(dev):
        dh = torch.empty((f, v), dtype=torch.float32, device=dev)
        _aligned(h_t, mask_row, dh)
        code = lib.slot_bwd_kernel(
            h_t.data_ptr(), mask_row.data_ptr(), pooled.data_ptr(), g.data_ptr(), dh.data_ptr(), f, v, slot, torch.cuda.current_stream(dev).cuda_stream
        )
        _build.check(lib, code, "slot_bwd_kernel")
    launches["slot_bwd_kernel"] += 1
    return dh


# ---------------------------------------------------------------------------
# The differentiable pool (the JAX package's custom_vjp)


class _SlotGroupMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h_t, mask_row, slot, plain):
        # checked here too, so that a bad mask fails in the forward pass
        _require(mask_row, "mask_row", torch.float32, (1, h_t.shape[-1]), h_t.device)
        pooled = (slot_fwd_kernel_ref if plain else slot_fwd_kernel)(h_t, slot)
        ctx.save_for_backward(h_t, mask_row, pooled)
        ctx.slot, ctx.plain = slot, plain
        return pooled

    @staticmethod
    def backward(ctx, grad):
        h_t, mask_row, pooled = ctx.saved_tensors
        bwd = slot_bwd_kernel_ref if ctx.plain else slot_bwd_kernel
        return bwd(h_t, mask_row, pooled, grad.contiguous(), ctx.slot), None, None, None


def slot_group_max(h_t: torch.Tensor, mask_row: torch.Tensor, slot: int = SLOT) -> torch.Tensor:
    """Max over every aligned ``slot``-lane group: ``[F, V] -> [F, V/slot]``
    (slot 8, 4 or 2).

    ``h_t`` must be non-negative with padded lanes zero (post-relu, masked);
    ``mask_row`` is the ``[1, V]`` f32 validity row (real lanes 1).
    Differentiable in ``h_t``: forward :func:`slot_fwd_kernel`, backward
    :func:`slot_bwd_kernel`."""
    return _SlotGroupMax.apply(h_t, mask_row, slot, False)


def slot_group_max_ref(h_t: torch.Tensor, mask_row: torch.Tensor, slot: int = SLOT) -> torch.Tensor:
    """Plain PyTorch version of :func:`slot_group_max`: the same backward
    rule over the plain versions of both kernels."""
    return _SlotGroupMax.apply(h_t, mask_row, slot, True)
