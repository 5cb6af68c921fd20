"""Sorted segment-sum kernel (counterpart of
``deeprank2_tpu/ops/pallas_segment.py``, as ops/vanilla.py is of
``pallas_vanilla.py``).

The CUDA kernel ``segment_sum_sorted_kernel`` (K7, ``csrc/segment_sum.cu``)
computes ``out[v] = sum_{e: rows[e] = v} messages[e]`` over messages whose
rows are ascending with the padding (``>= num_segments``) last, as the COO
collate emits them, in two launches: the row offsets
(:func:`segment_offsets_ref` is their plain version), then each output row's
contiguous run of messages summed in edge order, lanes on feature quads, no
atomics.

The wrapper takes its plain PyTorch version
(:func:`segment_sum_sorted_kernel_ref`) for tensors on the CPU, launches the
kernel for tensors on a CUDA device, and raises for anything else; it counts
its launches in :data:`launches`. Ascending rows are the caller's promise, as
in the JAX package: the kernel does not check them.
"""

from __future__ import annotations

import ctypes

import torch

from deeprank2_tpu_torch.ops import _build
from deeprank2_tpu_torch.ops.diag_spmm import _require, _route

SOURCE = "segment_sum"

# kernel launches since the last reset_launches(), by kernel
launches = {"segment_sum_sorted_kernel": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library(SOURCE)
    if lib.segment_sum_sorted_kernel.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.segment_sum_sorted_kernel.argtypes = [p, p, ll, i, i, p, p, p]  # msg, rows, E, V, F, row_ptr, out, stream
        lib.segment_sum_sorted_kernel.restype = i
    return lib


# ---------------------------------------------------------------------------
# K7: segment_sum_sorted_kernel (replaces deeprank2_tpu/ops/pallas_segment.py:_kernel)


def segment_offsets_ref(rows: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's first launch: ``row_ptr
    [num_segments + 1]`` (int64), ``row_ptr[v]`` the first ``e`` with
    ``rows[e] >= v``, so that segment ``v``'s messages are ``row_ptr[v] ..
    row_ptr[v + 1] - 1`` and the padding lies past ``row_ptr[num_segments]``."""
    bounds = torch.arange(num_segments + 1, dtype=rows.dtype, device=rows.device)
    return torch.searchsorted(rows, bounds, side="left")


def segment_sum_sorted_kernel_ref(messages: torch.Tensor, rows: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_sum_sorted_kernel`, through the
    row offsets: message ``e`` goes to the segment whose run holds it (the
    last ``v`` with ``row_ptr[v] <= e``), the messages outside every run (the
    padding) to a spare row, by an ``index_add``."""
    row_ptr = segment_offsets_ref(rows, num_segments)
    edges = torch.arange(messages.shape[0], dtype=torch.int64, device=messages.device)
    ids = (torch.searchsorted(row_ptr, edges, right=True) - 1).clamp(-1, num_segments)
    out = messages.new_zeros((num_segments + 2, messages.shape[1]))
    return out.index_add(0, ids + 1, messages)[1 : num_segments + 1]


def segment_sum_order_ref(messages: torch.Tensor, rows: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The kernel's f32 sums in its order: step ``k`` adds the ``k``-th
    message of every segment's run to the running sums (from +0), so each
    output row is the ascending f32 sum over its run, as the kernel adds it.
    A loop of as many steps as the longest run (the card tests hold the
    kernel to it bit for bit)."""
    row_ptr = segment_offsets_ref(rows, num_segments)
    beg, lengths = row_ptr[:-1], row_ptr.diff()
    out = messages.new_zeros((num_segments, messages.shape[1]))
    for k in range(int(lengths.max())):
        live = lengths > k
        out[live] += messages[beg[live] + k]
    return out


def segment_sum_sorted_kernel(messages: torch.Tensor, rows: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out [num_segments, F]`` (f32) from ``messages [E, F]`` (f32) and
    ``rows [E]`` (int32, ascending, padding ``>= num_segments`` last). Segments
    without a message get exact zeros."""
    if messages.dim() != 2 or rows.dim() != 1:
        msg = f"expected messages [E, F] and rows [E], got {tuple(messages.shape)} and {tuple(rows.shape)}"
        raise ValueError(msg)
    e, f = messages.shape
    dev = messages.device
    _require(messages, "messages", torch.float32, (e, f), dev)
    _require(rows, "rows", torch.int32, (e,), dev)
    if num_segments < 1 or f < 1:
        msg = f"need num_segments >= 1 and F >= 1, got {num_segments} and {f}"
        raise ValueError(msg)
    if not _route(dev):
        return segment_sum_sorted_kernel_ref(messages, rows, num_segments)
    lib = _lib()
    with torch.cuda.device(dev):
        row_ptr = torch.empty(num_segments + 1, dtype=torch.int64, device=dev)
        out = torch.empty((num_segments, f), dtype=torch.float32, device=dev)
        code = lib.segment_sum_sorted_kernel(
            messages.data_ptr(), rows.data_ptr(), e, num_segments, f, row_ptr.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream
        )
        _build.check(lib, code, "segment_sum_sorted_kernel")
    launches["segment_sum_sorted_kernel"] += 1
    return out


# ---------------------------------------------------------------------------
# The differentiable sorted segment sum (the JAX package's custom_vjp)


class _SegmentSumSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, messages, rows, num_segments):
        ctx.num_segments = num_segments
        ctx.save_for_backward(rows)
        return segment_sum_sorted_kernel(messages, rows, num_segments)

    @staticmethod
    def backward(ctx, grad):
        # a row gather, no kernel (pallas_segment.py:_segment_sum_bwd)
        (rows,) = ctx.saved_tensors
        n = ctx.num_segments
        d_messages = grad[rows.clamp(0, n - 1)] * (rows < n).to(grad.dtype)[:, None]
        return d_messages, None, None


def segment_sum_sorted(messages: torch.Tensor, rows: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment sum over messages pre-sorted by ``rows`` (out-of-range rows
    sort last), differentiable in ``messages``: f32 ``[E, F]``, int32 ``[E]``
    ascending -> ``[num_segments, F]``."""
    return _SegmentSumSorted.apply(messages, rows, num_segments)


def pallas_segment_sum(messages: torch.Tensor, rows: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment sum for rows in any order: a stable sort by row, then
    :func:`segment_sum_sorted` (the JAX name, kept so a reader finds it)."""
    order = torch.argsort(rows, stable=True)
    return segment_sum_sorted(messages[order], rows[order], num_segments)
