"""Segment aggregation (port of ``deeprank2_tpu/ops/segment.py``:
``set_segment_backend``, ``segment_sum``, ``segment_count``,
``segment_mean``, ``segment_max`` and ``segment_softmax``; ``segment_min``
is the JAX package's inline ``.at[ids].min(mode="drop")``).

Padding convention, as in the JAX package: rows whose segment id is out of
range (``>= num_segments``; padding carries ``num_segments``) are dropped.
PyTorch's ``index_add`` and ``scatter_reduce`` refuse such ids, so the plain
path clamps every id to ``num_segments``, aggregates into one spare row and
cuts it off: no boolean mask, so nothing waits for the device. Ids are
non-negative.

With the backend at ``"pallas"`` (the default), a sorted 2-D sum
(``indices_sorted=True``) of a CUDA tensor runs the CUDA kernel K7
(ops/segment_sorted.py), at every size: the JAX package's Pallas route,
whose VMEM guard is a TPU limit the kernel does not share. Every other call
takes the plain path, as the JAX ``"xla"`` route does.
"""

from __future__ import annotations

import torch

from deeprank2_tpu_torch.ops.segment_sorted import segment_sum_sorted

_SEGMENT_BACKEND = "pallas"


def set_segment_backend(name: str) -> None:
    """Select the segment-sum implementation: ``"pallas"`` (default; the CUDA
    kernel K7 for sorted 2-D sums on a CUDA device) or ``"xla"`` (the plain
    scatter, which unsorted, 1-D and CPU sums always take). The names are the
    JAX package's."""
    global _SEGMENT_BACKEND
    if name not in ("xla", "pallas"):
        msg = f"unknown segment backend: {name}"
        raise ValueError(msg)
    _SEGMENT_BACKEND = name


def _spare_row_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 ids with every out-of-range one sent to the spare row ``num_segments``."""
    return segment_ids.clamp(max=num_segments).long()


def gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` for row ids of which the out-of-range ones (padding,
    ``>= x.shape[0]``) the caller masks out afterwards. The JAX package clamps
    them to the last row; here entry i reads row ``i mod V`` instead: the same
    values once masked, but no row repeated by the padding, which the
    gather's backward on CUDA (a sort, then a loop over each row's repeats)
    would otherwise walk one entry at a time."""
    n = x.shape[0]
    spread = torch.arange(index.shape[0], dtype=index.dtype, device=index.device) % n
    return x[torch.where(index < n, index, spread)]


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, indices_sorted: bool = False) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets; out-of-range ids are dropped.

    ``indices_sorted=True`` promises ascending ids (padding sorted last, as the
    COO collate produces) and routes a 2-D sum of a CUDA tensor to K7."""
    if _SEGMENT_BACKEND == "pallas" and indices_sorted and data.dim() == 2 and data.device.type == "cuda":
        return segment_sum_sorted(data, segment_ids, num_segments)
    out = data.new_zeros((num_segments + 1, *data.shape[1:]))
    return out.index_add(0, _spare_row_ids(segment_ids, num_segments), data)[:num_segments]


def segment_count(segment_ids: torch.Tensor, num_segments: int, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Count of rows per segment (optionally masked), f32."""
    ones = torch.ones(segment_ids.shape[0], dtype=torch.float32, device=segment_ids.device)
    if valid is not None:
        ones = ones * valid.to(torch.float32)
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Mean of ``data`` rows per segment; empty segments give 0."""
    sums = segment_sum(data, segment_ids, num_segments)
    counts = segment_count(segment_ids, num_segments).clamp_min(1.0)
    return sums / counts.reshape((-1,) + (1,) * (data.dim() - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Max of ``data`` rows per segment; empty segments give 0 (torch_scatter
    parity for post-relu features). The gradient is shared equally among the
    rows that reach a segment's max, as in JAX's scatter-max rule."""
    index = _spare_row_ids(segment_ids, num_segments).reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    init = data.new_full((num_segments + 1, *data.shape[1:]), -torch.inf)
    out = init.scatter_reduce(0, index, data, reduce="amax", include_self=True)[:num_segments]
    return torch.where(torch.isneginf(out), torch.zeros((), dtype=out.dtype, device=out.device), out)


def segment_min(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, fill: int) -> torch.Tensor:
    """Per-segment min of integer ``values`` (a graph or cluster id per
    segment); empty segments keep ``fill``."""
    init = torch.full((num_segments + 1,), fill, dtype=values.dtype, device=values.device)
    return init.scatter_reduce(0, _spare_row_ids(segment_ids, num_segments), values, reduce="amin", include_self=True)[:num_segments]


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Numerically stable softmax over rows sharing a segment id (masked rows
    and out-of-range ids get probability 0)."""
    trailing = (-1,) + (1,) * (logits.dim() - 1)
    safe = segment_ids.clamp(0, num_segments - 1).long()
    shifted = logits - segment_max(logits, segment_ids, num_segments)[safe]
    expd = torch.exp(shifted)
    if valid is not None:
        expd = expd * valid.to(expd.dtype).reshape(trailing)
    denom = segment_sum(expd, segment_ids, num_segments).clamp_min(1e-16)
    out = expd / denom[safe]
    return out * (segment_ids < num_segments).to(out.dtype).reshape(trailing)
