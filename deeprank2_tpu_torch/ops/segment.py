"""Segment aggregation (port of ``deeprank2_tpu/ops/segment.py``:
``segment_sum``, ``segment_count``, ``segment_mean``, ``segment_max``).

Padding convention, as in the JAX package: rows whose segment id is out of
range (``>= num_segments``; padding carries ``num_segments``) are dropped.
PyTorch's ``index_add_`` and ``scatter_reduce`` refuse such ids, so every
function here masks them out first. Ids are non-negative.

These are plain PyTorch on every device: the JAX package's Pallas route for
sorted segment sums (``ops/pallas_segment.py``) is taken only on a TPU with
``indices_sorted=True``, and the graph-diagonal clustered path never asks
for it.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets; out-of-range ids are dropped."""
    keep = segment_ids < num_segments
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add(0, segment_ids[keep].long(), data[keep])


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
    keep = segment_ids < num_segments
    rows = data[keep]
    index = segment_ids[keep].long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(rows)
    init = data.new_full((num_segments, *data.shape[1:]), -torch.inf)
    out = init.scatter_reduce(0, index, rows, reduce="amax", include_self=True)
    return torch.where(torch.isneginf(out), torch.zeros((), dtype=out.dtype, device=out.device), out)
