"""Minimal NN primitives (port of ``deeprank2_tpu/neuralnets/nn.py``).

Initialization follows the JAX package and the reference: a linear layer's
weight and bias are uniform in ``±1/sqrt(init_size or in_dim)``. Random bits
come from an explicit ``torch.Generator`` (they differ from ``jax.random``'s
for the same seed; tests load the JAX initialization instead).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def init_linear(
    in_dim: int,
    out_dim: int,
    bias: bool = True,
    init_size: int | None = None,
    generator: torch.Generator | None = None,
    device: torch.device | None = None,
) -> nn.Linear:
    """``nn.Linear(in_dim, out_dim)`` (weight ``[out, in]``) drawn from
    ``U(-b, b)``, ``b = 1/sqrt(init_size or in_dim)``, on the CPU generator
    ``generator`` and then moved to ``device``."""
    bound = 1.0 / math.sqrt(init_size if init_size is not None else in_dim)
    layer = nn.Linear(in_dim, out_dim, bias=bias, device="meta")
    weight = torch.empty(out_dim, in_dim).uniform_(-bound, bound, generator=generator)
    layer.weight = nn.Parameter(weight.to(device))
    if bias:
        layer.bias = nn.Parameter(torch.empty(out_dim).uniform_(-bound, bound, generator=generator).to(device))
    return layer


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return nn.functional.linear(x, layer.weight, layer.bias)


relu = torch.relu


def checked_compute_dtype(model: nn.Module, compute_dtype: torch.dtype | None) -> torch.dtype | None:
    """A model's ``compute_dtype``: None (the kernels' f32 forms) or
    ``torch.bfloat16`` (their single-pass bf16 forms, the JAX package's fast
    training setting); anything else raises ``ValueError``."""
    if compute_dtype is not None and compute_dtype != torch.bfloat16:
        msg = f"{type(model).__name__}(compute_dtype={compute_dtype}): expected None or torch.bfloat16"
        raise ValueError(msg)
    return compute_dtype


def dropout(x: torch.Tensor, rate: float, training: bool, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout (torch semantics). No dropout when not training or
    when ``generator`` is None (as the JAX version with ``rng=None``); the
    generator must live on ``x``'s device."""
    if not training or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
