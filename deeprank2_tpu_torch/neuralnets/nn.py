"""Minimal NN primitives (port of ``deeprank2_tpu/neuralnets/nn.py``).

Initialization follows the JAX package and the reference: a linear layer's
weight and bias are uniform in ``±1/sqrt(init_size or in_dim)``, a Conv3d's
in ``±1/sqrt(in_ch · k³)`` (torch's default). Random bits come from an
explicit ``torch.Generator`` (they differ from ``jax.random``'s for the same
seed; tests load the JAX initialization instead).

The 3D convolution and max-pool are the JAX package's XLA ops
(``conv_general_dilated``, ``reduce_window``), no Pallas kernel, so their
twins are PyTorch's (cuDNN on the card). The convolution sums in float32
whatever ``torch.backends.cudnn.allow_tf32`` says, in its forward and in its
backward (:class:`_Conv3dF32`): the JAX package's precision is near-f32.
"""

from __future__ import annotations

import contextlib
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


def init_conv3d(
    in_ch: int,
    out_ch: int,
    ksize: int,
    bias: bool = True,
    generator: torch.Generator | None = None,
    device: torch.device | None = None,
) -> nn.Conv3d:
    """``nn.Conv3d(in_ch, out_ch, ksize)`` (weight ``[out, in, k, k, k]``, the
    JAX package's layout) drawn from ``U(-b, b)``, ``b = 1/sqrt(in_ch · k³)``,
    on the CPU generator ``generator`` and then moved to ``device``."""
    bound = 1.0 / math.sqrt(in_ch * ksize**3)
    layer = nn.Conv3d(in_ch, out_ch, ksize, bias=bias, device="meta")
    weight = torch.empty(out_ch, in_ch, ksize, ksize, ksize).uniform_(-bound, bound, generator=generator)
    layer.weight = nn.Parameter(weight.to(device))
    if bias:
        layer.bias = nn.Parameter(torch.empty(out_ch).uniform_(-bound, bound, generator=generator).to(device))
    return layer


@contextlib.contextmanager
def ieee_fp32():
    """cuDNN without TF32 inside the block (the global flag restored after)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class _Conv3dF32(torch.autograd.Function):
    """VALID, stride-1 ``conv3d`` whose forward and backward both run under
    :func:`ieee_fp32`: autograd's own backward would run after the forward's
    context has closed, under whatever the global flag says then."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        with ieee_fp32():
            return nn.functional.conv3d(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], ctx.has_bias and ctx.needs_input_grad[2]]
        with ieee_fp32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if ctx.has_bias else None, [1, 1, 1], [0, 0, 0], [1, 1, 1], False, [0, 0, 0], 1, mask
            )
        return gx, gw, gb


def conv3d(layer: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """VALID, stride-1 3D convolution of ``x [N, C, W, H, D]`` (NCDHW) with the
    layer's ``[out, in, k, k, k]`` kernel, in float32 (no TF32)."""
    return _Conv3dF32.apply(x, layer.weight, layer.bias)


def max_pool3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Max pooling with stride = window over ``x [N, C, W, H, D]`` (VALID: a
    ragged edge is dropped). A tied window sends its cotangent to its first
    maximum in (W, H, D) order, as JAX's ``reduce_window`` does."""
    return nn.functional.max_pool3d(x, window, stride=window)


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
