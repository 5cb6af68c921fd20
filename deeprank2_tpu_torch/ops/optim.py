"""Optimizers (port of ``deeprank2_tpu/ops/optim.py``: ``Optimizer``,
``Adam``, ``AdamW``, ``SGD``).

Each is a ``torch.optim.Optimizer`` that updates its parameters in place
with the JAX package's rule, written in the same order of operations. As in
JAX, every parameter is updated, including those that took no part in the
loss: a parameter whose ``.grad`` is None counts as having a zero gradient,
so it still decays. (``torch.optim.Adam`` skips such parameters; GINetDense's
``fc_edge_attr`` and ``fc_attention`` are of this kind.) Adam's bias
corrections are float32 host scalars, as JAX computes them.
"""

from __future__ import annotations

import copy

import numpy as np
import torch


class Optimizer(torch.optim.Optimizer):
    """Base optimizer: one parameter group with ``lr`` and ``weight_decay``
    (the JAX base's fields); subclasses implement ``_update``, the rule for
    one parameter."""

    def __init__(self, params, lr: float = 1e-3, weight_decay: float = 0.0, **defaults):
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay, **defaults})

    @property
    def lr(self) -> float:
        return self.param_groups[0]["lr"]

    @property
    def weight_decay(self) -> float:
        return self.param_groups[0]["weight_decay"]

    def state_dict(self) -> dict:
        """torch's state dict (``state``, ``param_groups``) with the JAX
        base's ``type``, ``lr`` and ``weight_decay`` beside it."""
        return {**super().state_dict(), "type": type(self).__name__, "lr": self.lr, "weight_decay": self.weight_decay}

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a copy of ``state_dict``'s state (torch's own would share its
        tensors with the dict when device and dtype already match)."""
        super().load_state_dict(copy.deepcopy({k: state_dict[k] for k in ("state", "param_groups")}))

    def __repr__(self) -> str:
        return f"{type(self).__name__}(lr={self.lr}, weight_decay={self.weight_decay})"

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            msg = f"{type(self).__name__}.step takes no closure"
            raise ValueError(msg)
        for group in self.param_groups:
            for p in group["params"]:
                self._update(group, p, torch.zeros_like(p) if p.grad is None else p.grad, self.state[p])

    def _update(self, group: dict, p: torch.Tensor, grad: torch.Tensor, state: dict) -> None:
        raise NotImplementedError


class Adam(Optimizer):
    """Adam with L2 weight decay folded into the gradient (torch.optim.Adam
    semantics; the decoupled variant is :class:`AdamW`)."""

    def __init__(self, params, lr: float = 1e-3, betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, lr, weight_decay, betas=betas, eps=eps)

    @staticmethod
    def _adam(group: dict, p: torch.Tensor, grad: torch.Tensor, state: dict, wd: float) -> None:
        b1, b2 = group["betas"]
        lr, eps = group["lr"], group["eps"]
        if not state:
            state["step"] = 0
            state["m"] = torch.zeros_like(p)
            state["v"] = torch.zeros_like(p)
        state["step"] += 1
        count = state["step"]
        if wd:
            grad = grad + wd * p
        m, v = state["m"], state["v"]
        m.mul_(b1).add_(grad, alpha=1 - b1)
        v.mul_(b2).addcmul_(grad, grad, value=1 - b2)
        # the bias corrections in float32, as JAX computes them (host scalars)
        one, step = np.float32(1.0), np.float32(count)
        mhat_scale = float(one / (one - np.float32(b1) ** step))
        vhat_scale = float(one / (one - np.float32(b2) ** step))
        p.sub_(lr * (m * mhat_scale) / ((v * vhat_scale).sqrt() + eps))

    def _update(self, group: dict, p: torch.Tensor, grad: torch.Tensor, state: dict) -> None:
        self._adam(group, p, grad, state, group["weight_decay"])


class ReferenceAdam(Adam):
    """Adam in the arithmetic of ``torch.optim.Adam``, the reference's
    optimizer (its single-tensor loop): the first moment by ``lerp``, the
    bias corrections as float64 host scalars, the step as ``addcdiv``. It
    differs from :class:`Adam` only in rounding; :class:`Adam` takes the
    corrections in float32, as JAX does, where ``1 - float32(0.999)``
    is 1.3e-5 from ``1 - 0.999``. As :class:`Adam`, it updates every
    parameter."""

    @staticmethod
    def _adam(group: dict, p: torch.Tensor, grad: torch.Tensor, state: dict, wd: float) -> None:
        b1, b2 = group["betas"]
        lr, eps = group["lr"], group["eps"]
        if not state:
            state["step"] = 0
            state["m"] = torch.zeros_like(p)
            state["v"] = torch.zeros_like(p)
        state["step"] += 1
        count = state["step"]
        if wd:
            grad = grad.add(p, alpha=wd)
        m, v = state["m"], state["v"]
        m.lerp_(grad, 1 - b1)
        v.mul_(b2).addcmul_(grad, grad, value=1 - b2)
        denom = (v.sqrt() / (1 - b2**count) ** 0.5).add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1 - b1**count))


class AdamW(Adam):
    """Adam with decoupled weight decay: ``lr * weight_decay * p``, taken from
    the parameter before the Adam update, is subtracted after it."""

    def _update(self, group: dict, p: torch.Tensor, grad: torch.Tensor, state: dict) -> None:
        wd = group["weight_decay"]
        decay = group["lr"] * wd * p if wd else None
        self._adam(group, p, grad, state, 0.0)
        if decay is not None:
            p.sub_(decay)


class SGD(Optimizer):
    """SGD with L2 weight decay folded into the gradient and, when
    ``momentum`` is set, the buffer ``buf = momentum * buf + g`` (no
    dampening, no Nesterov)."""

    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, lr, weight_decay, momentum=momentum)

    @staticmethod
    def _update(group: dict, p: torch.Tensor, grad: torch.Tensor, state: dict) -> None:
        lr, wd, momentum = group["lr"], group["weight_decay"], group["momentum"]
        if wd:
            grad = grad + wd * p
        if momentum:
            if not state:
                state["momentum"] = torch.zeros_like(p)
            buf = state["momentum"]
            buf.mul_(momentum).add_(grad)
            p.sub_(lr * buf)
        else:
            p.sub_(lr * grad)
