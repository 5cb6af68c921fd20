"""Adam (port of ``deeprank2_tpu/ops/optim.py:Adam``).

The update is the JAX package's, written in the same order: L2 weight decay
folded into the gradient, then Adam with bias correction. As in JAX, every
parameter is updated, including those that took no part in the loss: a
parameter whose ``.grad`` is None counts as having a zero gradient, so it
still decays. (``torch.optim.Adam`` skips such parameters; GINetDense's
``fc_edge_attr`` and ``fc_attention`` are of this kind.)
"""

from __future__ import annotations

import torch


class Adam(torch.optim.Optimizer):
    """Adam with L2 weight decay folded into the gradient. Parameters are
    updated in place."""

    def __init__(self, params, lr: float = 1e-3, betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps, "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            msg = "Adam.step takes no closure"
            raise ValueError(msg)
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                grad = torch.zeros_like(p) if p.grad is None else p.grad
                state = self.state[p]
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
                mhat_scale = 1.0 / (1 - b1**count)
                vhat_scale = 1.0 / (1 - b2**count)
                p.sub_(lr * (m * mhat_scale) / ((v * vhat_scale).sqrt() + eps))
