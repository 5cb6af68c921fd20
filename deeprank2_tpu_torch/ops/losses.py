"""Loss functions (port of ``deeprank2_tpu/ops/losses.py``: ``_masked_mean``,
``CrossEntropyLoss``).

``__call__(pred, target, mask=None)`` returns the mean over valid elements
(``mask`` excludes padded graphs); per-class ``weight`` follows torch's
weighted-mean semantics (divide by the summed weights of the targets).
"""

from __future__ import annotations

import torch


def _masked_mean(values: torch.Tensor, mask: torch.Tensor | None, weights: torch.Tensor | None = None) -> torch.Tensor:
    if weights is None:
        weights = torch.ones_like(values)
    if mask is not None:
        weights = weights * mask.to(values.dtype)
    total = weights.sum()
    return (values * weights).sum() / total.clamp_min(1e-12)


class CrossEntropyLoss:
    """Softmax cross entropy on raw logits ``[N, C]`` and integer targets ``[N]``."""

    def __init__(self, weight: torch.Tensor | None = None):
        self.weight = weight

    def __call__(self, logits: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        target = target.to(torch.int64)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(1, target[:, None])[:, 0]
        weights = None if self.weight is None else torch.as_tensor(self.weight, dtype=logits.dtype, device=logits.device)[target]
        return _masked_mean(nll, mask, weights)
