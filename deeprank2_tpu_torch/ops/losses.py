"""Loss functions (port of ``deeprank2_tpu/ops/losses.py``): the 19 loss
classes that ``domain/losstypes.py`` whitelists, in plain PyTorch.

Every loss is a class with ``__call__(pred, target, mask=None)`` returning the
mean over valid elements (``mask`` excludes padded graphs in a batch); the
losses over pairs or triplets take their extra inputs first, as in the JAX
package. Classification losses accept a per-class ``weight`` and follow
torch's weighted-mean semantics (divide by the summed weights of the
targets). Each computes what its JAX twin computes, in the same order of
operations.
"""

from __future__ import annotations

import torch
from torch.nn import functional


def _masked_mean(values: torch.Tensor, mask: torch.Tensor | None, weights: torch.Tensor | None = None) -> torch.Tensor:
    if weights is None:
        weights = torch.ones_like(values)
    if mask is not None:
        weights = weights * mask.to(values.dtype)
    total = weights.sum()
    return (values * weights).sum() / total.clamp_min(1e-12)


def _class_weights(weight, target: torch.Tensor, like: torch.Tensor) -> torch.Tensor | None:
    """``weight[target]`` on ``like``'s device (None without a weight)."""
    if weight is None:
        return None
    return torch.as_tensor(weight, dtype=like.dtype, device=like.device)[target]


class _Loss:
    """Base: repr/name used in checkpoints; losses of one class compare equal."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self).__name__)


# ---------------------------------------------------------------------------
# Regression losses
# ---------------------------------------------------------------------------
class MSELoss(_Loss):
    def __call__(self, pred, target, mask=None):
        return _masked_mean((pred - target) ** 2, mask)


class L1Loss(_Loss):
    def __call__(self, pred, target, mask=None):
        return _masked_mean((pred - target).abs(), mask)


class SmoothL1Loss(_Loss):
    def __init__(self, beta: float = 1.0):
        self.beta = beta

    def __call__(self, pred, target, mask=None):
        diff = (pred - target).abs()
        vals = torch.where(diff < self.beta, 0.5 * diff**2 / self.beta, diff - 0.5 * self.beta)
        return _masked_mean(vals, mask)


class HuberLoss(_Loss):
    def __init__(self, delta: float = 1.0):
        self.delta = delta

    def __call__(self, pred, target, mask=None):
        diff = (pred - target).abs()
        vals = torch.where(diff < self.delta, 0.5 * diff**2, self.delta * (diff - 0.5 * self.delta))
        return _masked_mean(vals, mask)


# ---------------------------------------------------------------------------
# Classification losses
# ---------------------------------------------------------------------------
class CrossEntropyLoss(_Loss):
    """Softmax cross entropy on raw logits ``[N, C]`` and integer targets ``[N]``."""

    def __init__(self, weight: torch.Tensor | None = None):
        self.weight = weight

    def __call__(self, logits, target, mask=None):
        target = target.to(torch.int64)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(1, target[:, None])[:, 0]
        return _masked_mean(nll, mask, _class_weights(self.weight, target, logits))


class NLLLoss(_Loss):
    """Expects log-probabilities ``[N, C]``."""

    def __init__(self, weight: torch.Tensor | None = None):
        self.weight = weight

    def __call__(self, logp, target, mask=None):
        target = target.to(torch.int64)
        nll = -logp.gather(1, target[:, None])[:, 0]
        return _masked_mean(nll, mask, _class_weights(self.weight, target, logp))


class BCELoss(_Loss):
    """Binary cross entropy on probabilities in (0, 1). ``weight`` is kept,
    not applied, as in the JAX package."""

    def __init__(self, weight: torch.Tensor | None = None):
        self.weight = weight

    def __call__(self, pred, target, mask=None):
        eps = 1e-12
        vals = -(target * torch.log(pred.clamp(eps, 1.0)) + (1 - target) * torch.log((1 - pred).clamp(eps, 1.0)))
        return _masked_mean(vals, mask)


class BCEWithLogitsLoss(_Loss):
    def __init__(self, weight: torch.Tensor | None = None):
        self.weight = weight

    def __call__(self, logits, target, mask=None):
        vals = logits.clamp_min(0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
        return _masked_mean(vals, mask)


class SoftMarginLoss(_Loss):
    def __call__(self, pred, target, mask=None):
        return _masked_mean(torch.log1p(torch.exp(-target * pred)), mask)


class PoissonNLLLoss(_Loss):
    def __init__(self, log_input: bool = True):
        self.log_input = log_input

    def __call__(self, pred, target, mask=None):
        vals = torch.exp(pred) - target * pred if self.log_input else pred - target * torch.log(pred.clamp_min(1e-8))
        return _masked_mean(vals, mask)


class GaussianNLLLoss(_Loss):
    def __init__(self, eps: float = 1e-6):
        self.eps = eps

    def __call__(self, pred, target, var=None, mask=None):
        if var is None:
            var = torch.ones_like(pred)
        var = var.clamp_min(self.eps)
        vals = 0.5 * (torch.log(var) + (pred - target) ** 2 / var)
        return _masked_mean(vals, mask)


class KLDivLoss(_Loss):
    def __call__(self, logp, target, mask=None):
        vals = target * (torch.log(target.clamp_min(1e-12)) - logp)
        return _masked_mean(vals.sum(dim=-1), mask)


class MultiLabelMarginLoss(_Loss):
    """Multi-class multi-label hinge (torch.nn.MultiLabelMarginLoss semantics).

    ``target`` is ``[N, C]`` int where each row lists the positive class
    indices and is terminated by the first ``-1``; entries after it are
    ignored. Per sample: ``sum_{j in targets, i not in targets}
    max(0, 1 - (x[y_j] - x_i)) / C``.
    """

    def __call__(self, pred, target, mask=None):
        pred = torch.atleast_2d(pred)
        target = torch.atleast_2d(target).to(torch.int64)
        num_classes = pred.shape[-1]
        valid = torch.cumprod((target >= 0).to(torch.int64), dim=1).bool()
        tgt = torch.where(valid, target, 0)
        onehot = (tgt[..., None] == torch.arange(num_classes, device=tgt.device)).to(pred.dtype) * valid[..., None]
        is_target = onehot.sum(dim=1) > 0
        x_tgt = pred.gather(1, tgt)
        margins = (1.0 - (x_tgt[:, :, None] - pred[:, None, :])).clamp_min(0.0)
        pair_mask = valid[:, :, None] & (~is_target)[:, None, :]
        vals = (margins * pair_mask).sum(dim=(1, 2)) / num_classes
        return _masked_mean(vals, mask)


class MultiLabelSoftMarginLoss(_Loss):
    def __call__(self, pred, target, mask=None):
        vals = -(target * functional.logsigmoid(pred) + (1 - target) * functional.logsigmoid(-pred))
        return _masked_mean(vals.mean(dim=-1), mask)


# "other" losses: present for whitelist parity; using them for these tasks is
# rejected by Trainer.set_lossfunction exactly like in the reference.
class HingeEmbeddingLoss(_Loss):
    def __call__(self, pred, target, mask=None):
        vals = torch.where(target == 1, pred, (1.0 - pred).clamp_min(0.0))
        return _masked_mean(vals, mask)


class CosineEmbeddingLoss(_Loss):
    """torch.nn.CosineEmbeddingLoss: ``1 - cos`` for ``target=1``,
    ``max(0, cos - margin)`` for ``target=-1``."""

    def __init__(self, margin: float = 0.0, eps: float = 1e-8):
        self.margin = margin
        self.eps = eps

    def __call__(self, x1, x2, target, mask=None):
        dot = (x1 * x2).sum(dim=-1)
        norm = torch.linalg.vector_norm(x1, dim=-1) * torch.linalg.vector_norm(x2, dim=-1)
        cos = dot / norm.clamp_min(self.eps)
        vals = torch.where(target == 1, 1.0 - cos, (cos - self.margin).clamp_min(0.0))
        return _masked_mean(vals, mask)


class MarginRankingLoss(_Loss):
    """torch.nn.MarginRankingLoss: ``max(0, -y * (x1 - x2) + margin)``."""

    def __init__(self, margin: float = 0.0):
        self.margin = margin

    def __call__(self, x1, x2, target, mask=None):
        return _masked_mean((-target * (x1 - x2) + self.margin).clamp_min(0.0), mask)


class TripletMarginLoss(_Loss):
    """torch.nn.TripletMarginLoss: ``max(d(a,p) - d(a,n) + margin, 0)`` with
    torch's pairwise distance convention (``eps`` added to the difference)."""

    def __init__(self, margin: float = 1.0, p: float = 2.0, eps: float = 1e-6, swap: bool = False):
        self.margin = margin
        self.p = p
        self.eps = eps
        self.swap = swap

    def _dist(self, a, b):
        return ((a - b + self.eps).abs() ** self.p).sum(dim=-1) ** (1.0 / self.p)

    def __call__(self, anchor, positive, negative, mask=None):
        d_pos = self._dist(anchor, positive)
        d_neg = self._dist(anchor, negative)
        if self.swap:
            d_neg = torch.minimum(d_neg, self._dist(positive, negative))
        return _masked_mean((d_pos - d_neg + self.margin).clamp_min(0.0), mask)


class CTCLoss(_Loss):
    """torch.nn.CTCLoss (forward algorithm over blank-extended targets).

    ``log_probs`` is ``[T, N, C]`` log-softmax output, ``targets`` ``[N, L]``
    padded class ids, plus per-sample ``input_lengths``/``target_lengths``.
    Reduction matches torch's default ``"mean"``: each sample's negative log
    likelihood is divided by its target length (clamped to 1), then averaged.
    The alpha recursion runs over time for the whole batch at once, each
    sample frozen past its ``input_lengths``. Impossible paths carry the
    finite ``_NEG_INF``, as in the JAX package, so no ``-inf - -inf`` turns
    into NaN in the log-space sums.
    """

    _NEG_INF = -1e30

    def __init__(self, blank: int = 0):
        self.blank = blank

    def __call__(self, log_probs, targets, input_lengths, target_lengths, mask=None):
        dev = log_probs.device
        targets = torch.atleast_2d(torch.as_tensor(targets, device=dev)).to(torch.int64)
        input_lengths = torch.as_tensor(input_lengths, device=dev).to(torch.int64)
        target_lengths = torch.as_tensor(target_lengths, device=dev).to(torch.int64)
        num_t, n = log_probs.shape[0], targets.shape[0]
        length = targets.shape[1]
        s_idx = torch.arange(2 * length + 1, device=dev)
        ext = torch.where(s_idx % 2 == 1, targets[:, (s_idx // 2).clamp_max(length - 1)], self.blank)  # [N, S]
        ext_shift2 = torch.cat([torch.full((n, 2), self.blank, dtype=ext.dtype, device=dev), ext[:, :-2]], dim=1)
        # s-2 transitions only between distinct non-blank labels
        allow_skip = (s_idx % 2 == 1) & (s_idx >= 2) & (ext != ext_shift2)
        neg = torch.full((), self._NEG_INF, dtype=log_probs.dtype, device=dev)
        rows = torch.arange(n, device=dev)

        first = log_probs[0]  # [N, C]
        alpha = torch.full((n, s_idx.numel()), self._NEG_INF, dtype=log_probs.dtype, device=dev)
        alpha[:, 0] = first[:, self.blank]
        alpha = torch.where((s_idx == 1) & (target_lengths > 0)[:, None], first[rows, ext[:, 1]][:, None], alpha)
        for t in range(1, num_t):
            advance = torch.cat([neg.expand(n, 1), alpha[:, :-1]], dim=1)
            skip = torch.cat([neg.expand(n, 2), alpha[:, :-2]], dim=1)
            merged = torch.logaddexp(torch.logaddexp(alpha, advance), torch.where(allow_skip, skip, neg))
            new = merged + log_probs[t].gather(1, ext)
            alpha = torch.where((t < input_lengths)[:, None], new, alpha)
        at_end = alpha.gather(1, (2 * target_lengths)[:, None])[:, 0]
        before_end = alpha.gather(1, (2 * target_lengths - 1).clamp_min(0)[:, None])[:, 0]
        end = torch.logaddexp(at_end, torch.where(target_lengths > 0, before_end, neg))
        vals = -end / target_lengths.clamp_min(1)
        return _masked_mean(vals, mask)
