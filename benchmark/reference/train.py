"""The reference's training arithmetic: the masked mean cross entropy of the
logits, and Adam with L2 weight decay folded into the gradient (the rule of
``torch.optim.Adam``, with its bias corrections taken in float32 as the
configuration states). Plain PyTorch."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, target.long()[:, None])[:, 0].mean()


def adam_step(params: dict, grads: dict, state: dict, lr: float, weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    b1, b2 = betas
    state["step"] = state.get("step", 0) + 1
    step = np.float32(state["step"])
    mhat = float(np.float32(1) / (np.float32(1) - np.float32(b1) ** step))
    vhat = float(np.float32(1) / (np.float32(1) - np.float32(b2) ** step))
    for name, p in params.items():
        g = grads[name] + weight_decay * p
        m = state.setdefault(("m", name), torch.zeros_like(p))
        v = state.setdefault(("v", name), torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.sub_(lr * (m * mhat) / ((v * vhat).sqrt() + eps))


@contextlib.contextmanager
def precision(tf32: bool):
    """Products in full float32 (``tf32=False``, the configuration's
    precision) or in TF32 on the tensor cores (the control), for cuBLAS and
    cuDNN alike; the flags are restored after."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _probs(logits: torch.Tensor) -> np.ndarray:
    return torch.softmax(logits.detach().double(), dim=-1).cpu().numpy()


def follow(forward, weights: dict, eval_batches, train_batches, optimizer: dict, report_share: float = 1.0, step_share: float = 1.0, tf32: bool = False) -> dict:
    """What the Trainer's first ``train`` call does, step for step: a
    forward over every batch of ``eval_batches`` (its epoch 0), then one
    train step a batch of ``train_batches`` (the same entries, in the order
    its train pass took them). Each yields ``(batch, targets)`` on the
    device, the same batches each time it is iterated. A share < 1 takes a
    loss over that leading share of each batch alone, the mean over the
    rest (faults, for the control readings): ``report_share`` in the loss
    the Trainer reports for the forward pass, ``step_share`` in the loss
    whose gradient each step takes. Returns the per-batch losses of both
    passes from the whole batches' logits, the reported loss, the
    probabilities of both passes (each in its pass's order), the final
    parameters and Adam's moments, on the host."""
    params = {k: v.clone() for k, v in weights.items()}
    state: dict = {}
    eval_losses, train_losses, reported, eval_probs, train_probs = [], [], [], [], []
    with precision(tf32):
        with torch.no_grad():
            for batch, target in eval_batches():
                logits = forward(params, batch)
                n = max(1, int(round(report_share * logits.shape[0])))
                eval_losses.append(float(cross_entropy(logits, target)))
                reported.append(float(cross_entropy(logits[:n], target[:n])))
                eval_probs.append(_probs(logits))
        for batch, target in train_batches():
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            logits = forward(leaves, batch)
            n = max(1, int(round(step_share * logits.shape[0])))
            loss = cross_entropy(logits[:n], target[:n])
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            # the logged loss and the exported outputs are the whole batch's, as the program's are
            train_losses.append(float(cross_entropy(logits.detach(), target)))
            train_probs.append(_probs(logits))
            params = {k: v.detach() for k, v in leaves.items()}
            with torch.no_grad():
                adam_step(params, grads, state, optimizer["lr"], optimizer["weight_decay"])
    return {
        "eval_losses": eval_losses,
        # the Trainer's reported loss of that forward pass: its batches' losses, a mean over equal batches
        "reported_eval_loss": sum(reported) / len(reported),
        "train_losses": train_losses,
        "eval_probs": np.concatenate(eval_probs),
        "train_probs": np.concatenate(train_probs),
        "params": {k: v.cpu() for k, v in params.items()},
        "m": {k: state[("m", k)].cpu() for k in params},
        "v": {k: state[("v", k)].cpu() for k in params},
    }


def score(forward, weights: dict, batches, tf32: bool = False) -> torch.Tensor:
    """Softmax probabilities of every entry, batch after batch, on the host."""
    out = []
    with precision(tf32), torch.no_grad():
        for batch, _ in batches():
            out.append(torch.softmax(forward(weights, batch), dim=-1).double().cpu())
    return torch.cat(out)
