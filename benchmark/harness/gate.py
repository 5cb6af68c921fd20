"""The numbers that decide ``correct``. Each cell's limits file
(``limits/<cell>.json``) names the numbers it holds and their limits, with
the readings each limit was set from; the other numbers are reported
beside them.

A train cell compares what the Trainer's first ``train`` call did (a
forward over every batch, its epoch 0, then one Adam step a batch) with the
reference following the same steps from the same weights on the same
batches:

- ``forward_loss_gap``: the widest relative gap of a batch's loss in the
  forward at the initial weights, from the exported probabilities;
- ``reported_loss_gap``: the relative gap of the loss that the Trainer
  reports for that pass (its batches' loss values) against the reference's;
- ``step_loss_gap``, ``step2_loss_gap``: the same for the train steps'
  losses, all of them or the second alone;
- ``moment_gap``, ``second_moment_gap``: by the worst leaf, the gap between
  the norms of Adam's first (second) moment on the two sides, against the
  reference leaf's norm or the median leaf's, whichever is larger, and
  ``*_median`` by the median leaf;
- ``change_gap`` (and ``change_gap_median``): the same for each leaf's
  change over the call, leaving out leaves whose first moment in the
  reference is under a thousandth of the median leaf's;
  ``change_diff_gap`` (and ``_median``): the norm of the difference of the
  two changes, by leaf, against the same norms;
- ``step1_effect_gap``: what the first step did to the next batch's
  outputs: the gap of the program's probabilities of the train pass's
  second batch from the reference's, against how far the reference's
  first step moved them (the norm of their difference from the same
  entries' epoch-0 probabilities). It reads the first step alone, before
  Adam's sign-like updates of near-zero gradients have compounded.

A score cell compares every answer of set-up's passes and of a sample of
the window's (drawn from the seed, and the last) with the reference's
probabilities:

- ``score_gap``: the widest gap of a probability;
- ``missing``: answers that did not come, came under another name or are
  not finite.
"""

from __future__ import annotations

import numpy as np
import torch


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: dict, ref: dict, leaves: list[str]) -> dict:
    """Each leaf's gap between the norms of ``prog[k]`` and ``ref[k]``,
    against ``max(|ref[k]|, median leaf |ref|)``; a leaf the program lacks
    has norm 0."""
    norms = {k: _norm(ref[k]) for k in leaves}
    median = float(np.median(list(norms.values())))
    return {k: abs((_norm(prog[k]) if k in prog else 0.0) - norms[k]) / max(norms[k], median, 1e-30) for k in leaves}


def batch_losses(outputs: np.ndarray, targets: np.ndarray, batch_size: int) -> list[float]:
    """Each batch's mean cross entropy from exported class probabilities."""
    p = outputs[np.arange(len(targets)), targets.astype(np.int64)]
    nll = -np.log(np.maximum(p, 1e-300))
    return [float(nll[s : s + batch_size].mean()) for s in range(0, len(targets), batch_size)]


def _rel_gap(got: list, want: list) -> float:
    if len(got) != len(want) or not want:
        return float("inf")
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want))


def _norm_gaps(diff: dict, ref: dict, leaves: list[str]) -> dict:
    """Each leaf's ``|diff[k]|`` against ``max(|ref[k]|, median leaf |ref|)``."""
    norms = {k: _norm(ref[k]) for k in leaves}
    median = float(np.median(list(norms.values())))
    return {k: _norm(diff[k]) / max(norms[k], median, 1e-30) for k in leaves}


def step1_effect(prog: dict, ref: dict, order: np.ndarray, batch_size: int) -> float:
    """``step1_effect_gap``; ``order``: the entries in the train pass's
    order, ``train_probs`` in that order, ``eval_probs`` in the entries'."""
    rows = slice(batch_size, 2 * batch_size)
    if prog.get("train_probs") is None or len(order) <= batch_size or len(prog["train_probs"]) != len(order):
        return float("inf")
    moved = float(np.linalg.norm(ref["train_probs"][rows] - ref["eval_probs"][order[rows]]))
    return float(np.linalg.norm(prog["train_probs"][rows] - ref["train_probs"][rows])) / max(moved, 1e-30)


def train_numbers(prog: dict, ref: dict, initial: dict, order: np.ndarray, batch_size: int, leaves_too: bool = False) -> dict:
    """``prog`` and ``ref``: ``eval_losses``, ``train_losses``,
    ``eval_probs``, ``train_probs``, ``params``, ``m`` and ``v`` (by
    parameter name); ``initial``: the weights both started from; ``order``
    and ``batch_size``: the train pass's. The worst leaf's gaps and the
    median leaf's; with ``leaves_too`` each leaf's as well."""
    leaves = list(initial)
    m_norms = {k: _norm(ref["m"][k]) for k in leaves}
    median_m = float(np.median(list(m_norms.values())))
    moving = [k for k in leaves if m_norms[k] >= 1e-3 * median_m]
    change_p = {k: prog["params"][k].double() - initial[k].double() for k in leaves}
    change_r = {k: ref["params"][k].double() - initial[k].double() for k in leaves}
    moment = leaf_gaps(prog["m"], ref["m"], leaves)
    second = leaf_gaps(prog["v"], ref["v"], leaves)
    change = leaf_gaps(change_p, change_r, moving)
    change_diff = _norm_gaps({k: change_p[k] - change_r[k] for k in moving}, change_r, moving)
    steps = [_rel_gap([a], [b]) for a, b in zip(prog["train_losses"], ref["train_losses"])]
    out = {
        "forward_loss_gap": _rel_gap(prog["eval_losses"], ref["eval_losses"]),
        "reported_loss_gap": _rel_gap([prog["reported_eval_loss"]] if prog.get("reported_eval_loss") is not None else [], [ref["reported_eval_loss"]]),
        "step_loss_gap": _rel_gap(prog["train_losses"], ref["train_losses"]),
        "step2_loss_gap": steps[1] if len(steps) > 1 else float("inf"),
        "moment_gap": max(moment.values()),
        "moment_gap_median": float(np.median(list(moment.values()))),
        "second_moment_gap": max(second.values()),
        "second_moment_gap_median": float(np.median(list(second.values()))),
        "change_gap": max(change.values()),
        "change_gap_median": float(np.median(list(change.values()))),
        "change_diff_gap": max(change_diff.values()),
        "change_diff_gap_median": float(np.median(list(change_diff.values()))),
        "step1_effect_gap": step1_effect(prog, ref, order, batch_size),
    }
    if leaves_too:
        out["step_loss_gaps"] = steps
        out["leaves"] = {k: [moment[k], change.get(k)] for k in leaves}
    return out


def score_numbers(passes: list[tuple[list[str], np.ndarray]], names: list[str], ref: np.ndarray) -> dict:
    """``passes``: each pass's entry names and probabilities ``[N, C]``;
    ``ref``: the reference's probabilities of ``names``, in that order."""
    missing, gap = 0, 0.0
    for got_names, probs in passes:
        if list(got_names) != list(names) or probs.shape != ref.shape:
            missing += len(names)
            continue
        finite = np.isfinite(probs).all(axis=1)
        missing += int((~finite).sum())
        if finite.any():
            gap = max(gap, float(np.abs(probs[finite] - ref[finite]).max()))
    if not passes:
        missing = len(names)
    return {"score_gap": gap, "missing": float(missing)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number that has a limit beside it; correct when none is over it."""
    checks = {name: {"value": numbers[name], "limit": float(limit)} for name, limit in limits.items()}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
