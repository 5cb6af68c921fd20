"""The timed path broken underneath the harness, one fault at a time, and
``correct`` comes out false: a train step that leaves the state unchanged,
half of each batch left out of the loss (the mean over the rest), in every
pass or in the train step's gradient alone (the forward and its reported
loss whole), and an answer altered where the Trainer produces it. (One card: no exchange
between chips to leave out.)"""

from __future__ import annotations

import pytest

from benchmark.tests.conftest import run_tiny


def test_state_left_unchanged(monkeypatch):
    from deeprank2_tpu_torch.ops import optim

    monkeypatch.setattr(optim.Adam, "_update", lambda self, group, p, grad, state: None)
    out = run_tiny("vanilla_residue.train")
    assert out["result"]["correct"] is False
    assert out["result"]["checks"]["change_gap"]["value"] > out["result"]["checks"]["change_gap"]["limit"]


@pytest.mark.parametrize("cell", ["vanilla_residue.train", "cnn_grid.train"])
def test_half_of_each_batch_left_out(monkeypatch, cell):
    from deeprank2_tpu_torch.ops import losses

    whole = losses.CrossEntropyLoss.__call__

    def half(self, logits, target, mask=None):
        keep = mask.clone()
        keep[keep.shape[0] // 2 :] = False
        return whole(self, logits, target, keep)

    monkeypatch.setattr(losses.CrossEntropyLoss, "__call__", half)
    out = run_tiny(cell)
    assert out["result"]["correct"] is False


@pytest.mark.parametrize("cell", ["vanilla_residue.train", "cnn_grid.train"])
def test_half_of_each_batch_left_out_of_the_step_alone(monkeypatch, cell):
    import torch

    from deeprank2_tpu_torch.ops import losses

    whole = losses.CrossEntropyLoss.__call__

    def half_in_the_step(self, logits, target, mask=None):
        if not torch.is_grad_enabled():  # the epoch-0 forward and its reported loss stay whole
            return whole(self, logits, target, mask)
        keep = mask.clone()
        keep[keep.shape[0] // 2 :] = False
        return whole(self, logits, target, keep)

    monkeypatch.setattr(losses.CrossEntropyLoss, "__call__", half_in_the_step)
    out = run_tiny(cell)
    checks = out["result"]["checks"]
    assert out["result"]["correct"] is False
    assert checks["forward_loss_gap"]["value"] <= checks["forward_loss_gap"]["limit"]
    assert checks["reported_loss_gap"]["value"] <= checks["reported_loss_gap"]["limit"]


def test_answer_altered(monkeypatch):
    from deeprank2_tpu_torch.trainer import Trainer

    exported = Trainer._export_outputs

    def altered(self, pred, y, valid, names):
        outputs, targets, entry_names = exported(self, pred, y, valid, names)
        outputs[0] = [1.0, 0.0] if outputs[0][0] < 0.5 else [0.0, 1.0]  # a confident answer for the other class
        return outputs, targets, entry_names

    monkeypatch.setattr(Trainer, "_export_outputs", altered)
    out = run_tiny("cnn_grid.score")
    assert out["result"]["correct"] is False
    assert out["result"]["checks"]["score_gap"]["value"] > out["result"]["checks"]["score_gap"]["limit"]
