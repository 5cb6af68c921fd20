"""The comparison's arithmetic: gaps by leaf against the larger of the leaf's
norm and the median leaf's, losses from exported probabilities, and a
verdict over the numbers that have limits."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness import gate


def test_leaf_gap_against_the_median_leaf():
    ref = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0, 1e-9], dtype=torch.float64), "c": torch.tensor([1.0])}
    prog = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0, 2e-9], dtype=torch.float64)}
    gaps = gate.leaf_gaps(prog, ref, ["a", "b", "c"])
    assert gaps["a"] == 0.0
    assert math.isclose(gaps["b"], 1e-9 / 1.0)  # the median leaf's norm, 1.0, not b's own 1e-9
    assert gaps["c"] == 1.0  # a leaf the program lacks reads as norm 0


def test_batch_losses_from_probabilities():
    probs = np.array([[0.5, 0.5], [0.25, 0.75], [0.9, 0.1], [0.2, 0.8]])
    losses = gate.batch_losses(probs, np.array([0.0, 1.0, 0.0, 1.0]), 2)
    assert np.allclose(losses, [-(np.log(0.5) + np.log(0.75)) / 2, -(np.log(0.9) + np.log(0.8)) / 2])


def test_judge_holds_only_numbers_with_limits():
    ok, checks = gate.judge({"x": 1e-8, "y": 5.0}, {"x": 1e-7})
    assert ok and list(checks) == ["x"]
    assert not gate.judge({"x": float("inf")}, {"x": 1.0})[0]
    assert not gate.judge({"x": 2.0}, {"x": 1.0})[0]


def test_score_numbers_count_missing_answers():
    names = ["a", "b"]
    ref = np.array([[0.5, 0.5], [0.4, 0.6]])
    assert gate.score_numbers([(names, ref.copy())], names, ref) == {"score_gap": 0.0, "missing": 0.0}
    assert gate.score_numbers([(["b", "a"], ref.copy())], names, ref)["missing"] == 2.0
    bad = ref.copy()
    bad[1] = np.nan
    assert gate.score_numbers([(names, bad)], names, ref)["missing"] == 1.0
    assert gate.score_numbers([], names, ref)["missing"] == 2.0
